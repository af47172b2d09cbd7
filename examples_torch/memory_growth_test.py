#!/usr/bin/env python
"""Client memory-growth check — parity with the reference's
memory_growth_test.py (reference src/python/examples/memory_growth_test.py,
and the Java client's MemoryGrowthTest): hammer infer + result parsing in a
loop and require that RSS stabilizes, catching leaked response buffers or
connection objects."""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def _rss_mb():
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass  # no procfs (non-Linux): growth reads as 0, loop still runs
    return 0.0


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-u", "--url", default="localhost:8001")
    parser.add_argument("-i", "--protocol", choices=["grpc", "http"],
                        default="grpc")
    parser.add_argument("-n", "--iterations", type=int, default=300)
    parser.add_argument("--max-growth-mb", type=float, default=32.0)
    args = parser.parse_args()

    if args.protocol == "grpc":
        import client_tpu_torch.grpc as mod
    else:
        import client_tpu_torch.http as mod

    data0 = np.arange(16, dtype=np.int32).reshape(1, 16)
    data1 = np.ones((1, 16), dtype=np.int32)
    with mod.InferenceServerClient(args.url) as client:
        def once():
            inputs = [
                mod.InferInput("INPUT0", [1, 16], "INT32"),
                mod.InferInput("INPUT1", [1, 16], "INT32"),
            ]
            inputs[0].set_data_from_numpy(data0)
            inputs[1].set_data_from_numpy(data1)
            result = client.infer("simple", inputs)
            assert result.as_numpy("OUTPUT0") is not None

        # warmup establishes pools/caches that count as steady state
        for _ in range(50):
            once()
        base = _rss_mb()
        for i in range(args.iterations):
            once()
        growth = _rss_mb() - base
        print(f"{args.iterations} iterations: RSS {base:.1f}MB -> "
              f"{base + growth:.1f}MB (growth {growth:.1f}MB)")
        if growth > args.max_growth_mb:
            sys.exit(f"error: RSS grew {growth:.1f}MB > "
                     f"{args.max_growth_mb}MB budget")
    print("PASS: memory_growth_test")


if __name__ == "__main__":
    main()
