#!/usr/bin/env python
"""Stateful sequences over plain HTTP infers — parity with the reference
simple_http_sequence_sync_infer_client.py: two interleaved sequences,
correlation ids carried per request."""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import client_tpu_torch.http as httpclient  # noqa: E402

def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-u", "--url", default="localhost:8000")
    parser.add_argument("--hermetic", action="store_true")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="device of the --hermetic server (cpu runs the "
                             "plain PyTorch path)")
    args = parser.parse_args()

    server = None
    url = args.url
    if args.hermetic:
        from client_tpu_torch import resolve_device
        from client_tpu_torch.serve import Server

        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            sys.exit(f"error: {e}")
        server = Server(http_port=0, device=device).start()
        url = server.http_address

    try:
        with httpclient.InferenceServerClient(url) as client:
            expected = {101: 0, 102: 0}
            values = [1, 2, 3, 4]
            for step, v in enumerate(values):
                for seq_id, scale in ((101, 1), (102, 10)):
                    inp = httpclient.InferInput("INPUT", [1], "INT32")
                    inp.set_data_from_numpy(np.array([v * scale], dtype=np.int32))
                    result = client.infer(
                        "simple_sequence", [inp],
                        sequence_id=seq_id,
                        sequence_start=(step == 0),
                        sequence_end=(step == len(values) - 1),
                    )
                    expected[seq_id] += v * scale
                    got = int(result.as_numpy("OUTPUT")[0])
                    print(f"seq {seq_id} step {step}: {got}")
                    if got != expected[seq_id]:
                        sys.exit("error: wrong running sum")
            print("PASS: http sequence sync infer")
    finally:
        if server:
            server.stop()


if __name__ == "__main__":
    main()
