#!/usr/bin/env python
"""Live endpoint discovery example: a config-file resolver retires a
replica out from under a serving client (client_tpu_torch.balance discovery).

Spins two in-process gRPC replicas (the usual -u single address is
accepted but unused) and points a ReplicatedClient at a *config file*
listing both.  While requests flow, the config file is rewritten with
one replica removed — the discovery loop notices, the pool retires it
gracefully (in-flight work finishes, then eviction), and every request
keeps landing on the survivor.  The retired server is only stopped after
the pool has let go of it.
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import client_tpu_torch.grpc as grpcclient  # noqa: E402
from client_tpu_torch.balance import ConfigFileResolver, ReplicatedClient  # noqa: E402
from client_tpu_torch.resilience import RetryPolicy  # noqa: E402
from client_tpu_torch import resolve_device  # noqa: E402
from client_tpu_torch.serve import Server  # noqa: E402


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-u", "--url", default=None,
                        help="ignored: this example spins its own replicas")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="device of the replicas (cpu runs the plain "
                             "PyTorch path)")
    args = parser.parse_args()

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"error: {e}")
    servers = [Server(grpc_port=0, device=device).start() for _ in range(2)]
    urls = [s.grpc_address for s in servers]

    fd, config_path = tempfile.mkstemp(suffix=".conf", prefix="fleet-")
    os.close(fd)
    client = None
    try:
        with open(config_path, "w", encoding="utf-8") as f:
            f.write("# the fleet, one replica per line\n")
            f.write("\n".join(urls) + "\n")

        client = ReplicatedClient(
            urls,
            transport="grpc",
            policy="round-robin",
            probe_interval_s=0.1,
            resolver=ConfigFileResolver(config_path),
            discovery_interval_s=0.1,
            retry_policy=RetryPolicy(
                max_attempts=5, initial_backoff_s=0.05, max_backoff_s=0.2
            ),
        )

        inputs = [
            grpcclient.InferInput("INPUT0", [1, 16], "INT32"),
            grpcclient.InferInput("INPUT1", [1, 16], "INT32"),
        ]
        input0_data = np.arange(16, dtype=np.int32).reshape(1, 16)
        input1_data = np.ones((1, 16), dtype=np.int32)
        inputs[0].set_data_from_numpy(input0_data)
        inputs[1].set_data_from_numpy(input1_data)

        def run(n):
            for _ in range(n):
                results = client.infer("simple", inputs)
                np.testing.assert_array_equal(
                    results.as_numpy("OUTPUT0"), input0_data + input1_data
                )

        run(6)  # both replicas serve
        if args.verbose:
            print(f"fleet: {client.pool.urls()}")

        # the operator edits the config: replica 0 leaves the fleet
        with open(config_path, "w", encoding="utf-8") as f:
            f.write(urls[1] + "\n")

        # discovery notices, retires, and (idle) evicts replica 0
        deadline = time.monotonic() + 10
        while urls[0] in client.pool.urls():
            if time.monotonic() > deadline:
                print("error: retired replica was never evicted")
                sys.exit(1)
            run(1)  # traffic keeps flowing throughout
            time.sleep(0.02)
        if args.verbose:
            print(f"fleet after retire: {client.pool.urls()}")

        servers[0].stop()  # only now is the replica actually gone
        run(6)  # every request lands on the survivor

        if client.pool.urls() != [urls[1]]:
            print(f"error: unexpected membership {client.pool.urls()}")
            sys.exit(1)
        print("PASS: discovery grpc client")
    finally:
        if client is not None:
            client.close()
        for server in servers:
            server.stop()
        try:
            os.unlink(config_path)
        except OSError:
            pass


if __name__ == "__main__":
    main()
