#!/usr/bin/env python
"""Replica-set gRPC client example: failover across replicas with the
hop recorded on one trace (client_tpu_torch.balance.ReplicatedClient).

Spins two in-process gRPC replicas (the usual -u single address is
accepted but unused), stops one outright, and shows the next request
failing over to the survivor — with both attempts visible, endpoint by
endpoint, on a single client trace span.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import client_tpu_torch.grpc as grpcclient  # noqa: E402
from client_tpu_torch.balance import ReplicatedClient  # noqa: E402
from client_tpu_torch.resilience import RetryPolicy  # noqa: E402
from client_tpu_torch import resolve_device  # noqa: E402
from client_tpu_torch.serve import Server  # noqa: E402
from client_tpu_torch.tracing import ClientTracer  # noqa: E402

# shrink the channel's own reconnect backoff so failover attempts map to
# real reconnects (see tests/test_resilience.py)
_FAST_RECONNECT = [
    ("grpc.initial_reconnect_backoff_ms", 50),
    ("grpc.min_reconnect_backoff_ms", 50),
    ("grpc.max_reconnect_backoff_ms", 100),
]


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
    tracer = ClientTracer()
    client = ReplicatedClient(
        urls,
        transport="grpc",
        policy="round-robin",
        probe_interval_s=None,  # let the request itself discover the death
        tracer=tracer,
        retry_policy=RetryPolicy(
            max_attempts=5, initial_backoff_s=0.05, max_backoff_s=0.2
        ),
        channel_args=_FAST_RECONNECT,
    )
    try:
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

        run(4)  # both replicas serve
        servers[0].stop()  # replica 0 dies
        run(4)  # every request still lands (failover to the survivor)

        hops = [
            trace.attempt_endpoints()
            for trace in tracer.traces
            if len(set(trace.attempt_endpoints())) > 1
        ]
        if args.verbose:
            print(f"failover hops: {hops}")
        if not hops:
            print("error: no trace recorded the failover hop")
            sys.exit(1)
        print("PASS: replicated grpc client")
    finally:
        client.close()
        for server in servers:
            server.stop()


if __name__ == "__main__":
    main()
