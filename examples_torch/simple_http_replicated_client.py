#!/usr/bin/env python
"""Replica-set HTTP client example: one logical service over three
in-process server replicas (client_tpu_torch.balance.ReplicatedClient).

Spins its own replicas (the point is a multi-server topology, so the
usual -u single address is accepted but unused), runs inference across
them round-robin, then drains one replica mid-traffic and shows the
balancer routing around it with zero failed requests.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import client_tpu_torch.http as httpclient  # noqa: E402
from client_tpu_torch.balance import EndpointPool, ReplicatedClient  # noqa: E402
from client_tpu_torch import resolve_device  # noqa: E402
from client_tpu_torch.serve import Server  # noqa: E402
from client_tpu_torch.serve.metrics import (  # noqa: E402
    BalancerMetricsObserver,
    Registry,
)
from client_tpu_torch.utils import SERVER_NOT_READY  # noqa: E402


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
    servers = [Server(device=device).start() for _ in range(3)]
    urls = [s.http_address for s in servers]
    registry = Registry()
    pool = EndpointPool(
        urls, policy="round-robin", observer=BalancerMetricsObserver(registry)
    )
    client = ReplicatedClient(pool, transport="http", probe_interval_s=0.1)
    try:
        inputs = [
            httpclient.InferInput("INPUT0", [1, 16], "INT32"),
            httpclient.InferInput("INPUT1", [1, 16], "INT32"),
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

        run(6)  # round-robin: every replica serves
        routed = {
            url: registry.get("ctpu_client_routed_total", {"endpoint": url})
            for url in urls
        }
        if args.verbose:
            print(f"routed: {routed}")
        if any(not count for count in routed.values()):
            print("error: a replica received no traffic")
            sys.exit(1)

        # drain replica 0 (readiness flips false; in-flight work finishes)
        servers[0].engine.drain(timeout_s=10)
        import time

        deadline = time.monotonic() + 5
        while (
            client.states()[urls[0]] != SERVER_NOT_READY
            and time.monotonic() < deadline
        ):
            time.sleep(0.02)
        before = registry.get("ctpu_client_routed_total",
                              {"endpoint": urls[0]})
        run(6)  # traffic continues, routed around the drained replica
        after = registry.get("ctpu_client_routed_total",
                             {"endpoint": urls[0]})
        if after != before:
            print("error: drained replica kept receiving traffic")
            sys.exit(1)
        print("PASS: replicated http client")
    finally:
        client.close()
        for server in servers:
            server.stop()


if __name__ == "__main__":
    main()
