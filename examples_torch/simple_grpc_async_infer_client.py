#!/usr/bin/env python
"""Callback-based async inference — parity with the reference
simple_grpc_async_infer_client.py: fire N requests, collect results on the
completion callback.
"""

import argparse
import os
import queue
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import client_tpu_torch.grpc as grpcclient  # noqa: E402


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-u", "--url", default="localhost:8001")
    parser.add_argument("-n", "--requests", type=int, default=8)
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
        server = Server(grpc_port=0, device=device).start()
        url = server.grpc_address

    try:
        with grpcclient.InferenceServerClient(url) as client:
            done = queue.Queue()
            for k in range(args.requests):
                inputs = [
                    grpcclient.InferInput("INPUT0", [1, 16], "INT32"),
                    grpcclient.InferInput("INPUT1", [1, 16], "INT32"),
                ]
                inputs[0].set_data_from_numpy(np.full((1, 16), k, np.int32))
                inputs[1].set_data_from_numpy(np.ones((1, 16), np.int32))
                client.async_infer(
                    "simple",
                    inputs,
                    callback=lambda result, error: done.put((result, error)),
                    request_id=str(k),
                )
            seen = set()
            for _ in range(args.requests):
                result, error = done.get(timeout=30)
                if error is not None:
                    sys.exit(f"async error: {error}")
                rid = int(result.get_response().id)
                assert (result.as_numpy("OUTPUT0") == rid + 1).all()
                seen.add(rid)
            assert seen == set(range(args.requests))
            print(f"PASS: {args.requests} async requests completed")
    finally:
        if server:
            server.stop()


if __name__ == "__main__":
    main()
