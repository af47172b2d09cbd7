#!/usr/bin/env python
"""Asynchronous HTTP inference via the worker pool — parity with the
reference simple_http_async_infer_client.py: submit N requests, then
collect futures."""

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
        with httpclient.InferenceServerClient(url, concurrency=4) as client:

            i0 = np.arange(16, dtype=np.int32).reshape(1, 16)
            i1 = np.ones((1, 16), dtype=np.int32)
            inputs = [
                httpclient.InferInput("INPUT0", [1, 16], "INT32"),
                httpclient.InferInput("INPUT1", [1, 16], "INT32"),
            ]
            inputs[0].set_data_from_numpy(i0)
            inputs[1].set_data_from_numpy(i1)

            pending = [client.async_infer("simple", inputs) for _ in range(8)]
            for req in pending:
                result = req.get_result()
                np.testing.assert_array_equal(result.as_numpy("OUTPUT0"), i0 + i1)
            print("PASS: http async infer x8")
    finally:
        if server:
            server.stop()


if __name__ == "__main__":
    main()
