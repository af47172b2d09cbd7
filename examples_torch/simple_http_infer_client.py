#!/usr/bin/env python
"""Minimal HTTP inference example — parity with the reference's
simple_http_infer_client.py (reference src/python/examples). Runs against any
KServe-v2 server with the 'simple' add/sub model; pass --hermetic to spin up
the in-process client_tpu_torch.serve server (on --device)
instead of connecting externally.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import client_tpu_torch.http as httpclient  # noqa: E402


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-u", "--url", default="localhost:8000")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument(
        "--hermetic",
        action="store_true",
        help="serve the model in-process instead of connecting to --url",
    )
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
        server = Server(device=device).start()
        url = server.http_address

    try:
        with httpclient.InferenceServerClient(url, verbose=args.verbose) as client:
            inputs = [
                httpclient.InferInput("INPUT0", [1, 16], "INT32"),
                httpclient.InferInput("INPUT1", [1, 16], "INT32"),
            ]
            input0_data = np.arange(16, dtype=np.int32).reshape(1, 16)
            input1_data = np.ones((1, 16), dtype=np.int32)
            inputs[0].set_data_from_numpy(input0_data)
            inputs[1].set_data_from_numpy(input1_data)
            outputs = [
                httpclient.InferRequestedOutput("OUTPUT0", binary_data=True),
                httpclient.InferRequestedOutput("OUTPUT1", binary_data=True),
            ]
            results = client.infer("simple", inputs, outputs=outputs)
            output0 = results.as_numpy("OUTPUT0")
            output1 = results.as_numpy("OUTPUT1")
            for i in range(16):
                print(f"{input0_data[0][i]} + {input1_data[0][i]} = {output0[0][i]}")
                if (input0_data[0][i] + input1_data[0][i]) != output0[0][i]:
                    print("error: incorrect sum")
                    sys.exit(1)
                if (input0_data[0][i] - input1_data[0][i]) != output1[0][i]:
                    print("error: incorrect difference")
                    sys.exit(1)
            print("PASS: infer")
    finally:
        if server is not None:
            server.stop()


if __name__ == "__main__":
    main()
