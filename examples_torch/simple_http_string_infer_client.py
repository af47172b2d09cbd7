#!/usr/bin/env python
"""BYTES-tensor inference over HTTP — parity with the reference
simple_http_string_infer_client.py."""

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
            i0 = np.array([[str(n) for n in range(16)]], dtype=np.object_)
            i1 = np.array([["1"] * 16], dtype=np.object_)
            inputs = [
                httpclient.InferInput("INPUT0", [1, 16], "BYTES"),
                httpclient.InferInput("INPUT1", [1, 16], "BYTES"),
            ]
            inputs[0].set_data_from_numpy(i0)
            inputs[1].set_data_from_numpy(i1)
            result = client.infer("simple_string", inputs)
            out0 = result.as_numpy("OUTPUT0")
            out1 = result.as_numpy("OUTPUT1")
            for i in range(16):
                if int(out0[0][i]) != i + 1 or int(out1[0][i]) != i - 1:
                    sys.exit("error: wrong string arithmetic")
            print("PASS: http string infer")
    finally:
        if server:
            server.stop()


if __name__ == "__main__":
    main()
