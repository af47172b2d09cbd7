#!/usr/bin/env python
"""BYTES-tensor inference — parity with the reference
simple_grpc_string_infer_client.py: string tensors in, string sums out.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import client_tpu_torch.grpc as grpcclient  # noqa: E402


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-u", "--url", default="localhost:8001")
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
            i0 = np.array([[str(n) for n in range(16)]], dtype=np.object_)
            i1 = np.array([["1"] * 16], dtype=np.object_)
            inputs = [
                grpcclient.InferInput("INPUT0", [1, 16], "BYTES"),
                grpcclient.InferInput("INPUT1", [1, 16], "BYTES"),
            ]
            inputs[0].set_data_from_numpy(i0)
            inputs[1].set_data_from_numpy(i1)
            result = client.infer("simple_string", inputs)
            out0 = result.as_numpy("OUTPUT0")
            out1 = result.as_numpy("OUTPUT1")
            for i in range(16):
                expected_sum = i + 1
                expected_diff = i - 1
                got_sum = int(out0[0][i])
                got_diff = int(out1[0][i])
                print(f"{i} + 1 = {got_sum}, {i} - 1 = {got_diff}")
                if got_sum != expected_sum or got_diff != expected_diff:
                    sys.exit("error: wrong string arithmetic")
            print("PASS: string infer")
    finally:
        if server:
            server.stop()


if __name__ == "__main__":
    main()
