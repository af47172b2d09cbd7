#!/usr/bin/env python
"""Reuse InferInput/InferRequestedOutput across requests — parity with the
reference reuse_infer_objects_client.cc (InferInput::Reset pattern,
reference common.h:261).
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
            inputs = [
                grpcclient.InferInput("INPUT0", [1, 16], "INT32"),
                grpcclient.InferInput("INPUT1", [1, 16], "INT32"),
            ]
            outputs = [
                grpcclient.InferRequestedOutput("OUTPUT0"),
                grpcclient.InferRequestedOutput("OUTPUT1"),
            ]
            for round_idx in range(3):
                i0 = np.full((1, 16), round_idx, np.int32)
                i1 = np.full((1, 16), 10, np.int32)
                inputs[0].reset().set_data_from_numpy(i0)
                inputs[1].reset().set_data_from_numpy(i1)
                result = client.infer("simple", inputs, outputs=outputs)
                assert (result.as_numpy("OUTPUT0") == round_idx + 10).all()
                assert (result.as_numpy("OUTPUT1") == round_idx - 10).all()
                print(f"round {round_idx}: ok")
            print("PASS: reused infer objects across requests")
    finally:
        if server:
            server.stop()


if __name__ == "__main__":
    main()
