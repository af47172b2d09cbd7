#!/usr/bin/env python
"""Per-request options over gRPC — parity with the reference
simple_grpc_custom_args_client.py: request id, client timeout,
compression, custom headers."""

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
            i0 = np.arange(16, dtype=np.int32).reshape(1, 16)
            i1 = np.ones((1, 16), dtype=np.int32)
            inputs = [
                grpcclient.InferInput("INPUT0", [1, 16], "INT32"),
                grpcclient.InferInput("INPUT1", [1, 16], "INT32"),
            ]
            inputs[0].set_data_from_numpy(i0)
            inputs[1].set_data_from_numpy(i1)
            result = client.infer(
                "simple", inputs,
                request_id="my-request-7",
                client_timeout=10.0,
                compression_algorithm="gzip",
                headers={"x-example": "custom"},
            )
            response = result.get_response()
            assert response.id == "my-request-7", "request id not echoed"
            np.testing.assert_array_equal(result.as_numpy("OUTPUT0"), i0 + i1)
            print("PASS: grpc custom args infer")
    finally:
        if server:
            server.stop()


if __name__ == "__main__":
    main()
