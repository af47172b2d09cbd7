#!/usr/bin/env python
"""Custom gRPC keepalive configuration — parity with the reference
simple_grpc_keepalive_client.py: explicit KeepAliveOptions on the
channel, then a normal infer."""

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
        ka = grpcclient.KeepAliveOptions(
            keepalive_time_ms=2**31 - 1,
            keepalive_timeout_ms=20000,
            keepalive_permit_without_calls=False,
            http2_max_pings_without_data=2,
        )
        with grpcclient.InferenceServerClient(url, keepalive_options=ka) as client:
            i0 = np.arange(16, dtype=np.int32).reshape(1, 16)
            i1 = np.ones((1, 16), dtype=np.int32)
            inputs = [
                grpcclient.InferInput("INPUT0", [1, 16], "INT32"),
                grpcclient.InferInput("INPUT1", [1, 16], "INT32"),
            ]
            inputs[0].set_data_from_numpy(i0)
            inputs[1].set_data_from_numpy(i1)
            result = client.infer("simple", inputs)
            np.testing.assert_array_equal(result.as_numpy("OUTPUT0"), i0 + i1)
            print("PASS: grpc keepalive infer")
    finally:
        if server:
            server.stop()


if __name__ == "__main__":
    main()
