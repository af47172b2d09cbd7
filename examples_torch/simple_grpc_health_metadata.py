#!/usr/bin/env python
"""Health + metadata surface over gRPC — parity with the reference
simple_grpc_health_metadata.py."""

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
            assert client.is_server_live(), "server not live"
            assert client.is_server_ready(), "server not ready"
            assert client.is_model_ready("simple"), "model not ready"
            meta = client.get_server_metadata(as_json=True)
            print("server:", meta["name"])
            mmeta = client.get_model_metadata("simple", as_json=True)
            print("model inputs:", [t["name"] for t in mmeta["inputs"]])
            stats = client.get_inference_statistics("simple", as_json=True)
            print("stat entries:", len(stats.get("model_stats", [])))
            print("PASS: grpc health metadata")
    finally:
        if server:
            server.stop()


if __name__ == "__main__":
    main()
