#!/usr/bin/env python
"""Health + metadata surface over HTTP — parity with the reference
simple_http_health_metadata.py: liveness, readiness, server and model
metadata, model config."""

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
            assert client.is_server_live(), "server not live"
            assert client.is_server_ready(), "server not ready"
            assert client.is_model_ready("simple"), "model not ready"
            meta = client.get_server_metadata()
            print("server:", meta["name"], meta.get("version", ""))
            mmeta = client.get_model_metadata("simple")
            print("model inputs:", [t["name"] for t in mmeta["inputs"]])
            config = client.get_model_config("simple")
            print("max_batch_size:", config["max_batch_size"])
            print("PASS: http health metadata")
    finally:
        if server:
            server.stop()


if __name__ == "__main__":
    main()
