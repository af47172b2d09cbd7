#!/usr/bin/env python
"""Explicit model control over HTTP — parity with the reference
simple_http_model_control.py: unload, observe readiness, load, index."""

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
            client.unload_model("identity")
            assert not client.is_model_ready("identity"), "unload did not take"
            index = client.get_model_repository_index()
            state = {m["name"]: m.get("state") for m in index}
            print("identity state after unload:", state.get("identity"))
            client.load_model("identity")
            assert client.is_model_ready("identity"), "load did not take"
            print("PASS: http model control")
    finally:
        if server:
            server.stop()


if __name__ == "__main__":
    main()
