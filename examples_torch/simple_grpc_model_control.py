#!/usr/bin/env python
"""Model repository control — parity with the reference
simple_grpc_model_control.py: index, unload, verify not-ready, load, infer.
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
            index = client.get_model_repository_index(as_json=True)
            names = {m["name"] for m in index.get("models", [])}
            assert "simple" in names, names
            print(f"repository: {sorted(names)}")

            client.unload_model("simple")
            assert not client.is_model_ready("simple")
            print("unloaded 'simple'")

            client.load_model("simple")
            assert client.is_model_ready("simple")
            print("loaded 'simple'")

            inputs = [
                grpcclient.InferInput("INPUT0", [1, 16], "INT32"),
                grpcclient.InferInput("INPUT1", [1, 16], "INT32"),
            ]
            inputs[0].set_data_from_numpy(np.ones((1, 16), np.int32))
            inputs[1].set_data_from_numpy(np.ones((1, 16), np.int32))
            result = client.infer("simple", inputs)
            assert (result.as_numpy("OUTPUT0") == 2).all()
            print("PASS: model control")
    finally:
        if server:
            server.stop()


if __name__ == "__main__":
    main()
