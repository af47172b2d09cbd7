#!/usr/bin/env python
"""Config-driven ensemble inference — parity with the reference
ensemble_image_client.py pattern: one request fans through the
ensemble's composing models server-side; composing statistics prove
the chain ran."""

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
            config = client.get_model_config("simple_ensemble", as_json=True)
            steps = config["config"]["ensemble_scheduling"]["step"]
            print("ensemble steps:", [s["model_name"] for s in steps])
            i0 = np.arange(16, dtype=np.int32).reshape(1, 16)
            i1 = np.full((1, 16), 3, dtype=np.int32)
            inputs = [
                grpcclient.InferInput("INPUT0", [1, 16], "INT32"),
                grpcclient.InferInput("INPUT1", [1, 16], "INT32"),
            ]
            inputs[0].set_data_from_numpy(i0)
            inputs[1].set_data_from_numpy(i1)
            result = client.infer("simple_ensemble", inputs)
            np.testing.assert_array_equal(result.as_numpy("OUTPUT0"), i0 + i1)
            np.testing.assert_array_equal(result.as_numpy("OUTPUT1"), i0 - i1)
            stats = client.get_inference_statistics("simple", as_json=True)
            count = int(stats["model_stats"][0]["inference_stats"]["success"]["count"])
            assert count >= 1, "composing model recorded no executions"
            print("PASS: ensemble infer (composing stats recorded)")
    finally:
        if server:
            server.stop()


if __name__ == "__main__":
    main()
