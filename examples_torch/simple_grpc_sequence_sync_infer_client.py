#!/usr/bin/env python
"""Stateful sequences over plain gRPC infers (no stream) — parity with the
reference simple_grpc_sequence_sync_infer_client.py."""

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
            expected = {201: 0, 202: 0}
            values = [2, 4, 6]
            for step, v in enumerate(values):
                for seq_id, scale in ((201, 1), (202, 100)):
                    inp = grpcclient.InferInput("INPUT", [1], "INT32")
                    inp.set_data_from_numpy(np.array([v * scale], dtype=np.int32))
                    result = client.infer(
                        "simple_sequence", [inp],
                        sequence_id=seq_id,
                        sequence_start=(step == 0),
                        sequence_end=(step == len(values) - 1),
                    )
                    expected[seq_id] += v * scale
                    got = int(result.as_numpy("OUTPUT")[0])
                    if got != expected[seq_id]:
                        sys.exit("error: wrong running sum")
            print("PASS: grpc sequence sync infer")
    finally:
        if server:
            server.stop()


if __name__ == "__main__":
    main()
