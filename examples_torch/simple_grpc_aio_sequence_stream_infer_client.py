#!/usr/bin/env python
"""Stateful sequences over the asyncio bidi stream — parity with the
reference simple_grpc_aio_sequence_stream_infer_client.py."""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import asyncio  # noqa: E402

import client_tpu_torch.grpc.aio as aioclient  # noqa: E402

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
        async def flow():
            async with aioclient.InferenceServerClient(url) as client:
                async def requests():
                    for step, v in enumerate((5, 10, 15)):
                        inp = aioclient.InferInput("INPUT", [1], "INT32")
                        inp.set_data_from_numpy(np.array([v], dtype=np.int32))
                        yield {
                            "model_name": "simple_sequence",
                            "inputs": [inp],
                            "sequence_id": 31,
                            "sequence_start": step == 0,
                            "sequence_end": step == 2,
                        }

                acc, want = [], [5, 15, 30]
                async for result, error in client.stream_infer(requests()):
                    assert error is None, error
                    acc.append(int(result.as_numpy("OUTPUT")[0]))
                    if len(acc) == 3:
                        break
                if acc != want:
                    sys.exit(f"error: wrong sums {acc}")

        asyncio.new_event_loop().run_until_complete(flow())
        print("PASS: grpc aio sequence stream")
    finally:
        if server:
            server.stop()


if __name__ == "__main__":
    main()
