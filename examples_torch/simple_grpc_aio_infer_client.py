#!/usr/bin/env python
"""asyncio gRPC inference — parity with the reference
simple_grpc_aio_infer_client.py: health + metadata + infer on the event loop.
"""

import argparse
import asyncio
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import client_tpu_torch.grpc.aio as grpcclient_aio  # noqa: E402
import client_tpu_torch.grpc as grpcclient  # noqa: E402


async def run(url):
    async with grpcclient_aio.InferenceServerClient(url) as client:
        assert await client.is_server_live()
        assert await client.is_server_ready()
        meta = await client.get_server_metadata(as_json=True)
        print(f"server: {meta['name']}")

        inputs = [
            grpcclient.InferInput("INPUT0", [1, 16], "INT32"),
            grpcclient.InferInput("INPUT1", [1, 16], "INT32"),
        ]
        i0 = np.arange(16, dtype=np.int32).reshape(1, 16)
        i1 = np.ones((1, 16), dtype=np.int32)
        inputs[0].set_data_from_numpy(i0)
        inputs[1].set_data_from_numpy(i1)
        result = await client.infer("simple", inputs)
        assert (result.as_numpy("OUTPUT0") == i0 + i1).all()
        assert (result.as_numpy("OUTPUT1") == i0 - i1).all()
        print("PASS: aio infer")


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
        asyncio.run(run(url))
    finally:
        if server:
            server.stop()


if __name__ == "__main__":
    main()
