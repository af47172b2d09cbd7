#!/usr/bin/env python
"""asyncio HTTP inference — parity with the reference
simple_http_aio_infer_client.py."""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import asyncio  # noqa: E402

import client_tpu_torch.http.aio as aioclient  # noqa: E402

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
        async def flow():
            async with aioclient.InferenceServerClient(url) as client:
                assert await client.is_server_live()
                i0 = np.arange(16, dtype=np.int32).reshape(1, 16)
                i1 = np.ones((1, 16), dtype=np.int32)
                inputs = [
                    aioclient.InferInput("INPUT0", [1, 16], "INT32"),
                    aioclient.InferInput("INPUT1", [1, 16], "INT32"),
                ]
                inputs[0].set_data_from_numpy(i0)
                inputs[1].set_data_from_numpy(i1)
                results = await asyncio.gather(
                    *(client.infer("simple", inputs) for _ in range(4))
                )
                for r in results:
                    np.testing.assert_array_equal(r.as_numpy("OUTPUT0"), i0 + i1)

        asyncio.new_event_loop().run_until_complete(flow())
        print("PASS: http aio infer")
    finally:
        if server:
            server.stop()


if __name__ == "__main__":
    main()
