#!/usr/bin/env python
"""Decoupled N-response model over the bidi stream — parity with the
reference simple_grpc_custom_repeat.py: one request to repeat_int32
yields --repeat-count responses.  Completion uses Triton's decoupled
protocol: the request asks for an empty final response
(enable_empty_final_response) and the consumer stops on the
triton_final_response=true marker instead of counting responses."""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import queue  # noqa: E402

import client_tpu_torch.grpc as grpcclient  # noqa: E402

def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-u", "--url", default="localhost:8001")
    parser.add_argument("--hermetic", action="store_true")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="device of the --hermetic server (cpu runs the "
                             "plain PyTorch path)")
    parser.add_argument("--repeat-count", type=int, default=8)
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
        results = queue.SimpleQueue()
        with grpcclient.InferenceServerClient(url) as client:
            client.start_stream(lambda result, error: results.put((result, error)))
            inp = grpcclient.InferInput("IN", [1], "INT32")
            inp.set_data_from_numpy(np.array([args.repeat_count], dtype=np.int32))
            client.async_stream_infer(
                "repeat_int32", [inp], enable_empty_final_response=True
            )
            got = []
            while True:
                result, error = results.get(timeout=30)
                if error is not None:
                    sys.exit(f"error: {error}")
                params = result.get_response().parameters
                if params["triton_final_response"].bool_param:
                    break  # empty completion marker, not a content response
                got.append(int(result.as_numpy("OUT")[0]))
            client.stop_stream()
            if got != list(range(args.repeat_count)):
                sys.exit(f"error: wrong repeat sequence {got}")
            print(f"PASS: grpc custom repeat x{args.repeat_count}")
    finally:
        if server:
            server.stop()


if __name__ == "__main__":
    main()
