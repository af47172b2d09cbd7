#!/usr/bin/env python
"""LLM token-streaming client — BASELINE.md config 5: send a text prompt to
the server-side tokenizer→LM ensemble and print pieces as they stream back
over the decoupled gRPC bidi stream (the Triton LLM pattern).
"""

import argparse
import os
import queue
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import client_tpu_torch.grpc as grpcclient  # noqa: E402


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-u", "--url", default="localhost:8001")
    parser.add_argument("-p", "--prompt", default="Once upon a time")
    parser.add_argument("-n", "--max-tokens", type=int, default=16)
    parser.add_argument("--temperature", type=float, default=0.0)
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
        from client_tpu_torch.serve.models import language_models

        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            sys.exit(f"error: {e}")
        server = Server(models=language_models(device=device), grpc_port=0,
                        with_default_models=False, device=device).start()
        url = server.grpc_address

    try:
        with grpcclient.InferenceServerClient(url) as client:
            results = queue.Queue()
            client.start_stream(
                callback=lambda result, error: results.put((result, error))
            )
            p_in = grpcclient.InferInput("PROMPT", [1], "BYTES")
            p_in.set_data_from_numpy(
                np.array([args.prompt.encode()], dtype=np.object_)
            )
            m_in = grpcclient.InferInput("MAX_TOKENS", [1], "INT32")
            m_in.set_data_from_numpy(
                np.array([args.max_tokens], dtype=np.int32)
            )
            params = (
                {"temperature": args.temperature} if args.temperature else None
            )
            client.async_stream_infer(
                "text_generator", [p_in, m_in], parameters=params
            )
            print(f"prompt: {args.prompt!r}")
            print("stream: ", end="", flush=True)
            pieces = 0
            while pieces < args.max_tokens:
                result, error = results.get(timeout=60)
                if error is not None:
                    sys.exit(f"stream error: {error}")
                piece = result.as_numpy("TEXT")[0]
                if not piece:
                    break  # EOS
                print(piece.decode("utf-8", errors="replace"), end="",
                      flush=True)
                pieces += 1
            print()
            client.stop_stream()
            print(f"PASS: streamed {pieces} pieces")
    finally:
        if server:
            server.stop()


if __name__ == "__main__":
    main()
