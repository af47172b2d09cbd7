#!/usr/bin/env python
"""CUDA device-buffer shared memory over HTTP — parity with the reference's
simple_http_cudashm_client.py (the JAX package's
simple_http_tpushm_client.py): tensors live in device regions, requests
carry only region references.  Against ``-u`` the server opens the regions
over CUDA IPC; with --hermetic it resolves them in process."""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import client_tpu_torch.http as httpclient  # noqa: E402
from client_tpu_torch.utils import cuda_shared_memory as cudashm  # noqa: E402


def region_device(args):
    """The device of the --hermetic server and of the regions: --device
    with --hermetic; else CUDA, since a server in another process opens
    the regions over CUDA IPC.  Exits with the refusal where it is absent."""
    from client_tpu_torch import resolve_device

    try:
        return resolve_device(args.device if args.hermetic else "cuda")
    except RuntimeError as e:
        if args.hermetic:
            sys.exit(f"error: {e}")
        sys.exit("error: a server in another process opens a CUDA shared "
                 "memory region over CUDA IPC, and this host has no CUDA "
                 "device (--device cpu needs --hermetic)")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-u", "--url", default="localhost:8000")
    parser.add_argument("--hermetic", action="store_true")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="device of the --hermetic server and its "
                             "regions (cpu runs the plain PyTorch path)")
    args = parser.parse_args()

    device = region_device(args)
    server = None
    url = args.url
    if args.hermetic:
        from client_tpu_torch.serve import Server

        server = Server(http_port=0, device=device).start()
        url = server.http_address

    try:
        i0 = np.arange(16, dtype=np.float32).reshape(1, 16)
        in_h = cudashm.create_shared_memory_region("cuda_in_http", i0.nbytes,
                                                   device=device)
        out_h = cudashm.create_shared_memory_region("cuda_out_http",
                                                    i0.nbytes, device=device)
        try:
            cudashm.set_shared_memory_region(in_h, [i0])
            with httpclient.InferenceServerClient(url) as client:
                # this example's regions only: other clients of the same
                # server keep theirs
                for name in ("cuda_in_http", "cuda_out_http"):
                    client.unregister_cuda_shared_memory(name)
                client.register_cuda_shared_memory(
                    "cuda_in_http", cudashm.get_raw_handle(in_h), 0,
                    i0.nbytes)
                client.register_cuda_shared_memory(
                    "cuda_out_http", cudashm.get_raw_handle(out_h), 0,
                    i0.nbytes)
                inp = httpclient.InferInput("INPUT0", [1, 16], "FP32")
                inp.set_shared_memory("cuda_in_http", i0.nbytes)
                out = httpclient.InferRequestedOutput("OUTPUT0")
                out.set_shared_memory("cuda_out_http", i0.nbytes)
                client.infer("identity", [inp], outputs=[out])
                got = cudashm.get_contents_as_numpy(out_h, np.float32, [1, 16])
                np.testing.assert_array_equal(got, i0)
                for name in ("cuda_in_http", "cuda_out_http"):
                    client.unregister_cuda_shared_memory(name)
            print("PASS: http cudashm infer")
        finally:
            cudashm.destroy_shared_memory_region(in_h)
            cudashm.destroy_shared_memory_region(out_h)
    finally:
        if server:
            server.stop()


if __name__ == "__main__":
    main()
