#!/usr/bin/env python
"""CUDA shared-memory infer — parity with the reference's
simple_grpc_cudashm_client.py (the JAX package's
simple_grpc_tpushm_client.py): allocate device regions, pass the raw CUDA
IPC handle to the server, run zero-copy infer with inputs/outputs resident
in device memory, read results back.

Against ``-u`` the regions are ``cudaMalloc``'d in this process and the
server opens them over CUDA IPC.  In-process (--hermetic) the server
resolves them through the process-local broker with no host copies; with
``--hermetic --device cpu`` they are host regions only that server can
resolve.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import client_tpu_torch.grpc as grpcclient  # noqa: E402
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
    parser.add_argument("-u", "--url", default="localhost:8001")
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

        server = Server(grpc_port=0, device=device).start()
        url = server.grpc_address

    i0 = np.arange(16, dtype=np.int32).reshape(1, 16)
    i1 = np.full((1, 16), 2, dtype=np.int32)
    in_handle = cudashm.create_shared_memory_region(
        "cuda_input", i0.nbytes + i1.nbytes, device=device
    )
    out_handle = cudashm.create_shared_memory_region(
        "cuda_output", i0.nbytes + i1.nbytes, device=device
    )
    try:
        cudashm.set_shared_memory_region(in_handle, [i0, i1])  # one H2D
        with grpcclient.InferenceServerClient(url) as client:
            # this example's regions only: other clients of the same
            # server keep theirs
            for name in ("cuda_input", "cuda_output"):
                client.unregister_cuda_shared_memory(name)
            client.register_cuda_shared_memory(
                "cuda_input", cudashm.get_raw_handle(in_handle), 0,
                i0.nbytes + i1.nbytes,
            )
            client.register_cuda_shared_memory(
                "cuda_output", cudashm.get_raw_handle(out_handle), 0,
                i0.nbytes + i1.nbytes,
            )
            inputs = [
                grpcclient.InferInput("INPUT0", [1, 16], "INT32"),
                grpcclient.InferInput("INPUT1", [1, 16], "INT32"),
            ]
            inputs[0].set_shared_memory("cuda_input", i0.nbytes)
            inputs[1].set_shared_memory("cuda_input", i1.nbytes,
                                        offset=i0.nbytes)
            outputs = [
                grpcclient.InferRequestedOutput("OUTPUT0"),
                grpcclient.InferRequestedOutput("OUTPUT1"),
            ]
            outputs[0].set_shared_memory("cuda_output", i0.nbytes)
            outputs[1].set_shared_memory("cuda_output", i1.nbytes,
                                         offset=i0.nbytes)
            client.infer("simple", inputs, outputs=outputs)
            sum_ = cudashm.get_contents_as_numpy(out_handle, "INT32", [1, 16])
            diff = cudashm.get_contents_as_numpy(out_handle, "INT32", [1, 16],
                                                 offset=i0.nbytes)
            for i in range(16):
                print(f"{i0[0][i]} + {i1[0][i]} = {sum_[0][i]}")
                if (i0[0][i] + i1[0][i]) != sum_[0][i]:
                    sys.exit("error: incorrect sum")
                if (i0[0][i] - i1[0][i]) != diff[0][i]:
                    sys.exit("error: incorrect difference")
            # unregister (the server closes its IPC mappings) before the
            # regions are freed below
            for name in ("cuda_input", "cuda_output"):
                client.unregister_cuda_shared_memory(name)
            print("PASS: cuda shared memory")
    finally:
        cudashm.destroy_shared_memory_region(in_handle)
        cudashm.destroy_shared_memory_region(out_handle)
        if server:
            server.stop()


if __name__ == "__main__":
    main()
