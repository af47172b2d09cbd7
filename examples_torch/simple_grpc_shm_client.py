#!/usr/bin/env python
"""System shared-memory infer — parity with the reference
simple_grpc_shm_client.py: create POSIX regions, register, infer with
region-referencing inputs/outputs, read results back from the region.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import client_tpu_torch.grpc as grpcclient  # noqa: E402
from client_tpu_torch.utils import shared_memory as shm  # noqa: E402


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

    i0 = np.arange(16, dtype=np.int32).reshape(1, 16)
    i1 = np.ones((1, 16), dtype=np.int32)
    # keys of this process's own: two runs at once never unlink each
    # other's region
    in_key = f"/input_simple_{os.getpid()}"
    out_key = f"/output_simple_{os.getpid()}"
    in_handle = shm.create_shared_memory_region("input_data", in_key,
                                                i0.nbytes + i1.nbytes)
    out_handle = shm.create_shared_memory_region("output_data", out_key,
                                                 i0.nbytes + i1.nbytes)
    try:
        shm.set_shared_memory_region(in_handle, [i0, i1])
        with grpcclient.InferenceServerClient(url) as client:
            client.unregister_system_shared_memory()
            client.register_system_shared_memory(
                "input_data", in_key, i0.nbytes + i1.nbytes
            )
            client.register_system_shared_memory(
                "output_data", out_key, i0.nbytes + i1.nbytes
            )
            inputs = [
                grpcclient.InferInput("INPUT0", [1, 16], "INT32"),
                grpcclient.InferInput("INPUT1", [1, 16], "INT32"),
            ]
            inputs[0].set_shared_memory("input_data", i0.nbytes)
            inputs[1].set_shared_memory("input_data", i1.nbytes, offset=i0.nbytes)
            outputs = [
                grpcclient.InferRequestedOutput("OUTPUT0"),
                grpcclient.InferRequestedOutput("OUTPUT1"),
            ]
            outputs[0].set_shared_memory("output_data", i0.nbytes)
            outputs[1].set_shared_memory("output_data", i1.nbytes,
                                         offset=i0.nbytes)
            client.infer("simple", inputs, outputs=outputs)
            sum_ = shm.get_contents_as_numpy(out_handle, np.int32, [1, 16])
            diff = shm.get_contents_as_numpy(out_handle, np.int32, [1, 16],
                                             offset=i0.nbytes)
            for i in range(16):
                print(f"{i0[0][i]} + {i1[0][i]} = {sum_[0][i]}")
                if (i0[0][i] + i1[0][i]) != sum_[0][i]:
                    sys.exit("error: incorrect sum")
                if (i0[0][i] - i1[0][i]) != diff[0][i]:
                    sys.exit("error: incorrect difference")
            client.unregister_system_shared_memory()
            print("PASS: system shared memory")
    finally:
        shm.destroy_shared_memory_region(in_handle)
        shm.destroy_shared_memory_region(out_handle)
        if server:
            server.stop()


if __name__ == "__main__":
    main()
