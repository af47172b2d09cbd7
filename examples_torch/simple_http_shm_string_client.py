#!/usr/bin/env python
"""BYTES tensors through system shared memory over HTTP — parity with the
reference simple_http_shm_string_client.py: serialized string tensors
placed in and read back from POSIX regions."""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import client_tpu_torch.http as httpclient  # noqa: E402
from client_tpu_torch.utils import serialize_byte_tensor, shared_memory as shm  # noqa: E402

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
        i0 = np.array([[str(n) for n in range(16)]], dtype=np.object_)
        i1 = np.array([["1"] * 16], dtype=np.object_)
        raw0 = serialize_byte_tensor(i0).tobytes()
        raw1 = serialize_byte_tensor(i1).tobytes()
        # keys of this process's own: two runs at once never unlink each
        # other's region
        in_key = f"/http_in_str_{os.getpid()}"
        out_key = f"/http_out_str_{os.getpid()}"
        in_h = shm.create_shared_memory_region("str_in", in_key,
                                               len(raw0) + len(raw1))
        out_h = shm.create_shared_memory_region("str_out", out_key, 4096)
        try:
            shm.set_shared_memory_region(in_h, [i0, i1])
            with httpclient.InferenceServerClient(url) as client:
                client.unregister_system_shared_memory()
                client.register_system_shared_memory("str_in", in_key,
                                                     len(raw0) + len(raw1))
                client.register_system_shared_memory("str_out", out_key, 4096)
                inputs = [
                    httpclient.InferInput("INPUT0", [1, 16], "BYTES"),
                    httpclient.InferInput("INPUT1", [1, 16], "BYTES"),
                ]
                inputs[0].set_shared_memory("str_in", len(raw0))
                inputs[1].set_shared_memory("str_in", len(raw1), offset=len(raw0))
                outputs = [
                    httpclient.InferRequestedOutput("OUTPUT0"),
                    httpclient.InferRequestedOutput("OUTPUT1"),
                ]
                outputs[0].set_shared_memory("str_out", 2048)
                outputs[1].set_shared_memory("str_out", 2048, offset=2048)
                client.infer("simple_string", inputs, outputs=outputs)
                got_sum = shm.get_contents_as_numpy(out_h, np.object_, [1, 16])
                for i in range(16):
                    if int(got_sum[0][i]) != i + 1:
                        sys.exit("error: wrong shm string sum")
                client.unregister_system_shared_memory()
            print("PASS: http shm string infer")
        finally:
            shm.destroy_shared_memory_region(in_h)
            shm.destroy_shared_memory_region(out_h)
    finally:
        if server:
            server.stop()


if __name__ == "__main__":
    main()
