#!/usr/bin/env python
"""System shared-memory inference over HTTP — parity with the reference
simple_http_shm_client.py."""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import client_tpu_torch.http as httpclient  # noqa: E402
from client_tpu_torch.utils import shared_memory as shm  # noqa: E402

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
        i0 = np.arange(16, dtype=np.int32).reshape(1, 16)
        i1 = np.ones((1, 16), dtype=np.int32)
        # keys of this process's own: two runs at once never unlink each
        # other's region
        in_key = f"/http_in_simple_{os.getpid()}"
        out_key = f"/http_out_simple_{os.getpid()}"
        in_h = shm.create_shared_memory_region("in_data", in_key,
                                               i0.nbytes + i1.nbytes)
        out_h = shm.create_shared_memory_region("out_data", out_key,
                                                i0.nbytes + i1.nbytes)
        try:
            shm.set_shared_memory_region(in_h, [i0, i1])
            with httpclient.InferenceServerClient(url) as client:
                client.unregister_system_shared_memory()
                client.register_system_shared_memory("in_data", in_key,
                                                     i0.nbytes + i1.nbytes)
                client.register_system_shared_memory("out_data", out_key,
                                                     i0.nbytes + i1.nbytes)
                inputs = [
                    httpclient.InferInput("INPUT0", [1, 16], "INT32"),
                    httpclient.InferInput("INPUT1", [1, 16], "INT32"),
                ]
                inputs[0].set_shared_memory("in_data", i0.nbytes)
                inputs[1].set_shared_memory("in_data", i1.nbytes, offset=i0.nbytes)
                outputs = [
                    httpclient.InferRequestedOutput("OUTPUT0"),
                    httpclient.InferRequestedOutput("OUTPUT1"),
                ]
                outputs[0].set_shared_memory("out_data", i0.nbytes)
                outputs[1].set_shared_memory("out_data", i1.nbytes, offset=i0.nbytes)
                client.infer("simple", inputs, outputs=outputs)
                got_sum = shm.get_contents_as_numpy(out_h, np.int32, [1, 16])
                got_diff = shm.get_contents_as_numpy(out_h, np.int32, [1, 16],
                                                     offset=i0.nbytes)
                np.testing.assert_array_equal(got_sum, i0 + i1)
                np.testing.assert_array_equal(got_diff, i0 - i1)
                client.unregister_system_shared_memory()
            print("PASS: http shm infer")
        finally:
            shm.destroy_shared_memory_region(in_h)
            shm.destroy_shared_memory_region(out_h)
    finally:
        if server:
            server.stop()


if __name__ == "__main__":
    main()
