#!/usr/bin/env python3
"""Run a program of examples/ with its POSIX shared-memory keys made its
own: each key it creates a system region under, and registers with a
server, gets ``_<pid>`` appended.

The reference's system-region examples create their regions under fixed
keys (``/input_simple``, ``/grpc_in_str``, ...), open with ``O_CREAT``
and unlink on exit, so two of them running at once on one host can
unlink each other's region between its create and the server's open.
Nothing else of the example changes: its options, its requests and its
output are the same.

    python3 tools/own_shm_keys.py examples/simple_grpc_shm_client.py -u localhost:8001
"""

import os
import runpy
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def own(key):
    """*key* made this process's own."""
    return f"{key}_{os.getpid()}"


def _own_registration(register):
    def register_own(self, name, key, *args, **kwargs):
        return register(self, name, own(key), *args, **kwargs)

    return register_own


def main():
    sys.path.insert(0, ROOT)
    import client_tpu.grpc
    import client_tpu.http
    from client_tpu.utils import shared_memory

    create = shared_memory.create_shared_memory_region

    def create_own(triton_shm_name, shm_key, *args, **kwargs):
        return create(triton_shm_name, own(shm_key), *args, **kwargs)

    shared_memory.create_shared_memory_region = create_own
    for client in (client_tpu.grpc.InferenceServerClient,
                   client_tpu.http.InferenceServerClient):
        client.register_system_shared_memory = _own_registration(
            client.register_system_shared_memory)
    example = sys.argv[1]
    sys.argv = sys.argv[1:]
    runpy.run_path(example, run_name="__main__")


if __name__ == "__main__":
    main()
