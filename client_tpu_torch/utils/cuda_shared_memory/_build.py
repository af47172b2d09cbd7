"""Build and load the CUDA shared-memory extension at first use.

``cudashm.cpp`` (host C++ over cudart, bound with pybind11) compiles with
``torch.utils.cpp_extension.load`` into ``build/client_tpu_torch_cudashm/``
beside the package, apart from the kernels' build (``ops/_build.py``).
Nothing is built at import time: the CPU never builds it.  A server that
hands regions to a client process builds it first, so two processes never
wait on one build's lock.
"""

import os
import threading
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))
BUILD_DIR = os.path.join(_ROOT, "build", "client_tpu_torch_cudashm")
SOURCES = [os.path.join(_HERE, "cudashm.cpp")]

_lock = threading.Lock()
_ext = None
build_seconds = None  # wall time of this process's build, once built


def extension():
    """The compiled extension module (builds it on the first call)."""
    global _ext, build_seconds
    with _lock:
        if _ext is None:
            from torch.utils.cpp_extension import load

            # load() does not create the directory and fails on its lock
            # file without it
            os.makedirs(BUILD_DIR, exist_ok=True)
            t0 = time.monotonic()
            _ext = load(
                name="client_tpu_torch_cudashm",
                sources=SOURCES,
                build_directory=BUILD_DIR,
                extra_cflags=["-O2", "-std=c++17"],
                with_cuda=True,
            )
            build_seconds = time.monotonic() - t0
        return _ext
