"""Build and load the package's CUDA kernels at first use.

The sources under ``csrc/`` compile for ``sm_90a`` with
``torch.utils.cpp_extension.load`` into ``build/client_tpu_torch_kernels/``
beside the package; ``flash_bf16.cuh``, which the two bf16 flash sources
include, is tracked by ninja's dependency files.  Nothing is built at
import time: the CPU never builds, and a CUDA caller builds once per
process (``load`` reuses an up-to-date build directory).
"""

import os
import threading
import time

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_CSRC)))
BUILD_DIR = os.path.join(_ROOT, "build", "client_tpu_torch_kernels")
SOURCES = [
    os.path.join(_CSRC, "int8_matmul.cu"),
    os.path.join(_CSRC, "flash_attention.cu"),
    os.path.join(_CSRC, "flash_fwd_bf16.cu"),
    os.path.join(_CSRC, "flash_bwd_bf16.cu"),
    os.path.join(_CSRC, "paged_attention.cu"),
    os.path.join(_CSRC, "binding.cpp"),
]
CUDA_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_ext = None
build_seconds = None  # wall time of this process's build, once built


def kernels():
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
                name="client_tpu_torch_kernels",
                sources=SOURCES,
                build_directory=BUILD_DIR,
                extra_cflags=["-O3", "-std=c++17"],
                extra_cuda_cflags=CUDA_FLAGS,
            )
            build_seconds = time.monotonic() - t0
        return _ext
