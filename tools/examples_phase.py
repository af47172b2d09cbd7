#!/usr/bin/env python3
"""Run chip_smoke.py's phase 29 alone on one CUDA card.

It builds the kernels and the CUDA shared-memory extension from this
checkout (the extension in a process of its own, beside the kernels, as
phase 2 does), then calls ``chip_smoke.examples_phase``: the port's
examples against one server in this process (the language set,
ResNet-50 and the builtin set), the CUDA-region examples with the
server's copies and regions, the C++ HTTP clients and the C++ gRPC
examples built with g++ alone, and the C++ CUDA-region example over
libccudashm with the ABI's check against the Python module.  It prints
those lines and exits non-zero when a check fails.

    python3 tools/examples_phase.py
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main():
    if not torch.cuda.is_available():
        chip_smoke.fail("phase 29 needs a CUDA device")
    from client_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    card = {"gpu": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    shm_build = chip_smoke.popen(
        [sys.executable, "-c",
         "from client_tpu_torch.utils.cuda_shared_memory import _build\n"
         "_build.extension()"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": ROOT})
    _build.kernels()
    _, err = shm_build.communicate(timeout=900)
    chip_smoke.check(shm_build.returncode == 0,
                     f"the shared-memory extension did not build: "
                     f"{err[-3000:]}")
    chip_smoke.phase(2, "build", seconds=round(_build.build_seconds, 3),
                     **card)
    launches, seconds = chip_smoke.examples_phase(card)
    print(smi, flush=True)
    chip_smoke.phase(29, "alone_done", seconds=seconds, launches=launches,
                     **card)


if __name__ == "__main__":
    try:
        main()
    finally:
        chip_smoke.stop_children()
