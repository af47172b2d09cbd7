#!/usr/bin/env python3
"""Run chip_smoke.py's phase 19 alone on one CUDA card.

It builds the kernels from this checkout and calls
``chip_smoke.parallel_phase`` with phase 8's tokens: (a) on a one-rank
NCCL mesh, the ring_flash, MoE and GPipe train steps as CUDA graphs
against their eager steps, their times graphed and eager, and the NCCL
capture probe; (b) the two-rank gloo ring on the card.  It prints phase
19's lines and exits non-zero when a check fails.

    python3 tools/mesh_phase.py
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main():
    if not torch.cuda.is_available():
        chip_smoke.fail("phase 19 needs a CUDA device")
    from client_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    card = {"gpu": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    _build.kernels()
    chip_smoke.phase(2, "build", seconds=round(_build.build_seconds, 3),
                     **card)
    tokens = torch.from_numpy(np.random.default_rng(
        chip_smoke.TRAIN_SEED).integers(
            0, chip_smoke.FLAGSHIP["vocab_size"],
            (chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_SEQ + 1))).cuda()
    launches, rank_launches, seconds = chip_smoke.parallel_phase(card,
                                                                 tokens)
    print(smi, flush=True)
    chip_smoke.phase(19, "alone_done", launches=launches,
                     rank_launches=rank_launches, seconds=seconds, **card)


if __name__ == "__main__":
    try:
        main()
    finally:
        chip_smoke.stop_children()
