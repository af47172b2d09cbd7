#!/usr/bin/env python3
"""Run chip_smoke.py's phase 27 alone on one CUDA card.

It builds the kernels from this checkout, serves the language set
behind ``Server(http_port=0, grpc_port=0)`` as phase 23 does (the int8
engine captures its graphs at its first stream), and calls
``chip_smoke.chaos_phase``: the spec-cancel-preempt round under the
port's three witnesses in float32 and int8, gRPC streams behind the
port's FaultProxy, and profview.  It prints phase 27's lines and exits
non-zero when a check fails.

    python3 tools/chaos_phase.py
"""

import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main():
    if not torch.cuda.is_available():
        chip_smoke.fail("phase 27 needs a CUDA device")
    from client_tpu_torch.ops import _build
    from client_tpu_torch.serve import Server
    from client_tpu_torch.serve.models import language

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
    models = language.language_models(device="cuda")
    engines = {m.name: m.closer.__self__ for m in models
               if m.closer is not None and m.name.startswith("lm_")}
    tmp = tempfile.mkdtemp(prefix="chaos_phase_")
    try:
        with Server(models=models, http_port=0, grpc_port=0,
                    with_default_models=False) as server:
            launches, routes = chip_smoke.chaos_phase(card, server, engines,
                                                      tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(smi, flush=True)
    chip_smoke.phase(27, "alone_done", launches=launches,
                     launches_by_route=routes, **card)


if __name__ == "__main__":
    main()
