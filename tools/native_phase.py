#!/usr/bin/env python3
"""Run chip_smoke.py's phase 26a alone on one CUDA card.

It builds the kernels from this checkout, serves ResNet-50 (warmed up)
and the language set behind ``Server(http_port=0, grpc_port=0)`` as
phase 23 does, runs phase 22b's Python gRPC wire leg on ResNet-50 at 1
and 8 on that server (the figure 26a prints beside the native worker's),
then calls ``chip_smoke.native_leg``: the native worker built by g++
alone and its libraries, ``--native-loadgen`` from the wire and from
CUDA regions, and the worker's decoupled int8 LM streams with their
kernel launches.  It prints those lines and exits non-zero when a check
fails.

    python3 tools/native_phase.py
"""

import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main():
    if not torch.cuda.is_available():
        chip_smoke.fail("phase 26a needs a CUDA device")
    from client_tpu_torch.ops import _build
    from client_tpu_torch.serve import Server
    from client_tpu_torch.serve.models import language, vision

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
    models = ([vision.resnet50_model(warmup=True)]
              + language.language_models(device="cuda"))
    env = {**os.environ, "PYTHONPATH": ROOT}
    tmp = tempfile.mkdtemp(prefix="native_phase_")
    try:
        with Server(models=models, http_port=0, grpc_port=0,
                    with_default_models=False) as server:
            leg, doc, served, _, seconds = chip_smoke.perf_socket_leg(
                server, tmp, "grpc", "resnet50", "none", env=env, n=22)
            levels = chip_smoke.perf_levels(doc)
            chip_smoke.PYTHON_GRPC_AT_8.update(
                next(lv for lv in levels if lv["level"] == 8),
                leg="python -m client_tpu_torch.perf -i grpc from the wire "
                    "on this server (ResNet-50 and the language set), just "
                    "before, the metrics scrape and the probe on")
            chip_smoke.phase(22, "perf_grpc", leg=leg, levels=levels,
                             server_successes=served, seconds=seconds,
                             **card)
            t0 = time.monotonic()
            launches, routes = chip_smoke.native_leg(card, server, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(smi, flush=True)
    chip_smoke.phase(26, "alone_done", seconds=time.monotonic() - t0,
                     launches=launches, launches_by_route=routes, **card)


if __name__ == "__main__":
    try:
        main()
    finally:
        chip_smoke.stop_children()
