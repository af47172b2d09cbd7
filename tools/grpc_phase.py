#!/usr/bin/env python3
"""Run chip_smoke.py's phase 21 alone on one CUDA card.

It builds the kernels from this checkout and calls
``chip_smoke.grpc_phase``: the language set behind
``Server(grpc_port=0)``, driven through the port's gRPC client, with
RUNS streams the client stops after GRPC_STOP_AFTER tokens (the whole
script stops one).  Each stop's tokens are split at the client's
cancel, the server's notice of it and the engine handle's cancel, with
the delivery of the last token read timed (``chip_smoke.StopSplit``),
and printed on the ``grpc_stops`` line before any stop is checked
against its bound.  It prints phase 21's lines and exits non-zero when
a check fails.

    python3 tools/grpc_phase.py [RUNS] [--windows W,W,...]

RUNS (default ``chip_smoke.GRPC_STOP_RUNS``, 20) sets how many streams
are stopped.  ``--windows`` takes the stops in turns at each served
stream window (``BatchedLmRunner.stream_window``; 0 streams every token
at once), so two settings meet the same stretch of the host's load: the
``grpc_stops`` line gives each window's stops within the bound.
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
        chip_smoke.fail("phase 21 needs a CUDA device")
    args = sys.argv[1:]
    windows = (None,)
    if "--windows" in args:
        i = args.index("--windows")
        windows = tuple(int(w) for w in args[i + 1].split(","))
        del args[i:i + 2]
    runs = int(args[0]) if args else chip_smoke.GRPC_STOP_RUNS
    from client_tpu_torch.ops import _build
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
    launches, routes = chip_smoke.grpc_phase(
        card, language.encode_text(chip_smoke.PROMPT), stop_count=runs,
        windows=windows)
    print(smi, flush=True)
    chip_smoke.phase(21, "alone_done", launches=launches,
                     launches_by_route=routes, **card)


if __name__ == "__main__":
    try:
        main()
    finally:
        chip_smoke.stop_children()
