"""The port's engine, end to end, at one checkout: for A/B runs on the card.

    python3 tools/engine_ab.py ROOT LABEL

ROOT is this checkout or another one unpacked inside it (for example the
parent commit's `git archive` under build/, which .gitignore lists).
Imports client_tpu_torch from ROOT (its own engine and kernels, built into
ROOT/build/) and measures it with THIS checkout's chip_smoke.py, so both
sides of an A/B are timed by one harness.  Prints one JSON line a
measurement, each tagged LABEL: the engine's aggregate tokens/s, TTFT and
host ms a decode tick (tick_trace) at 1, 4 and 8 concurrent greedy streams
of 128 tokens (bf16 and int8 weights, DEFAULT_LM_CONFIG, seed 0;
chip_smoke.engine_rate), and the device-busy share of a bf16 decode window
with its kernels a decode tick (chip_smoke.engine_profile).  Host-clock
figures vary between machines more than a kernel moves them, so compare
two checkouts only within one call on one card, in turns: parent, change,
change, parent.
"""

import importlib.util
import json
import os
import subprocess
import sys


def main():
    root, label = os.path.abspath(sys.argv[1]), sys.argv[2]
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from client_tpu_torch.ops import _build
    from client_tpu_torch.serve.lm import LmEngine
    from client_tpu_torch.serve.models import language
    from client_tpu_torch.serve.models import transformer as tfm

    if not torch.cuda.is_available():
        sys.exit("engine_ab: needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    _build.kernels()
    cfg = language.DEFAULT_LM_CONFIG
    prompt = language.encode_text(cs.PROMPT)
    pbf = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    p8 = tfm.quantize_params(pbf)
    tag = {"label": label, "root": root, "nvidia_smi": smi}
    for name, params in (("bfloat16", pbf), ("int8", p8)):
        for n in (1, 4, 8):
            print(json.dumps({"engine_rate": name, **tag, **cs.engine_rate(
                LmEngine, params, cfg, prompt, n)}), flush=True)
    prof = cs.engine_profile(LmEngine, pbf, cfg, prompt)
    prof.pop("top_kernels", None)
    print(json.dumps({"engine_profile": "bfloat16", **tag, **prof}),
          flush=True)


if __name__ == "__main__":
    main()
