#!/usr/bin/env python3
"""Run chip_smoke.py's CUDA-graph legs of phases 6, 8-9 and 16 alone on
one CUDA card.

It builds the kernels from this checkout and calls chip_smoke's own
functions, the same ones ``main()`` calls: ``serial_legs`` (serial
``generate`` through its CUDA graphs and through the eager loop, int8,
bf16 and float32 at ``DEFAULT_LM_CONFIG``, each graph stream checked
equal to its eager stream) and ``serial_beside_batched`` (serial requests
at a mix of prompt lengths beside live batched streams); then
``train_graph_pair`` and ``f32_graph_pair`` (the flagship's flash train
step as one CUDA graph against the eager step from the same weights),
``checkpoint_round_trip`` (resumed in place and into fresh objects) and
``train_step_turns`` (eager and graphed step times, both profiled); and
``moe_train_graph``.  It prints phase-style JSON lines and exits non-zero
when a check fails.

    python3 tools/graph_legs.py [serial] [train] [moe]

With no argument it runs all three.
"""

import dataclasses
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def serial(tfm, language, card):
    from client_tpu_torch.serve.lm import LmEngine

    cfg = language.DEFAULT_LM_CONFIG
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    init = lambda c, device: tfm.init_params(  # noqa: E731
        torch.Generator().manual_seed(0), c, device)
    p8 = cs.tree_to(tfm.quantize_params(init(cfg, "cpu")), "cuda")
    bf16 = init(cfg, "cuda")
    prompt = language.encode_text(cs.PROMPT)
    out = cs.serial_legs(tfm, prompt, card, (
        ("lm_streaming_int8", p8, cfg),
        ("lm_streaming", bf16, cfg),
        ("lm_streaming_f32", init(cfg32, "cuda"), cfg32)))
    cs.phase(6, "serial_graph_launches", **out)
    cs.serial_beside_batched(tfm, language, LmEngine, bf16, cfg, prompt,
                             card)


def train(tfm, card):
    from client_tpu_torch.train import CheckpointManager

    tcfg = tfm.TransformerConfig(**cs.FLAGSHIP)
    tokens = torch.from_numpy(np.random.default_rng(cs.TRAIN_SEED).integers(
        0, tcfg.vocab_size, (cs.TRAIN_BATCH, cs.TRAIN_SEQ + 1))).cuda()
    cfg32 = dataclasses.replace(tcfg, n_layers=2, dtype="float32")
    cs.phase(8, "train_graph", config=cs.FLAGSHIP,
             **cs.train_graph_pair(tfm, tcfg, tokens, "bf16 flash training"),
             float32_2layer=cs.f32_graph_pair(tfm, cfg32, tokens),
             resumed_step_loss=cs.checkpoint_round_trip(
                 tfm, CheckpointManager, tcfg, tokens), **card)
    cs.train_step_turns(tfm, tcfg, tokens, card)


def moe(tfm, card):
    cs.moe_train_graph(tfm, tfm.TransformerConfig(**cs.MOE),
                       cs.moe_tokens(cs.TRAIN_SEED), card)


def main():
    if not torch.cuda.is_available():
        cs.fail("the graph legs need a CUDA device")
    what = sys.argv[1:] or ["serial", "train", "moe"]
    from client_tpu_torch.ops import _build
    from client_tpu_torch.serve.models import language
    from client_tpu_torch.serve.models import transformer as tfm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    card = {"gpu": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    t0 = time.monotonic()
    _build.kernels()
    cs.phase(2, "build", seconds=round(_build.build_seconds, 3), **card)
    if "serial" in what:
        serial(tfm, language, card)
    if "train" in what:
        train(tfm, card)
    if "moe" in what:
        moe(tfm, card)
    cs.phase(0, "graph_legs_done", seconds=time.monotonic() - t0, **card)


if __name__ == "__main__":
    main()
