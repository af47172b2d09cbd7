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
``train_step_turns`` (eager and graphed step times, both profiled);
``moe_train_graph``; and phase 13's ``vision_pipeline_run`` (the vision
pipeline's step programs at 224 against their eager functions, timed,
then the ensemble).  It prints phase-style JSON lines and exits non-zero
when a check fails.

    python3 tools/graph_legs.py [serial] [train] [moe] [vision] [split]

With no argument it runs the first four.  ``vision`` alone builds no
kernel (the pipeline launches none).  ``split`` splits a serial prefill
capture beside live batched streams (``split``, below).
"""

import dataclasses
import gc
import os
import subprocess
import sys
import threading
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


def vision(card):
    from client_tpu_torch.serve.model_runtime import InferenceEngine
    from client_tpu_torch.serve.models import pipeline_models

    cs.phase(13, "vision_pipeline", **cs.vision_pipeline_run(
        pipeline_models, InferenceEngine, card))


SPLIT_ROUNDS = 8
SPLIT_VARIANTS = ("graph_ctx", "routine", "eager")


class _Steps:
    """Host intervals of wrapped calls made on the thread that made the
    object: [(name, start, end)]."""

    def __init__(self):
        self.steps, self._thread = [], threading.get_ident()

    def wrap(self, name, fn):
        def timed(*args, **kw):
            if threading.get_ident() != self._thread:
                return fn(*args, **kw)
            t0 = time.monotonic()
            try:
                return fn(*args, **kw)
            finally:
                self.steps.append((name, t0, time.monotonic()))
        return timed


def split_capture(progs, params, length, variant):
    """One prefill at ``length`` on ``progs``' buffers, its steps timed:
    ``graph_ctx`` warms up on the side stream, then captures through
    ``torch.cuda.graph``'s own context with its set-up calls
    (``torch.cuda.synchronize``, ``gc.collect``, ``torch.cuda.empty_cache``,
    ``torch._C._host_emptyCache``) timed in place; ``routine`` captures
    through ``ops.capture_graph``; ``eager`` runs the prefill on the main
    stream.  An interval of ``graph_context`` or ``capture_graph`` holds
    the steps inside it (``body``, the set-up calls, ``warm_up``).  The
    graphs are dropped.  Returns [(step, start, end)]."""
    from client_tpu_torch import ops
    from client_tpu_torch.serve.models import programs

    buf = torch.zeros((1, length), dtype=torch.int32, device="cuda")
    scratch = programs._scratch(progs.cache)
    out = torch.empty_like(progs.logits)
    t = _Steps()
    warm_up = t.wrap("warm_up", lambda: progs._prefill_body(
        params, buf, scratch, out))
    body = t.wrap("body", lambda: progs._prefill_body(
        params, buf, progs.cache, progs.logits))
    pool, stream = progs._pool, progs._stream
    if variant == "eager":
        body()
    elif variant == "routine":
        t.wrap("capture_graph", ops.capture_graph)(body, warm_up, pool,
                                                   stream)
    else:
        main = torch.cuda.current_stream()
        stream.wait_stream(main)
        with torch.cuda.stream(stream), ops.recording():
            warm_up()
        calls = ((torch.cuda, "synchronize"), (gc, "collect"),
                 (torch.cuda, "empty_cache"), (torch._C, "_host_emptyCache"))
        real = [getattr(owner, name, None) for owner, name in calls]
        graph = torch.cuda.CUDAGraph()

        def context():
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                body()

        try:
            for (owner, name), fn in zip(calls, real):
                if fn is not None:
                    setattr(owner, name, t.wrap(name, fn))
            with ops.CAPTURE_LOCK, ops.recording(stream):
                t.wrap("graph_context", context)()
        finally:
            for (owner, name), fn in zip(calls, real):
                if fn is not None:
                    setattr(owner, name, fn)
        main.wait_stream(stream)
    t.wrap("logits_read", lambda: progs.logits.argmax(-1).item())()
    return t.steps


def split(tfm, language, card, rounds=SPLIT_ROUNDS):
    """A serial prefill capture split into its steps beside
    ``cs.SERIAL_MIX_STREAMS`` greedy streams kept in flight on an
    ``LmEngine`` (bf16, ``DEFAULT_LM_CONFIG``): ``rounds`` rounds of the
    three ``split_capture`` variants in turn, at lengths near the mix's
    median that the set does not hold.  Prints each step's host ms and
    the widest gap between a batched stream's tokens that overlaps it,
    and the garbage collections inside each variant, as medians and
    maxima over the rounds."""
    from client_tpu_torch.serve.lm import LmEngine
    from client_tpu_torch.serve.models import programs

    cfg = language.DEFAULT_LM_CONFIG
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    eng = LmEngine(params, cfg, device="cuda", **cs.ENGINE_KW)
    prompt = language.encode_text(cs.PROMPT)
    stamps, errors, collections = [], [], []
    stop, lock = threading.Event(), threading.Lock()

    def batched(p):
        try:
            while not stop.is_set():
                q, _ = eng.submit(p, cs.ENGINE_TOKENS)
                last = None
                while q.get(timeout=300) is not LmEngine.CLOSE:
                    now = time.monotonic()
                    if last is not None:
                        with lock:
                            stamps.append((last, now))
                    last = now
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    def widest(t0, t1):
        with lock:
            return max([(b - a) * 1e3 for a, b in stamps
                        if a < t1 and b > t0], default=0.0)

    started = [0.0]  # the open collection's start

    def on_gc(what, info):
        if what == "start":
            started[0] = time.monotonic()
        else:
            collections.append((started[0], time.monotonic(),
                                info["generation"]))

    q, _ = eng.submit(prompt, 8)  # the engine captures its programs
    while q.get(timeout=300) is not LmEngine.CLOSE:
        pass
    lengths = iter(range(cs.SERIAL_MIX_MEDIAN - 16,
                         cs.SERIAL_MIX_MEDIAN - 16 + 3 * rounds))
    threads = [threading.Thread(target=batched, args=(p,), daemon=True)
               for p in cs.distinct_prompts(prompt, cs.SERIAL_MIX_STREAMS)]
    rows = {v: [] for v in SPLIT_VARIANTS}
    pool = programs.serial_pool(params, cfg)
    gc.callbacks.append(on_gc)
    try:
        with pool.acquire(params, 1) as progs:
            for th in threads:
                th.start()
            time.sleep(0.5)
            t0 = time.monotonic()
            time.sleep(cs.SERIAL_MIX_ALONE_S)
            alone = widest(t0, time.monotonic())
            for _ in range(rounds):
                for variant in SPLIT_VARIANTS:
                    steps = split_capture(progs, params, next(lengths),
                                          variant)
                    time.sleep(0.05)  # the stamps after the last step
                    a, b = steps[0][1], max(end for *_, end in steps)
                    gcs = [(x, y, g) for x, y, g in list(collections)
                           if a <= x < b]
                    row = {"total": ((b - a) * 1e3, widest(a, b)),
                           "gc_ms": sum(y - x for x, y, _ in gcs) * 1e3,
                           "gc_full": sum(g == 2 for *_, g in gcs)}
                    for name, x, y in steps:
                        row[name] = ((y - x) * 1e3, widest(x, y))
                    rows[variant].append(row)
                    time.sleep(0.1)  # the streams settle between variants
    finally:
        gc.callbacks.remove(on_gc)
        stop.set()
        for th in threads:
            th.join(timeout=120)
        eng.close()
    cs.check(not errors, f"batched streams: {errors}")
    for variant, got in rows.items():
        summary = {}
        for key, first in got[0].items():
            vals = [r[key] for r in got]
            if isinstance(first, tuple):
                ms, gap = [v[0] for v in vals], [v[1] for v in vals]
                summary[key] = {"ms_p50": float(np.median(ms)),
                                "ms_max": max(ms),
                                "widest_gap_ms_p50": float(np.median(gap)),
                                "widest_gap_ms_max": max(gap)}
            else:
                summary[key] = {"p50": float(np.median(vals)),
                                "max": max(vals)}
        cs.phase(6, "capture_split", variant=variant, rounds=len(got),
                 torch=torch.__version__, batched_alone_widest_gap_ms=alone,
                 force_cudagraph_gc=bool(
                     torch.compiler.config.force_cudagraph_gc),
                 **summary, **card)


def main():
    if not torch.cuda.is_available():
        cs.fail("the graph legs need a CUDA device")
    what = sys.argv[1:] or ["serial", "train", "moe", "vision"]
    cs.check(not set(what) - {"serial", "train", "moe", "vision", "split"},
             f"unknown legs {what}")
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
    if set(what) - {"vision"}:
        _build.kernels()
        cs.phase(2, "build", seconds=round(_build.build_seconds, 3), **card)
    if "serial" in what:
        serial(tfm, language, card)
    if "train" in what:
        train(tfm, card)
    if "moe" in what:
        moe(tfm, card)
    if "vision" in what:
        vision(card)
    if "split" in what:
        split(tfm, language, card)
    cs.phase(0, "graph_legs_done", seconds=time.monotonic() - t0, **card)


if __name__ == "__main__":
    main()
