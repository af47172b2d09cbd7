#!/usr/bin/env python3
"""Time the engine of
tests/test_torch_engine_sched.py::test_spec_adversarial_drafter_backs_off_and_never_slower
in both packages, on the CPU.

The test's engine (``max_slots=1``, ``lane_counts=(1,)``, 8-token blocks,
16-token chunks) on tests/test_lm.py's float32 config and the JAX init's
weights: one warm submit, then a timed one, once plain and once with a
drafter that always proposes the wrong token (k = 4).  For each package
and run it prints one JSON line: the plain and speculative seconds,
their ratio (the test bounds it by 1/0.95 with 0.25 s of slack), the
drafts proposed, and from each engine's profiler the ticks by kind and
the seconds by phase over both submits.

    JAX_PLATFORMS=cpu python tools/spec_adversary_timing.py [runs]
"""

import dataclasses
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from client_tpu.serve.lm import LmEngine as JaxEngine  # noqa: E402
from client_tpu.serve.lm.spec import Drafter as JaxDrafter  # noqa: E402
from client_tpu.serve.models import transformer as jtfm  # noqa: E402
from client_tpu_torch import convert  # noqa: E402
from client_tpu_torch.serve.lm import LmEngine  # noqa: E402
from client_tpu_torch.serve.lm.spec import Drafter  # noqa: E402
from client_tpu_torch.serve.models import transformer as tfm  # noqa: E402

JCFG = jtfm.TransformerConfig(
    vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq=96, dtype="float32",
)
CFG = tfm.TransformerConfig(**dataclasses.asdict(JCFG))
ENGINE = dict(max_slots=1, lane_counts=(1,), block_size=8, prefill_chunk=16,
              min_bucket=4)
PROMPT = [1, 2, 3, 4]
N_TOK = 80


def adversary(base, full):
    """A drafter proposing, for every position, anything but the greedy
    token (the test's Adversary)."""

    class Adversary(base):
        name = "adversary"

        def propose(self, state, history, k):
            nxt = full[len(history)] if len(history) < len(full) else 0
            return [(nxt + 1) % CFG.vocab_size] * k

    return Adversary()


def collect(q, close):
    out = []
    while True:
        tok = q.get(timeout=120)
        if tok is close:
            return out
        out.append(tok)


def timed(make):
    """(seconds of the timed submit, its tokens, spec stats, ticks by
    kind, seconds by phase) of one engine after a warm submit."""
    eng = make()
    try:
        collect(eng.submit(PROMPT, N_TOK)[0], eng.CLOSE)
        t0 = time.perf_counter()
        got = collect(eng.submit(PROMPT, N_TOK)[0], eng.CLOSE)
        seconds = time.perf_counter() - t0
        rollup = eng.prof.report(window_s=0)["engines"][0]
        stats = eng.spec_stats()
    finally:
        eng.close()
    return (seconds, got, stats, rollup["kinds"],
            {k: v["s"] for k, v in rollup["phases"].items()})


def main():
    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    jparams = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    serial = list(tfm.generate(params, CFG, PROMPT, N_TOK, readback_depth=0))
    full = PROMPT + serial
    makers = {
        "port": lambda spec: lambda: LmEngine(
            params, CFG, device="cpu", speculative=spec, **ENGINE),
        "jax": lambda spec: lambda: JaxEngine(
            jparams, JCFG, speculative=spec, **ENGINE),
    }
    drafters = {"port": Drafter, "jax": JaxDrafter}
    for pkg, make in makers.items():
        ratios = []
        for run in range(runs):
            plain = timed(make(None))
            spec = timed(make({"k": 4,
                               "drafter": adversary(drafters[pkg], full)}))
            assert plain[1] == serial and spec[1] == serial, pkg
            ratios.append(spec[0] / plain[0])
            print(json.dumps({
                "package": pkg, "run": run, "plain_s": plain[0],
                "spec_s": spec[0], "ratio": ratios[-1],
                "bound_s": plain[0] / 0.95 + 0.25,
                "proposed": spec[2]["proposed"],
                "accepted": spec[2]["accepted"],
                "plain_kinds": plain[3], "spec_kinds": spec[3],
                "plain_phases_s": plain[4], "spec_phases_s": spec[4],
            }), flush=True)
        print(json.dumps({"package": pkg,
                          "median_ratio": statistics.median(ratios)}),
              flush=True)


if __name__ == "__main__":
    main()
