"""The JAX package's own LmEngine against its serial generate, in bf16.

    JAX_PLATFORMS=cpu python tools/jax_engine_vs_generate.py

Runs the reference engine (client_tpu.serve.lm.LmEngine, 8 slots, 16-token
blocks, 64-token prefill chunks) on the 16 concurrent greedy requests that
chip_smoke.py's phase 11 gives the port's engine (chip_smoke.engine_prompts)
at DEFAULT_LM_CONFIG in bf16, with weights from
jax.random.PRNGKey(0), and each prompt through serial generate
(readback_depth=0).  Prints one JSON line: how many streams are equal and,
for each divergent one, the first divergent position, the serial logits'
gap between the two tokens there and the serial top-2 gap.  This tells
whether a bf16 engine diverging from serial generate at near-ties is the
reference's own behaviour or the port's.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from chip_smoke import engine_prompts  # noqa: E402
from client_tpu.serve.lm.engine import LmEngine  # noqa: E402
from client_tpu.serve.models import transformer as tfm  # noqa: E402
from client_tpu.serve.models.language import DEFAULT_LM_CONFIG  # noqa: E402


def collect(q):
    out = []
    while (tok := q.get(timeout=1800)) is not LmEngine.CLOSE:
        out.append(int(tok))
    return out


def main():
    cfg = DEFAULT_LM_CONFIG
    params = tfm.init_params(jax.random.PRNGKey(0), cfg)
    prompts, lengths = engine_prompts()
    eng = LmEngine(params, cfg, max_slots=8, block_size=16, prefill_chunk=64)
    try:
        qs = [eng.submit(p, n)[0] for p, n in zip(prompts, lengths)]
        got = [collect(q) for q in qs]
    finally:
        eng.close()
    report = []
    for p, n, g in zip(prompts, lengths, got):
        want = [int(t) for t in tfm.generate(params, cfg, np.array(p), n,
                                             readback_depth=0)]
        if g == want:
            report.append({"prompt_tokens": len(p), "equal": True})
            continue
        i = next(j for j, (a, b) in enumerate(zip(g, want)) if a != b)
        seq = jnp.asarray([list(p) + want[:i]], jnp.int32)
        logits = np.asarray(tfm.forward(params, seq, cfg)[0, -1],
                            np.float32)
        top2 = np.sort(logits)[-2:]
        report.append({"prompt_tokens": len(p), "equal": False,
                       "first_divergence": i,
                       "gap": float(logits[want[i]] - logits[g[i]]),
                       "top2_gap": float(top2[1] - top2[0])})
    print(json.dumps({
        "config": "DEFAULT_LM_CONFIG bf16", "weights": "PRNGKey(0)",
        "streams": len(report),
        "equal_streams": sum(r["equal"] for r in report),
        "divergent": [r for r in report if not r["equal"]]}))


if __name__ == "__main__":
    main()
