"""Continuous batching for decoupled LM token streaming — compat surface.

Counterpart of client_tpu/serve/models/continuous.py: the original names
and submit/cancel/stream surface over the continuous-batching engine of
``client_tpu_torch.serve.lm``.

- :class:`ContinuousLmScheduler` IS :class:`client_tpu_torch.serve.lm.LmEngine`
  (``submit(prompt, max_tokens) -> (queue, handle)``, ``cancel``,
  ``close``, the ``CLOSE`` sentinel);
- :class:`BatchedLmRunner` is the ``stream()`` provider
  lm_streaming_batched_model plugs into, with per-request temperature /
  top-k / seed and a ``tenant`` identity that feeds per-tenant decode-lane
  quotas.  Speculative decoding, prefix-cache adoption and lane
  autoscaling live below submit/cancel/stream.
"""

import numpy as np

from client_tpu_torch.serve.lm.engine import _CLOSE, _TOPK_CAP, LmEngine
from client_tpu_torch.utils import InferenceServerException

# the engine, under its historical serving-path name
ContinuousLmScheduler = LmEngine


class BatchedLmRunner:
    """Drop-in ``stream()`` provider backed by the continuous-batching
    engine — signature-compatible with language._LmRunner.stream so the
    batched model reuses lm_streaming_model verbatim.  Per-request
    sampling (temperature / top_k / seed) runs inside the tick with
    per-lane RNG state; temperature 0 lanes take the on-device argmax, so
    mixed greedy/sampled batches share one program."""

    def __init__(self, params, cfg, max_slots=4, eos_id=None,
                 check_prompt=None, **engine_kwargs):
        self.cfg = cfg
        self.scheduler = LmEngine(
            params, cfg, max_slots=max_slots, eos_id=eos_id,
            check_prompt=check_prompt, **engine_kwargs,
        )

    def stream(self, tokens, max_tokens, temperature=0.0, seed=0,
               top_k=0, tenant=""):
        if int(top_k) > _TOPK_CAP:
            # the tick's per-lane filter has a static width: a
            # silently-truncated k would sample a different distribution
            # than the client asked for
            raise InferenceServerException(
                f"top_k {int(top_k)} exceeds the engine's static cap of "
                f"{_TOPK_CAP}; use top_k <= {_TOPK_CAP} or 0 (unfiltered)",
                status="400",
            )
        if self.scheduler.check_prompt is not None:
            self.scheduler.check_prompt(
                int(np.asarray(tokens).reshape(-1).shape[0])
            )
        q, handle = self.scheduler.submit(
            tokens, max_tokens, temperature=temperature, top_k=top_k,
            seed=seed, tenant=tenant,
        )
        try:
            while True:
                tok = q.get()
                if tok is _CLOSE:
                    return
                yield tok
        finally:
            self.scheduler.cancel(handle)
