"""Continuous-batching LM serving subsystem.

The port's counterpart of client_tpu/serve/lm, with the same exports; see
client_tpu_torch/serve/lm/engine.py for what differs in the port.

The production-grade successor of the fixed-lane prototype that used to
live inside ``serve/models/continuous.py`` (which now re-exports this
package's engine under its old names).  Four pillars:

- **prompt-length bucketing** (:mod:`.policy`) — prompts pad to a small
  geometric set of prefill widths so the dispatched prefill shape count
  is bounded by ``len(buckets)`` instead of growing with every novel
  prompt length;
- **chunked prefill** (:class:`.engine.LmEngine`) — prefill dispatches in
  fixed-width chunks interleaved 1:1 with decode ticks, so one novel
  long prompt can no longer freeze every active token stream for the
  length of its prefill;
- **paged KV cache** (:mod:`.kv`) — a block-table KV pool with
  fixed-size blocks and static shapes; HBM is pooled across lanes and
  requests reserve only the blocks their own ``prompt + max_tokens``
  needs, instead of every lane pinning ``max_seq`` rows forever;
- **lane autoscaling + per-tenant lane quotas** — the engine steps
  between a small fixed set of decode lane counts on sustained
  queue depth, and admission is tenant-aware so one tenant cannot occupy
  every decode lane while another waits;
- **prefix cache** (:mod:`.prefix`) — a radix trie over token-block
  chains adopts cached full prompt-prefix blocks BY REFERENCE at
  admission (per-block refcounts in :mod:`.kv`), so chunked prefill
  starts at the first non-cached block; retiring requests hand their
  prompt blocks to the cache (LRU, evicted only under pool pressure);
- **preemption / swap** (:class:`.engine.LmEngine`) — under pool
  exhaustion with a strictly higher-priority tenant waiting, the
  lowest-priority lane swaps its KV to a bounded host-side store (or
  drops it for recompute), its stream pausing — not erroring — until
  blocks free up, byte-exact with an unpreempted run on the swap path.

Per-lane sampling (temperature / top-k via per-lane RNG state inside the
tick) removes the old "greedy only" limitation.
"""

from client_tpu_torch.serve.lm.engine import LmEngine
from client_tpu_torch.serve.lm.kv import KvBlockPool
from client_tpu_torch.serve.lm.policy import (
    LaneAutoscaler,
    bucket_for,
    geometric_buckets,
    pad_prompt,
)
from client_tpu_torch.serve.lm.prefix import PrefixCache

__all__ = [
    "LmEngine",
    "KvBlockPool",
    "LaneAutoscaler",
    "PrefixCache",
    "bucket_for",
    "geometric_buckets",
    "pad_prompt",
]
