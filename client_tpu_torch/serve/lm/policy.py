"""Admission policy pieces: prompt-length bucketing and lane autoscaling.

The port's copy of client_tpu/serve/lm/policy.py (numpy only; the port
keeps its own copy under the same module path).  In the port the bucket
set bounds the distinct prefill shapes the engine dispatches, which the
CUDA-graph capture of a later step relies on.

Bucketing exists because ``jax.jit`` keys executables on shape: a prefill
invoked at every distinct prompt length compiles a fresh XLA program per
length (seconds each on a real chip), unbounded by anything but client
behavior.  Padding prompts to a small geometric set of widths makes the
executable count provably ``<= len(buckets)``; prompts longer than the
largest bucket run as a sequence of largest-bucket-wide chunks, so the
chunk width set IS the compiled-shape set.
"""

import numpy as np


def geometric_buckets(min_bucket, max_bucket, factor=2):
    """Geometric prefill-width set: ``min_bucket * factor^i`` capped at
    ``max_bucket`` (always included).  These are the ONLY shapes the
    prefill executable ever compiles for."""
    if min_bucket <= 0 or max_bucket <= 0:
        raise ValueError("buckets must be positive")
    min_bucket = min(min_bucket, max_bucket)
    buckets = []
    width = int(min_bucket)
    while width < max_bucket:
        buckets.append(width)
        width *= int(factor)
    buckets.append(int(max_bucket))
    return tuple(buckets)


def bucket_for(n, buckets):
    """Smallest bucket >= n, or the largest bucket (the chunk width) for
    prompts that span multiple chunks."""
    for width in buckets:
        if n <= width:
            return width
    return buckets[-1]


def pad_prompt(prompt, width, pad_id=0):
    """Right-pad a ``[1, T]`` int32 prompt to ``[1, width]``.  Padded
    positions are never written to the KV pool (the chunk kernel's write
    mask) and never attended (the causal/length mask), so the pad id is
    semantically inert — it only fixes the dispatch shape."""
    prompt = np.asarray(prompt, np.int32).reshape(1, -1)
    t = prompt.shape[1]
    if t > width:
        raise ValueError(f"prompt of {t} tokens exceeds pad width {width}")
    if t == width:
        return prompt
    out = np.full((1, width), int(pad_id), np.int32)
    out[0, :t] = prompt[0]
    return out


def chunk_plan(prompt_len, buckets, start=0):
    """The per-chunk (start, width) dispatch plan for one prompt.

    ``start`` > 0 skips positions already in the KV cache (prefix-cache
    adoption: the matched blocks' tokens need no recompute, so the plan
    covers only ``[start, prompt_len)``).  Remainders <= the largest
    bucket run as ONE chunk at ``bucket_for`` width; longer remainders
    run max-bucket-wide chunks back to back (the final chunk pads).
    Every width in the plan is a member of ``buckets`` — that is the
    bounded-compile invariant tests assert: adoption changes WHERE
    prefill starts, never which shapes compile.
    """
    start = int(start)
    if not 0 <= start < prompt_len:
        raise ValueError(f"chunk start {start} outside [0, {prompt_len})")
    chunk = buckets[-1]
    remaining = prompt_len - start
    if remaining <= chunk:
        return [(start, bucket_for(remaining, buckets))]
    return [(s, chunk) for s in range(start, prompt_len, chunk)]


def verify_widths(max_k, min_width=2):
    """The speculative verify tick's fixed window widths: geometric from
    ``min_width`` up to ``max_k + 1`` (k draft tokens + the pending input
    token).  Same bounded-compile discipline as prefill bucketing — a
    verify dispatch pads its draft count up to the next width, so the
    verify executable set is provably
    ``<= len(verify_widths(k)) * len(lane_counts)``."""
    if max_k < 1:
        raise ValueError("speculative k must be >= 1")
    return geometric_buckets(min(min_width, max_k + 1), max_k + 1)


class LaneAutoscaler:
    """Step the decode lane count through a small precompiled set.

    Scale-up: ``up_after`` consecutive scheduler passes with admissible
    pending work but no free lane.  Scale-down: ``down_after``
    consecutive passes where nothing is pending and every active lane
    fits in the next-smaller count (admission always fills the
    lowest-index free lane, so "fits" is just ``max active index``).
    Hysteresis on both sides keeps one bursty tenant from thrashing the
    executable set.
    """

    def __init__(self, lane_counts, up_after=3, down_after=50):
        counts = sorted(set(int(c) for c in lane_counts))
        if not counts or counts[0] < 1:
            raise ValueError("lane_counts must be positive")
        self.counts = tuple(counts)
        self.up_after = int(up_after)
        self.down_after = int(down_after)
        self._idx = 0
        self._starved = 0
        self._idle = 0

    @property
    def n_lanes(self):
        return self.counts[self._idx]

    def note_starved(self):
        """Pending work found no free lane this pass; maybe scale up."""
        self._idle = 0
        self._starved += 1
        if self._starved >= self.up_after and self._idx + 1 < len(self.counts):
            self._idx += 1
            self._starved = 0
            return True
        return False

    def note_ok(self, pending, max_active_index):
        """One pass with a free lane (or nothing pending); maybe scale
        down.  ``max_active_index`` is -1 when no lane is active."""
        self._starved = 0
        if self._idx == 0:
            self._idle = 0
            return False
        lower = self.counts[self._idx - 1]
        if pending or max_active_index >= lower:
            self._idle = 0
            return False
        self._idle += 1
        if self._idle >= self.down_after:
            self._idx -= 1
            self._idle = 0
            return True
        return False
