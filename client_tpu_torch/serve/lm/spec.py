"""Speculative decoding: model-free drafters + per-lane adaptive-k

The port's copy of client_tpu/serve/lm/spec.py (host logic only).  In
the port the verify and decode ticks are eager PyTorch programs rather
than XLA ones; the bf16 near-tie caveat below holds the same way.

control for the LM engine's draft/verify path.

Speculative decoding turns one decode tick into up to ``k + 1``
delivered tokens: a cheap host-side *drafter* proposes ``k``
continuation tokens, the engine scores all of them (plus the pending
input token) in ONE batched paged-attention pass (``engine._verify_tick``
— the multi-position generalization of ``_decode_tick``), and an
acceptance rule keeps the longest valid prefix:

- **greedy lanes** (temperature 0): a draft position is accepted iff it
  equals the argmax of the target logits there — the accepted prefix plus
  the argmax correction token reconstructs the plain-decode output
  byte-exactly, so speculation changes latency, never content.  One
  numerics caveat: the verify tick and the decode tick are different XLA
  programs (width ``w`` vs width 1), so their logits can differ by a few
  ulps of the compute dtype.  In float32 that never flips an argmax in
  practice; in bfloat16 a near-tie (top-2 margin at the ~1-ulp level,
  e.g. 1/64 at logit magnitude 2) can resolve differently — the output
  is still an exact greedy decode *of the verify pass's logits*, the
  same equivalence class every batched-verify implementation ships;
- **temperature lanes**: distribution-preserving rejection sampling for
  point-mass (deterministic) drafters — draft token ``x`` at a position
  with target probability ``p(x)`` (after the lane's top-k filter and
  temperature, exactly ``engine._select_token``'s distribution) is
  accepted with probability ``p(x)``; on rejection the correction token
  samples the residual (``p`` with ``x``'s mass removed, renormalized),
  which makes every delivered token an exact draw from the target
  distribution [Leviathan et al. 2023 / Chen et al. 2023, specialized to
  a deterministic proposal].

The drafters here need no second model (the interface is shaped so a
small draft model CAN plug in later via the device-placement layer):

- :class:`NgramDrafter` — prompt-lookup decoding: match the longest
  suffix (up to ``n`` tokens) of the generated history against the
  prompt + history and propose the continuation of the most recent
  prior occurrence.  Strong on the shared-prefix / extraction / code
  workloads where output echoes input.
- :class:`BigramDrafter` — a static greedy-bigram table seeded from the
  prompt at admission: propose by chaining each token's most frequent
  prompt successor.  Cheaper than n-gram search, weaker matches.

Adaptive k (:class:`LaneSpec`, one per active lane): a rolling
acceptance window shrinks ``k`` (halving; 1 -> 0 disables; a window
with ZERO accepts disables outright — the drafter has no signal, so
walking down just wastes verifies) when the drafter keeps missing, so
an adversarial prompt degrades to plain decode — the engine skips
drafting AND the verify dispatch entirely for disabled lanes, which is
the never-slower guarantee tests assert.  A
disabled lane re-probes with ``k = 1`` after ``retry_after`` plain
ticks (output statistics can drift into draftable territory), and a lane
whose window shows high acceptance grows ``k`` back toward the
configured maximum.
"""

import numpy as np

__all__ = [
    "Drafter",
    "NgramDrafter",
    "BigramDrafter",
    "make_drafter",
    "SpecConfig",
    "LaneSpec",
]


class Drafter:
    """Draft-token proposer interface (host-side, stateless across
    lanes: per-lane state lives in whatever ``begin`` returns).

    ``begin(prompt_row)`` runs once at lane activation and returns the
    drafter's per-lane state (any object; None is fine).  ``propose``
    is called on the scheduler thread with the CURRENT token history
    (prompt + every delivered token, as one int32 row — the last entry
    is the next tick's input token) and returns up to ``k`` proposed
    continuation tokens.  Returning ``[]`` means "no draft": the lane
    rides the pass as plain decode at zero extra cost.

    A model-backed drafter slots in here later: ``begin`` prefills the
    draft model, ``propose`` runs its (cheap) autoregressive loop.
    """

    name = "null"

    def begin(self, prompt_row):
        return None

    def propose(self, state, history, k):
        return []


class NgramDrafter(Drafter):
    """Prompt-lookup drafter: propose the continuation of the most
    recent prior occurrence of the history's longest matching suffix.

    For match lengths ``m = n .. 1``: find the latest position where the
    last ``m`` tokens of ``history`` previously occurred (vectorized
    sliding-window compare — the history is prompt + generation, a few
    hundred tokens, so this is microseconds) and propose the ``k``
    tokens that followed.  Longer matches are tried first: they predict
    the continuation far more reliably.
    """

    name = "ngram"

    def __init__(self, n=3, min_match=1):
        if n < 1:
            raise ValueError("ngram n must be >= 1")
        self.n = int(n)
        self.min_match = max(1, int(min_match))

    def propose(self, state, history, k):
        h = np.asarray(history, np.int32)
        t = h.shape[0]
        if k <= 0 or t < self.min_match + 1:
            return []
        for m in range(min(self.n, t - 1), self.min_match - 1, -1):
            pat = h[t - m:]
            # candidate starts 0 .. t-m-1: strictly before the suffix
            # itself, so a match always has at least one continuation
            # token
            wins = np.lib.stride_tricks.sliding_window_view(h, m)[:t - m]
            hits = np.nonzero((wins == pat).all(axis=1))[0]
            if hits.size:
                start = int(hits[-1]) + m  # most recent occurrence
                return h[start:start + k].tolist()
        return []


class BigramDrafter(Drafter):
    """Static greedy-bigram drafter: ``begin`` builds a token -> most
    frequent successor table from the prompt; ``propose`` chains it
    greedily from the last history token.  No per-token search at
    propose time — the cheapest possible drafter."""

    name = "bigram"

    def begin(self, prompt_row):
        row = np.asarray(prompt_row, np.int32)
        counts = {}
        for cur, nxt in zip(row[:-1].tolist(), row[1:].tolist()):
            slot = counts.setdefault(cur, {})
            slot[nxt] = slot.get(nxt, 0) + 1
        return {
            cur: max(succ.items(), key=lambda kv: (kv[1], -kv[0]))[0]
            for cur, succ in counts.items()
        }

    def propose(self, state, history, k):
        if not state or k <= 0 or len(history) == 0:
            return []
        out = []
        cur = int(history[-1])
        while len(out) < k:
            nxt = state.get(cur)
            if nxt is None:
                break
            out.append(nxt)
            cur = nxt
        return out


_DRAFTERS = {"ngram": NgramDrafter, "bigram": BigramDrafter}


def make_drafter(name, **kwargs):
    """Drafter registry lookup (``"ngram"`` / ``"bigram"``)."""
    try:
        cls = _DRAFTERS[str(name)]
    except KeyError:
        raise ValueError(
            f"unknown drafter {name!r} (have {sorted(_DRAFTERS)})"
        ) from None
    return cls(**kwargs)


class SpecConfig:
    """Parsed per-model speculative-decoding policy.

    Accepts the model-config block
    ``speculative={"k": 4, "drafter": "ngram", ...}`` (also a bare int
    as ``k``, or ``True`` for all defaults); ``drafter`` may be a
    registry name or a :class:`Drafter` instance (tests inject
    adversarial drafters that way).  Knobs:

    - ``k``: maximum draft tokens per verify tick (>= 1);
    - ``min_rate``: rolling acceptance rate below which a lane's k
      halves (1 -> 0 disables speculation for that lane);
    - ``grow_rate``: rate at or above which a backed-off lane's k
      doubles back toward ``k``;
    - ``window``: verify rounds per rolling-acceptance decision;
    - ``retry_after``: plain decode ticks a disabled lane waits before
      re-probing with k = 1.
    """

    __slots__ = ("k", "drafter", "min_rate", "grow_rate", "window",
                 "retry_after")

    def __init__(self, k=4, drafter="ngram", min_rate=0.35,
                 grow_rate=0.75, window=8, retry_after=128):
        self.k = int(k)
        if self.k < 1:
            raise ValueError("speculative k must be >= 1")
        self.drafter = (
            drafter if isinstance(drafter, Drafter)
            else make_drafter(drafter)
        )
        self.min_rate = float(min_rate)
        self.grow_rate = float(grow_rate)
        self.window = max(1, int(window))
        self.retry_after = max(1, int(retry_after))

    @classmethod
    def parse(cls, spec):
        """``None``/falsy -> None (speculation off); otherwise a
        SpecConfig from a config block / int / True / SpecConfig."""
        if not spec:
            return None
        if isinstance(spec, cls):
            return spec
        if spec is True:
            return cls()
        if isinstance(spec, (int, np.integer)):
            return cls(k=spec)
        if isinstance(spec, dict):
            extra = set(spec) - {
                "k", "drafter", "min_rate", "grow_rate", "window",
                "retry_after",
            }
            if extra:
                raise ValueError(
                    f"unknown speculative options: {sorted(extra)}"
                )
            return cls(**spec)
        raise TypeError(f"bad speculative config: {spec!r}")


class LaneSpec:
    """One lane's speculative state: drafter state + the adaptive-k
    controller.  Owned by the engine's scheduler thread; created at
    lane activation, dropped at retire (a resumed/preempted stream
    rebuilds it from the prompt — the rolling window restarts, which
    only delays re-disabling by one window)."""

    __slots__ = ("cfg", "state", "k", "_prop", "_acc", "_rounds",
                 "_idle")

    def __init__(self, cfg, prompt_row):
        self.cfg = cfg
        self.state = cfg.drafter.begin(prompt_row)
        self.k = cfg.k
        self._prop = 0
        self._acc = 0
        self._rounds = 0
        self._idle = 0  # plain ticks while disabled (re-probe timer)

    def draft(self, history):
        """Up to ``self.k`` proposed tokens ([] when disabled or the
        drafter has nothing)."""
        if self.k <= 0:
            return []
        toks = self.cfg.drafter.propose(self.state, history, self.k)
        return [int(t) for t in toks[:self.k]]

    def note_plain(self):
        """One plain decode tick ran for this lane; a disabled lane
        re-probes with k = 1 after ``retry_after`` of these."""
        if self.k > 0:
            return
        self._idle += 1
        if self._idle >= self.cfg.retry_after:
            self.k = 1
            self._idle = 0
            self._prop = self._acc = self._rounds = 0

    def note(self, proposed, accepted):
        """One verify round's outcome; steps k on a full window."""
        if proposed <= 0:
            return
        self._prop += int(proposed)
        self._acc += int(accepted)
        self._rounds += 1
        if self._rounds < self.cfg.window:
            return
        rate = self._acc / max(self._prop, 1)
        if self._acc == 0:
            # a FULLY rejected window is qualitatively different from a
            # low rate: the drafter has no signal at all here, so walking
            # k down (3 windows of wasted verifies) buys nothing — drop
            # straight to disabled and let the re-probe timer recover.
            # Healthy workloads never hit this (measured zero-accept
            # streaks top out well under a window), low-but-nonzero ones
            # take the gentle halving path below.
            self.k = 0
            self._idle = 0
        elif rate < self.cfg.min_rate:
            self.k //= 2  # 1 -> 0 disables; note_plain re-probes later
            self._idle = 0
        elif rate >= self.cfg.grow_rate and self.k < self.cfg.k:
            self.k = min(self.cfg.k, self.k * 2)
        self._prop = self._acc = 0
        self._rounds = 0
