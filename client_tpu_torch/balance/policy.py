"""Load-balancing policies: which healthy replica gets the next request.

Counterpart of client_tpu/balance/policy.py.

One interface — ``pick(candidates, request_ctx)`` over the pool's eligible
:class:`~client_tpu_torch.balance.pool.Endpoint` objects — behind four shapes:

- **round-robin**: strict rotation; the right default when replicas are
  homogeneous and requests are similar-sized.
- **least-inflight**: route to the replica with the fewest outstanding
  requests; adapts to heterogeneous replicas and long-tailed request
  durations (a slow replica accumulates inflight and stops receiving).
- **power-of-two-choices**: sample two random replicas, take the less
  loaded (Mitzenmacher) — least-inflight's adaptivity without the
  herd-to-the-minimum behavior when many clients share stale load views.
- **weighted**: stationary weighted-random split, for canaries and
  capacity-skewed fleets.
- **sticky**: sequence-affine routing — every request of one sequence id
  lands on one replica (the server's ``SequenceContext`` state lives on
  exactly one replica); when that replica dies mid-sequence the policy
  remaps the sequence and surfaces :class:`SequenceRestartError` so the
  caller restarts the sequence instead of silently splitting its state
  across replicas.
- **prefix-aware**: cache-affinity routing for the fleet cache tier —
  route to the replica whose gossiped digest summary holds the request's
  LONGEST cached prefix (``request_ctx['prefix_digests']``, the
  cumulative block-chain digests of ``client_tpu_torch.serve.fleet.
  chain_digests``), multiplying the prefix cache's prefill savings by
  the fleet hit rate; ties and digest-less requests fall back to
  least-inflight, so stale gossip degrades to load balancing.

Policies are invoked with the pool lock held: they may keep unguarded
internal state (the round-robin cursor, the sticky sequence map), and
they must never block or call back into the pool.
"""

import collections
import random

from client_tpu_torch.utils import InferenceServerException

__all__ = [
    "Policy",
    "RoundRobin",
    "LeastInflight",
    "PowerOfTwoChoices",
    "Weighted",
    "Sticky",
    "PrefixAware",
    "SequenceRestartError",
    "make_policy",
]


class SequenceRestartError(InferenceServerException):
    """The replica holding this sequence's state is gone; the sequence was
    remapped to a fresh replica.

    Raised by the sticky policy instead of silently routing a mid-sequence
    request at a replica that never saw the sequence (which would fork its
    state).  The condition is *restartable*: the new mapping is already
    installed, so re-sending the sequence from its start
    (``sequence_start=True``) lands it whole on the new replica.  The
    status is 409 (conflict) — deliberately NOT in the retry layer's
    retryable set, because replaying only the failed request (what a retry
    would do) is exactly the state split this error exists to prevent.
    """

    def __init__(self, sequence_id, dead_endpoint, new_endpoint):
        super().__init__(
            msg=(
                f"sequence {sequence_id!r} was pinned to "
                f"{dead_endpoint!r}, which is no longer routable; remapped "
                f"to {new_endpoint!r} — restart the sequence "
                "(sequence_start=True) to rebuild its state there"
            ),
            status="409",
        )
        self.sequence_id = sequence_id
        self.dead_endpoint = dead_endpoint
        self.new_endpoint = new_endpoint


class Policy:
    """Picks one endpoint from the eligible candidates.

    ``candidates`` is a non-empty list of Endpoint objects (already
    filtered to routable ones); ``request_ctx`` is an optional dict of
    request attributes (``model_name``, ...) for content-aware policies.
    """

    name = "policy"

    def pick(self, candidates, request_ctx=None):
        raise NotImplementedError


class RoundRobin(Policy):
    name = "round-robin"

    def __init__(self):
        self._cursor = 0

    def pick(self, candidates, request_ctx=None):
        # The candidate set shrinks and grows as health changes; a plain
        # modular cursor still spreads load evenly within any stable set.
        self._cursor = (self._cursor + 1) % (1 << 30)
        return candidates[self._cursor % len(candidates)]


class LeastInflight(Policy):
    name = "least-inflight"

    def __init__(self):
        self._cursor = 0

    def pick(self, candidates, request_ctx=None):
        # rotate the tie-break start point so equal-load replicas share
        # work instead of the first one absorbing every burst
        self._cursor = (self._cursor + 1) % (1 << 30)
        n = len(candidates)
        best = None
        for i in range(n):
            candidate = candidates[(self._cursor + i) % n]
            if best is None or candidate.inflight < best.inflight:
                best = candidate
        return best


class PowerOfTwoChoices(Policy):
    name = "power-of-two"

    def __init__(self, rng=None):
        self._rng = rng or random.Random()

    def pick(self, candidates, request_ctx=None):
        if len(candidates) == 1:
            return candidates[0]
        a, b = self._rng.sample(candidates, 2)
        return a if a.inflight <= b.inflight else b


class Weighted(Policy):
    """Weighted-random split over ``Endpoint.weight`` (weight 0 removes an
    endpoint from this policy's rotation without marking it unhealthy —
    the canary-off switch)."""

    name = "weighted"

    def __init__(self, rng=None):
        self._rng = rng or random.Random()

    def pick(self, candidates, request_ctx=None):
        # the probation slow-start ramp is applied by the pool's candidate
        # thinning BEFORE any policy runs (one mechanism for every policy);
        # scaling weights here too would compound the penalty to ~f^2
        weights = [max(float(e.weight), 0.0) for e in candidates]
        total = sum(weights)
        if total <= 0:  # all zero-weight: fall back to uniform
            return self._rng.choice(candidates)
        x = self._rng.uniform(0.0, total)
        for endpoint, w in zip(candidates, weights):
            x -= w
            if x <= 0:
                return endpoint
        return candidates[-1]


class Sticky(Policy):
    """Sequence-affine routing over ``request_ctx['sequence_id']``.

    Requests without a sequence id fall through to *fallback* (so one
    pool serves mixed stateless + sequence traffic).  A sequence's first
    request (or any ``sequence_start``) maps it to a fallback-picked
    replica; later requests return the mapped replica as long as it is
    still a candidate.  When it is not — dead, drained, retired, or
    excluded after a failed attempt — the policy remaps the sequence to a
    fresh replica and raises :class:`SequenceRestartError` (see its
    docstring for the restart contract) — UNLESS the request context
    carries ``sequence_durable``: durable sequences replicate their
    server-side state through the fleet tier's sequence lane, the
    survivor rebuilds the context from a peer snapshot on first touch,
    and the remap is silent.  ``sequence_end`` drops the mapping; an LRU
    bound (*max_sequences*) keeps abandoned sequences from pinning the
    map forever.
    """

    name = "sticky"

    def __init__(self, fallback="round-robin", max_sequences=100000):
        self._fallback = make_policy(fallback)
        self._map = collections.OrderedDict()  # sequence_id -> endpoint url
        self._max_sequences = int(max_sequences)

    def sequences(self):
        """{sequence_id: url} snapshot (test/introspection hook)."""
        return dict(self._map)

    def _remember(self, seq_id, url):
        self._map[seq_id] = url
        self._map.move_to_end(seq_id)
        while len(self._map) > self._max_sequences:
            self._map.popitem(last=False)

    def pick(self, candidates, request_ctx=None):
        ctx = request_ctx or {}
        seq_id = ctx.get("sequence_id") or 0
        if not seq_id:
            return self._fallback.pick(candidates, request_ctx)
        url = self._map.get(seq_id)
        if url is not None:
            # honor the mapping whenever the pinned replica is routable —
            # including on sequence_start, so a restart after
            # SequenceRestartError lands on the remap the error installed
            for endpoint in candidates:
                if endpoint.url == url:
                    if ctx.get("sequence_end"):
                        self._map.pop(seq_id, None)
                    else:
                        self._map.move_to_end(seq_id)
                    return endpoint
        replacement = self._fallback.pick(candidates, request_ctx)
        if ctx.get("sequence_end"):  # one-shot / final step: nothing to pin
            self._map.pop(seq_id, None)
        else:
            self._remember(seq_id, replacement.url)
        if url is not None and not ctx.get("sequence_start"):
            if ctx.get("sequence_durable"):
                # durable sequences replicate their state through the
                # fleet tier (SequenceContext snapshots, see serve/fleet
                # "sequence lane"): the survivor rebuilds the sequence
                # from a peer snapshot on first touch, so the remap is
                # SILENT — the client never sees the replica die
                return replacement
            # the pinned replica is gone mid-sequence: the remap is
            # installed, but the caller must rebuild the state there
            raise SequenceRestartError(seq_id, url, replacement.url)
        return replacement


class PrefixAware(Policy):
    """Cache-affinity routing over ``request_ctx['prefix_digests']``.

    The context value is the request's cumulative block-chain digest
    list (``client_tpu_torch.serve.fleet.chain_digests``: ``digests[i]``
    identifies the first ``i + 1`` full token blocks).  Each candidate's
    ``Endpoint.summary`` is the digest set its replica gossiped —
    piggybacked on the pool's health probes
    (``EndpointPool.set_summary``).  The pick is the replica holding the
    request's LONGEST cached prefix: its trie (or fleet store) already
    has those blocks, so routing there turns per-replica prefill savings
    into fleet-level savings without any peer fetch at all.

    Degradation is deliberate: requests without digests, candidates
    without summaries (stale/never-gossiped), and ties all fall through
    to *fallback* (least-inflight by default) — affinity is a hint, load
    balance is the floor, and a wrong/stale summary can only cost the
    peer-fetch the fleet tier would have done anyway.
    """

    name = "prefix-aware"

    def __init__(self, fallback="least-inflight"):
        self._fallback = make_policy(fallback)

    @staticmethod
    def _depth(digests, summary):
        """Longest cached prefix: the deepest cumulative digest the
        summary holds (walked longest-first — chain digests compose, so
        holding digest i without i-1 only happens under store eviction,
        and then the deeper hit is still the better answer)."""
        for i in range(len(digests) - 1, -1, -1):
            if digests[i] in summary:
                return i + 1
        return 0

    def pick(self, candidates, request_ctx=None):
        ctx = request_ctx or {}
        digests = ctx.get("prefix_digests") or ()
        if not digests:
            return self._fallback.pick(candidates, request_ctx)
        best_depth = 0
        best = []
        for endpoint in candidates:
            summary = getattr(endpoint, "summary", None) or ()
            depth = self._depth(digests, summary)
            if depth > best_depth:
                best_depth, best = depth, [endpoint]
            elif depth == best_depth and best_depth > 0:
                best.append(endpoint)
        if not best:
            return self._fallback.pick(candidates, request_ctx)
        if len(best) == 1:
            return best[0]
        return self._fallback.pick(best, request_ctx)


_POLICIES = {
    RoundRobin.name: RoundRobin,
    LeastInflight.name: LeastInflight,
    PowerOfTwoChoices.name: PowerOfTwoChoices,
    Weighted.name: Weighted,
    Sticky.name: Sticky,
    PrefixAware.name: PrefixAware,
}


def make_policy(spec):
    """Policy instance from a name ('round-robin', 'least-inflight',
    'power-of-two', 'weighted', 'sticky') or an already-built Policy."""
    if isinstance(spec, Policy):
        return spec
    cls = _POLICIES.get(str(spec))
    if cls is None:
        raise InferenceServerException(
            f"unknown balancing policy '{spec}' "
            f"(choose from {sorted(_POLICIES)})"
        )
    return cls()
