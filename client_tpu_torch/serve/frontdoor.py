"""Multi-tenant front door: response cache, request coalescing, tenant QoS.

Counterpart of client_tpu/serve/frontdoor.py, with the fleet tier's
hooks: ``ResponseCache.peek``/``keys`` (a peer's read and the gossip
summary) and ``TenantQoS.delta_counts``/``absorb_remote`` (fleet-wide
quota accounting).

"Millions of users" traffic is not uniform — it has hot keys (the same
request sent by thousands of clients at once) and unfair tenants (one
integration bug floods the fleet).  The engine-level shedding from the
resilience layer treats all of that as one FIFO, which degrades every
user equally; this module is the part that degrades *selectively*:

- :class:`ResponseCache` — a content-addressed inference response cache
  (exact match on model + version + input digest; the server-side analog
  of the reference ModelParser's ``response cache`` flag, whose hit/miss
  durations surface in perf stats).  Bounded LRU with optional TTL;
  hit/miss/eviction/bytes metrics.
- :class:`Coalescer` — in-flight request coalescing: N identical
  concurrent requests collapse to ONE model dispatch whose result fans
  out to all N waiters.  A hot-key storm costs one device dispatch
  instead of N.
- :class:`TenantQoS` — per-tenant admission control layered on the
  engine's global shedding: priority-class weights (consumed by the
  dynamic batcher's weighted-fair queue), per-tenant in-flight caps and
  token-bucket rate quotas.  Violations are rejected with a *retryable*
  429 carrying a ``Retry-After`` hint, which a client's retry policy
  honors — a well-behaved flooder backs off instead of erroring.

Tenant identity arrives on the wire as the ``x-tenant-id`` HTTP header
(:data:`TENANT_HEADER`); requests without it share the default tenant
``""``.  The server's front door keeps every request that reads or
writes a shared-memory region off the cache and the coalescer
(:func:`request_digest` returns None for it): its tensors live in the
region, and a cached answer would skip the region write.
"""

import hashlib
import threading
import time
from collections import OrderedDict

from client_tpu_torch.utils import TENANT_HEADER, InferenceServerException

__all__ = [
    "TENANT_HEADER",
    "ResponseCache",
    "Coalescer",
    "TenantQoS",
    "request_digest",
]


def request_digest(model_name, model_version, request, binary_section):
    """Content digest of one inference request, or None when uncacheable.

    Exact-match semantics: two requests share a digest iff they name the
    same model+version and carry byte-identical inputs, the same requested
    outputs (rendering flags included — they change the response body),
    and the same request parameters.  The request ``id`` is excluded (it
    is caller identity, not content — the hit path re-stamps it) and so is
    tenant identity: a hot key is hot *across* tenants.

    Uncacheable shapes return None:
    - sequence requests (``sequence_id``): the response depends on server
      state, not just the request bytes;
    - shared-memory inputs or outputs: the payload lives in a region this
      process may not re-read later (inputs), or the response's side
      effect is a region write that must happen per request (outputs).
    """
    params = request.get("parameters") or {}
    if params.get("sequence_id"):
        return None
    h = hashlib.sha256()
    h.update(model_name.encode("utf-8"))
    h.update(b"\x00")
    h.update(str(model_version).encode("utf-8"))
    for entry in request.get("inputs") or []:
        eparams = entry.get("parameters") or {}
        if "shared_memory_region" in eparams:
            return None
        h.update(b"\x01")
        h.update(str(entry.get("name", "")).encode("utf-8"))
        h.update(str(entry.get("datatype", "")).encode("utf-8"))
        h.update(repr(list(entry.get("shape") or [])).encode("utf-8"))
        if "data" in entry:
            h.update(repr(entry["data"]).encode("utf-8"))
        h.update(repr(sorted(eparams.items())).encode("utf-8"))
    for out in request.get("outputs") or []:
        oparams = out.get("parameters") or {}
        if "shared_memory_region" in oparams:
            return None
        h.update(b"\x02")
        h.update(str(out.get("name", "")).encode("utf-8"))
        h.update(repr(sorted(oparams.items())).encode("utf-8"))
    h.update(b"\x03")
    h.update(repr(sorted(params.items())).encode("utf-8"))
    h.update(b"\x04")
    if binary_section:
        if isinstance(binary_section, (list, tuple)):
            for part in binary_section:
                h.update(bytes(part))
                h.update(b"\x05")
        else:
            h.update(bytes(binary_section))
    return h.hexdigest()


def _response_nbytes(response_json, blobs):
    """Approximate retained bytes of one cached (response, blobs) value."""
    n = sum(len(b) for b in blobs)
    for out in response_json.get("outputs") or []:
        data = out.get("data")
        if data is not None:
            n += 8 * len(data)  # JSON-rendered scalars, rough host cost
    return n + 256  # dict/key overhead floor so empty entries still count


class ResponseCache:
    """Bounded content-addressed LRU cache of rendered responses.

    Values are ``(response_json, blobs)`` exactly as the engine returns
    them, stored WITHOUT the request ``id`` (the hit path stamps the
    requester's own).  Eviction is LRU by entry count and by retained
    bytes; ``ttl_s`` (optional) expires entries at read time.

    Metrics (when built with a :class:`client_tpu_torch.serve.metrics.Registry`):
    ``ctpu_cache_hits_total`` / ``ctpu_cache_misses_total`` /
    ``ctpu_cache_evictions_total{reason}`` counters and the
    ``ctpu_cache_entries`` / ``ctpu_cache_bytes`` gauges.
    """

    def __init__(self, max_entries=1024, max_bytes=64 << 20, ttl_s=None,
                 registry=None):
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)
        self.ttl_s = ttl_s
        self.registry = registry
        self._lock = threading.Lock()
        # key -> (value, nbytes, stored_at, ttl_s) — ttl_s None means
        # the cache-wide default applies
        self._entries = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def stats(self):
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "entries": len(self._entries),
                "bytes": self._bytes,
            }

    def _inc(self, name, labels=None):
        if self.registry is not None:
            self.registry.inc(name, labels, help_=_CACHE_HELP[name])

    def _gauges_locked(self):
        if self.registry is not None:
            self.registry.set(
                "ctpu_cache_entries", None, len(self._entries),
                help_=_CACHE_HELP["ctpu_cache_entries"],
            )
            self.registry.set(
                "ctpu_cache_bytes", None, self._bytes,
                help_=_CACHE_HELP["ctpu_cache_bytes"],
            )

    def get(self, key):
        """Cached value for *key* or None; counts the hit/miss."""
        now = time.monotonic()
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                ttl = entry[3] if entry[3] is not None else self.ttl_s
                if ttl is not None and now - entry[2] > ttl:
                    self._entries.pop(key)
                    self._bytes -= entry[1]
                    self.evictions += 1
                    self._gauges_locked()
                    entry = None
                    self._inc("ctpu_cache_evictions_total",
                              {"reason": "ttl"})
            if entry is None:
                self.misses += 1
                self._inc("ctpu_cache_misses_total")
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            self._inc("ctpu_cache_hits_total")
            return entry[0]

    def put(self, key, response_json, blobs, ttl_s=None):
        """Insert one rendered response (no-op for values that alone exceed
        the byte bound — caching them would evict the whole working set).

        ``ttl_s`` overrides the cache-wide TTL for THIS entry — the
        per-model ``response_cache`` config block's freshness hint (a
        weather model's answers go stale in seconds, an embedding
        model's never do)."""
        nbytes = _response_nbytes(response_json, blobs)
        if nbytes > self.max_bytes:
            return
        value = (response_json, blobs)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
            self._entries[key] = (value, nbytes, time.monotonic(), ttl_s)
            self._bytes += nbytes
            while (
                len(self._entries) > self.max_entries
                or self._bytes > self.max_bytes
            ):
                _, (_, evicted_bytes, _, _) = self._entries.popitem(
                    last=False
                )
                self._bytes -= evicted_bytes
                self.evictions += 1
                self._inc("ctpu_cache_evictions_total", {"reason": "lru"})
            self._gauges_locked()

    def peek(self, key):
        """Read *key* WITHOUT touching hit/miss counters or LRU order —
        the fleet peer-serving path: a peer's lookup must not skew this
        replica's own hit-rate accounting (its miss already counted on
        the replica that asked) nor keep entries hot that only remote
        traffic touches.  TTL still applies (a stale entry is stale for
        peers too), but expiry is left to the owning ``get`` path."""
        now = time.monotonic()
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return None
            ttl = entry[3] if entry[3] is not None else self.ttl_s
            if ttl is not None and now - entry[2] > ttl:
                return None
            return entry[0]

    def keys(self):
        """Digest-key snapshot (the routing-gossip summary source)."""
        with self._lock:
            return list(self._entries)

    def clear(self):
        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self._gauges_locked()


_CACHE_HELP = {
    "ctpu_cache_hits_total": "Response-cache hits",
    "ctpu_cache_misses_total": "Response-cache misses",
    "ctpu_cache_evictions_total": "Response-cache evictions (lru/ttl)",
    "ctpu_cache_entries": "Response-cache live entry count",
    "ctpu_cache_bytes": "Response-cache retained bytes",
}


class _Flight:
    """One in-flight dispatch identical concurrent requests attach to."""

    __slots__ = ("event", "result", "error", "retry", "followers")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.error = None
        # leader was rejected by ITS OWN tenant's admission (429): that
        # error is tenant-scoped, not content-scoped — followers must
        # re-contend under their own quotas instead of inheriting it
        self.retry = False
        self.followers = 0


class Coalescer:
    """Collapse identical concurrent requests into one dispatch.

    The leader (first arrival for a key) executes; followers block until
    the leader publishes and receive the same rendered result (the hit
    path stamps each follower's own request id).  The leader ALWAYS
    publishes — success or error — in a ``finally``, so followers can
    wait without a timeout.  An error fans out to the followers too:
    a byte-identical request would have failed identically, and retrying
    it N times is exactly the herd coalescing exists to prevent.

    Metrics: ``ctpu_coalesced_requests_total`` (followers served without
    a dispatch) and the high-watermark gauge ``ctpu_coalesce_depth_max``
    (largest N collapsed into one dispatch).
    """

    def __init__(self, registry=None):
        self.registry = registry
        self._lock = threading.Lock()
        self._flights = {}
        self.coalesced = 0
        self.depth_max = 0

    def join(self, key):
        """Returns ``(is_leader, flight)``; leaders must complete the
        flight via :meth:`publish` / :meth:`fail` (once)."""
        with self._lock:
            flight = self._flights.get(key)
            if flight is None:
                flight = _Flight()
                self._flights[key] = flight
                return True, flight
            flight.followers += 1
            self.coalesced += 1
            depth = flight.followers + 1  # leader included
            if depth > self.depth_max:
                self.depth_max = depth
                if self.registry is not None:
                    self.registry.set(
                        "ctpu_coalesce_depth_max", None, depth,
                        help_="Largest request count collapsed into one "
                              "dispatch",
                    )
            if self.registry is not None:
                self.registry.inc(
                    "ctpu_coalesced_requests_total",
                    help_="Requests served from a peer's in-flight dispatch",
                )
            return False, flight

    def publish(self, key, flight, result):
        with self._lock:
            self._flights.pop(key, None)
        flight.result = result
        flight.event.set()

    def fail(self, key, flight, error):
        with self._lock:
            self._flights.pop(key, None)
        flight.error = error
        flight.event.set()

    def retry_followers(self, key, flight):
        """Release the followers to re-contend (one becomes the next
        leader under its OWN tenant's admission) — for leader failures
        that are tenant-scoped, not content-scoped."""
        with self._lock:
            self._flights.pop(key, None)
        flight.retry = True
        flight.event.set()


class _TokenBucket:
    """Classic token bucket; ``take()`` returns 0.0 on admit or the
    seconds until a token will exist (the Retry-After hint)."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate_per_s, burst):
        self.rate = float(rate_per_s)
        self.burst = float(burst)
        self.tokens = self.burst
        self.stamp = time.monotonic()

    def take(self, now):
        # clamp: the caller's `now` can predate this bucket's creation
        # stamp (captured before the state was lazily built); a negative
        # elapsed must not drain the bucket below its real level
        self.tokens = min(
            self.burst,
            self.tokens + max(now - self.stamp, 0.0) * self.rate,
        )
        self.stamp = max(now, self.stamp)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        return (1.0 - self.tokens) / self.rate if self.rate > 0 else 1.0


class _TenantState:
    __slots__ = ("inflight", "bucket", "requests", "shed", "gossip_delta")

    def __init__(self):
        self.inflight = 0
        self.bucket = None
        self.requests = 0
        self.shed = 0
        # admissions since the last fleet-gossip collection: what peers
        # drain from THEIR buckets so a flooder spraying N replicas
        # converges on ~1x its quota fleet-wide, not N x
        self.gossip_delta = 0


class TenantQoS:
    """Per-tenant admission control + priority-class weights.

    Parameters
    ----------
    default_weight : fair-queue weight for tenants without an explicit
        class entry (the dynamic batcher shares batch capacity
        proportionally to weight).
    default_max_inflight : per-tenant concurrent-request cap (None =
        uncapped).  The cap is what keeps a flooder from occupying every
        engine execution slot.
    default_rate_per_s / default_burst : per-tenant token-bucket quota
        (None = unmetered).  Burst defaults to 2x the rate.
    tenants : {name: {"weight", "max_inflight", "rate_per_s", "burst"}}
        per-tenant overrides (priority classes are expressed as weights:
        gold=8.0, bronze=1.0).
    registry : optional metrics Registry for the per-tenant series.

    :meth:`admit` raises a retryable 429 (with ``retry_after_s`` — the
    HTTP frontend renders it as the ``Retry-After`` header) when a quota
    or cap is exceeded; on success it returns a release callable that
    MUST run when the request finishes (streams release at close).
    """

    def __init__(self, default_weight=1.0, default_max_inflight=None,
                 default_rate_per_s=None, default_burst=None,
                 default_lane_share=0.75, default_priority=0.0,
                 tenants=None, registry=None):
        self.default_weight = float(default_weight)
        self.default_max_inflight = default_max_inflight
        self.default_rate_per_s = default_rate_per_s
        self.default_burst = default_burst
        self.default_lane_share = default_lane_share
        self.default_priority = float(default_priority)
        self.tenants = dict(tenants or {})
        self.registry = registry
        self._lock = threading.Lock()
        self._states = {}

    # -- configuration lookups ----------------------------------------------

    def _cfg(self, tenant, key, default):
        return self.tenants.get(tenant, {}).get(key, default)

    def weight(self, tenant):
        """Fair-queue weight for *tenant* (>= a small positive floor so a
        zero/negative config cannot starve the tenant forever)."""
        w = float(self._cfg(tenant, "weight", self.default_weight))
        return max(w, 1e-3)

    def lane_share(self, tenant):
        """Max fraction of the continuous-batching DECODE LANES *tenant*
        may hold while another tenant is waiting (per-tenant ``lane_share``
        config key; None = uncapped).  Decoupled token streams bypass the
        request-level front door — one tenant's long generations would
        otherwise occupy every decode lane for minutes — so the LM engine
        enforces this at lane-admission time (work-conserving: the quota
        binds only while someone else is queued)."""
        share = self._cfg(tenant, "lane_share", self.default_lane_share)
        return None if share is None else float(share)

    def priority(self, tenant):
        """Preemption priority class of *tenant* (per-tenant ``priority``
        config key; higher outranks lower, default 0).  Weights shape how
        much service a tenant gets; priority decides who keeps their KV
        blocks when the LM engine's pool runs dry — a STRICTLY
        higher-priority waiter may swap out a lower-priority lane (the
        engine's preemption controller consumes this via the
        ``tenant_priority`` hook wired in add_model)."""
        return float(self._cfg(tenant, "priority", self.default_priority))

    def _state_locked(self, tenant):
        state = self._states.get(tenant)
        if state is None:
            state = _TenantState()
            rate = self._cfg(tenant, "rate_per_s", self.default_rate_per_s)
            if rate is not None:
                burst = self._cfg(tenant, "burst", self.default_burst)
                state.bucket = _TokenBucket(
                    rate, burst if burst is not None else max(2.0 * rate, 1.0)
                )
            self._states[tenant] = state
        return state

    # -- admission ----------------------------------------------------------

    def note(self, tenant):
        """Count one request served WITHOUT an execution dispatch (cache
        hit, coalesced follower) — those bypass the caps by design (they
        occupy no execution slot; shedding them would defeat the cache),
        but must still reconcile against the per-tenant request counters."""
        with self._lock:
            self._state_locked(tenant).requests += 1
        self._count(tenant, None)

    def admit(self, tenant):
        """Admit one dispatching request for *tenant* or raise the
        retryable 429.

        Returns a zero-arg release callable (idempotent)."""
        max_inflight = self._cfg(
            tenant, "max_inflight", self.default_max_inflight
        )
        now = time.monotonic()
        with self._lock:
            state = self._state_locked(tenant)
            state.requests += 1
            reason = None
            retry_after = 1.0
            if max_inflight is not None and state.inflight >= max_inflight:
                reason = "inflight"
            elif state.bucket is not None:
                wait = state.bucket.take(now)
                if wait > 0.0:
                    reason = "quota"
                    retry_after = wait
            if reason is None:
                state.inflight += 1
                state.gossip_delta += 1
                # gauge written under the SAME lock as the count: a
                # read-then-set outside it lets a preempted thread park
                # the gauge on a stale value
                self._set_inflight_locked(tenant, state.inflight)
            else:
                state.shed += 1
        self._count(tenant, reason)
        if reason is not None:
            exc = InferenceServerException(
                f"tenant {tenant!r} exceeded its "
                f"{'in-flight cap' if reason == 'inflight' else 'rate quota'}"
                "; retry after backoff",
                status="429",
            )
            # the HTTP frontend renders this hint as the Retry-After
            # header
            exc.retry_after_s = max(retry_after, 0.05)
            raise exc
        released = [False]

        def release():
            with self._lock:
                if released[0]:
                    return
                released[0] = True
                state.inflight -= 1
                self._set_inflight_locked(tenant, state.inflight)

        return release

    def _count(self, tenant, reason):
        """Monotonic counters (order-insensitive: safe outside the lock)."""
        if self.registry is None:
            return
        self.registry.inc(
            "ctpu_tenant_requests_total", {"tenant": tenant},
            help_="Requests received per tenant (admitted or shed)",
        )
        if reason is not None:
            self.registry.inc(
                "ctpu_tenant_shed_total",
                {"tenant": tenant, "reason": reason},
                help_="Requests shed per tenant with a retryable 429",
            )

    def _set_inflight_locked(self, tenant, inflight):
        """Caller holds self._lock (the Registry's own lock is a leaf —
        no callbacks — so nesting it here is safe)."""
        if self.registry is not None:
            self.registry.set(
                "ctpu_tenant_inflight", {"tenant": tenant}, inflight,
                help_="Requests currently executing per tenant",
            )

    # -- fleet-wide accounting ----------------------------------------------

    def delta_counts(self):
        """{tenant: admissions since the last call} — collected by the
        fleet gossip loop and pushed to peers, then reset.  Only tenants
        with activity appear (the payload stays compact)."""
        with self._lock:
            out = {}
            for tenant, state in self._states.items():
                if state.gossip_delta:
                    out[tenant] = state.gossip_delta
                    state.gossip_delta = 0
            return out

    def absorb_remote(self, counts):
        """Drain each tenant's local token bucket by the admissions a
        PEER replica reported (fleet gossip): the rate quota becomes
        approximately fleet-wide instead of per-process, so a flooder
        cannot collect N x its quota by spraying N replicas.  Convergence
        is eventual (one gossip interval of slack); tenants without a
        bucket, or unknown here, are ignored — remote evidence must never
        fabricate local state."""
        with self._lock:
            for tenant, n in (counts or {}).items():
                state = self._states.get(tenant)
                if state is None and tenant in self.tenants:
                    # operator-configured tenant this replica just hasn't
                    # served yet: materialize its bucket so the remote
                    # consumption isn't forgotten (arbitrary gossip names
                    # stay ignored — a peer must not grow the state map)
                    state = self._state_locked(tenant)
                if state is None or state.bucket is None:
                    continue
                state.bucket.tokens = max(
                    state.bucket.tokens - float(n), 0.0
                )

    # -- introspection -------------------------------------------------------

    def snapshot(self):
        """{tenant: {"inflight", "requests", "shed"}} view."""
        with self._lock:
            return {
                t: {
                    "inflight": s.inflight,
                    "requests": s.requests,
                    "shed": s.shed,
                }
                for t, s in self._states.items()
            }
