"""Endpoint pool: N server replicas as one routable set.

Counterpart of client_tpu/balance/pool.py, on the port's
:class:`~client_tpu_torch.resilience.CircuitBreakerRegistry`.

The pool owns, per endpoint: a :class:`~client_tpu_torch.resilience.CircuitBreaker`
(from a shared :class:`~client_tpu_torch.resilience.CircuitBreakerRegistry`), a
health state (READY / NOT_READY / UNREACHABLE — the ``server_state()``
client verb's vocabulary), a membership *phase* (ACTIVE / PROBATION /
RETIRING), a routing weight, and a live inflight count.

Health is fed from two directions:

- **background readiness probes** (:meth:`EndpointPool.start_probes`): a
  daemon thread polls each endpoint's readiness with per-endpoint full
  jitter (a recovering fleet must not take synchronized probe bursts).
  Probes are what notice *drain* — a draining server still answers, with
  not-ready — and what bring a recovered endpoint back without burning a
  request on it.
- **per-request outcomes**: a successful response marks its endpoint READY
  immediately; a connection-level failure marks it UNREACHABLE (only while
  probing is active — without a prober nothing would ever un-mark it, so
  the circuit breaker alone gates the endpoint then).

Membership is *live* (:meth:`EndpointPool.update_endpoints`, the discovery
entry point — see balance/discovery.py):

- **added** endpoints enter PROBATION while a prober is armed and only take
  traffic once a readiness probe observes READY (without a prober they are
  admitted optimistically, like constructor endpoints);
- **removed** endpoints are gracefully RETIRED: no new leases, in-flight
  leases (including pinned streams) finish, then the endpoint is evicted;
- a **safety valve** never retires the last healthy endpoint — a flapping
  resolver cannot evict the only replica still serving.

Routing (:meth:`EndpointPool.lease`) filters to ACTIVE+READY endpoints
whose breaker admits an attempt (open circuits are skipped until their
half-open probe), asks the policy to pick, and returns a *lease* whose
``success()``/``failure()`` hooks feed the outcome back into inflight,
breaker, and health state — the contract
:func:`client_tpu_torch.resilience.call_with_failover` drives.

All endpoint state is guarded by one pool lock; policies run under it (and
must not block — see policy.py).
"""

import random
import threading
import time

from client_tpu_torch.balance.policy import make_policy
from client_tpu_torch.resilience import (
    CircuitBreaker,
    CircuitBreakerRegistry,
    CircuitOpenError,
    NoHealthyEndpointError,
    _notify,
    _SerialDeliverer,
    is_connection_level,
)
from client_tpu_torch.utils import (
    SERVER_NOT_READY,
    SERVER_READY,
    SERVER_UNREACHABLE,
)

__all__ = [
    "Endpoint",
    "EndpointPool",
    "Lease",
    "PHASE_ACTIVE",
    "PHASE_PROBATION",
    "PHASE_RETIRING",
]

# Membership lifecycle phases (orthogonal to the READY/NOT_READY/
# UNREACHABLE health state: phase is what the operator/resolver wants,
# state is what probes/outcomes observe).
PHASE_ACTIVE = "active"
PHASE_PROBATION = "probation"
PHASE_RETIRING = "retiring"

_VALID_STATES = (SERVER_READY, SERVER_NOT_READY, SERVER_UNREACHABLE)


class Endpoint:
    """One replica: identity + routed-state (mutated under the pool lock)."""

    def __init__(self, url, weight=1.0, breaker=None):
        self.url = str(url)
        self.weight = float(weight)
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            name=self.url
        )
        # Optimistic start: an unprobed endpoint is routable until a probe
        # or an outcome says otherwise (pessimistic start would blackhole
        # a pool constructed before its servers finish binding).
        self.state = SERVER_READY
        self.phase = PHASE_ACTIVE
        self.inflight = 0
        self.last_error = None
        # Gossiped digest-prefix summary (what this replica's cache tier
        # holds), fed by probes via set_summary; the prefix-aware policy
        # reads it.  Empty = no affinity signal, policies fall back.
        self.summary = frozenset()
        # Gossiped autoscaling pressure ({"queue_depth", "prefix_hot",
        # ...}), fed by probes via set_pressure; surfaced through
        # pressures() and the observer's on_endpoint_pressure hook so a
        # discovery source can scale on it.  Empty = never gossiped.
        self.pressure = {}
        # monotonic stamp of the last set_pressure delivery: pressures()
        # drops entries older than a few probe intervals so a dead
        # replica's final gossip cannot steer the autoscaler forever.
        # None = never gossiped.
        self.pressure_at = None
        # Probation ramp-up (slow start): stamped at promote time when the
        # pool has a rampup window; ramp_fraction() climbs floor -> 1 over
        # [ramp_started, ramp_started + ramp_span].
        self.ramp_started = None
        self.ramp_span = 0.0
        self.ramp_floor = 0.1
        # State-change delivery ordering: transitions are stamped under the
        # pool lock and delivered outside it with stale ones dropped, so a
        # preempted thread can never park the endpoint-state gauge on an
        # older value (same scheme as CircuitBreaker._deliver).
        self._state_seq = 0
        self._state_delivered = 0

    def __repr__(self):
        return (
            f"Endpoint({self.url!r}, state={self.state}, "
            f"phase={self.phase}, inflight={self.inflight}, "
            f"circuit={self.breaker.state})"
        )

    def ramp_fraction(self, now=None):
        """Slow-start traffic share in [ramp_floor, 1]: 1.0 when not
        ramping, else the elapsed fraction of the ramp window (floored so
        a freshly promoted replica gets SOME probe traffic — zero share
        would never exercise it).  Consumed ONLY by the pool's candidate
        thinning — the single ramp mechanism, applied before any policy
        runs, so weight-aware policies don't compound the penalty."""
        if self.ramp_started is None or self.ramp_span <= 0:
            return 1.0
        now = time.monotonic() if now is None else now
        frac = (now - self.ramp_started) / self.ramp_span
        if frac >= 1.0:
            self.ramp_started = None  # ramp complete: back to O(1) checks
            return 1.0
        return max(frac, self.ramp_floor)


class Lease:
    """One routed attempt on one endpoint.

    Exactly one of :meth:`success` / :meth:`failure` must be called to
    release the inflight slot and record the outcome (the failover loop in
    ``client_tpu_torch.resilience`` does this).  ``key`` is the stable endpoint
    identity the loop excludes on retry; ``last_candidate`` is True when no
    other non-excluded healthy replica existed at pick time (so the loop
    backs off instead of hammering a wrapped rotation).
    """

    __slots__ = ("_pool", "endpoint", "key", "last_candidate", "_done")

    def __init__(self, pool, endpoint, last_candidate):
        self._pool = pool
        self.endpoint = endpoint
        self.key = endpoint.url
        self.last_candidate = last_candidate
        self._done = False

    @property
    def url(self):
        return self.endpoint.url

    def success(self):
        if not self._done:
            self._done = True
            self._pool._complete(self.endpoint, ok=True)

    def failure(self, exc=None, retryable=True):
        if not self._done:
            self._done = True
            self._pool._complete(
                self.endpoint, ok=False, exc=exc, retryable=retryable
            )

    def release(self):
        """Free the inflight slot WITHOUT health/breaker evidence — for
        leases whose outcome says nothing about the endpoint (a finished
        stream may end because the endpoint died; marking it READY would
        route new work at a corpse until the next probe)."""
        if not self._done:
            self._done = True
            self._pool._release(self.endpoint)


class EndpointPool:
    """Registry of replicas + health state machine + policy routing.

    Parameters
    ----------
    endpoints : iterable of url strings, ``(url, weight)`` pairs, or
        prebuilt :class:`Endpoint` objects.
    policy : policy name or Policy instance (see balance/policy.py).
    breakers : optional shared CircuitBreakerRegistry; one is created from
        ``failure_threshold``/``reset_timeout_s`` when absent.
    observer : optional hook object; any subset of ``on_route(url)``,
        ``on_failover(url)`` (a retryable failure rotated the request off
        this endpoint), ``on_endpoint_state(url, state)``,
        ``on_endpoint_phase(url, phase)``, ``on_membership(op, url)`` (op
        in add/retire/unretire/promote/retain/evict), and
        ``on_pool_size(active, probation, retiring)`` is called —
        ``client_tpu_torch.serve.metrics.BalancerMetricsObserver`` feeds these
        into per-endpoint /metrics series.
    """

    def __init__(self, endpoints, policy="round-robin", breakers=None,
                 failure_threshold=5, reset_timeout_s=30.0, observer=None,
                 rampup_s=0.0, rampup_floor=0.1, rng=None):
        # Probation ramp-up (slow start): a PROBATION endpoint promoted to
        # ACTIVE takes traffic gradually over `rampup_s` seconds instead of
        # instantly absorbing a full 1/N share — a replica whose caches,
        # JIT executables, and connection pools are cold serves its first
        # requests slowest, and handing it full traffic at promote time
        # spikes tail latency exactly when the fleet just recovered.
        # 0.0 (default) disables; `rampup_floor` is the minimum share so a
        # ramping replica still sees some traffic from t=0.
        self.rampup_s = float(rampup_s)
        self.rampup_floor = float(rampup_floor)
        self._ramp_rng = rng if rng is not None else random.Random()
        if breakers is None:
            breakers = CircuitBreakerRegistry(
                failure_threshold=failure_threshold,
                reset_timeout_s=reset_timeout_s,
            )
        self.breakers = breakers
        self.observer = observer
        self._policy = make_policy(policy)
        self._lock = threading.Lock()
        self._endpoints = []
        for spec in endpoints:
            self._endpoints.append(self._build_endpoint(spec))
        # construction errors are programming errors, not the transient
        # retryable NoHealthyEndpointError routing raises
        if not self._endpoints:
            raise ValueError("endpoint pool constructed empty")
        seen = set()
        for endpoint in self._endpoints:
            if endpoint.url in seen:
                raise ValueError(
                    f"duplicate endpoint {endpoint.url!r} in pool"
                )
            seen.add(endpoint.url)
        # probe plumbing (armed by start_probes; _probe_loop reads these)
        self._probe = None
        self._probe_interval_s = 0.0
        self._prober = None
        self._stop = threading.Event()
        # Observer delivery: ordered, stale-dropping, and — crucially —
        # with NO pool lock held during the callback (an observer that
        # looks back at the pool, or whose delivery triggers another
        # transition, must never deadlock on a private delivery lock).
        self._deliverer = _SerialDeliverer()

    def _build_endpoint(self, spec):
        if isinstance(spec, Endpoint):
            return spec
        if isinstance(spec, (tuple, list)):
            url, weight = spec
            return Endpoint(url, weight, self.breakers.get(str(url)))
        return Endpoint(spec, 1.0, self.breakers.get(str(spec)))

    # -- introspection -------------------------------------------------------

    def __len__(self):
        with self._lock:
            return len(self._endpoints)

    def urls(self):
        with self._lock:
            return [e.url for e in self._endpoints]

    def endpoints(self):
        with self._lock:
            return list(self._endpoints)

    def states(self):
        with self._lock:
            return {e.url: e.state for e in self._endpoints}

    def phases(self):
        """{url: ACTIVE/PROBATION/RETIRING} membership view."""
        with self._lock:
            return {e.url: e.phase for e in self._endpoints}

    def snapshot(self):
        """Per-endpoint routing view: state, phase, inflight, circuit,
        weight."""
        with self._lock:
            return [
                {
                    "url": e.url,
                    "state": e.state,
                    "phase": e.phase,
                    "inflight": e.inflight,
                    "weight": e.weight,
                    "circuit": e.breaker.state,
                }
                for e in self._endpoints
            ]

    def _sizes_locked(self):
        active = probation = retiring = 0
        for e in self._endpoints:
            if e.phase == PHASE_ACTIVE:
                active += 1
            elif e.phase == PHASE_PROBATION:
                probation += 1
            else:
                retiring += 1
        return active, probation, retiring

    # -- health state machine ------------------------------------------------

    def _deliver_state(self, endpoint, state, seq):
        """Deliver one stamped state transition, dropping it if a newer one
        was already delivered (out-of-order delivery would wedge the
        endpoint-state gauge on a stale value forever, since changes only
        notify on transitions).  The staleness check runs in delivery
        order inside the deliverer; the observer call runs lock-free."""
        if seq is None:
            return

        def accept():
            if seq <= endpoint._state_delivered:
                return False
            endpoint._state_delivered = seq
            return True

        self._deliverer.post(
            lambda: _notify(
                self.observer, "on_endpoint_state", endpoint.url, state
            ),
            accept,
        )

    def _deliver_events(self, events):
        """Deliver a batch of membership/phase events in order, contiguous
        per batch, with no lock held during the callbacks (observers may
        look back at the pool)."""
        if not events:
            return

        def deliver():
            for method, args in events:
                _notify(self.observer, method, *args)

        self._deliverer.post(deliver)

    def set_state(self, url, state):
        """Record a health observation for *url* (probe or admin).  A
        READY observation on a PROBATION endpoint promotes it to ACTIVE —
        the readiness gate new discovery members pass before taking
        traffic."""
        if state not in _VALID_STATES:
            raise ValueError(f"unknown endpoint state {state!r}")
        transition = None
        events = []
        with self._lock:
            for endpoint in self._endpoints:
                if endpoint.url != url:
                    continue
                if endpoint.state != state:
                    endpoint.state = state
                    endpoint._state_seq += 1
                    transition = (endpoint, state, endpoint._state_seq)
                if (
                    state == SERVER_READY
                    and endpoint.phase == PHASE_PROBATION
                ):
                    endpoint.phase = PHASE_ACTIVE
                    if self.rampup_s > 0:
                        # slow start: the promoted replica's share climbs
                        # from rampup_floor to full over the window
                        endpoint.ramp_started = time.monotonic()
                        endpoint.ramp_span = self.rampup_s
                        endpoint.ramp_floor = self.rampup_floor
                    events.append(("on_membership", ("promote", url)))
                    events.append(("on_endpoint_phase", (url, PHASE_ACTIVE)))
                    events.append(("on_pool_size", self._sizes_locked()))
        if transition is not None:
            self._deliver_state(*transition)
        self._deliver_events(events)

    def set_weight(self, url, weight):
        with self._lock:
            for endpoint in self._endpoints:
                if endpoint.url == url:
                    endpoint.weight = float(weight)

    def set_summary(self, url, digests):
        """Install *url*'s gossiped cache-summary (an iterable of digest
        strings — ``fleet.chain_digests`` / response-cache keys).  Probes
        piggyback this: a ``probe(url)`` returning ``(state, digests)``
        updates health AND summary in one round trip, so cache-aware
        routing costs no extra probe traffic."""
        summary = frozenset(str(d) for d in digests)
        with self._lock:
            for endpoint in self._endpoints:
                if endpoint.url == url:
                    endpoint.summary = summary

    def summaries(self):
        """{url: frozenset(digests)} gossip view."""
        with self._lock:
            return {e.url: e.summary for e in self._endpoints}

    def set_pressure(self, url, pressure):
        """Install *url*'s gossiped autoscaling pressure (a mapping of
        numeric signals — ``FleetTier.local_summary()['pressure']``).
        Probes piggyback this as the third element of a ``(state,
        digests, pressure)`` result; the observer's
        ``on_endpoint_pressure`` hook exports it as the
        ``ctpu_fleet_pressure_*`` per-endpoint gauges."""
        pressure = dict(pressure or {})
        matched = False
        now = time.monotonic()
        with self._lock:
            for endpoint in self._endpoints:
                if endpoint.url == url:
                    endpoint.pressure = pressure
                    endpoint.pressure_at = now
                    matched = True
        if matched:
            # unknown urls (an in-flight probe completing after eviction)
            # must NOT notify: the observer would resurrect the evicted
            # endpoint's pressure gauges and nothing would ever remove
            # them again
            _notify(self.observer, "on_endpoint_pressure", url, pressure)

    # pressure entries older than this many probe intervals are stale:
    # a dead replica's last gossip must not steer the autoscaler forever
    PRESSURE_FRESH_INTERVALS = 3.0

    def pressures(self):
        """{url: pressure dict} autoscaling-signal view — what a
        discovery source (or the autoscaler) polls to scale the fleet on
        queue depth, KV occupancy and prefix-affinity pressure.  With a
        prober armed, an entry not refreshed within
        ``PRESSURE_FRESH_INTERVALS`` probe intervals reads as ``{}`` —
        same as never-gossiped — so a dead replica's final numbers age
        out instead of lingering at their last value."""
        now = time.monotonic()
        horizon = (
            self.PRESSURE_FRESH_INTERVALS * self._probe_interval_s
            if self._probe_interval_s > 0 else None
        )
        with self._lock:
            out = {}
            for e in self._endpoints:
                stale = (
                    horizon is not None
                    and e.pressure_at is not None
                    and now - e.pressure_at > horizon
                )
                out[e.url] = {} if stale else dict(e.pressure)
            return out

    # -- live membership (the discovery entry point) -------------------------

    def update_endpoints(self, specs):
        """Apply a new membership list (urls, ``(url, weight)`` pairs, or
        Endpoint objects) — the :mod:`client_tpu_torch.balance.discovery` feed.

        - New endpoints enter PROBATION while a prober is armed (promoted
          by their first READY probe; see :meth:`set_state`), ACTIVE
          otherwise.
        - Endpoints absent from *specs* are RETIRED: excluded from routing
          immediately, evicted once their in-flight leases (and pinned
          streams) finish.
        - A RETIRING endpoint named again is un-retired in place.
        - Safety valve: if the update would leave no healthy (ACTIVE +
          READY) member, the last healthy endpoint slated for removal is
          retained instead of retired — a flapping resolver can never
          evict the only replica still serving.

        Raises ValueError on an empty or duplicate-bearing list (config
        mistakes, not transient routing conditions).  Returns a summary
        dict: {"added", "retired", "unretired", "retained", "evicted"}.
        """
        incoming = []
        for spec in specs:
            if isinstance(spec, Endpoint):
                incoming.append((spec.url, spec.weight))
            elif isinstance(spec, (tuple, list)):
                url, weight = spec
                incoming.append((str(url), float(weight)))
            else:
                incoming.append((str(spec), None))
        if not incoming:
            raise ValueError(
                "refusing to apply empty endpoint membership "
                "(a flapping resolver must not drain the pool)"
            )
        urls = [u for u, _ in incoming]
        if len(set(urls)) != len(urls):
            raise ValueError(f"duplicate endpoint in membership: {urls}")

        events = []
        summary = {
            "added": [], "retired": [], "unretired": [], "retained": [],
            "evicted": [],
        }
        with self._lock:
            current = {e.url: e for e in self._endpoints}
            wanted = set(urls)
            for url, weight in incoming:
                endpoint = current.get(url)
                if endpoint is None:
                    endpoint = Endpoint(
                        url,
                        1.0 if weight is None else weight,
                        self.breakers.get(url),
                    )
                    if self._probe is not None:
                        # unproven: takes traffic only after a READY probe
                        endpoint.phase = PHASE_PROBATION
                        endpoint.state = SERVER_NOT_READY
                    self._endpoints.append(endpoint)
                    summary["added"].append(url)
                    events.append(("on_membership", ("add", url)))
                    events.append(
                        ("on_endpoint_phase", (url, endpoint.phase))
                    )
                else:
                    if weight is not None:
                        endpoint.weight = weight
                    if endpoint.phase == PHASE_RETIRING:
                        # resolver flapped it back before eviction
                        endpoint.phase = PHASE_ACTIVE
                        summary["unretired"].append(url)
                        events.append(("on_membership", ("unretire", url)))
                        events.append(
                            ("on_endpoint_phase", (url, PHASE_ACTIVE))
                        )

            removals = [
                e for e in self._endpoints
                if e.url not in wanted and e.phase != PHASE_RETIRING
            ]
            # safety valve: never retire the last healthy endpoint
            survivors_healthy = any(
                e.url in wanted
                and e.phase == PHASE_ACTIVE
                and e.state == SERVER_READY
                for e in self._endpoints
            )
            if not survivors_healthy:
                keep = next(
                    (
                        e for e in removals
                        if e.phase == PHASE_ACTIVE
                        and e.state == SERVER_READY
                    ),
                    None,
                )
                if keep is not None:
                    removals = [e for e in removals if e is not keep]
                    summary["retained"].append(keep.url)
                    events.append(("on_membership", ("retain", keep.url)))
            for endpoint in removals:
                endpoint.phase = PHASE_RETIRING
                summary["retired"].append(endpoint.url)
                events.append(("on_membership", ("retire", endpoint.url)))
                events.append(
                    ("on_endpoint_phase", (endpoint.url, PHASE_RETIRING))
                )
            summary["evicted"] = self._evict_idle_locked(events)
            events.append(("on_pool_size", self._sizes_locked()))
        self._deliver_events(events)
        return summary

    def _evict_idle_locked(self, events):
        """Drop RETIRING endpoints with no in-flight work (caller holds
        the pool lock and delivers *events* after releasing it)."""
        evicted = []
        keep = []
        for endpoint in self._endpoints:
            if endpoint.phase == PHASE_RETIRING and endpoint.inflight <= 0:
                evicted.append(endpoint.url)
                events.append(("on_membership", ("evict", endpoint.url)))
            else:
                keep.append(endpoint)
        if evicted:
            self._endpoints[:] = keep
        return evicted

    # -- probes --------------------------------------------------------------

    def start_probes(self, probe, interval_s=2.0, rng=None):
        """Start the background readiness prober.

        ``probe(url)`` must return one of the three state constants (the
        clients' ``server_state()`` verb is exactly this shape) — or a
        ``(state, digests)`` tuple to piggyback the replica's cache-tier
        summary for prefix-aware routing, or ``(state, digests,
        pressure)`` to additionally carry its autoscaling pressure
        signals — and should bound its own
        transport timeout — a probe that can block forever wedges the
        whole pool's (serial) prober.  Exceptions count as
        UNREACHABLE.  Each endpoint is probed on its own full-jittered
        schedule (first probe at ``uniform(0, interval)``, then every
        ``uniform(interval/2, interval)``) so a fleet of replicas never
        takes a synchronized probe burst.  Returns True when this call
        armed the prober, False when one was already running;
        :meth:`close` stops it (and the pool can be re-armed afterwards).
        """
        with self._lock:
            if self._prober is not None:
                return False
            # Each prober generation gets ITS OWN stop event and probe fn
            # as thread args: a zombie prober whose close() join timed out
            # (stuck in a slow probe) still answers only to its own event
            # and can never adopt a re-armed generation's probe.
            stop = threading.Event()
            self._stop = stop
            self._probe = probe
            self._probe_interval_s = float(interval_s)
            prober = threading.Thread(
                target=self._probe_loop,
                args=(probe, stop, float(interval_s),
                      rng if rng is not None else random.Random()),
                name="endpoint-pool-probe", daemon=True,
            )
            self._prober = prober
        prober.start()
        return True

    def _probe_schedule(self, url, next_due, now, interval_s, rng,
                        first_sight):
        """Jittered next-probe time for *url* (full jitter on first sight
        spreads a whole fleet's probes inside one interval; steady-state
        periods stay jittered so endpoints never re-align)."""
        if first_sight:
            next_due[url] = now + rng.uniform(0.0, interval_s)
        else:
            next_due[url] = now + rng.uniform(interval_s / 2.0, interval_s)

    def _probe_loop(self, probe, stop, interval_s, rng):
        # Whole-pass guard (the BG-THREAD-CRASH shape, generalizing the
        # probe-arity fix): ANY escaped exception — a broken observer, a
        # hostile summary payload — would otherwise kill this thread and
        # freeze all health probing forever, silently.
        next_due = {}
        while not stop.is_set():
            try:
                if self._probe_pass(probe, stop, interval_s, rng, next_due):
                    return
            except Exception:
                if stop.wait(interval_s):
                    return

    def _probe_pass(self, probe, stop, interval_s, rng, next_due):
        """One full probe sweep + sleep; True when *stop* fired."""
        with self._lock:
            members = [
                e.url for e in self._endpoints
                if e.phase != PHASE_RETIRING
            ]
        now = time.monotonic()
        for url in members:
            if stop.is_set():
                return True
            due = next_due.get(url)
            if due is None:
                self._probe_schedule(
                    url, next_due, now, interval_s, rng, True
                )
                continue
            if due > now:
                continue
            try:
                state = probe(url)
            except Exception:
                state = SERVER_UNREACHABLE
            # probes may piggyback the replica's cache-tier gossip:
            # (state, digests) updates health AND routing affinity, and
            # (state, digests, pressure) additionally carries the
            # autoscaling signals — all in one round trip (see
            # set_summary/set_pressure).  Any OTHER tuple arity is a
            # malformed probe result and must degrade like a broken
            # state — an unpack error here would kill the prober thread
            # and freeze all health probing forever.
            summary = None
            pressure = None
            if isinstance(state, tuple):
                if len(state) == 2:
                    state, summary = state
                elif len(state) == 3:
                    state, summary, pressure = state
                else:
                    state = SERVER_UNREACHABLE
            if state not in _VALID_STATES:
                state = SERVER_UNREACHABLE  # a broken probe is no health
                summary = None
                pressure = None
            self.set_state(url, state)
            if summary is not None:
                self.set_summary(url, summary)
            if pressure is not None:
                self.set_pressure(url, pressure)
            self._probe_schedule(
                url, next_due, time.monotonic(), interval_s, rng, False
            )
        # forget departed endpoints so the schedule map cannot grow
        live = set(members)
        for url in list(next_due):
            if url not in live:
                del next_due[url]
        now = time.monotonic()
        delays = [max(due - now, 0.0) for due in next_due.values()]
        sleep_s = min(delays) if delays else interval_s
        return stop.wait(min(max(sleep_s, 0.001), interval_s))

    def close(self):
        with self._lock:
            prober = self._prober
            self._prober = None
            # Clear the probe so the outcome-driven UNREACHABLE marking in
            # _complete() stops too: with no prober left to recover an
            # endpoint, one transient failure must not remove it forever.
            self._probe = None
            stop = self._stop
        stop.set()
        if prober is not None:
            prober.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- routing -------------------------------------------------------------

    def _routable_locked(self):
        """Endpoints whose health AND membership admit new work (breaker
        gating happens per-pick, where half-open single-probe semantics
        live).  PROBATION members are unproven, RETIRING members are on
        their way out — neither takes new leases."""
        return [
            e for e in self._endpoints
            if e.state == SERVER_READY and e.phase == PHASE_ACTIVE
        ]

    def _thin_ramping_locked(self, candidates, request_ctx=None):
        """Probabilistically skip ramping (slow-start) endpoints so EVERY
        policy — not just weight-aware ones — honors the ramp: a replica at
        ramp fraction f stays in the candidate set with probability f.
        Never empties the set (a pool of only-ramping replicas still
        serves).  Sequence-bearing requests are exempt: the sticky policy
        treats a missing pinned replica as DEAD and forces a sequence
        restart (SequenceRestartError) — thinning a healthy ramping
        replica out from under its pinned sequences would fabricate
        restarts for the whole ramp window."""
        if self.rampup_s <= 0:
            return candidates
        if request_ctx and request_ctx.get("sequence_id"):
            return candidates
        now = time.monotonic()
        kept = [
            e for e in candidates
            if (f := e.ramp_fraction(now)) >= 1.0
            or self._ramp_rng.random() < f
        ]
        return kept or candidates

    def lease(self, excluded=(), request_ctx=None):
        """Route one attempt: returns a :class:`Lease` on a healthy,
        breaker-admitted endpoint, preferring ones not in *excluded*
        (the failover loop's already-tried set).  ``request_ctx`` is an
        optional dict of request attributes (model_name, sequence_id,
        sequence_start/end) content-aware policies key on — the sticky
        sequence policy routes with it.  Raises
        :class:`NoHealthyEndpointError` when nothing is routable.

        Breaker gating runs OUTSIDE the pool lock: ``before_attempt()``
        can deliver an OPEN→HALF_OPEN observer transition, and an observer
        that looks back at the pool (states/snapshot) under our lock would
        deadlock."""
        with self._lock:
            routable = self._routable_locked()
            if not routable:
                raise NoHealthyEndpointError(
                    f"no endpoint is routable: {self._describe_locked()}"
                )
            routable = self._thin_ramping_locked(routable, request_ctx)
            fresh = [e for e in routable if e.url not in excluded]
            candidates = fresh or routable  # wrap once every replica tried
            last_candidate = len(fresh) <= 1
        fell_back = False
        last_open = None
        while True:
            if not candidates:
                if not fell_back and fresh and len(fresh) < len(routable):
                    # every fresh candidate is circuit-blocked: fall back
                    # to the already-tried remainder before giving up
                    candidates = [e for e in routable if e.url in excluded]
                    fell_back = True
                    last_candidate = True
                    continue
                with self._lock:
                    description = self._describe_locked()
                raise NoHealthyEndpointError(
                    "every routable endpoint is behind an open circuit: "
                    f"{description}"
                ) from last_open
            with self._lock:
                endpoint = self._policy.pick(candidates, request_ctx)
            try:
                # half-open single-probe gate: at most one caller gets
                # through a cooled-down open circuit
                endpoint.breaker.before_attempt()
            except CircuitOpenError as exc:
                last_open = exc
                candidates = [e for e in candidates if e is not endpoint]
                continue
            with self._lock:
                endpoint.inflight += 1
            lease = Lease(self, endpoint, last_candidate)
            break
        _notify(self.observer, "on_route", lease.url)
        return lease

    def pick(self, request_ctx=None):
        """Policy pick WITHOUT lease accounting — for external assignment
        (e.g. binding perf workers to replicas).  Skips endpoints that are
        unhealthy, non-ACTIVE, or behind a currently-open circuit; raises
        :class:`NoHealthyEndpointError` when none qualify."""
        with self._lock:
            candidates = [
                e for e in self._routable_locked()
                if e.breaker.state != CircuitBreaker.OPEN
            ]
            if not candidates:
                raise NoHealthyEndpointError(
                    f"no endpoint is routable: {self._describe_locked()}"
                )
            candidates = self._thin_ramping_locked(candidates, request_ctx)
            return self._policy.pick(candidates, request_ctx)

    def _describe_locked(self):
        return ", ".join(
            f"{e.url}={e.state}/{e.phase}/{e.breaker.state}"
            for e in self._endpoints
        )

    # -- outcome accounting (Lease callbacks) --------------------------------

    def _release(self, endpoint):
        """Outcome-free inflight release (Lease.release)."""
        events = []
        with self._lock:
            endpoint.inflight = max(endpoint.inflight - 1, 0)
            self._maybe_evict_locked(endpoint, events)
        self._deliver_events(events)

    def _maybe_evict_locked(self, endpoint, events):
        """Evict a drained RETIRING endpoint the moment its last in-flight
        lease releases (caller holds the pool lock)."""
        if (
            endpoint.phase == PHASE_RETIRING
            and endpoint.inflight <= 0
            and any(e is endpoint for e in self._endpoints)
        ):
            self._endpoints[:] = [
                e for e in self._endpoints if e is not endpoint
            ]
            events.append(("on_membership", ("evict", endpoint.url)))
            events.append(("on_pool_size", self._sizes_locked()))

    def _complete(self, endpoint, ok, exc=None, retryable=True):
        transition = None
        events = []
        with self._lock:
            endpoint.inflight = max(endpoint.inflight - 1, 0)
            if ok:
                endpoint.last_error = None
                if endpoint.state != SERVER_READY:
                    endpoint.state = SERVER_READY
                    endpoint._state_seq += 1
                    transition = (endpoint, SERVER_READY, endpoint._state_seq)
            else:
                endpoint.last_error = exc
                # UNREACHABLE needs BOTH: a connection-level failure (an
                # answered 429/503 means the server is alive — overloaded
                # or draining, never "dead") and an active prober to bring
                # the endpoint back; with no prober the breaker's
                # open/half-open cycle is the sole (self-recovering) gate.
                if (
                    retryable
                    and is_connection_level(exc)
                    and self._probe is not None
                    and endpoint.state == SERVER_READY
                ):
                    endpoint.state = SERVER_UNREACHABLE
                    endpoint._state_seq += 1
                    transition = (
                        endpoint, SERVER_UNREACHABLE, endpoint._state_seq
                    )
            self._maybe_evict_locked(endpoint, events)
        # Breaker accounting outside the pool lock (the breaker has its
        # own).  A non-retryable application error means the endpoint
        # answered — evidence of health, never a circuit strike.
        if ok or not retryable:
            endpoint.breaker.record_success()
        else:
            endpoint.breaker.record_failure()
        if not ok and retryable:
            _notify(self.observer, "on_failover", endpoint.url)
        if transition is not None:
            self._deliver_state(*transition)
        self._deliver_events(events)
