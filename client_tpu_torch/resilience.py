"""Circuit breakers, retry policies and connection-level error
classification.

Counterpart of client_tpu/resilience.py: :class:`CircuitBreaker` (per-endpoint
closed -> open -> half-open), :class:`CircuitBreakerRegistry`,
:class:`CircuitOpenError`, :func:`is_connection_error` and
:func:`is_connection_level`, and the retry half the clients route their
unary calls through: :func:`combine_timeouts`, :class:`Deadline`,
:class:`RetryPolicy`, :func:`backoff_delays`, :func:`call_with_retry`
(client_tpu_torch/grpc and http) and its asyncio twin
:func:`acall_with_retry` (client_tpu_torch/grpc/aio and http/aio),
and the failover half the replica-set router (``balance/``) routes its
calls through: :class:`NoHealthyEndpointError`,
:func:`call_with_failover` and :func:`acall_with_failover`, copied from
the reference onto the port's own ``InferenceServerException``.  The fleet tier (serve/fleet.py) puts
every peer behind one breaker, and the server's coalescer tells a dead
leader's transport error from an answered one with
:func:`is_connection_level`.

**Retry**: exponential backoff with full jitter (attempt ``k`` sleeps
``uniform(0, min(max_backoff, initial * multiplier**k))``); connection
failures and overload statuses (HTTP 429/503, gRPC
``UNAVAILABLE``/``RESOURCE_EXHAUSTED``/``DEADLINE_EXCEEDED``) retry,
application errors never do; a server's Retry-After hint overrides the
backoff, capped at ``max_backoff_s``; one :class:`Deadline` caps the
total wall time across attempts.

**Circuit breaker**: per-endpoint closed -> open -> half-open.  After
``failure_threshold`` consecutive failures the breaker opens and calls
fail fast (no socket work) for ``reset_timeout_s``; then exactly one
probe is allowed through (half-open) and its outcome closes or re-opens
the circuit.  Never share one breaker across endpoints.

All deadlines are computed from ``time.monotonic()``.
"""

import asyncio
import collections
import random
import threading
import time

from client_tpu_torch.utils import InferenceServerException

__all__ = [
    "RetryPolicy",
    "Deadline",
    "CircuitBreaker",
    "CircuitBreakerRegistry",
    "CircuitOpenError",
    "NoHealthyEndpointError",
    "acall_with_retry",
    "call_with_retry",
    "is_connection_error",
    "is_connection_level",
    "backoff_delays",
    "combine_timeouts",
    "call_with_failover",
    "acall_with_failover",
]


def combine_timeouts(a, b):
    """Tighter of two optional timeouts in seconds (None = unbounded)."""
    if a is None:
        return b
    if b is None:
        return a
    return min(a, b)


# Overload / transient statuses worth retrying.  HTTP codes arrive as
# decimal strings; gRPC codes as StatusCode names.  DEADLINE_EXCEEDED is
# the gRPC spelling of a per-attempt timeout: retryable, with the attempt
# budget and the policy Deadline bounding the total spend.
RETRYABLE_STATUSES = frozenset(
    {"429", "503", "UNAVAILABLE", "RESOURCE_EXHAUSTED", "DEADLINE_EXCEEDED"}
)


# Transport exception types whose module marks them as connection-level.
# Checked by module prefix so this module imports neither urllib3, aiohttp,
# nor grpc (transport-agnostic; any subset may be absent at runtime).
_CONN_MODULE_PREFIXES = ("urllib3", "aiohttp", "http.client", "grpc")


def is_connection_error(exc):
    """Whether *exc* is a connection-level transport failure.

    Covers OSError (refused/reset/unreachable), timeouts, and the
    transport libraries' wrapper hierarchies (urllib3 ProtocolError et al.
    do not derive from OSError).
    """
    if isinstance(exc, (ConnectionError, TimeoutError, OSError)):
        return True
    if isinstance(exc, (asyncio.TimeoutError, EOFError)):
        return True
    mod = type(exc).__module__ or ""
    return mod.startswith(_CONN_MODULE_PREFIXES)


def is_connection_level(exc):
    """Connection-level classification across wrapped and bare transport
    exceptions: the endpoint never answered (dead/partitioned), as opposed
    to an answered error (overload shed, drain, application failure).  The
    one classifier shared by retry decisions and the replica-set pool's
    UNREACHABLE marking."""
    if exc is None:
        return False
    if isinstance(exc, InferenceServerException):
        details = exc.debug_details()
        return details is not None and is_connection_error(details)
    return is_connection_error(exc)


class CircuitOpenError(InferenceServerException):
    """Fast-fail raised while a circuit breaker is open.

    Subclasses InferenceServerException so callers' existing error handling
    sees the familiar type; ``status`` is the retryable 503 so a *different*
    endpoint's policy layered above may still route around it.
    """

    def __init__(self, msg):
        super().__init__(msg=msg, status="503")


class NoHealthyEndpointError(InferenceServerException):
    """Raised when a replica-set router has no endpoint to offer.

    Every endpoint is drained, unreachable, or behind an open circuit.
    ``status`` is the retryable 503: the condition is transient by
    construction (circuits half-open, drained replicas come back), so a
    retry layer above may keep backing off into the router.
    """

    def __init__(self, msg):
        super().__init__(msg=msg, status="503")


class Deadline:
    """A monotonic wall-time budget shared across retry attempts.

    ``remaining()`` is what is left; ``attempt_timeout(cap)`` derives one
    attempt's transport timeout (never exceeding the budget, optionally
    capped by the caller's own per-try timeout).
    """

    def __init__(self, budget_s):
        if budget_s is None or budget_s <= 0:
            raise ValueError(f"deadline budget must be positive, got {budget_s!r}")
        self.budget_s = float(budget_s)
        self._expires = time.monotonic() + self.budget_s

    def remaining(self):
        return self._expires - time.monotonic()

    def expired(self):
        return self.remaining() <= 0

    def attempt_timeout(self, cap=None):
        """Per-attempt transport timeout from the remaining budget."""
        remaining = max(self.remaining(), 0.0)
        if cap is not None:
            return min(remaining, cap)
        return remaining


def _notify(observer, method, *args):
    """Invoke an optional observer hook; observers are best-effort and
    must never break the call path (or a lock-free state transition)."""
    if observer is None:
        return
    fn = getattr(observer, method, None)
    if fn is None:
        return
    try:
        fn(*args)
    except Exception:
        pass


class _SerialDeliverer:
    """Ordered observer delivery with NO lock held during the callback.

    The old scheme serialized deliveries by holding a ``_notify_lock``
    across the observer call — which handed third-party code a private,
    non-reentrant lock: an observer that triggered another transition
    (or looked back at an object that does) deadlocked on it
    (CALLBACK-UNDER-LOCK).  This replaces it with a FIFO queue + single
    drainer: posters enqueue under a tiny mutex; whichever thread finds
    no drainer active becomes one and delivers queued items with the
    mutex RELEASED, so total order is preserved (one drainer at a time,
    FIFO queue) while observers run lock-free.

    ``post(deliver, accept=None)``: *accept* (optional) runs under the
    mutex at dequeue time and may veto the delivery — the stale-transition
    drop (a preempted thread's older state change must not be delivered
    after a newer one) keeps its exact semantics, because the accept check
    happens in delivery order, not post order.
    """

    __slots__ = ("_mu", "_queue", "_draining")

    def __init__(self):
        self._mu = threading.Lock()
        self._queue = collections.deque()
        self._draining = False

    def post(self, deliver, accept=None):
        with self._mu:
            self._queue.append((deliver, accept))
            if self._draining:
                return  # the active drainer will deliver this, in order
            self._draining = True
        try:
            while True:
                with self._mu:
                    if not self._queue:
                        self._draining = False
                        return
                    deliver, accept = self._queue.popleft()
                    ok = accept is None or accept()
                if ok:
                    deliver()
        except BaseException:
            # a raising deliver/accept must not latch _draining forever
            # (every later post would enqueue into a queue nobody drains);
            # items already queued wait for the next post to drain them
            with self._mu:
                self._draining = False
            raise  # observer code: no lock of ours is held


class CircuitBreaker:
    """Per-endpoint circuit breaker: closed → open → half-open.

    Thread-safe (one lock, no blocking inside it), usable from both the
    sync clients and coroutine code.  ``before_attempt()`` raises
    :class:`CircuitOpenError` while open; after ``reset_timeout_s`` one
    probe passes (half-open) and its outcome decides the next state.

    ``observer`` (optional) receives ``on_state_change(old, new)`` on
    every transition — outside the breaker lock — so metrics (e.g.
    ``client_tpu.serve.metrics.ResilienceMetricsObserver``) and logging
    can watch the circuit without touching its hot path.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(self, failure_threshold=5, reset_timeout_s=30.0, name="",
                 observer=None):
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self.name = name
        self.observer = observer
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False  # a half-open probe is in flight
        # Transition delivery: stamped under _lock, delivered outside it
        # through the serial deliverer, stale deliveries dropped — so a
        # preempted thread can never report an older transition after a
        # newer one (which would wedge a state gauge at the wrong value),
        # and the observer runs with NO breaker lock held (an observer
        # that reads .state or trips another transition must not deadlock).
        self._transition_seq = 0
        self._delivered_seq = 0
        self._deliverer = _SerialDeliverer()

    @property
    def state(self):
        with self._lock:
            return self._state

    def _fast_fail(self):
        raise CircuitOpenError(
            f"circuit breaker{f' {self.name!r}' if self.name else ''} "
            f"is open ({self._failures} consecutive failures); "
            f"fast-failing for {self.reset_timeout_s:g}s"
        )

    def _deliver(self, seq, old, new):
        """Deliver one stamped transition, dropping it if a newer one was
        already delivered (a preempted thread must not overwrite a fresher
        observer state — e.g. park a circuit-state gauge at 'open' after
        the breaker already closed again).  The accept check runs in
        delivery order inside the deliverer's mutex; the observer call
        itself runs outside every lock."""
        if seq is None:
            return

        def accept():
            if seq <= self._delivered_seq:
                return False
            self._delivered_seq = seq
            return True

        self._deliverer.post(
            lambda: _notify(self.observer, "on_state_change", old, new),
            accept,
        )

    def before_attempt(self):
        """Gate one attempt; raises CircuitOpenError without touching the
        network while the circuit is open and the cooldown has not passed.
        After the cooldown exactly ONE probe passes — concurrent callers
        keep fast-failing until that probe's outcome is recorded (no
        thundering herd onto a recovering endpoint)."""
        transition = None
        with self._lock:
            if self._state == self.OPEN:
                if time.monotonic() - self._opened_at < self.reset_timeout_s:
                    self._fast_fail()
                self._transition_seq += 1
                transition = (self._transition_seq, self._state, self.HALF_OPEN)
                self._state = self.HALF_OPEN
                self._probing = True
            elif self._state == self.HALF_OPEN and self._probing:
                self._fast_fail()
        if transition is not None:
            self._deliver(*transition)

    def record_success(self):
        transition = None
        with self._lock:
            old = self._state
            self._failures = 0
            self._state = self.CLOSED
            self._probing = False
            if old != self.CLOSED:
                self._transition_seq += 1
                transition = (self._transition_seq, old, self.CLOSED)
        if transition is not None:
            self._deliver(*transition)

    def record_failure(self):
        transition = None
        with self._lock:
            old = self._state
            self._failures += 1
            self._probing = False
            if self._state == self.HALF_OPEN or self._failures >= self.failure_threshold:
                self._state = self.OPEN
                self._opened_at = time.monotonic()
                if old != self.OPEN:
                    self._transition_seq += 1
                    transition = (self._transition_seq, old, self.OPEN)
        if transition is not None:
            self._deliver(*transition)


class CircuitBreakerRegistry:
    """Per-endpoint :class:`CircuitBreaker` instances sharing one config.

    A replica set needs one breaker *per endpoint* (sharing a breaker
    across endpoints would let one dead replica open the circuit against
    its healthy peers); this registry creates them on demand, keyed by the
    endpoint string, all with the same thresholds.

    ``observer_factory(endpoint)`` (optional) builds the per-endpoint
    observer each new breaker is born with — e.g.
    ``client_tpu.serve.metrics.ResilienceMetricsObserver`` so every
    endpoint's circuit state lands on /metrics under its own label.
    """

    def __init__(self, failure_threshold=5, reset_timeout_s=30.0,
                 observer_factory=None):
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self._observer_factory = observer_factory
        self._lock = threading.Lock()
        self._breakers = {}

    def get(self, endpoint):
        with self._lock:
            breaker = self._breakers.get(endpoint)
            if breaker is None:
                observer = (
                    self._observer_factory(endpoint)
                    if self._observer_factory is not None
                    else None
                )
                breaker = CircuitBreaker(
                    failure_threshold=self.failure_threshold,
                    reset_timeout_s=self.reset_timeout_s,
                    name=endpoint,
                    observer=observer,
                )
                self._breakers[endpoint] = breaker
            return breaker

    def states(self):
        """{endpoint: state} snapshot (the state reads take each breaker's
        own lock; the registry lock only guards the dict)."""
        with self._lock:
            breakers = dict(self._breakers)
        return {endpoint: b.state for endpoint, b in breakers.items()}


class RetryPolicy:
    """Retry/backoff/deadline policy for one client's unary calls.

    Parameters
    ----------
    max_attempts : total tries including the first (1 = no retry).
    initial_backoff_s, backoff_multiplier, max_backoff_s : the exponential
        schedule jittered by ``jitter``.
    jitter : True for full jitter (uniform(0, delay)); False for the bare
        exponential (deterministic — useful in tests).
    retryable_statuses : status strings (HTTP codes / gRPC code names)
        classified retryable in addition to connection errors.
    deadline_s : total wall-time budget across attempts (None = unbounded).
    circuit_breaker : optional CircuitBreaker shared by calls through this
        policy.
    observer : optional hook object; any subset of ``on_backoff(attempt,
        delay_s, exc)`` (a retry is about to sleep), ``on_giveup(attempt,
        exc)`` (the policy stopped retrying), and ``on_success(attempt)``
        is called — best-effort, never on the raising path's stack state.
    """

    def __init__(
        self,
        max_attempts=4,
        initial_backoff_s=0.05,
        backoff_multiplier=2.0,
        max_backoff_s=2.0,
        jitter=True,
        retryable_statuses=RETRYABLE_STATUSES,
        deadline_s=None,
        circuit_breaker=None,
        rng=None,
        observer=None,
    ):
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.max_attempts = int(max_attempts)
        self.initial_backoff_s = float(initial_backoff_s)
        self.backoff_multiplier = float(backoff_multiplier)
        self.max_backoff_s = float(max_backoff_s)
        self.jitter = bool(jitter)
        self.retryable_statuses = frozenset(retryable_statuses)
        self.deadline_s = deadline_s
        self.circuit_breaker = circuit_breaker
        self.observer = observer
        self._rng = rng or random.Random()

    # -- classification ----------------------------------------------------

    def retryable(self, exc):
        """Whether one failed attempt is worth retrying."""
        if isinstance(exc, CircuitOpenError):
            return False  # fast-fail is the point; do not spin on the breaker
        if isinstance(exc, InferenceServerException):
            status = exc.status()
            if status is not None:
                return str(status) in self.retryable_statuses
        return is_connection_level(exc)

    # -- schedule ----------------------------------------------------------

    def backoff_s(self, attempt):
        """Sleep before retry number *attempt* (0-based)."""
        delay = min(
            self.max_backoff_s,
            self.initial_backoff_s * (self.backoff_multiplier ** attempt),
        )
        if self.jitter:
            delay = self._rng.uniform(0.0, delay)
        return delay

    def delay_for(self, exc, attempt):
        """Backoff for this retry, honoring the server's Retry-After hint
        (capped at max_backoff_s — a bad hint must not park the client)."""
        hint = getattr(exc, "retry_after_s", None)
        if hint is not None:
            try:
                return min(float(hint), self.max_backoff_s)
            except (TypeError, ValueError):
                pass
        return self.backoff_s(attempt)

    def new_deadline(self):
        return Deadline(self.deadline_s) if self.deadline_s else None


def backoff_delays(initial_s=0.05, multiplier=2.0, max_s=2.0, rng=None):
    """Infinite generator of full-jitter exponential delays.

    The reusable loop shape for ad-hoc retry sites (e.g. the perf
    rendezvous connect loop) that don't need the full policy object.
    """
    rng = rng or random.Random()
    delay = initial_s
    while True:
        yield rng.uniform(0.0, delay)
        delay = min(delay * multiplier, max_s)


def _record_outcome(breaker, retryable):
    """Breaker accounting for one failed attempt: only transport/overload
    failures count against the circuit.  A non-retryable application error
    (bad input, unknown model) means the endpoint answered — that is
    evidence of health, and must not open the circuit against a healthy
    server (or strand a half-open probe)."""
    if breaker is None:
        return
    if retryable:
        breaker.record_failure()
    else:
        breaker.record_success()


def _next_step(policy, deadline, exc, attempt, retryable):
    """Shared retry decision: returns the backoff sleep, or raises *exc*
    when the classification, attempt budget, or deadline budget says stop."""
    if not retryable or attempt + 1 >= policy.max_attempts:
        _notify(policy.observer, "on_giveup", attempt, exc)
        raise exc
    delay = policy.delay_for(exc, attempt)
    if deadline is not None:
        remaining = deadline.remaining()
        # a backoff that would outlive the budget is a guaranteed-dead
        # retry: surface the real error now instead of sleeping into it
        if remaining <= 0 or delay >= remaining:
            _notify(policy.observer, "on_giveup", attempt, exc)
            raise exc
    _notify(policy.observer, "on_backoff", attempt, delay, exc)
    return delay


def call_with_retry(fn, policy):
    """Run ``fn(attempt_timeout_s_or_None)`` under *policy* (sync).

    *fn* receives the per-attempt transport timeout derived from the
    policy's deadline (None when the policy has no deadline) and must raise
    on failure — including application-level retryable statuses the caller
    wants retried (e.g. an HTTP 503 response mapped to an exception).
    """
    deadline = policy.new_deadline()
    breaker = policy.circuit_breaker
    attempt = 0
    while True:
        if breaker is not None:
            breaker.before_attempt()
        try:
            result = fn(deadline.attempt_timeout() if deadline else None)
        except CircuitOpenError:
            raise
        except Exception as exc:
            retryable = policy.retryable(exc)
            _record_outcome(breaker, retryable)
            if breaker is not None and breaker.state == CircuitBreaker.OPEN:
                # this failure opened (or re-opened) the circuit: further
                # retries would only fast-fail after a pointless backoff —
                # surface the real error now
                _notify(policy.observer, "on_giveup", attempt, exc)
                raise
            delay = _next_step(policy, deadline, exc, attempt, retryable)
            attempt += 1
            time.sleep(delay)
        else:
            if breaker is not None:
                breaker.record_success()
            _notify(policy.observer, "on_success", attempt)
            return result


def _failover_step(policy, deadline, exc, attempt, retryable, fresh):
    """Retry decision for one failed *routed* attempt: returns the backoff
    sleep before the next attempt, or raises *exc* when the classification,
    attempt budget, or deadline budget says stop.

    ``fresh`` is True when the router still has an untried healthy replica
    for this request: the failover hop to it is immediate (sleeping in
    front of a different, healthy endpoint only adds latency).  Once the
    request has cycled through every candidate the normal backoff schedule
    applies — hammering replicas that all just failed is the retry storm
    the schedule exists to prevent."""
    if not retryable or attempt + 1 >= policy.max_attempts:
        _notify(policy.observer, "on_giveup", attempt, exc)
        raise exc
    delay = 0.0 if fresh else policy.delay_for(exc, attempt)
    if deadline is not None:
        remaining = deadline.remaining()
        if remaining <= 0 or (delay > 0 and delay >= remaining):
            _notify(policy.observer, "on_giveup", attempt, exc)
            raise exc
    _notify(policy.observer, "on_backoff", attempt, delay, exc)
    return delay


def call_with_failover(fn, policy, route):
    """Run one logical request under *policy*, rotating endpoints per attempt.

    The replica-set twin of :func:`call_with_retry`: instead of retrying one
    fixed endpoint, every attempt is routed —

    - ``route(excluded_keys)`` returns a *lease*: an object with ``key``
      (stable endpoint identity for exclusion), ``last_candidate`` (True
      when no other non-excluded healthy endpoint existed at pick time),
      and ``success()`` / ``failure(exc, retryable)`` outcome hooks (the
      router's inflight/breaker/health accounting).  It raises
      :class:`NoHealthyEndpointError` when nothing is routable.
    - ``fn(lease, attempt_timeout_s_or_None)`` performs one transport
      attempt against ``lease.endpoint`` and raises on failure.

    A failed attempt's endpoint is excluded from the next ``route()`` call,
    so a retry lands on a different healthy replica while one exists (and
    the hop is immediate — see :func:`_failover_step`); when every
    candidate has been tried the exclusions wrap and the backoff schedule
    takes over.  ``NoHealthyEndpointError`` from the router is itself
    retried on the schedule (circuits half-open, drained replicas return)
    until the attempt or deadline budget runs out.
    """
    deadline = policy.new_deadline()
    excluded = []
    attempt = 0
    last_exc = None
    while True:
        try:
            lease = route(tuple(excluded))
        except NoHealthyEndpointError as exc:
            if last_exc is not None:
                exc.__cause__ = last_exc
            delay = _failover_step(policy, deadline, exc, attempt,
                                   retryable=True, fresh=False)
            attempt += 1
            time.sleep(delay)
            excluded = []  # the endpoint set may have recovered: retry all
            continue
        try:
            result = fn(lease, deadline.attempt_timeout() if deadline else None)
        except Exception as exc:
            retryable = policy.retryable(exc)
            lease.failure(exc, retryable)
            last_exc = exc
            fresh = not lease.last_candidate
            if lease.key not in excluded:
                excluded.append(lease.key)
            else:  # wrapped onto an already-tried replica: restart rotation
                excluded = [lease.key]
            delay = _failover_step(policy, deadline, exc, attempt, retryable,
                                   fresh)
            attempt += 1
            if delay > 0:
                time.sleep(delay)
        else:
            lease.success()
            _notify(policy.observer, "on_success", attempt)
            return result


async def acall_with_failover(fn, policy, route):
    """Async twin of :func:`call_with_failover`; ``fn`` is a coroutine
    function ``fn(lease, timeout)``; ``route`` stays synchronous (endpoint
    selection never blocks)."""
    deadline = policy.new_deadline()
    excluded = []
    attempt = 0
    last_exc = None
    while True:
        try:
            lease = route(tuple(excluded))
        except NoHealthyEndpointError as exc:
            if last_exc is not None:
                exc.__cause__ = last_exc
            delay = _failover_step(policy, deadline, exc, attempt,
                                   retryable=True, fresh=False)
            attempt += 1
            await asyncio.sleep(delay)
            excluded = []
            continue
        try:
            result = await fn(
                lease, deadline.attempt_timeout() if deadline else None
            )
        except Exception as exc:
            retryable = policy.retryable(exc)
            lease.failure(exc, retryable)
            last_exc = exc
            fresh = not lease.last_candidate
            if lease.key not in excluded:
                excluded.append(lease.key)
            else:
                excluded = [lease.key]
            delay = _failover_step(policy, deadline, exc, attempt, retryable,
                                   fresh)
            attempt += 1
            if delay > 0:
                await asyncio.sleep(delay)
        else:
            lease.success()
            _notify(policy.observer, "on_success", attempt)
            return result


async def acall_with_retry(fn, policy):
    """Async twin of :func:`call_with_retry`; ``fn`` is a coroutine
    function taking the derived per-attempt timeout."""
    deadline = policy.new_deadline()
    breaker = policy.circuit_breaker
    attempt = 0
    while True:
        if breaker is not None:
            breaker.before_attempt()
        try:
            result = await fn(deadline.attempt_timeout() if deadline else None)
        except CircuitOpenError:
            raise
        except Exception as exc:
            retryable = policy.retryable(exc)
            _record_outcome(breaker, retryable)
            if breaker is not None and breaker.state == CircuitBreaker.OPEN:
                # failure opened the circuit: surface the real error now
                # instead of backing off into a guaranteed fast-fail
                _notify(policy.observer, "on_giveup", attempt, exc)
                raise
            delay = _next_step(policy, deadline, exc, attempt, retryable)
            attempt += 1
            await asyncio.sleep(delay)
        else:
            if breaker is not None:
                breaker.record_success()
            _notify(policy.observer, "on_success", attempt)
            return result
