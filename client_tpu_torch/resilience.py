"""Circuit breakers and connection-level error classification.

Counterpart of the breaker half of client_tpu/resilience.py:
:class:`CircuitBreaker` (per-endpoint closed -> open -> half-open),
:class:`CircuitBreakerRegistry`, :class:`CircuitOpenError`,
:func:`is_connection_error` and :func:`is_connection_level`, copied from
the reference onto the port's own ``InferenceServerException``.  The
fleet tier (serve/fleet.py) puts every peer behind one breaker, and the
server's coalescer tells a dead leader's transport error from an
answered one with :func:`is_connection_level`.  The retry, deadline and
failover policies stay with the JAX package's clients.

**Circuit breaker**: per-endpoint closed -> open -> half-open.  After
``failure_threshold`` consecutive failures the breaker opens and calls
fail fast (no socket work) for ``reset_timeout_s``; then exactly one
probe is allowed through (half-open) and its outcome closes or re-opens
the circuit.  Never share one breaker across endpoints.

All deadlines are computed from ``time.monotonic()``.
"""

import asyncio
import collections
import threading
import time

from client_tpu_torch.utils import InferenceServerException

__all__ = [
    "CircuitBreaker",
    "CircuitBreakerRegistry",
    "CircuitOpenError",
    "is_connection_error",
    "is_connection_level",
]


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
