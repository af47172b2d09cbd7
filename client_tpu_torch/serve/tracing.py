"""Server-side request tracing: per-request timelines behind trace_settings.

Counterpart of client_tpu/serve/tracing.py.  The engine owns one
:class:`Tracer`; the HTTP frontend samples a :class:`RequestTrace` per
inference request (joining the client's trace id when a ``traceparent``
header arrives) and the engine and dynamic batcher record the timeline:

    REQUEST_START -> QUEUE_START -> QUEUE_END -> COMPUTE_START ->
    COMPUTE_INPUT_END -> COMPUTE_OUTPUT_START -> COMPUTE_END ->
    RESPONSE_SENT

(the timestamp names Triton's trace API emits for its queue/compute
breakdown; batched requests get their QUEUE_END/COMPUTE_* from the
batcher at dispatch/completion time).

Sampling honors the engine's ``trace_settings`` exactly as the reference
trace extension defines them: ``trace_level`` ([\"OFF\"] disables),
``trace_rate`` (trace the first of every N requests), ``trace_count``
(budget of traces, -1 unlimited, resets when updated), ``trace_file``
(JSON-lines export, one Triton-shaped record per trace) and
``log_frequency`` (buffer N records between file flushes; 0 flushes per
trace).

Every timestamp is the host's clock.  A span around work on the card
times its dispatch (a CUDA graph replay, a kernel launch), not the
device's execution, which may still run when the span ends.  The fleet
tier's spans are the reference's: a peer RPC's span (``peer_span``) as a
child of the request it serves, the peer server's (``serve_span``) under
the traceparent the frame carried, and a resumed sequence's marker
(``resume_span``) continuing the trace id its snapshot carried.
"""

import collections
import contextlib
import threading
import time

from client_tpu_torch.tracing import (
    SpanBase,
    append_trace_record,
    format_traceparent,
    gen_span_id,
    gen_trace_id,
    parse_traceparent,
)
from client_tpu_torch.utils import InferenceServerException

__all__ = [
    "RequestTrace",
    "Tracer",
    "TRACE_SETTING_DEFAULTS",
    "current_trace",
    "normalize_trace_settings",
    "push_trace",
]

# The request trace active on THIS thread (the engine brackets execute()
# with push_trace).  The fleet tier reads it so a peer RPC issued while
# serving a traced request records a child span under the request's trace
# id — no plumbing of the trace object through every call layer.
_ACTIVE = threading.local()


def current_trace():
    """The RequestTrace the current thread is serving, or None."""
    return getattr(_ACTIVE, "trace", None)


@contextlib.contextmanager
def push_trace(trace):
    """Install *trace* (may be None) as this thread's active request
    trace for the duration of the block; always restores the previous
    one (nested ensemble steps re-enter the engine on the same thread)."""
    prev = getattr(_ACTIVE, "trace", None)
    _ACTIVE.trace = trace
    try:
        yield trace
    finally:
        _ACTIVE.trace = prev


TRACE_LEVELS = ("OFF", "TIMESTAMPS", "TENSORS")

TRACE_SETTING_DEFAULTS = {
    "trace_file": "",
    "trace_level": ["OFF"],
    "trace_rate": "1000",
    "trace_count": "-1",
    "log_frequency": "0",
}

_INT_KEYS = ("trace_rate", "trace_count", "log_frequency")


def normalize_trace_settings(updates):
    """Canonicalize a trace-settings update to the wire schema:
    ``trace_level`` is a list of level names, every numeric setting is the
    decimal *string* of an int, and ``trace_file`` is a string.  Raises a
    400 on malformed values so a bad update is rejected rather than
    half-applied."""
    normalized = {}
    for key, value in (updates or {}).items():
        if value is None:
            continue  # present-but-empty: leave the current value alone
        if key == "trace_level":
            levels = value if isinstance(value, (list, tuple)) else [value]
            levels = [str(lv).upper() for lv in levels]
            bad = [lv for lv in levels if lv not in TRACE_LEVELS]
            if bad or not levels:
                raise InferenceServerException(
                    f"invalid trace_level {bad or levels}: levels are "
                    f"{list(TRACE_LEVELS)}",
                    status="400",
                )
            normalized[key] = levels
        elif key in _INT_KEYS:
            if isinstance(value, (list, tuple)):
                value = value[0] if value else ""
            try:
                normalized[key] = str(int(str(value)))
            except ValueError:
                raise InferenceServerException(
                    f"invalid {key} {value!r}: expected an integer",
                    status="400",
                ) from None
        elif key == "trace_file":
            if isinstance(value, (list, tuple)):
                value = value[0] if value else ""
            normalized[key] = str(value)
        else:
            raise InferenceServerException(
                f"unknown trace setting {key!r}", status="400"
            )
    return normalized


class RequestTrace(SpanBase):
    """One traced server-side request (a span joined to the client's
    trace id when the request carried a traceparent)."""

    def __init__(self, trace_id, span_id, parent_span_id=None,
                 model_name="", model_version="", protocol="", seq=0,
                 step="", ensemble=""):
        super().__init__(trace_id, span_id, model_name)
        self.parent_span_id = parent_span_id
        self.model_version = model_version
        self.protocol = protocol
        self.seq = seq
        # tenant identity (x-tenant-id header), stamped by the engine so
        # per-tenant latency can be split straight from traces
        self.tenant = ""
        # ensemble step tags (serve/pipeline.py): one child span per DAG
        # step, tagged with the step label and the owning ensemble
        self.step = step
        self.ensemble = ensemble
        # free-form key/value tags (peer url, bytes, breaker state,
        # hit/miss, resume provenance), exported verbatim
        self.tags = {}

    def traceparent(self):
        return format_traceparent(self.trace_id, self.span_id)

    def to_json(self):
        record = {
            "id": self.seq,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "source": "server",
            "protocol": self.protocol,
            "model_name": self.model_name,
            "model_version": self.model_version,
            "timestamps": list(self.timestamps),
        }
        if self.tenant:
            record["tenant"] = self.tenant
        if self.step:
            record["step"] = self.step
            record["composing_model"] = self.model_name
        if self.ensemble:
            record["ensemble"] = self.ensemble
        if self.tags:
            record["tags"] = dict(self.tags)
        if self.error:
            record["error"] = self.error
        return record


class Tracer:
    """Samples, collects, and exports per-request server traces.

    Reads the engine's live ``trace_settings`` dict on every sample so
    settings updates apply immediately; thread-safe (frontend handler
    threads sample concurrently)."""

    def __init__(self, settings, max_traces=1000):
        self._settings = settings  # the engine's live trace_settings dict
        self._lock = threading.Lock()
        self._seen = 0
        self._used = 0  # traces taken against the trace_count budget
        self._seq = 0
        self._pending_flush = []
        self.completed = collections.deque(maxlen=max_traces)
        # scheduler tick spans live apart from request traces: they fire
        # hundreds of times a second and must not evict request spans
        self._tick_seen = 0
        self.tick_completed = collections.deque(maxlen=max_traces)
        # fleet peer-RPC child spans (client side of prefix/cache/seq
        # lookups, durability pushes, anti-entropy) and the peer-server
        # side's serve spans — bounded apart from request spans for the
        # same reason as ticks
        self.peer_completed = collections.deque(maxlen=max_traces)
        # completion hook (the engine points it at the flight recorder so
        # every finished span lands in the postmortem ring even when no
        # trace_file is configured); called OUTSIDE the tracer lock
        self.on_complete = None

    def enabled(self):
        levels = self._settings.get("trace_level") or ["OFF"]
        return any(str(lv).upper() != "OFF" for lv in levels)

    def reset_budget(self):
        """Restart the trace_count budget (called when the setting is
        updated, matching the reference trace API's count semantics)."""
        with self._lock:
            self._used = 0

    @staticmethod
    def _int_setting(settings, key, default):
        try:
            return int(str(settings.get(key, default)))
        except (TypeError, ValueError):
            return default

    def sample(self, traceparent=None, model_name="", model_version="",
               protocol=""):
        """A RequestTrace for this request, or None (tracing off, request
        not sampled, or budget exhausted)."""
        if not self.enabled():
            return None
        rate = max(self._int_setting(self._settings, "trace_rate", 1), 1)
        count = self._int_setting(self._settings, "trace_count", -1)
        with self._lock:
            seen = self._seen
            self._seen += 1
            if seen % rate:
                return None
            if 0 <= count <= self._used:
                return None
            self._used += 1
            self._seq += 1
            seq = self._seq
        parent = parse_traceparent(traceparent)
        if parent is not None:
            trace_id, parent_span = parent
        else:
            trace_id, parent_span = gen_trace_id(), None
        return RequestTrace(
            trace_id, gen_span_id(), parent_span_id=parent_span,
            model_name=model_name, model_version=model_version,
            protocol=protocol, seq=seq,
        )

    def complete(self, trace):
        """Record a finished trace; export per log_frequency."""
        if trace is None:
            return
        self._complete_into(trace, self.completed)

    def _complete_into(self, trace, store):
        """Shared completion tail for request and tick spans: append to
        *store* and batch-flush to the trace file per log_frequency."""
        trace_file = self._settings.get("trace_file") or ""
        log_frequency = max(
            self._int_setting(self._settings, "log_frequency", 0), 0
        )
        to_write = []
        with self._lock:
            store.append(trace)
            if trace_file:
                self._pending_flush.append(trace.to_json())
                if len(self._pending_flush) >= max(log_frequency, 1):
                    to_write = self._pending_flush
                    self._pending_flush = []
        self._write(trace_file, to_write)
        on_complete = self.on_complete
        if on_complete is not None:
            try:
                on_complete(trace)
            except Exception:
                pass  # observability must never fail the request path

    def tick_span(self, kind, t0, t1):
        """One continuous-batching scheduler tick as a completed COMPUTE
        span under the synthetic model name ``__lm_<kind>__`` (kinds:
        ``decode``, ``prefill_chunk``, ``verify``, ``draft``).  ``t0``/``t1`` are
        monotonic seconds; the span is stamped onto the wall clock ending
        now, so tick spans interleave with request spans in the exported
        trace file.

        Host time: on the card a tick dispatches a CUDA graph replay and
        returns; its device work ends up to ``readback_depth`` ticks
        later, after this span has closed (the JAX engine's spans do the
        same under async dispatch).  The span reads host state only: no
        device call, no sync.

        Ticks subsample on ``trace_rate`` with their OWN counter and land
        in ``tick_completed``: decode ticks fire hundreds of times per
        second, so sharing the request path's ``trace_count`` budget or
        its bounded ``completed`` deque would exhaust the budget (and
        evict every real request trace) within seconds."""
        if not self.enabled():
            return
        rate = max(self._int_setting(self._settings, "trace_rate", 1), 1)
        with self._lock:
            seen = self._tick_seen
            self._tick_seen += 1
            if seen % rate:
                return
            self._seq += 1
            seq = self._seq
        span = RequestTrace(
            gen_trace_id(), gen_span_id(),
            model_name=f"__lm_{kind}__", seq=seq,
        )
        now = time.time_ns()
        span.event("COMPUTE_START", now - int((t1 - t0) * 1e9))
        span.event("COMPUTE_END", now)
        self._complete_into(span, self.tick_completed)

    def _span_seq(self):
        with self._lock:
            self._seq += 1
            return self._seq

    @contextlib.contextmanager
    def peer_span(self, op, peer="", **tags):
        """Bracket one fleet peer RPC with PEER_START/PEER_END.

        A request-thread peer call (prefix/cache/sequence lookup, the
        synchronous durability push) records a CHILD span under the
        thread's active request trace, so a peer fetch shows inside the
        originating request's timeline.  Off-request callers (the
        anti-entropy thread) get a standalone span with its own trace id,
        subsampled on ``trace_rate`` with the tick counter so background
        pushes never drain the request budget.  Yields the span (or None
        when nothing records); callers stamp result tags onto
        ``span.tags`` before the block exits."""
        parent = current_trace()
        if parent is not None:
            span = RequestTrace(
                parent.trace_id, gen_span_id(),
                parent_span_id=parent.span_id,
                model_name=f"__peer_{op}__", protocol="fleet",
                seq=self._span_seq(),
            )
        elif self.enabled():
            rate = max(
                self._int_setting(self._settings, "trace_rate", 1), 1
            )
            with self._lock:
                seen = self._tick_seen
                self._tick_seen += 1
            if seen % rate:
                span = None
            else:
                span = RequestTrace(
                    gen_trace_id(), gen_span_id(),
                    model_name=f"__peer_{op}__", protocol="fleet",
                    seq=self._span_seq(),
                )
        else:
            span = None
        if span is None:
            yield None
            return
        span.tags["op"] = op
        if peer:
            span.tags["peer"] = peer
        span.tags.update(tags)
        span.event("PEER_START")
        try:
            yield span
        except Exception as e:
            span.error = str(e)
            raise
        finally:
            span.event("PEER_END")
            self._complete_into(span, self.peer_completed)

    @contextlib.contextmanager
    def serve_span(self, op, traceparent=None, **tags):
        """The peer-server half of a fleet RPC: a span under the CALLING
        replica's trace id when the frame carried a traceparent — the
        receipt that joins a cross-replica fetch into one trace spanning
        both processes.  Frames with no trace context record nothing
        (the caller decided not to sample)."""
        parent = parse_traceparent(traceparent)
        if parent is None:
            yield None
            return
        span = RequestTrace(
            parent[0], gen_span_id(), parent_span_id=parent[1],
            model_name=f"__peer_{op}__", protocol="fleet",
            seq=self._span_seq(),
        )
        span.tags["op"] = op
        span.tags["side"] = "serve"
        span.tags.update(tags)
        span.event("COMPUTE_START")
        try:
            yield span
        except Exception as e:
            span.error = str(e)
            raise
        finally:
            span.event("COMPUTE_END")
            self._complete_into(span, self.peer_completed)

    def resume_span(self, traceparent, seq_id, **tags):
        """One SEQ_RESUME marker span CONTINUING a replicated snapshot's
        trace id: a survivor resuming a dead replica's durable sequence
        stamps the resume into the ORIGINATING trace, so the failover
        reads as one trace spanning the dead and surviving processes.
        No-op (returns None) when the snapshot carried no trace context."""
        parent = parse_traceparent(traceparent)
        if parent is None:
            return None
        span = RequestTrace(
            parent[0], gen_span_id(), parent_span_id=parent[1],
            model_name="__seq_resume__", protocol="fleet",
            seq=self._span_seq(),
        )
        span.tags["sequence_id"] = seq_id
        span.tags.update(tags)
        span.event("SEQ_RESUME")
        self._complete_into(span, self.peer_completed)
        return span

    def flush(self):
        """Force any buffered records to the trace file (engine close)."""
        trace_file = self._settings.get("trace_file") or ""
        with self._lock:
            to_write = self._pending_flush
            self._pending_flush = []
        self._write(trace_file, to_write)

    @staticmethod
    def _write(trace_file, records):
        if not trace_file or not records:
            return
        try:
            for record in records:
                append_trace_record(trace_file, record)
        except OSError:
            pass  # tracing must never fail the request path
