"""Request tracing: W3C-style trace context + span records.

Counterpart of client_tpu/tracing.py: trace and span ids,
``traceparent`` parse and format, the JSON-lines trace-file writer and
reader, the span base class the server's ``RequestTrace``
(serve/tracing.py) extends, and the client half the gRPC client
(client_tpu_torch/grpc) takes as ``tracer=ClientTracer(...)``: a sampled
``infer`` records client-observed timestamps (request start, serialize
end, one ATTEMPT_START/ATTEMPT_END pair per transport attempt, request
end) and propagates a ``traceparent`` in its gRPC metadata, so the
server's span joins the client's under one trace id.

Trace files are newline-delimited JSON records (one object per line, the
Triton trace-record shape: ids + a ``timestamps`` list of {name, ns}),
append-only so a client and an in-process server can share one file and a
reader can correlate their records by ``trace_id``.
"""

import collections
import contextlib
import json
import os
import re
import threading
import time

__all__ = [
    "ClientTrace",
    "ClientTracer",
    "SpanBase",
    "append_trace_record",
    "attempt_span",
    "client_span",
    "format_traceparent",
    "gen_span_id",
    "gen_trace_id",
    "parse_traceparent",
    "read_trace_file",
]

_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$"
)


def gen_trace_id():
    """128-bit trace id, lowercase hex (W3C trace-context form)."""
    return os.urandom(16).hex()


def gen_span_id():
    """64-bit span id, lowercase hex."""
    return os.urandom(8).hex()


def format_traceparent(trace_id, span_id):
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(header):
    """(trace_id, span_id) from a traceparent header, or None if absent
    or malformed (a bad header must never fail the request)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    return m.group(1), m.group(2)


def append_trace_record(path, record):
    """Append one JSON trace record (single line) to *path*."""
    with open(path, "a", encoding="utf-8") as f:
        f.write(json.dumps(record, separators=(",", ":")) + "\n")


def read_trace_file(path):
    """All trace records from *path* (JSON-lines, or one JSON array)."""
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    stripped = text.lstrip()
    if stripped.startswith("["):
        return json.loads(stripped)
    return [json.loads(line) for line in text.splitlines() if line.strip()]


class SpanBase:
    """One span under a trace id: the ids plus a timestamp timeline
    (``ClientTrace``'s event half, which the server's ``RequestTrace``
    extends)."""

    def __init__(self, trace_id, span_id, model_name=""):
        self.trace_id = trace_id
        self.span_id = span_id
        self.model_name = model_name
        self.timestamps = []
        self.error = None

    def event(self, name, ns=None, endpoint=None):
        record = {"name": name, "ns": time.time_ns() if ns is None else ns}
        if endpoint:
            record["endpoint"] = endpoint
        self.timestamps.append(record)

    def traceparent(self):
        return format_traceparent(self.trace_id, self.span_id)


class ClientTrace(SpanBase):
    """One traced client request: a span id under a trace id plus the
    client-observed timestamp timeline."""

    def attempts(self):
        """Transport attempts observed (retries show as extra pairs)."""
        return sum(
            1 for t in self.timestamps if t["name"] == "CLIENT_ATTEMPT_START"
        )

    def attempt_endpoints(self):
        """Endpoint of each transport attempt, in order — a replica-set
        failover shows as consecutive attempts on different endpoints."""
        return [
            t.get("endpoint", "")
            for t in self.timestamps
            if t["name"] == "CLIENT_ATTEMPT_START"
        ]

    def to_json(self):
        record = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "source": "client",
            "model_name": self.model_name,
            "timestamps": list(self.timestamps),
        }
        if self.error:
            record["error"] = self.error
        return record


@contextlib.contextmanager
def client_span(tracer, model_name, context_key=None):
    """Bracket one client request: sample a trace from *tracer* (yields
    None when tracing is off or the request is not sampled), record
    CLIENT_REQUEST_START/END, capture the error on failure, and always
    complete the trace.  The shared request-bracket all four clients use —
    span semantics change here, once, not per transport.  Synchronous on
    purpose: the trace calls never block, so coroutine clients use it too.

    ``context_key`` pins every request sharing the key under ONE trace id
    (each request still gets its own span): the replicated clients key it
    on the sequence id, so all steps of a sequence — including the retries
    and failover hops after a replica death — join as one trace.
    """
    trace = (
        tracer.sample(model_name, context_key=context_key)
        if tracer is not None else None
    )
    if trace is None:
        yield None
        return
    trace.event("CLIENT_REQUEST_START")
    try:
        yield trace
        trace.event("CLIENT_REQUEST_END")
    except Exception as e:
        trace.error = str(e)
        raise
    finally:
        tracer.complete(trace)


@contextlib.contextmanager
def attempt_span(trace, endpoint=None):
    """Bracket one transport attempt with CLIENT_ATTEMPT_START/END (a
    no-op when the request is untraced) — retries through the resilience
    layer show as repeated pairs on the same trace.  ``endpoint`` stamps
    the attempt with the replica it targeted, so a replica-set failover
    hop is visible as consecutive attempts on different endpoints."""
    if trace is None:
        yield
        return
    trace.event("CLIENT_ATTEMPT_START", endpoint=endpoint)
    try:
        yield
    finally:
        trace.event("CLIENT_ATTEMPT_END", endpoint=endpoint)


class ClientTracer:
    """Samples and collects client-side traces.

    ``trace_rate=N`` samples the first of every N requests (1 = every
    request).  Completed traces are kept on a bounded deque
    (:attr:`traces`) and, when ``trace_file`` is set, appended to the file
    as JSON-lines — point it at the server's ``trace_file`` to get the
    combined client+server timeline in one place.
    """

    def __init__(self, trace_file="", trace_rate=1, max_traces=1000):
        self.trace_file = trace_file
        self.trace_rate = max(int(trace_rate), 1)
        self._lock = threading.Lock()
        self._seen = 0
        self.traces = collections.deque(maxlen=max_traces)
        # context_key -> pinned decision: a trace id (every request
        # sharing the key joins one trace) or None (the key's FIRST
        # request was unsampled, so the whole sequence stays untraced —
        # a sequence is traced whole or not at all, never from a random
        # mid-step).  Bounded; release_context drops a finished key.
        self._pinned = collections.OrderedDict()

    def sample(self, model_name="", context_key=None):
        """A new ClientTrace for this request, or None (not sampled).

        With ``context_key``, the key's FIRST request decides sampling
        for every request sharing it: sampled mints the shared trace id,
        unsampled pins the whole key untraced — so with ``trace_rate``
        > 1 a sequence is traced from its first step or not at all."""
        with self._lock:
            seen = self._seen
            self._seen += 1
            if context_key is not None and context_key in self._pinned:
                trace_id = self._pinned[context_key]
                if trace_id is None:
                    return None
                return ClientTrace(trace_id, gen_span_id(), model_name)
        sampled = not seen % self.trace_rate
        if context_key is None:
            if not sampled:
                return None
            return ClientTrace(gen_trace_id(), gen_span_id(), model_name)
        with self._lock:
            trace_id = self._pinned.setdefault(
                context_key, gen_trace_id() if sampled else None
            )
            self._pinned.move_to_end(context_key)
            while len(self._pinned) > 4096:
                self._pinned.popitem(last=False)
        if trace_id is None:
            return None
        return ClientTrace(trace_id, gen_span_id(), model_name)

    def release_context(self, context_key):
        """Drop a pinned trace id (the sequence ended; a restarted
        sequence id then starts a fresh trace)."""
        with self._lock:
            self._pinned.pop(context_key, None)

    def complete(self, trace):
        with self._lock:
            self.traces.append(trace)
        if self.trace_file:
            try:
                append_trace_record(self.trace_file, trace.to_json())
            except OSError:
                pass  # tracing must never fail the request path
