"""Trace context shared by the server's request tracing.

Counterpart of client_tpu/tracing.py, cut to what serve/tracing.py
needs: W3C-style trace and span ids, ``traceparent`` parse and format,
the JSON-lines trace-file writer, and the span base class (the timestamp
and event half of ``ClientTrace``).  The client-side tracer
(``ClientTracer``, ``client_span``, ``attempt_span``) comes with the
client libraries.

Trace files are newline-delimited JSON records (one object per line, the
Triton trace-record shape: ids + a ``timestamps`` list of {name, ns}),
append-only so a client and an in-process server can share one file and a
reader can correlate their records by ``trace_id``.
"""

import json
import os
import re
import time

__all__ = [
    "SpanBase",
    "append_trace_record",
    "format_traceparent",
    "gen_span_id",
    "gen_trace_id",
    "parse_traceparent",
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
