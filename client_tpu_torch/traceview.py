"""traceview: join client + server + peer trace files by trace id and
print per-trace timelines with critical-path attribution.

The port's copy of client_tpu/traceview.py, over the port's
:func:`client_tpu_torch.tracing.read_trace_file`.  The join, the
timeline, the attribution and the ``--format json`` objects are the
reference's, so both tools render the same text from the same files.

The tracing subsystem writes JSON-lines span records from three places —
clients (``client_tpu_torch.tracing``), servers
(``client_tpu_torch.serve.tracing``)
and the fleet tier's peer spans — often into separate files on separate
machines.  This tool is the join::

    python -m client_tpu_torch.traceview client.jsonl replica0.jsonl
    python -m client_tpu_torch.traceview --trace 4f2a... --format json *.jsonl

For every trace id it prints the spans in timeline order (source, model,
endpoint/peer tags, per-event offsets from the trace's first timestamp)
and a **critical-path attribution** line splitting the end-to-end latency
into:

- ``queue``   — server-side scheduling wait (QUEUE_START → QUEUE_END),
- ``compute`` — model execution (COMPUTE_START → COMPUTE_END, peer-serve
  spans excluded),
- ``peer``    — fleet tier fetches (PEER_START → PEER_END: prefix/cache/
  sequence lookups, durability pushes),
- ``wire``    — the remainder of the client-observed duration not inside
  any server span (serialization + network + client overhead).

A trace that spans a replica SIGKILL (client attempt spans on two
endpoints, both replicas' server spans, the survivor's peer
``sequence_lookup`` and ``__seq_resume__`` marker) renders as ONE
timeline — the artifact the three-replica chaos acceptance asserts on.

``--format json`` emits the joined structure (one object per trace) for
scripting; everything in this module is stdlib-only.
"""

import argparse
import json
import sys

from client_tpu_torch.tracing import read_trace_file

__all__ = ["join_traces", "load_records", "critical_path", "render_trace",
           "main"]


def load_records(paths):
    """All span records from *paths* (JSON-lines trace files), in file
    order.  Unreadable files raise; unparsable lines were never written
    by the tracers and raise too — garbage in a postmortem artifact
    should be loud."""
    records = []
    for path in paths:
        records.extend(read_trace_file(path))
    return records


def _events(record):
    """(name, ns, extra) tuples of one record's timestamps."""
    out = []
    for ts in record.get("timestamps") or ():
        name = ts.get("name")
        ns = ts.get("ns")
        if name is None or ns is None:
            continue
        out.append((str(name), int(ns), ts))
    return out


def _span_bounds(record):
    """(first_ns, last_ns) over a record's events, or None."""
    events = _events(record)
    if not events:
        return None
    times = [ns for _name, ns, _e in events]
    return min(times), max(times)


def _interval(record, start_name, end_name):
    """Duration ns between the first *start_name* and the last
    *end_name* event (0 when either is missing)."""
    start = end = None
    for name, ns, _extra in _events(record):
        if name == start_name and start is None:
            start = ns
        if name == end_name:
            end = ns
    if start is None or end is None or end < start:
        return 0
    return end - start


def _is_peer(record):
    return str(record.get("model_name", "")).startswith("__peer_")


def _is_tick(record):
    return str(record.get("model_name", "")).startswith("__lm_")


def join_traces(records):
    """Group span records by trace id -> ``{trace_id: [records]}`` with
    each trace's records sorted by first timestamp.  Records with no
    timestamps (or no trace id) are dropped — nothing to place on a
    timeline."""
    traces = {}
    for record in records:
        trace_id = record.get("trace_id")
        if not trace_id or _span_bounds(record) is None:
            continue
        traces.setdefault(trace_id, []).append(record)
    for spans in traces.values():
        spans.sort(key=lambda r: _span_bounds(r)[0])
    return traces


def _merged_length(intervals):
    """Total ns covered by the union of (start, end) intervals —
    overlapping server spans (ensemble steps, resumes) must not
    double-count."""
    total = 0
    last_end = None
    for start, end in sorted(intervals):
        if last_end is None or start > last_end:
            total += end - start
            last_end = end
        elif end > last_end:
            total += end - last_end
            last_end = end
    return total


def critical_path(spans):
    """Attribute one trace's end-to-end time -> dict of millisecond
    figures.

    ``total`` is the client-observed duration (CLIENT_REQUEST_START →
    the last CLIENT_REQUEST_END; multi-request traces — a pinned
    sequence — sum their per-request client spans) falling back to the
    trace's full event extent.  ``queue``/``compute`` sum the server
    request spans' phase intervals, ``peer`` the peer spans' durations,
    and ``wire`` is the client time not covered by any server span."""
    client_intervals = []
    server_intervals = []
    queue_ns = compute_ns = peer_ns = 0
    for record in spans:
        source = record.get("source")
        if source == "client":
            dur = _interval(record, "CLIENT_REQUEST_START",
                            "CLIENT_REQUEST_END")
            bounds = _span_bounds(record)
            if dur:
                client_intervals.append((bounds[0], bounds[0] + dur))
            elif bounds is not None:
                client_intervals.append(bounds)
            continue
        if _is_peer(record):
            peer_ns += (
                _interval(record, "PEER_START", "PEER_END")
                or _interval(record, "COMPUTE_START", "COMPUTE_END")
            )
            continue
        if _is_tick(record):
            continue  # scheduler ticks are engine-wide, not per-request
        # server request span
        queue_ns += _interval(record, "QUEUE_START", "QUEUE_END")
        compute_ns += _interval(record, "COMPUTE_START", "COMPUTE_END")
        bounds = _span_bounds(record)
        if bounds is not None:
            server_intervals.append(bounds)
    if client_intervals:
        total_ns = _merged_length(client_intervals)
    else:
        bounds = [b for b in map(_span_bounds, spans) if b is not None]
        total_ns = (
            max(e for _s, e in bounds) - min(s for s, _e in bounds)
            if bounds else 0
        )
    server_ns = _merged_length(server_intervals)
    wire_ns = max(total_ns - server_ns, 0) if client_intervals else 0
    to_ms = 1e-6
    return {
        "total_ms": total_ns * to_ms,
        "queue_ms": queue_ns * to_ms,
        "compute_ms": compute_ns * to_ms,
        "peer_ms": peer_ns * to_ms,
        "wire_ms": wire_ns * to_ms,
    }


def _span_label(record):
    source = record.get("source", "?")
    name = record.get("model_name", "")
    bits = [f"{source:<6}", name]
    tags = record.get("tags") or {}
    endpoint = next(
        (e.get("endpoint") for _n, _ns, e in _events(record)
         if e.get("endpoint")),
        None,
    )
    if endpoint:
        bits.append(f"endpoint={endpoint}")
    for key in ("peer", "op", "hit", "stored", "bytes", "breaker",
                "sequence_id", "resumed_trace", "resumed_sequence"):
        if key in tags:
            bits.append(f"{key}={tags[key]}")
    if record.get("tenant"):
        bits.append(f"tenant={record['tenant']}")
    if record.get("error"):
        bits.append(f"ERROR={record['error']}")
    return " ".join(str(b) for b in bits)


def trace_summary(trace_id, spans):
    """The joined, attribution-annotated structure of one trace (what
    ``--format json`` emits per trace)."""
    t0 = min(_span_bounds(r)[0] for r in spans)
    models = sorted({
        str(r.get("model_name"))
        for r in spans
        if r.get("model_name") and not _is_peer(r) and not _is_tick(r)
    })
    sources = sorted({str(r.get("source", "?")) for r in spans})
    return {
        "trace_id": trace_id,
        "start_ns": t0,
        "spans": len(spans),
        "sources": sources,
        "models": models,
        "critical_path": critical_path(spans),
        "records": spans,
    }


def render_trace(trace_id, spans, out):
    """Human timeline for one trace."""
    summary = trace_summary(trace_id, spans)
    t0 = summary["start_ns"]
    cp = summary["critical_path"]
    out.write(
        f"trace {trace_id}  spans={len(spans)} "
        f"sources={','.join(summary['sources'])} "
        f"models={','.join(summary['models']) or '-'}\n"
    )
    out.write(
        "  critical path: total {total_ms:.3f} ms = "
        "queue {queue_ms:.3f} | compute {compute_ms:.3f} | "
        "peer-fetch {peer_ms:.3f} | wire {wire_ms:.3f}\n".format(**cp)
    )
    for record in spans:
        bounds = _span_bounds(record)
        out.write(
            f"  [{(bounds[0] - t0) / 1e6:9.3f} ms "
            f"+{(bounds[1] - bounds[0]) / 1e6:8.3f} ms] "
            f"{_span_label(record)}\n"
        )
        for name, ns, _extra in _events(record):
            out.write(f"      {(ns - t0) / 1e6:9.3f} ms  {name}\n")


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m client_tpu_torch.traceview",
        description="Join client/server/peer trace files by trace id and "
                    "print per-trace timelines with critical-path "
                    "attribution.",
    )
    parser.add_argument("files", nargs="+", help="JSON-lines trace files")
    parser.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="text timelines (default) or one JSON object per trace "
             "for scripting",
    )
    parser.add_argument(
        "--trace", default=None,
        help="only the trace with this id (prefix match)",
    )
    parser.add_argument(
        "--min-spans", type=int, default=1,
        help="skip traces with fewer spans (default 1)",
    )
    args = parser.parse_args(argv)
    try:
        records = load_records(args.files)
    except (OSError, ValueError) as e:
        print(f"traceview: {e}", file=sys.stderr)
        return 2
    traces = join_traces(records)
    selected = sorted(
        (
            (trace_id, spans)
            for trace_id, spans in traces.items()
            if len(spans) >= args.min_spans
            and (args.trace is None or trace_id.startswith(args.trace))
        ),
        key=lambda pair: _span_bounds(pair[1][0])[0],
    )
    if args.format == "json":
        for trace_id, spans in selected:
            sys.stdout.write(
                json.dumps(trace_summary(trace_id, spans),
                           separators=(",", ":")) + "\n"
            )
        return 0
    if not selected:
        print("no traces matched", file=sys.stderr)
        return 1
    for trace_id, spans in selected:
        render_trace(trace_id, spans, sys.stdout)
        sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
