"""Flight recorder: a bounded in-memory ring of recent observability
events, dumped as JSON-lines on demand and automatically on anomaly.

Counterpart of client_tpu/serve/flight.py.  Postmortems must not depend
on having had tracing enabled or a scraper attached when the anomaly
happened.  Each server keeps one :class:`FlightRecorder`
(``engine.flight``) fed continuously and cheaply:

- every completed trace span (request timelines, LM tick spans) via the
  tracer's ``on_complete`` hook,
- discrete events the subsystems note directly — preemptions and engine
  wedges (serve/lm/engine.py), SLO breaches (serve/slo.py).

The ring is bounded (default 4096 records) so a server that runs for
weeks holds the *recent* past, which is what a postmortem needs.  A dump
writes the whole ring as JSON-lines prefixed with a header record naming
the reason, followed by the last tick records of the server's phase
profiler and every profiler it adopted (``PhaseProfiler.recent``) as
``prof_tick`` records; triggers are the debug endpoint
(``GET /v2/debug/flight``), an SLO breach and an LM engine wedge.  Dumps
land under ``dump_dir`` (constructor arg, else ``$TPU_FLIGHT_DIR``, else
the system temp dir).

Everything here is best-effort by design: a full disk or unwritable
directory must never fail the request path, so :meth:`dump` returns None
on failure instead of raising.  Noting an event reads host state only.
"""

import collections
import json
import os
import tempfile
import threading
import time

from client_tpu_torch.serve.metrics import SLO_HELP

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Bounded ring of observability events with JSON-lines dumps."""

    def __init__(self, capacity=4096, dump_dir=None, registry=None,
                 name="", prof=None):
        self.capacity = int(capacity)
        self.dump_dir = dump_dir
        self.registry = registry
        self.name = str(name)  # distinguishes replicas sharing a dir
        self.prof = prof  # PhaseProfiler whose ticks ride along in dumps
        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=self.capacity)
        self._dump_seq = 0
        self.events_noted = 0
        self.dumps = []  # paths of every dump written, in order

    # -- feeding -----------------------------------------------------------

    def note(self, kind, **fields):
        """Append one event record (cheap: one deque append under the
        lock; dropped fields must already be JSON-safe)."""
        record = {"kind": str(kind), "ts": time.time()}
        record.update(fields)
        with self._lock:
            self._ring.append(record)
            self.events_noted += 1

    def note_span(self, span):
        """Tracer completion hook: fold a finished trace span into the
        ring (anything with ``to_json()``)."""
        try:
            self.note("span", span=span.to_json())
        except Exception:
            pass  # a hostile span must not break recording

    # -- reading / dumping -------------------------------------------------

    def snapshot(self):
        """The ring's current records, oldest first."""
        with self._lock:
            return list(self._ring)

    def render(self, reason=""):
        """The dump payload as a JSON-lines string (the debug endpoint
        serves this without touching the filesystem)."""
        records = self.snapshot()
        header = {
            "kind": "flight_dump",
            "ts": time.time(),
            "reason": str(reason),
            "name": self.name,
            "events": len(records),
        }
        lines = [json.dumps(header, separators=(",", ":"))]
        lines.extend(
            json.dumps(r, separators=(",", ":"), default=str)
            for r in records
        )
        if self.prof is not None:
            # the last N tick profiles ride along so a postmortem sees
            # where time was going right before the anomaly
            try:
                for record in self.prof.recent(last=32):
                    tagged = dict(record)
                    tagged["tick_kind"] = tagged.pop("kind", None)
                    tagged["kind"] = "prof_tick"
                    lines.append(
                        json.dumps(tagged, separators=(",", ":"),
                                   default=str)
                    )
            except Exception:
                pass  # profiling must never break a dump
        return "\n".join(lines) + "\n"

    def _dir(self):
        return (
            self.dump_dir
            or os.environ.get("TPU_FLIGHT_DIR")
            or os.path.join(tempfile.gettempdir(), "ctpu-flight")
        )

    def dump(self, reason):
        """Write the ring as one JSON-lines file under the dump dir and
        return its path — or None when the write failed (a postmortem
        aid must never fail the path that is already failing)."""
        with self._lock:
            self._dump_seq += 1
            seq = self._dump_seq
        directory = self._dir()
        tag = f"-{self.name}" if self.name else ""
        path = os.path.join(
            directory,
            f"flight{tag}-{os.getpid()}-{seq:03d}-{_slug(reason)}.jsonl",
        )
        try:
            os.makedirs(directory, exist_ok=True)
            with open(path, "w", encoding="utf-8") as f:
                f.write(self.render(reason))
        except OSError:
            return None
        with self._lock:
            self.dumps.append(path)
        if self.registry is not None:
            self.registry.inc(
                "ctpu_flight_dumps_total", {"reason": _slug(reason)},
                help_=SLO_HELP["ctpu_flight_dumps_total"],
            )
        return path


def _slug(reason):
    """Filesystem-safe reason tag."""
    out = "".join(
        c if c.isalnum() or c in "-_" else "-" for c in str(reason)
    )
    return out[:48] or "manual"
