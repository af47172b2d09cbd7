"""SLO watchdog: streaming per-model/per-tenant latency quantiles with
configurable objectives, breach counters, and flight-recorder dumps.

Counterpart of client_tpu/serve/slo.py.  The server itself knows its
objectives and makes breaches self-documenting:

- **sketches, not sample lists**: latency lands in a
  :class:`LatencySketch` — a fixed geometric-bucket digest (~60 ints).
  Constant memory per (model, tenant) key, O(1) observe, and MERGEABLE:
  adding two sketches' counts merges their distributions exactly, which
  is what makes the two-window rotation and any future cross-replica
  aggregation correct by construction.
- **sliding window**: each key keeps a current and a previous sketch,
  rotated every ``window_s``; quantiles read over their merge, so a
  spike ages out instead of polluting the quantile forever.
- **objectives**: ``{model_or_"*": {"p99_ms": float, "error_rate":
  float}}``.  A key whose windowed p99 (or error rate) exceeds its
  objective — with at least ``min_samples`` observations — increments
  ``ctpu_slo_breaches_total{model,tenant,kind}`` and triggers a
  flight-recorder dump (rate-limited to one per ``dump_interval_s``),
  so the postmortem artifact exists the moment the SLO is broken.  The
  first breach always dumps: the interval is counted from the previous
  dump, and before one there is none to count from (the host's uptime
  plays no part).
- **gauges**: every check exports ``ctpu_slo_p50_ms`` / ``_p95_ms`` /
  ``_p99_ms`` / ``ctpu_slo_error_rate`` per (model, tenant), scrapeable
  from /metrics next to the request counters they summarize.

Errors counted against the error-rate objective are SERVER faults
(5xx/transport); 4xx rejections are the client's problem and only count
as latency samples.  The engine calls :meth:`SloWatchdog.observe` once
per request — one lock and one bucket bisect on host state.
"""

import bisect
import math
import threading
import time
from collections import OrderedDict

from client_tpu_torch.serve.metrics import SLO_HELP

__all__ = ["LatencySketch", "SloWatchdog", "BOUNDS_MS"]

# Geometric bucket bounds (milliseconds): 0.05ms .. ~32s with 1.25x
# growth — <=12.5% relative quantile error across the whole serving
# range, in 60 integers.
_RATIO = 1.25
BOUNDS_MS = tuple(0.05 * _RATIO ** i for i in range(60))


class LatencySketch:
    """Compact mergeable latency digest over fixed geometric buckets."""

    __slots__ = ("counts", "count", "errors", "sum_ms", "max_ms")

    def __init__(self):
        self.counts = [0] * (len(BOUNDS_MS) + 1)  # +Inf tail
        self.count = 0
        self.errors = 0
        self.sum_ms = 0.0
        self.max_ms = 0.0

    def observe(self, latency_ms, error=False):
        self.counts[bisect.bisect_left(BOUNDS_MS, latency_ms)] += 1
        self.count += 1
        self.sum_ms += latency_ms
        if latency_ms > self.max_ms:
            self.max_ms = latency_ms
        if error:
            self.errors += 1

    def merge(self, other):
        """Fold *other* into self (exact: buckets are shared)."""
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.errors += other.errors
        self.sum_ms += other.sum_ms
        self.max_ms = max(self.max_ms, other.max_ms)
        return self

    def merged(self, other):
        out = LatencySketch()
        out.merge(self)
        if other is not None:
            out.merge(other)
        return out

    def quantile(self, q):
        """The q-quantile's bucket upper bound in ms (0 when empty) —
        an overestimate by at most one bucket ratio, the conservative
        side for an SLO check."""
        if self.count <= 0:
            return 0.0
        rank = max(int(math.ceil(float(q) * self.count)), 1)
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                if i < len(BOUNDS_MS):
                    return BOUNDS_MS[i]
                return self.max_ms  # +Inf tail: the observed max
        return self.max_ms

    def error_rate(self):
        return self.errors / self.count if self.count else 0.0

    def to_json(self):
        return {
            "count": self.count,
            "errors": self.errors,
            "sum_ms": self.sum_ms,
            "max_ms": self.max_ms,
            "counts": list(self.counts),
        }


class _Key:
    """Per-(model, tenant) window state."""

    __slots__ = ("cur", "prev", "rotated_at", "since_check", "breaches",
                 "last_quantiles")

    def __init__(self):
        self.cur = LatencySketch()
        self.prev = None
        self.rotated_at = time.monotonic()
        self.since_check = 0
        self.breaches = 0
        self.last_quantiles = {}


class SloWatchdog:
    """Streaming SLO evaluation over per-(model, tenant) sketches.

    ``objectives`` maps a model name (or ``"*"`` for every model) to
    ``{"p99_ms": float, "error_rate": float}`` — either key optional.
    With no objectives the watchdog still exports the quantile gauges
    (observation-only mode: the engine enables it by default).
    """

    def __init__(self, objectives=None, registry=None, flight=None,
                 window_s=60.0, min_samples=32, check_every=16,
                 dump_interval_s=30.0, max_keys=512):
        self.objectives = dict(objectives or {})
        self.registry = registry
        self.flight = flight
        self.window_s = float(window_s)
        self.min_samples = int(min_samples)
        self.check_every = max(int(check_every), 1)
        self.dump_interval_s = float(dump_interval_s)
        self.max_keys = int(max_keys)
        self._lock = threading.Lock()
        self._keys = OrderedDict()  # (model, tenant) -> _Key
        self._last_dump = None  # monotonic time of the last dump
        self.breaches = 0

    def objective_for(self, model):
        """The objective block applying to *model* (exact name wins over
        the ``"*"`` default), or None."""
        return self.objectives.get(model, self.objectives.get("*"))

    # -- feeding -----------------------------------------------------------

    def observe(self, model, tenant, latency_s, error=False):
        """Record one finished request.  Cheap by contract (one lock,
        one bisect); every ``check_every`` observations of a key the
        objectives are evaluated over the merged two-window sketch."""
        latency_ms = float(latency_s) * 1e3
        key = (str(model), str(tenant))
        now = time.monotonic()
        with self._lock:
            entry = self._keys.get(key)
            if entry is None:
                entry = self._keys[key] = _Key()
                # insertion-order eviction, not strict LRU: the key set
                # is model x tenant (tiny in practice), and per-observe
                # move_to_end would tax the hot path for an eviction
                # that essentially never fires
                while len(self._keys) > self.max_keys:
                    self._keys.popitem(last=False)
            if now - entry.rotated_at > self.window_s:
                entry.prev = entry.cur
                entry.cur = LatencySketch()
                entry.rotated_at = now
            entry.cur.observe(latency_ms, error=error)
            entry.since_check += 1
            if entry.since_check < self.check_every:
                return
            entry.since_check = 0
            window = entry.cur.merged(entry.prev)
        # evaluation runs OUTSIDE the lock: gauge export and a possible
        # flight dump must not serialize concurrent request completions
        self._check_key(key, entry, window)

    # -- evaluation --------------------------------------------------------

    def _check_key(self, key, entry, window):
        model, tenant = key
        quantiles = {
            "p50_ms": window.quantile(0.50),
            "p95_ms": window.quantile(0.95),
            "p99_ms": window.quantile(0.99),
            "error_rate": window.error_rate(),
            "count": window.count,
        }
        entry.last_quantiles = quantiles
        labels = {"model": model, "tenant": tenant}
        if self.registry is not None:
            for name, field in (
                ("ctpu_slo_p50_ms", "p50_ms"),
                ("ctpu_slo_p95_ms", "p95_ms"),
                ("ctpu_slo_p99_ms", "p99_ms"),
                ("ctpu_slo_error_rate", "error_rate"),
            ):
                self.registry.set(
                    name, labels, quantiles[field], help_=SLO_HELP[name]
                )
        objective = self.objective_for(model)
        if objective is None or window.count < self.min_samples:
            return
        breaches = []
        p99_obj = objective.get("p99_ms")
        if p99_obj is not None and quantiles["p99_ms"] > float(p99_obj):
            breaches.append(("p99_ms", quantiles["p99_ms"], float(p99_obj)))
        err_obj = objective.get("error_rate")
        if err_obj is not None and quantiles["error_rate"] > float(err_obj):
            breaches.append(
                ("error_rate", quantiles["error_rate"], float(err_obj))
            )
        for kind, value, bound in breaches:
            self._breach(model, tenant, entry, kind, value, bound,
                         quantiles)

    def _breach(self, model, tenant, entry, kind, value, bound, quantiles):
        with self._lock:
            entry.breaches += 1
            self.breaches += 1
            now = time.monotonic()
            want_dump = self.flight is not None and (
                self._last_dump is None
                or now - self._last_dump >= self.dump_interval_s
            )
            if want_dump:
                self._last_dump = now
        if self.registry is not None:
            self.registry.inc(
                "ctpu_slo_breaches_total",
                {"model": model, "tenant": tenant, "kind": kind},
                help_=SLO_HELP["ctpu_slo_breaches_total"],
            )
        flight = self.flight
        if flight is not None:
            flight.note(
                "slo_breach", model=model, tenant=tenant,
                objective_kind=kind, value=value, objective=bound,
                window=quantiles,
            )
            if want_dump:
                flight.dump("slo_breach")

    # -- introspection -----------------------------------------------------

    def check_now(self):
        """Force an objective pass over every key (tests, bench rounds,
        pre-scrape hooks) and return :meth:`summary`."""
        with self._lock:
            items = [
                (key, entry, entry.cur.merged(entry.prev))
                for key, entry in self._keys.items()
            ]
        for key, entry, window in items:
            self._check_key(key, entry, window)
        return self.summary()

    def summary(self):
        """``{"model|tenant": {p50_ms, p95_ms, p99_ms, error_rate,
        count, breaches}}`` over the latest checked windows (JSON-safe —
        bench rounds record this block)."""
        with self._lock:
            out = {}
            for (model, tenant), entry in self._keys.items():
                q = dict(entry.last_quantiles)
                if not q:
                    window = entry.cur.merged(entry.prev)
                    q = {
                        "p50_ms": window.quantile(0.50),
                        "p95_ms": window.quantile(0.95),
                        "p99_ms": window.quantile(0.99),
                        "error_rate": window.error_rate(),
                        "count": window.count,
                    }
                q["breaches"] = entry.breaches
                out[f"{model}|{tenant}"] = q
            return out
