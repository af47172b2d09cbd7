"""Continuous low-overhead phase profiler: where serving time goes.

The port's copy of client_tpu/serve/prof.py.  One difference: the MFU
denominator reads the device kind from ``torch.cuda.get_device_name()``
(an NVIDIA H100 maps to its 989 TFLOP/s dense bf16 peak).

Request tracing answers *what happened* per request; this module is the
always-on layer that answers *why it was slow*: every engine keeps a
:class:`PhaseProfiler` — a bounded ring of per-tick phase timings
(sibling of ``serve/flight.py``'s FlightRecorder) fed continuously by
the hot paths and rolled up on demand:

- the LM engine's scheduler loop brackets each iteration
  (lock/schedule, prefill/decode dispatch, device wait, token delivery,
  idle wait) with ``perf_counter`` spans,
- the unary engine's execute path folds its existing monotonic
  timestamps (input gather / model fn / render) into ``unary`` ticks at
  zero added timing cost,
- the HTTP/gRPC frontends and the perf client backends commit
  wire-path ticks (deserialize / execute-wait / serialize / send).

Rollups attribute windowed wall time into per-phase shares, and the
measured device time + per-model FLOP figures produce compute-share and
MFU series (``ctpu_prof_*`` gauges/counters in serve/metrics.py's
catalog).  :func:`device_peak_tflops` supplies the MFU denominator —
the advertised bf16 peak of the card, or a measured host GEMM peak
where there is none (``cpu_fallback``) so attribution ratios are non-null everywhere.

Surfaces: ``GET /v2/debug/prof`` (rollup JSON),
``python -m client_tpu_torch.profview`` (attribution tables),
flight-recorder dumps (the last N tick profiles ride along), and
bench.py's ``prof`` block.

Bracket discipline: a handle acquired with ``start_tick`` MUST reach
``finish`` on every exit path (``with`` handle, or ``try/finally``) —
the SPAN-LEAK lint rule enforces this shape (analysis/resources.py
registers ``start_tick`` in the span vocabulary).  An unfinished tick
never reaches the ring, so the rollup under-attributes exactly when a
failure makes the timeline interesting.

Everything here must stay cheap enough to leave armed in production:
one perf_counter pair per phase, one deque append per tick, no
allocation beyond the record dict.  The measured budget (bench
``prof_overhead_pct``, tests/test_prof.py) is <= 2% on the in-process
headline path.
"""

import collections
import threading
import time

from client_tpu_torch import require_torch
from client_tpu_torch.analysis.witness import witness_shared

__all__ = [
    "PhaseProfiler",
    "NULL_TICK",
    "ATTRIBUTION_GROUPS",
    "device_peak_tflops",
    "host_peak_tflops",
    "attribute_phases",
]

# Advertised dense bf16 peaks by CUDA device name (NVIDIA's H100 SXM data
# sheet: 989 TFLOP/s dense bf16 on the tensor cores).
_GPU_PEAKS = (
    ("h100", 989.0),
)

# Phase -> attribution bucket for the dispatch/compute/host/idle split
# (bench's prof block, profview's summary row).  On the CPU test
# platform jitted "dispatch" blocks until the computation finishes, so
# the dispatch-site phases are device work, not launch overhead — they
# group under compute; the device_wait phase (readback/np.asarray) is
# where async TPU dispatch actually pays.
ATTRIBUTION_GROUPS = {
    "compute": ("compute", "decode_dispatch", "prefill_dispatch",
                "verify_dispatch", "device_wait"),
    "dispatch": ("schedule", "preempt", "resume", "execute"),
    "host": ("host", "render", "deliver", "sample", "serialize",
             "deserialize", "send", "wait", "draft"),
    "idle": ("idle",),
}

_peak_cache = None
_peak_lock = threading.Lock()


def host_peak_tflops(n=384, reps=3):
    """Measured host GEMM peak in TFLOP/s (best of *reps* numpy matmuls
    of an n x n fp32 problem) — the off-TPU MFU denominator.  A probe,
    not an advertised figure: BLAS-backed numpy lands within a small
    factor of the host's real dense peak, which is all an attribution
    *ratio* needs."""
    import numpy as np

    a = np.ones((n, n), np.float32)
    b = np.ones((n, n), np.float32)
    a @ b  # warm the BLAS path outside the timed reps
    best = float("inf")
    for _ in range(max(1, int(reps))):
        t0 = time.perf_counter()
        a @ b
        best = min(best, time.perf_counter() - t0)
    flops = 2.0 * n * n * n
    return max(flops / max(best, 1e-9) / 1e12, 1e-6)


def device_peak_tflops():
    """(peak_tflops, peak_kind) of the local accelerator.

    CUDA device names map to their advertised dense bf16 peaks; anything
    else (the CPU test platform, an unrecognized device) falls back to
    the measured host GEMM peak tagged ``"cpu_fallback"`` so MFU figures
    are non-null everywhere.  Cached: the probe runs once per process.
    """
    global _peak_cache
    with _peak_lock:
        if _peak_cache is not None:
            return _peak_cache
        kind = ""
        try:
            torch = require_torch("the device peak")
        except ModuleNotFoundError:  # no torch: no device to name
            torch = None
        if torch is not None and torch.cuda.is_available():
            kind = torch.cuda.get_device_name().lower()
        for pat, peak in _GPU_PEAKS:
            if pat in kind:
                _peak_cache = (peak, "gpu")
                return _peak_cache
        _peak_cache = (round(host_peak_tflops(), 4), "cpu_fallback")
        return _peak_cache


def attribute_phases(phases, wall_s=None):
    """Fold a {phase: seconds} dict into the dispatch/compute/host/idle
    share split (percentages summing to ~100).

    *wall_s* is the window the phases were measured over; time it
    covers beyond the summed phases counts as idle.  Concurrent
    execution can sum past the wall — shares then normalize over the
    summed total (idle 0)."""
    groups = {"compute": 0.0, "dispatch": 0.0, "host": 0.0, "idle": 0.0}
    for name, seconds in (phases or {}).items():
        for group, members in ATTRIBUTION_GROUPS.items():
            if name in members:
                groups[group] += seconds
                break
        else:
            groups["host"] += seconds  # unmapped phases are host work
    covered = sum(groups.values())
    if wall_s is not None and wall_s > covered:
        groups["idle"] += wall_s - covered
    total = sum(groups.values())
    if total <= 0.0:
        return None
    return {
        f"{group}_pct": round(100.0 * seconds / total, 2)
        for group, seconds in groups.items()
    }


class _Phase:
    """One ``with tick.phase(name):`` bracket — accumulates elapsed
    seconds into the owning tick's phase dict on exit."""

    __slots__ = ("_tick", "_name", "_t0")

    def __init__(self, tick, name):
        self._tick = tick
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tick.add(self._name, time.perf_counter() - self._t0)
        return False


class _NullPhase:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_PHASE = _NullPhase()


class _Tick:
    """One in-progress tick: phase durations + attribution meta,
    committed to the profiler's ring by ``finish`` (or ``close`` /
    ``with``)."""

    __slots__ = ("prof", "kind", "t0", "phases", "meta", "_items",
                 "_flops", "_model")

    def __init__(self, prof, kind):
        self.prof = prof
        self.kind = kind
        self.phases = {}
        self.meta = None
        self._items = 0
        self._flops = 0.0
        self._model = None
        self.t0 = time.perf_counter()

    def phase(self, name):
        return _Phase(self, name)

    def relabel(self, kind):
        """Retag the tick once the iteration knows what it did (a
        scheduler tick starts as "sched" and becomes decode/prefill/
        idle)."""
        self.kind = kind

    def add(self, name, seconds):
        """Fold a pre-measured duration into phase *name* (the unary
        path reuses its existing monotonic timestamps this way)."""
        self.phases[name] = self.phases.get(name, 0.0) + seconds

    def compute(self, model, items, flops_per_item=None):
        """Count device work delivered this tick (MFU numerator): the
        device seconds come from the tick's own compute-group phases."""
        self._model = model
        self._items += int(items)
        if flops_per_item:
            self._flops += float(flops_per_item) * int(items)

    def note(self, **meta):
        if self.meta is None:
            self.meta = {}
        self.meta.update(meta)

    def close(self):
        self.prof.finish(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.prof.finish(self)
        return False


class _NullTick:
    """Disarmed profiler's handle: every bracket is a no-op."""

    __slots__ = ()
    kind = None

    def phase(self, name):
        return _NULL_PHASE

    def relabel(self, kind):
        pass

    def add(self, name, seconds):
        pass

    def compute(self, model, items, flops_per_item=None):
        pass

    def note(self, **meta):
        pass

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_TICK = _NullTick()

# compute-group phase names (device seconds of one tick) — derived once
_DEVICE_PHASES = frozenset(ATTRIBUTION_GROUPS["compute"])


@witness_shared("_lock")
class PhaseProfiler:
    """Bounded ring of per-tick phase timings with windowed rollups.

    Always-on and cheap: ``start_tick``/``finish`` bracket one scheduler
    iteration / request / RPC; ``commit`` folds pre-measured durations
    in one call (the unary hot path).  Consecutive ``idle`` ticks
    coalesce in place so a quiet engine doesn't churn the ring.

    ``registry`` (late-bindable) receives the ``ctpu_prof_*`` series;
    per-model FLOP counts committed via ``_Tick.compute`` update the
    MFU and compute-share gauges using :func:`device_peak_tflops`.
    """

    def __init__(self, name="", capacity=4096, registry=None,
                 window_s=60.0, flush_interval_s=0.25):
        self.name = str(name)
        self.capacity = int(capacity)
        self.window_s = float(window_s)
        self.flush_interval_s = float(flush_interval_s)
        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=self.capacity)
        self._totals = {}        # phase -> cumulative seconds
        self._kinds = {}         # tick kind -> count
        self._wall_s = 0.0       # cumulative tick wall seconds
        self._models = {}        # model -> [device_s, items, flops]
        self._children = []      # adopted engine profilers (LM scheds)
        self._armed = True
        self.registry = registry
        self.ticks_noted = 0
        # metric deltas batched between registry flushes: exporting on
        # every commit costs several label-formatted registry ops per
        # tick, which alone would blow the <=2% overhead budget on a
        # cheap unary path.
        self._pending_ticks = {}   # kind -> count since last flush
        self._pending_phases = {}  # phase -> seconds since last flush
        self._last_flush = 0.0

    # -- arming ------------------------------------------------------------

    @property
    def armed(self):
        return self._armed

    def arm(self, on=True):
        """Toggle recording (the overhead-measurement hook; the profiler
        is armed by default).  Disarmed, ``start_tick`` hands out the
        shared no-op tick and ``commit`` returns immediately."""
        with self._lock:
            self._armed = bool(on)

    def set_registry(self, registry):
        with self._lock:
            self.registry = registry

    def adopt(self, child):
        """Register a per-engine child profiler (the LM scheduler's) so
        reports and flight dumps cover every engine in the server."""
        if child is None or child is self:
            return
        with self._lock:
            if child not in self._children:
                self._children.append(child)

    # -- recording ---------------------------------------------------------

    def start_tick(self, kind):
        """A new tick handle (or the no-op handle when disarmed).  The
        caller MUST finish it on every exit path: ``with`` the handle,
        or ``finish``/``close`` inside a ``finally`` — the SPAN-LEAK
        lint shape."""
        if not self._armed:
            return NULL_TICK
        return _Tick(self, kind)

    def finish(self, tick, kind=None):
        """Commit one tick handle to the ring (idempotent for the no-op
        handle)."""
        if tick is NULL_TICK or tick is None:
            return
        t1 = time.perf_counter()
        self.commit(
            kind if kind is not None else tick.kind,
            t1 - tick.t0,
            phases=tick.phases,
            model=tick._model,
            items=tick._items,
            flops=tick._flops,
            meta=tick.meta,
        )

    def commit(self, kind, dur_s, phases=None, model=None, items=0,
               flops=0.0, flops_per_item=None, meta=None):
        """Fold one pre-measured tick into the ring and rollup state —
        the zero-extra-clock path the unary engine and frontends use.
        ``flops_per_item`` is a convenience for callers that count items
        but carry per-item FLOP figures."""
        if not self._armed:
            return
        phases = phases or {}
        if flops_per_item and items:
            flops = float(flops) + float(flops_per_item) * int(items)
        device_s = 0.0
        for name, seconds in phases.items():
            if name in _DEVICE_PHASES:
                device_s += seconds
        record = {
            "ts": time.time(),
            "kind": str(kind),
            "dur_s": dur_s,
            "phases": phases,
        }
        if model is not None:
            record["model"] = str(model)
        if items:
            record["items"] = int(items)
        if meta:
            record.update(meta)
        flush = None
        with self._lock:
            ring = self._ring
            if (kind == "idle" and ring
                    and ring[-1]["kind"] == "idle"):
                # coalesce idle runs: a quiet engine must not wash real
                # ticks out of the bounded ring
                last = ring[-1]
                last["dur_s"] += dur_s
                last["ticks"] = last.get("ticks", 1) + 1
                for name, seconds in phases.items():
                    last["phases"][name] = (
                        last["phases"].get(name, 0.0) + seconds
                    )
            else:
                ring.append(record)
            self.ticks_noted += 1
            self._wall_s += dur_s
            self._kinds[kind] = self._kinds.get(kind, 0) + 1
            totals = self._totals
            pending = self._pending_phases
            for name, seconds in phases.items():
                totals[name] = totals.get(name, 0.0) + seconds
                pending[name] = pending.get(name, 0.0) + seconds
            self._pending_ticks[kind] = (
                self._pending_ticks.get(kind, 0) + 1
            )
            if model is not None and (device_s or items):
                entry = self._models.setdefault(model, [0.0, 0, 0.0])
                entry[0] += device_s
                entry[1] += int(items)
                entry[2] += float(flops)
            if (self.registry is not None
                    and record["ts"] - self._last_flush
                    >= self.flush_interval_s):
                flush = self._drain_pending_locked(record["ts"])
        if flush is not None:
            self._export(*flush)

    def _drain_pending_locked(self, now):
        """Grab-and-reset the batched metric deltas (caller holds the
        ring lock); returns the _export argument tuple."""
        ticks, self._pending_ticks = self._pending_ticks, {}
        phases, self._pending_phases = self._pending_phases, {}
        models = {m: list(v) for m, v in self._models.items()}
        self._last_flush = now
        return self.registry, ticks, phases, models

    def flush_metrics(self):
        """Force the batched ctpu_prof_* deltas out to the registry now
        (reports and tests; the commit path flushes on its own interval)."""
        with self._lock:
            if self.registry is None:
                return
            flush = self._drain_pending_locked(time.time())
        self._export(*flush)

    def _export(self, registry, ticks, phases, models):
        """Push one batch of metric deltas to the registry (outside the
        ring lock; the registry has its own)."""
        from client_tpu_torch.serve.metrics import PROF_HELP

        engine = self.name
        for kind, count in ticks.items():
            registry.inc(
                "ctpu_prof_ticks_total", {"engine": engine, "kind": kind},
                value=count,
                help_=PROF_HELP["ctpu_prof_ticks_total"],
            )
        for name, seconds in phases.items():
            registry.inc(
                "ctpu_prof_phase_seconds_total",
                {"engine": engine, "phase": name}, value=seconds,
                help_=PROF_HELP["ctpu_prof_phase_seconds_total"],
            )
        total_device = sum(v[0] for v in models.values())
        for model, (dev, _items, total_flops) in models.items():
            if total_device > 0.0:
                registry.set(
                    "ctpu_prof_compute_share_pct",
                    {"engine": engine, "model": model},
                    round(100.0 * dev / total_device, 3),
                    help_=PROF_HELP["ctpu_prof_compute_share_pct"],
                )
            if total_flops and dev > 0.0:
                peak, _kind = device_peak_tflops()
                registry.set(
                    "ctpu_prof_mfu_pct",
                    {"engine": engine, "model": model},
                    round(100.0 * total_flops / (dev * peak * 1e12), 4),
                    help_=PROF_HELP["ctpu_prof_mfu_pct"],
                )

    # -- reading -----------------------------------------------------------

    def snapshot(self, last=None):
        """The ring's records, oldest first (the last *last* when set)."""
        with self._lock:
            records = list(self._ring)
        if last is not None:
            records = records[-int(last):]
        return records

    def recent(self, last=16):
        """The last *last* tick records of this profiler AND every
        adopted child, each tagged with its engine name — what flight
        dumps carry."""
        with self._lock:
            children = list(self._children)
        out = []
        for prof in [self] + children:
            for record in prof.snapshot(last=last):
                tagged = dict(record)
                tagged["engine"] = prof.name
                out.append(tagged)
        out.sort(key=lambda r: r.get("ts", 0.0))
        return out

    def rollup(self, window_s=None, kinds=None):
        """Windowed attribution summary of this profiler's ring.

        *window_s* bounds the records considered (None = the profiler's
        default window; 0/negative = everything in the ring); *kinds*
        optionally filters tick kinds.  Returns phase totals with
        percentages, tick counts by kind, per-model device share / MFU,
        and the dispatch/compute/host/idle split."""
        if window_s is None:
            window_s = self.window_s
        cutoff = time.time() - window_s if window_s > 0 else None
        records = self.snapshot()
        if cutoff is not None:
            records = [r for r in records if r["ts"] >= cutoff]
        if kinds is not None:
            allowed = set(kinds)
            records = [r for r in records if r["kind"] in allowed]
        phases = {}
        kind_counts = {}
        models = {}
        wall = 0.0
        ticks = 0
        for record in records:
            n = record.get("ticks", 1)
            ticks += n
            wall += record["dur_s"]
            kind_counts[record["kind"]] = (
                kind_counts.get(record["kind"], 0) + n
            )
            device_s = 0.0
            for name, seconds in record["phases"].items():
                phases[name] = phases.get(name, 0.0) + seconds
                if name in _DEVICE_PHASES:
                    device_s += seconds
            model = record.get("model")
            if model is not None:
                entry = models.setdefault(model, [0.0, 0])
                entry[0] += device_s
                entry[1] += record.get("items", 0)
        covered = sum(phases.values())
        phase_rows = {
            name: {
                "s": round(seconds, 6),
                "pct": round(100.0 * seconds / covered, 2) if covered
                else 0.0,
            }
            for name, seconds in sorted(
                phases.items(), key=lambda kv: -kv[1]
            )
        }
        peak, peak_kind = device_peak_tflops()
        total_device = sum(v[0] for v in models.values())
        with self._lock:
            flops_by_model = {
                m: v[2] for m, v in self._models.items()
            }
        model_rows = {}
        for model, (device_s, items) in sorted(models.items()):
            row = {
                "device_s": round(device_s, 6),
                "items": items,
                "compute_share_pct": (
                    round(100.0 * device_s / total_device, 2)
                    if total_device else 0.0
                ),
            }
            flops = flops_by_model.get(model)
            if flops and device_s > 0.0:
                # lifetime FLOP/s over lifetime device time: the ring
                # window carries items but not flops per record
                with self._lock:
                    life = self._models.get(model)
                if life and life[0] > 0.0:
                    row["mfu_pct"] = round(
                        100.0 * life[2] / (life[0] * peak * 1e12), 4
                    )
            model_rows[model] = row
        return {
            "engine": self.name,
            "window_s": window_s,
            "ticks": ticks,
            "wall_s": round(wall, 6),
            "covered_s": round(covered, 6),
            "kinds": kind_counts,
            "phases": phase_rows,
            "models": model_rows,
            "attribution": attribute_phases(phases, wall_s=wall),
            "peak_tflops": peak,
            "peak_kind": peak_kind,
        }

    def report(self, window_s=None):
        """This profiler's rollup plus every adopted child's — the
        ``/v2/debug/prof`` payload and profview's input."""
        with self._lock:
            children = list(self._children)
        for prof in [self] + children:
            prof.flush_metrics()
        return {
            "kind": "prof_report",
            "ts": time.time(),
            "engines": [
                prof.rollup(window_s=window_s)
                for prof in [self] + children
            ],
        }
