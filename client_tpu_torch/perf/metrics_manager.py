"""Server metrics scraping during measurement.

Parity with the reference MetricsManager (reference
src/c++/perf_analyzer/metrics_manager.h:44-91): a background thread polls
the server's Prometheus ``/metrics`` on an interval and keeps per-window
snapshots; the profiler merges them into each load level's summary.  The
gauges of interest are the GPU ones the port's server exposes
(``ctpu_gpu_memory_*``, serve/metrics.py) plus the inference counters —
the ``nv_gpu_utilization`` analog set.

The port's copy of client_tpu/perf/metrics_manager.py.  Its two device
parts read the local GPU through torch.cuda: :func:`local_device_snapshot`
(the gauges a colocated perf process reads itself) and
:class:`DeviceUtilizationProbe` (a one-element add timed on a stream of
its own; its delay is not a utilization figure, see the class).  Both
raise without CUDA, where the reference's snapshot returns
``{}`` off-device, and import torch only when they run: the scraper
itself needs none.
"""

import threading
import time
import urllib.request

import numpy as np

from client_tpu_torch import require_torch, resolve_device
from client_tpu_torch.analysis.witness import witness_shared
from client_tpu_torch.utils import escape_label


def parse_prometheus(text):
    """Prometheus text format -> {metric_name: [(labels_str, value), ...]}."""
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            name_part, value_part = line.rsplit(" ", 1)
            value = float(value_part)
        except ValueError:
            continue
        if "{" in name_part:
            name, labels = name_part.split("{", 1)
            labels = "{" + labels
        else:
            name, labels = name_part, ""
        out.setdefault(name, []).append((labels, value))
    return out


def local_device_snapshot():
    """GPU gauges read directly from this process's CUDA runtime — the
    telemetry source of last resort when the *server* under test exposes
    no GPU gauges (any third-party KServe server).  Only meaningful when
    the perf process is colocated with the card.  For every visible
    device: ``ctpu_gpu_memory_used_bytes`` is the device's total less its
    free bytes (``torch.cuda.mem_get_info``: every process's allocations),
    ``ctpu_gpu_memory_total_bytes`` its capacity, and
    ``ctpu_gpu_memory_peak_bytes`` this process's own allocator peak
    (``torch.cuda.memory_stats``).  Raises without torch or CUDA."""
    torch = require_torch("local GPU metrics")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "local GPU metrics need CUDA, and this machine has none"
        )
    out = {}
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        stats = torch.cuda.memory_stats(i)
        labels = f'{{device="{escape_label(i)}",source="local"}}'
        out.setdefault("ctpu_gpu_memory_used_bytes", []).append(
            (labels, float(total - free))
        )
        out.setdefault("ctpu_gpu_memory_total_bytes", []).append(
            (labels, float(total))
        )
        out.setdefault("ctpu_gpu_memory_peak_bytes", []).append(
            (labels, float(stats.get("allocated_bytes.all.peak", 0)))
        )
    return out


class DeviceUtilizationProbe:
    """Server-independent device probe: the delay a one-element add
    waits on the LOCAL device.

    Launches the add on a non-default stream of its own and times it to
    completion; latency beyond the idle baseline is what the probe waited
    for.  This trusts nothing the server under test reports — the blind
    spot the reference perf_analyzer has for non-Triton servers (its
    nv_gpu_utilization comes from Triton's own /metrics).

    On a GPU the delay is not a utilization figure, and what it reads
    depends on where the load runs (measured on an H100, PERF.md §6):

    - in the process that runs the load (an in-process server), the
      probe's block waits until the running kernels leave an SM free: it
      reads their occupancy.  Under one load of SM-filling GEMMs it read
      a few µs in one run (it slipped in at kernels' tails) and a whole
      GEMM (~1.4 ms) in another;
    - from another process, the two CUDA contexts time-slice the GPU (no
      MPS): under any load the probe waits out the other context's time
      slice (~2.4 ms on the H100), whatever that context's kernels fill,
      and reads as near-always busy.

    Per sample: queue delay in us, and a busy flag (latency >
    busy_factor × idle baseline).  A window of samples summarizes as
    ``ctpu_probe_utilization_pct``, the busy share of the samples (the
    reference harness's gauge name, kept so the reports line up): probes
    are point samples, so short kernels can slip between them.  For the
    device's busy share, read the server's own busy counter.  ``device``
    is ``cuda`` unless the caller passes ``"cpu"`` (the tests: a host
    add, no stream).
    """

    def __init__(self, busy_factor=2.0, baseline_samples=8, device=None):
        torch = require_torch("the device utilization probe")
        self._torch = torch
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.busy_factor = busy_factor
        self.device_id = dev.index if dev.index is not None else 0
        self._x = torch.ones((), dtype=torch.float32, device=dev)
        self._y = torch.empty_like(self._x)
        self._stream = (
            torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
        )
        self._time()  # first launch outside the baseline
        lats = [self._time() for _ in range(baseline_samples)]
        # min: the emptiest-queue observation is the best idle estimate
        self.baseline_s = max(min(lats), 1e-6)

    def _time(self):
        """Seconds from launching the add to its completion."""
        torch = self._torch
        t0 = time.perf_counter()
        if self._stream is None:
            torch.add(self._x, 1.0, out=self._y)
        else:
            with torch.cuda.stream(self._stream):
                torch.add(self._x, 1.0, out=self._y)
            self._stream.synchronize()
        return time.perf_counter() - t0

    def sample(self):
        """One probe: (queue_delay_us, busy 0/1)."""
        lat = self._time()
        delay_us = max(0.0, (lat - self.baseline_s) * 1e6)
        busy = 1.0 if lat > self.busy_factor * self.baseline_s else 0.0
        return delay_us, busy


@witness_shared("_lock")
class MetricsManager:
    def __init__(self, metrics_url, interval_s=1.0, timeout_s=5.0,
                 include_local_devices=False, utilization_probe=None):
        self.metrics_url = metrics_url
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.include_local_devices = include_local_devices
        self.utilization_probe = utilization_probe
        self._snapshots = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self.scrape_errors = 0

    def scrape(self):
        try:
            with urllib.request.urlopen(
                self.metrics_url, timeout=self.timeout_s
            ) as r:
                snap = parse_prometheus(
                    r.read().decode("utf-8", errors="replace")
                )
        except Exception:
            # A server with no /metrics endpoint at all is the PRIMARY
            # local-telemetry use case: the local snapshot and the
            # utilization probe must still flow.  (On re-raise the polling
            # loop counts the scrape error; the fallback success path
            # counts it here — exactly once either way.)
            if not self.include_local_devices and self.utilization_probe is None:
                raise
            local = dict(
                self._local_snapshot() if self.include_local_devices else {}
            )
            self._probe_into(local)
            if not local:
                raise
            with self._lock:  # scrape() runs caller- and loop-side
                self.scrape_errors += 1
            return local
        if self.include_local_devices:
            for name, entries in self._local_snapshot().items():
                # server-reported gauges win; local fills the blind spot
                if name not in snap:
                    snap[name] = entries
        self._probe_into(snap)
        return snap

    def _probe_into(self, snap):
        if self.utilization_probe is None:
            return
        try:
            delay_us, busy = self.utilization_probe.sample()
        except Exception:
            return
        labels = (
            f'{{device="{escape_label(self.utilization_probe.device_id)}"'
            ',source="probe"}'
        )
        snap["ctpu_probe_queue_delay_us"] = [(labels, delay_us)]
        snap["ctpu_probe_busy"] = [(labels, busy)]

    _local_snapshot = staticmethod(local_device_snapshot)

    def start(self):
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    snap = self.scrape()
                    with self._lock:
                        self._snapshots.append(snap)
                except Exception:
                    with self._lock:
                        self.scrape_errors += 1
                self._stop.wait(self.interval_s)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def swap_snapshots(self):
        """Collect-and-clear, like the managers' timestamp swap."""
        with self._lock:
            snaps = self._snapshots
            self._snapshots = []
        return snaps

    # Series families summarize() folds in wholesale: the LM engine, the
    # fleet tier, the SLO watchdog, the flight recorder and the profiler
    # all export under these prefixes, and a fixed gauge list would
    # silently drop every series added after it was written.
    SERIES_PREFIXES = ("ctpu_lm_", "ctpu_fleet_", "ctpu_slo_",
                      "ctpu_flight_", "ctpu_prof_")

    @staticmethod
    def summarize(snapshots, gauges=("ctpu_gpu_memory_used_bytes",
                                     "ctpu_gpu_memory_total_bytes",
                                     "ctpu_gpu_memory_peak_bytes",
                                     "ctpu_probe_queue_delay_us"),
                  prefixes=None):
        """Max/avg per gauge over the window's snapshots (the reference
        merges per-GPU utilization/memory the same way), plus every
        series matching :data:`SERIES_PREFIXES`: gauges aggregate as
        avg/max of their per-snapshot label-summed values, ``*_total``
        counters as the window delta (reported as avg==max so the
        report's column pair renders them unchanged)."""
        summary = {}
        for gauge in gauges:
            values = []
            for snap in snapshots:
                for _, v in snap.get(gauge, []):
                    values.append(v)
            if values:
                summary[gauge] = {
                    "avg": float(np.mean(values)),
                    "max": float(np.max(values)),
                }
        prefixes = (
            MetricsManager.SERIES_PREFIXES if prefixes is None else prefixes
        )
        names = sorted({
            name
            for snap in snapshots
            for name in snap
            if name.startswith(tuple(prefixes)) and name not in summary
        })
        for name in names:
            # quantile/rate gauges are NOT additive across label sets:
            # summing two models' p99s reports a latency nobody saw (and
            # summed error rates exceed 1.0) — take the worst label
            # instead; usage/count gauges fold by sum as before
            additive = not (
                name.endswith(("_ms", "_rate", "_pct"))
            )
            fold = sum if additive else max
            sums = [
                fold(v for _, v in snap[name])
                for snap in snapshots
                if snap.get(name)
            ]
            if not sums:
                continue
            if name.endswith("_total"):
                delta = float(sums[-1] - sums[0]) if len(sums) > 1 else float(
                    sums[-1]
                )
                summary[name] = {"avg": delta, "max": delta}
            else:
                summary[name] = {
                    "avg": float(np.mean(sums)),
                    "max": float(np.max(sums)),
                }
        # utilization gauges are emitted in PERCENT: the report renders
        # tpu_metrics with :.0f, which would flatten a 0-1 fraction to 0/1
        util = MetricsManager.utilization(snapshots)
        if util is not None:
            summary["ctpu_server_utilization_pct"] = {
                "avg": util * 100.0, "max": util * 100.0,
            }
        # probe-based estimate: fraction of window probes that found the
        # device busy — utilization without trusting the server under test
        busy = [
            v for snap in snapshots for _, v in snap.get("ctpu_probe_busy", [])
        ]
        if busy:
            summary["ctpu_probe_utilization_pct"] = {
                "avg": float(np.mean(busy)) * 100.0,
                "max": float(np.max(busy)) * 100.0,
            }
        summary.update(MetricsManager.server_breakdown(snapshots))
        return summary

    @staticmethod
    def server_breakdown(snapshots):
        """Server-side per-inference phase breakdown over the window.

        Deltas the cumulative ``ctpu_inference_{queue,compute_*}_duration_us``
        counters (summed across models) between the window's first and last
        scrape and divides by the successful-request delta — so the perf
        report shows where server time went (queue vs compute) next to the
        client-observed latency, the reference perf_analyzer's
        server-side-breakdown column set."""

        def total(snap, name):
            return sum(v for _, v in snap.get(name, []))

        if len(snapshots) < 2:
            return {}
        first, last = snapshots[0], snapshots[-1]
        d_requests = total(last, "ctpu_inference_request_success") - total(
            first, "ctpu_inference_request_success"
        )
        if d_requests <= 0:
            return {}
        out = {}
        for phase in ("queue", "compute_input", "compute_infer",
                      "compute_output"):
            metric = f"ctpu_inference_{phase}_duration_us"
            if metric not in last:
                continue
            avg = (total(last, metric) - total(first, metric)) / d_requests
            # real max: worst per-infer rate over consecutive scrape
            # intervals (reporting max==avg would hide window spikes)
            worst = avg
            for a, b in zip(snapshots, snapshots[1:]):
                d_req = total(b, "ctpu_inference_request_success") - total(
                    a, "ctpu_inference_request_success"
                )
                if d_req <= 0:
                    continue
                rate = (total(b, metric) - total(a, metric)) / d_req
                worst = max(worst, rate)
            out[f"ctpu_server_{phase}_us_per_infer"] = {
                "avg": avg, "max": worst,
            }
        return out

    @staticmethod
    def utilization(snapshots):
        """Server duty cycle over the window: delta(busy_ns) / delta(wall),
        from the ctpu_server_busy_ns counter + scrape timestamps.  The
        nv_gpu_utilization analog; None when fewer than two usable scrapes."""

        def point(snap):
            busy = snap.get("ctpu_server_busy_ns")
            ts = snap.get("ctpu_scrape_timestamp_seconds")
            if not busy or not ts:
                return None
            return ts[0][1], busy[0][1]

        points = [p for p in (point(s) for s in snapshots) if p is not None]
        if len(points) < 2:
            return None
        (t0, b0), (t1, b1) = points[0], points[-1]
        if t1 <= t0:
            return None
        return max(0.0, min(1.0, (b1 - b0) / 1e9 / (t1 - t0)))
