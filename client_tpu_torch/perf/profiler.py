"""Measurement engine: windows, stability detection, summarization.

Parity with the reference InferenceProfiler (reference
src/c++/perf_analyzer/inference_profiler.{h,cc}): per load level, repeat
measurement windows until the last ``stability_window`` trials agree on both
latency and throughput within ``stability_threshold`` percent
(DetermineStability/CheckWindowForStability, inference_profiler.h:365-399),
clipping each window to requests that completed inside it
(ValidLatencyMeasurement, :442), then summarize client percentiles, send
rate, delayed/error counts, and server-side queue/compute deltas from the
statistics endpoint.

The port's copy of client_tpu/perf/profiler.py.  ``PerfStatus.tpu_metrics``
keeps its name (the JSON export's key); it carries the port's gauge names
(``ctpu_gpu_memory_*``, ``ctpu_probe_*``).
"""

import time

import numpy as np

from client_tpu_torch.utils import InferenceServerException


class PerfStatus:
    """Summary of one stabilized load level."""

    def __init__(self, level_label, level_value):
        self.level_label = level_label  # "concurrency" | "request_rate"
        self.level_value = level_value
        self.throughput = 0.0  # infer/sec
        self.latency_avg_us = 0.0
        self.percentiles_us = {}  # 50/90/95/99 -> usec
        self.completed_requests = 0
        self.error_count = 0
        self.delayed_count = 0
        self.send_rate = 0.0
        self.stable = False
        self.server_stats = {}
        self.ensemble_stats = {}  # composing model -> flat counter deltas
        self.tpu_metrics = {}  # gauge -> {avg, max} from MetricsManager
        # multi-replica runs: endpoint -> {count, throughput, avg_us,
        # p99_us, errors} (empty for single-endpoint runs)
        self.per_endpoint = {}
        # --tenants mixes: tenant -> same split (empty below two tenants);
        # the per-tenant p99 is the noisy-neighbor isolation readout
        self.per_tenant = {}
        self.client_window_s = 0.0
        # Fraction of worker-slot wall time NOT spent inside a request —
        # harness bookkeeping + data rotation (reference "perf_analyzer
        # overhead", inference_profiler.h:430-533).
        self.overhead_pct = 0.0
        # --prefix-share sweeps: this level's KV prefix-cache outcome
        # ({"prefix_hit_pct", "prefill_tokens_saved_pct", raw deltas};
        # empty when no prefix probe is wired)
        self.lm_prefix = {}
        # --speculative sweeps: this level's draft/verify outcome
        # ({"spec_acceptance_pct", "spec_tokens_per_sec", raw deltas};
        # empty when no spec probe is wired)
        self.lm_spec = {}

    def latency_us(self, percentile=None):
        if percentile is None:
            return self.latency_avg_us
        return self.percentiles_us.get(percentile, 0.0)


class Measurement:
    __slots__ = ("throughput", "latency_avg_ns", "latencies_ns", "errors",
                 "delayed", "window_s", "send_rate", "busy_ns",
                 "per_endpoint", "per_tenant")

    def __init__(self, throughput, latency_avg_ns, latencies_ns, errors,
                 delayed, window_s, send_rate, busy_ns=0, per_endpoint=None,
                 per_tenant=None):
        self.throughput = throughput
        self.latency_avg_ns = latency_avg_ns
        self.latencies_ns = latencies_ns
        self.errors = errors
        self.delayed = delayed
        self.window_s = window_s
        self.send_rate = send_rate
        self.busy_ns = busy_ns  # total in-request time across worker slots
        # endpoint -> {"latencies_ns": ndarray, "errors": int} for this
        # window (only populated when records carry endpoint identities)
        self.per_endpoint = per_endpoint or {}
        self.per_tenant = per_tenant or {}


class InferenceProfiler:
    def __init__(self, manager, backend=None, measurement_window_s=1.0,
                 max_trials=10, stability_threshold=0.1, stability_window=3,
                 percentile=None, verbose=False, metrics_manager=None,
                 rendezvous=None, measurement_mode="time_windows",
                 measurement_request_count=50):
        """stability_threshold is fractional (0.1 == ±10%, the reference's
        default); percentile selects the latency used for the stability check
        (None = average, reference --percentile).

        measurement_mode: "time_windows" closes each window after
        ``measurement_window_s``; "count_windows" closes it after
        ``measurement_request_count`` completed requests (reference
        --measurement-mode count_windows, inference_profiler.h:430-533),
        with a 10x-window time cap so an idle server cannot hang the sweep.
        """
        self.manager = manager
        self.backend = backend
        self.window_s = measurement_window_s
        self.max_trials = max_trials
        self.threshold = stability_threshold
        self.stability_window = stability_window
        self.percentile = percentile
        self.verbose = verbose
        self.metrics = metrics_manager  # optional MetricsManager
        self.rendezvous = rendezvous  # optional multi-rank coordinator
        if measurement_mode not in ("time_windows", "count_windows"):
            raise InferenceServerException(
                f"unknown measurement mode '{measurement_mode}'"
            )
        self.measurement_mode = measurement_mode
        self.request_count = int(measurement_request_count)
        # optional zero-arg callable returning the LM engine's prefix-
        # cache counters ({hits, misses, prefill_tokens, saved_tokens});
        # wired by the CLI for --prefix-share runs so every sweep level
        # reports its hit rate and prefill savings as a counter DELTA
        self.prefix_probe = None
        # --speculative analogue ({proposed, accepted, lm_tokens}); per
        # level the delta yields acceptance rate and decode tokens/s
        self.spec_probe = None

    # -- one window ----------------------------------------------------------

    def measure(self):
        if self.measurement_mode == "count_windows":
            return self._measure_count()
        window_start = time.monotonic_ns()
        self.manager.get_and_reset_num_sent()
        time.sleep(self.window_s)
        sent = self.manager.get_and_reset_num_sent()
        records = self.manager.swap_timestamps()
        # close the window after the swap so a record completing during the
        # swap itself is never clipped as "future"
        window_end = time.monotonic_ns()
        self.manager.check_health()
        return self._window_measurement(
            records, window_start, window_end, sent
        )

    def _measure_count(self):
        """Close the window once ``request_count`` requests have completed
        inside it (MeasureForCountWindows); capped at 10x the time window so
        a stalled server surfaces as a short, zero-ish measurement instead
        of a hang."""
        window_start = time.monotonic_ns()
        deadline = window_start + int(self.window_s * 10 * 1e9)
        self.manager.get_and_reset_num_sent()
        records = []
        sent = 0
        while True:
            time.sleep(min(0.02, self.window_s))
            sent += self.manager.get_and_reset_num_sent()
            records.extend(self.manager.swap_timestamps())
            now = time.monotonic_ns()
            done = sum(
                1 for r in records
                if r.ok and window_start <= r.end_ns <= now
            )
            if done >= self.request_count or now >= deadline:
                window_end = now
                break
        self.manager.check_health()
        return self._window_measurement(
            records, window_start, window_end, sent
        )

    def _window_measurement(self, records, window_start, window_end, sent):
        # ValidLatencyMeasurement: only requests completing inside the window
        valid = [r for r in records
                 if window_start <= r.end_ns <= window_end and r.ok]
        errors = sum(1 for r in records if not r.ok)
        delayed = sum(1 for r in valid if r.delayed)
        window_s = (window_end - window_start) / 1e9
        lat = np.array([r.end_ns - r.start_ns for r in valid], np.int64)
        # In-request time attributed to the window a request COMPLETES in
        # (full duration, not clipped at window_start): consecutive windows
        # then conserve busy time — clipping both ends would drop the
        # prior-window portion of every in-flight request and overstate
        # harness overhead.  Failed requests count too (the slot was busy).
        busy = sum(
            r.end_ns - r.start_ns
            for r in records
            if r.end_ns <= window_end
        )
        per_endpoint = self._group_window(records, valid, "endpoint")
        per_tenant = self._group_window(records, valid, "tenant")
        return Measurement(
            throughput=len(valid) / window_s if window_s > 0 else 0.0,
            latency_avg_ns=float(lat.mean()) if lat.size else 0.0,
            latencies_ns=lat,
            errors=errors,
            delayed=delayed,
            window_s=window_s,
            send_rate=sent / window_s if window_s > 0 else 0.0,
            busy_ns=int(busy),
            per_endpoint=per_endpoint,
            per_tenant=per_tenant,
        )

    @staticmethod
    def _group_window(records, valid, attr):
        """One window's {group: latencies/errors} split keyed on a record
        attribute — the shared shape behind the per-endpoint (replica) and
        per-tenant (QoS) summaries."""
        groups = {}
        if not any(getattr(r, attr) for r in records):
            return groups
        for r in valid:
            entry = groups.setdefault(
                getattr(r, attr), {"latencies_ns": [], "errors": 0}
            )
            entry["latencies_ns"].append(r.end_ns - r.start_ns)
        for r in records:
            if not r.ok:
                entry = groups.setdefault(
                    getattr(r, attr), {"latencies_ns": [], "errors": 0}
                )
                entry["errors"] += 1
        for entry in groups.values():
            entry["latencies_ns"] = np.asarray(
                entry["latencies_ns"], np.int64
            )
        return groups

    # -- stability loop ------------------------------------------------------

    def _stability_metric(self, m):
        if self.percentile and m.latencies_ns.size:
            return float(np.percentile(m.latencies_ns, self.percentile))
        return m.latency_avg_ns

    def _is_stable(self, window):
        if len(window) < self.stability_window:
            return False
        tps = [m.throughput for m in window]
        lats = [self._stability_metric(m) for m in window]
        if any(m.throughput == 0 for m in window):
            return False
        for series in (tps, lats):
            avg = np.mean(series)
            if avg <= 0:
                return False
            if max(abs(v - avg) / avg for v in series) > self.threshold:
                return False
        return True

    def profile_level(self, label, value):
        """Run windows at the current manager configuration until stable."""
        before_prefix = (
            self.prefix_probe() if self.prefix_probe is not None else None
        )
        before_spec = (
            self.spec_probe() if self.spec_probe is not None else None
        )
        t0 = time.monotonic()
        status = self._profile_level_windows(label, value)
        elapsed_s = time.monotonic() - t0
        if before_prefix is not None:
            status.lm_prefix = self._prefix_delta(before_prefix)
        if before_spec is not None:
            status.lm_spec = self._spec_delta(before_spec, elapsed_s)
        return status

    def _prefix_delta(self, before):
        after = self.prefix_probe()
        delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
        looked = delta.get("hits", 0) + delta.get("misses", 0)
        prefilled = (
            delta.get("prefill_tokens", 0) + delta.get("saved_tokens", 0)
        )
        return {
            "prefix_hit_pct": (
                round(100.0 * delta.get("hits", 0) / looked, 2)
                if looked else 0.0
            ),
            "prefill_tokens_saved_pct": (
                round(100.0 * delta.get("saved_tokens", 0) / prefilled, 2)
                if prefilled else 0.0
            ),
            **delta,
        }

    def _spec_delta(self, before, elapsed_s):
        after = self.spec_probe()
        delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
        proposed = delta.get("proposed", 0)
        return {
            "spec_acceptance_pct": (
                round(100.0 * delta.get("accepted", 0) / proposed, 2)
                if proposed else 0.0
            ),
            # delivered LM tokens over the level's wall clock: the
            # speedup readout a spec-on vs spec-off A/B divides
            "spec_tokens_per_sec": (
                round(delta.get("lm_tokens", 0) / elapsed_s, 1)
                if elapsed_s > 0 else 0.0
            ),
            **delta,
        }

    def _profile_level_windows(self, label, value):
        if self.metrics is not None:
            self.metrics.swap_snapshots()  # drop pre-level scrapes
        window = []
        for trial in range(self.max_trials):
            m = self.measure()
            window.append(m)
            if len(window) > self.stability_window:
                window.pop(0)
            if self.verbose:
                print(
                    f"  [trial {trial + 1}] {label}={value} "
                    f"throughput={m.throughput:.1f}/s "
                    f"avg_lat={m.latency_avg_ns / 1e3:.0f}us "
                    f"errors={m.errors}"
                )
            local_stable = self._is_stable(window)
            # multi-rank: keep measuring until EVERY rank stabilizes
            # (reference AllMPIRanksAreStable, inference_profiler.h:537)
            all_stable = (
                self.rendezvous.all_ranks_stable(local_stable)
                if self.rendezvous is not None
                else local_stable
            )
            if all_stable:
                return self._summarize(label, value, window, stable=True)
        # ranks stay in lockstep here: one consensus per trial and identical
        # max_trials means every rank leaves the loop on the same trial
        return self._summarize(label, value, window, stable=False)

    def _summarize(self, label, value, window, stable):
        status = PerfStatus(label, value)
        status.stable = stable
        all_lat = (
            np.concatenate([m.latencies_ns for m in window])
            if window else np.array([], np.int64)
        )
        status.completed_requests = int(all_lat.size)
        status.client_window_s = sum(m.window_s for m in window)
        status.throughput = float(np.mean([m.throughput for m in window]))
        status.send_rate = float(np.mean([m.send_rate for m in window]))
        status.error_count = sum(m.errors for m in window)
        status.delayed_count = sum(m.delayed for m in window)
        if all_lat.size:
            status.latency_avg_us = float(all_lat.mean()) / 1e3
            wanted = {50, 90, 95, 99}
            if self.percentile:
                wanted.add(self.percentile)  # the stability-governing one
            for p in sorted(wanted):
                status.percentiles_us[p] = float(np.percentile(all_lat, p)) / 1e3
        # Harness overhead is only meaningful for concurrency mode, where a
        # slot is meant to be saturated; request-rate workers idle between
        # scheduled sends BY DESIGN, so the ratio would just measure pacing.
        slots = int(getattr(self.manager, "concurrency", 0) or 0)
        total_slot_ns = sum(m.window_s for m in window) * slots * 1e9
        if label == "concurrency" and total_slot_ns > 0:
            busy = sum(m.busy_ns for m in window)
            status.overhead_pct = round(
                max(0.0, 100.0 * (1.0 - busy / total_slot_ns)), 2
            )
        status.per_endpoint = self._group_summary(window, "per_endpoint")
        status.per_tenant = self._group_summary(window, "per_tenant")
        if self.metrics is not None:
            status.tpu_metrics = self.metrics.summarize(
                self.metrics.swap_snapshots()
            )
        return status

    @staticmethod
    def _group_summary(window, attr):
        """Aggregate the windows' grouped measurements (``per_endpoint`` or
        ``per_tenant``) into the summary's throughput/latency split (only
        meaningful past one group)."""
        groups = sorted({g for m in window for g in getattr(m, attr)})
        if len(groups) < 2:
            return {}
        total_s = sum(m.window_s for m in window)
        out = {}
        for group in groups:
            lat = [
                getattr(m, attr)[group]["latencies_ns"]
                for m in window
                if group in getattr(m, attr)
            ]
            lat = (
                np.concatenate([a for a in lat if a.size] or
                               [np.array([], np.int64)])
            )
            errors = sum(
                getattr(m, attr).get(group, {}).get("errors", 0)
                for m in window
            )
            out[group] = {
                "count": int(lat.size),
                "throughput": lat.size / total_s if total_s > 0 else 0.0,
                "avg_us": float(lat.mean()) / 1e3 if lat.size else 0.0,
                "p99_us": (
                    float(np.percentile(lat, 99)) / 1e3 if lat.size else 0.0
                ),
                "errors": int(errors),
            }
        return out

    def profile_completion(self, concurrency, window_s=8.0, warmup_s=2.0):
        """Drain-corrected completion throughput for shared-memory outputs.

        One fixed window at ``concurrency``, then the workers stop and the
        data manager drains (``sync_outputs()``: every output region read
        back to the host) before the clock closes, so the reported
        infer/sec counts only work whose outputs are readable.  The
        reference's TPU server acks at device dispatch, so its drain
        matters; the port's server waits for its output copies before it
        answers (utils/cuda_shared_memory, "Ordering across processes"),
        so an ack already means completion and the drain only adds the
        reads.  Latency percentiles are still ack latencies (the
        per-request completion variant is ``--cuda-shm-sync``)."""
        self.manager.change_concurrency_level(concurrency)
        time.sleep(warmup_s)
        self.manager.swap_timestamps()
        self.manager.get_and_reset_num_sent()
        t0 = time.monotonic_ns()
        time.sleep(window_s)
        self.manager.stop_workers()
        sync = getattr(self.manager.data_manager, "sync_outputs", None)
        if sync is not None:
            sync()
        t1 = time.monotonic_ns()
        records = self.manager.swap_timestamps()
        sent = self.manager.get_and_reset_num_sent()
        status = PerfStatus("concurrency", concurrency)
        ok = [r for r in records if r.ok]
        lat = np.array([r.end_ns - r.start_ns for r in ok], np.int64)
        elapsed = (t1 - t0) / 1e9
        status.throughput = len(ok) / elapsed if elapsed > 0 else 0.0
        status.completed_requests = len(ok)
        status.client_window_s = elapsed
        status.error_count = len(records) - len(ok)
        status.send_rate = sent / elapsed if elapsed > 0 else 0.0
        status.stable = True  # single drained window: no stability loop
        if lat.size:
            status.latency_avg_us = float(lat.mean()) / 1e3
            for p in (50, 90, 95, 99):
                status.percentiles_us[p] = float(np.percentile(lat, p)) / 1e3
        if self.metrics is not None:
            status.tpu_metrics = self.metrics.summarize(
                self.metrics.swap_snapshots()
            )
        return status

    # -- search over load levels ---------------------------------------------

    def profile_concurrency_range(self, start, end, step, latency_limit_us=None):
        """Linear sweep (reference Profile<size_t>, inference_profiler.h:243)."""
        results = []
        c = start
        while c <= end:
            self.manager.change_concurrency_level(c)
            before = self._server_stats()
            before_ens = self._ensemble_stats()
            status = self.profile_level("concurrency", c)
            status.server_stats = self._server_stats_delta(before)
            status.ensemble_stats = self._ensemble_stats_delta(before_ens)
            results.append(status)
            if latency_limit_us and status.latency_us(
                self.percentile
            ) > latency_limit_us:
                break
            c += step
        return results

    def profile_request_rate_range(self, start, end, step,
                                   latency_limit_us=None):
        results = []
        r = start
        while r <= end:
            self.manager.change_request_rate(r)
            before = self._server_stats()
            before_ens = self._ensemble_stats()
            status = self.profile_level("request_rate", r)
            status.server_stats = self._server_stats_delta(before)
            status.ensemble_stats = self._ensemble_stats_delta(before_ens)
            results.append(status)
            if latency_limit_us and status.latency_us(
                self.percentile
            ) > latency_limit_us:
                break
            r += step
        return results

    def profile_concurrency_binary(self, start, end, latency_limit_us):
        """Binary search for max concurrency under the latency limit
        (SearchMode::BINARY)."""
        results = []
        lo, hi = start, end
        best = None
        while lo <= hi:
            mid = (lo + hi) // 2
            self.manager.change_concurrency_level(mid)
            status = self.profile_level("concurrency", mid)
            results.append(status)
            if status.latency_us(self.percentile) <= latency_limit_us:
                best = status
                lo = mid + 1
            else:
                hi = mid - 1
        return results, best

    def profile_request_rate_binary(self, start, end, latency_limit_us,
                                    resolution=None):
        """SLO-seeking search over REQUEST RATE: the max sustainable
        open-loop req/s whose stabilized latency (``percentile`` when
        set, else the average) stays under ``latency_limit_us``.

        Concurrency search answers "how many outstanding requests fit";
        this answers the capacity-planning question — "what arrival rate
        can I advertise under my p99 SLO" — on the open-loop schedule
        whose queueing collapse closed-loop concurrency sweeps hide.
        Bisects [start, end] to ``resolution`` req/s (default: 1/16 of
        the span); returns (all measured levels, best passing level or
        None when even ``start`` violates the SLO).
        """
        lo, hi = float(start), float(end)
        if resolution is None or resolution <= 0:
            resolution = max((hi - lo) / 16.0, 1e-3)

        def measure(rate):
            self.manager.change_request_rate(rate)
            before = self._server_stats()
            before_ens = self._ensemble_stats()
            status = self.profile_level("request_rate", round(rate, 3))
            status.server_stats = self._server_stats_delta(before)
            status.ensemble_stats = self._ensemble_stats_delta(before_ens)
            return status

        results = []
        # probe start explicitly: bisection midpoints never reach lo, so
        # without this a capacity at/just above `start` would be reported
        # as "no passing rate" instead of `start` itself
        status = measure(lo)
        results.append(status)
        if status.latency_us(self.percentile) > latency_limit_us:
            return results, None
        best = status
        while hi - lo >= resolution:
            mid = (lo + hi) / 2.0
            status = measure(mid)
            results.append(status)
            if status.latency_us(self.percentile) <= latency_limit_us:
                best = status
                lo = mid
            else:
                hi = mid
        return results, best

    # -- server-side stats ---------------------------------------------------

    def _server_stats(self):
        if self.backend is None:
            return {}
        try:
            stats = self.backend.statistics(self.manager.model_name)
        except (InferenceServerException, NotImplementedError):
            return {}
        return _flatten_stats(stats)

    def _server_stats_delta(self, before):
        after = self._server_stats()
        return {
            k: after.get(k, 0) - before.get(k, 0)
            for k in after
        }

    # -- ensemble recursion (reference EnsembleDurations,
    #    inference_profiler.h:77-120) ----------------------------------------

    def _composing_models(self):
        """Transitive composing-model names of the swept model, resolved once
        per profiler (the topology is static across a sweep) via ModelParser
        — the single implementation of the ensemble walk."""
        cached = getattr(self, "_composing_cache", None)
        if cached is not None:
            return cached
        composing = []
        if self.backend is not None:
            from client_tpu_torch.perf.model_parser import ModelParser

            try:
                composing = ModelParser.create(
                    self.backend, self.manager.model_name
                ).composing_models
            except (InferenceServerException, NotImplementedError, KeyError):
                composing = []
        self._composing_cache = composing
        return composing

    def _ensemble_stats(self):
        """Flat counters per composing model of the swept ensemble (empty for
        non-ensemble models)."""
        composing = self._composing_models()
        out = {}
        for name in composing:
            try:
                out[name] = _flatten_stats(self.backend.statistics(name))
            except (InferenceServerException, NotImplementedError):
                out[name] = {}
        return out

    def _ensemble_stats_delta(self, before):
        after = self._ensemble_stats()
        return {
            name: {
                k: counters.get(k, 0) - before.get(name, {}).get(k, 0)
                for k in counters
            }
            for name, counters in after.items()
        }


def _flatten_stats(stats):
    """Normalize a statistics() response into flat counters (ns totals).
    Accepts the wire shape ({"model_stats": [...]}) and the in-process
    engine's bare list of per-model entries."""
    out = {}
    if isinstance(stats, dict):
        model_stats = stats.get("model_stats", [])
    elif isinstance(stats, list):
        model_stats = stats
    else:
        model_stats = []
    for ms in model_stats:
        agg = ms.get("inference_stats", {})
        for phase in ("success", "queue", "compute_input", "compute_infer",
                      "compute_output", "cache_hit", "cache_miss"):
            entry = agg.get(phase, {})
            out[f"{phase}_count"] = out.get(f"{phase}_count", 0) + int(
                entry.get("count", 0)
            )
            out[f"{phase}_ns"] = out.get(f"{phase}_ns", 0) + int(
                entry.get("ns", 0)
            )
    return out
