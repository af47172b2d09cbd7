"""Result reporting: stdout summary + CSV and JSON export.

Parity with the reference ReportWriter (reference
src/c++/perf_analyzer/report_writer.cc:39-246): a per-level stdout block in
the perf_analyzer format and a CSV with one row per load level (verbose adds
send rate, delayed/error counts and server-side breakdown columns).  The
JSON export carries the FULL per-sweep-point record (every latency
percentile, per-endpoint/per-tenant splits, server + ensemble stats
deltas, tpu_metrics aggregates) — the machine-readable companion the flat
CSV column set cannot hold.

The port's copy of client_tpu/perf/report.py.  ``tpu_metrics`` keeps its
name in the records and the JSON export, so both packages' exports read
alike; in the port it holds the ``ctpu_gpu_memory_*`` gauges (and the
probe's) where the reference's holds ``ctpu_tpu_memory_*``.
"""

import csv
import json


def print_summary(results, percentile=None):
    """``percentile`` marks which latency governed the stability check."""
    for s in results:
        label = s.level_label.replace("_", " ").title()
        print(f"{label}: {s.level_value}")
        if not s.stable:
            print("  WARNING: measurements did not stabilize")
        print(
            f"  Client: request count: {s.completed_requests}, "
            f"throughput: {s.throughput:.1f} infer/sec, "
            f"send rate: {s.send_rate:.1f} req/sec"
        )
        if s.error_count:
            print(f"    failed requests: {s.error_count}")
        if s.delayed_count:
            print(f"    delayed requests: {s.delayed_count}")
        print(f"    avg latency: {s.latency_avg_us:.0f} usec")
        for p in sorted(s.percentiles_us):
            governed = " (stability metric)" if p == percentile else ""
            print(
                f"    p{p} latency: {s.percentiles_us[p]:.0f} usec{governed}"
            )
        for endpoint, ep in sorted(s.per_endpoint.items()):
            failed = f", {ep['errors']} failed" if ep["errors"] else ""
            print(
                f"    endpoint {endpoint}: {ep['count']} ok, "
                f"{ep['throughput']:.1f} infer/sec, "
                f"avg {ep['avg_us']:.0f} usec, "
                f"p99 {ep['p99_us']:.0f} usec{failed}"
            )
        for tenant, tp in sorted(s.per_tenant.items()):
            failed = f", {tp['errors']} failed" if tp["errors"] else ""
            print(
                f"    tenant {tenant or '(default)'}: {tp['count']} ok, "
                f"{tp['throughput']:.1f} infer/sec, "
                f"avg {tp['avg_us']:.0f} usec, "
                f"p99 {tp['p99_us']:.0f} usec{failed}"
            )
        for gauge, agg in sorted(s.tpu_metrics.items()):
            print(
                f"    {gauge}: avg {agg['avg']:.0f}, max {agg['max']:.0f}"
            )
        if s.lm_prefix:
            print(
                f"    prefix cache: {s.lm_prefix['prefix_hit_pct']:.1f}% "
                "block hit rate, "
                f"{s.lm_prefix['prefill_tokens_saved_pct']:.1f}% prefill "
                "tokens saved"
            )
        if s.lm_spec:
            print(
                f"    speculative: {s.lm_spec['spec_acceptance_pct']:.1f}% "
                "draft acceptance, "
                f"{s.lm_spec['spec_tokens_per_sec']:.1f} LM tokens/s"
            )
        if s.overhead_pct:
            print(f"    harness overhead: {s.overhead_pct:.1f}% of slot time")
        if s.server_stats:
            srv = s.server_stats
            cnt = max(srv.get("success_count", 0), 1)
            parts = []
            for phase in ("queue", "compute_input", "compute_infer",
                          "compute_output"):
                ns = srv.get(f"{phase}_ns", 0)
                parts.append(f"{phase} {ns / cnt / 1e3:.0f}")
            print(f"  Server: avg usec/request: {', '.join(parts)}")
            hits = srv.get("cache_hit_count", 0)
            if hits or srv.get("cache_miss_count", 0):
                served = hits + srv.get("cache_miss_count", 0)
                pct = 100.0 * hits / served if served else 0.0
                print(
                    f"    response cache: {hits} hits / {served} lookups "
                    f"({pct:.1f}%), avg hit "
                    f"{srv.get('cache_hit_ns', 0) / max(hits, 1) / 1e3:.0f} "
                    "usec"
                )
        for name, counters in sorted(s.ensemble_stats.items()):
            # full per-stage phase split (mirrors the reference's ensemble
            # recursion in ReportWriter): each composing model's queue and
            # compute breakdown under its own name, so a pipeline's slow
            # stage is visible straight from the sweep output
            cnt = max(counters.get("success_count", 0), 1)
            parts = []
            for phase in ("queue", "compute_input", "compute_infer",
                          "compute_output"):
                ns = counters.get(f"{phase}_ns", 0)
                parts.append(f"{phase} {ns / cnt / 1e3:.0f}")
            print(
                f"  Composing model {name}: {counters.get('success_count', 0)}"
                f" exec, avg usec/request: {', '.join(parts)}"
            )
        print()
    if results:
        best = max(results, key=lambda s: s.throughput)
        print(
            f"Best: {best.level_label}={best.level_value} -> "
            f"{best.throughput:.1f} infer/sec, "
            f"avg latency {best.latency_avg_us:.0f} usec"
        )


def write_csv(path, results, verbose=False):
    """CSV export; column set follows report_writer.cc, plus one avg/max
    column pair per collected tpu_metrics gauge (the reference appends GPU
    metric columns the same way)."""
    fields = [
        "Level", "Inferences/Second", "Client Send Rate",
        "Avg latency", "p50 latency", "p90 latency", "p95 latency",
        "p99 latency", "Request Count", "Failed Count", "Delayed Count",
        "Stable",
    ]
    if verbose:
        fields += [
            "Server Queue", "Server Compute Input", "Server Compute Infer",
            "Server Compute Output", "Server Cache Hits",
        ]
    # --prefix-share sweeps: the per-level KV prefix-cache outcome
    has_prefix = any(s.lm_prefix for s in results)
    if has_prefix:
        fields += ["Prefix Hit %", "Prefill Tokens Saved %"]
    # --speculative sweeps: the per-level draft/verify outcome
    has_spec = any(s.lm_spec for s in results)
    if has_spec:
        fields += ["Spec Acceptance %", "LM Tokens/Second"]
    # ensemble targets: one queue/compute column pair per composing model
    # (the reference appends per-composing columns the same way)
    composing = sorted({n for s in results for n in s.ensemble_stats})
    for name in composing:
        fields += [f"Ensemble {name} Queue", f"Ensemble {name} Compute"]
    gauges = sorted({g for s in results for g in s.tpu_metrics})
    for gauge in gauges:
        fields += [f"{gauge} (avg)", f"{gauge} (max)"]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(fields)
        for s in results:
            row = [
                s.level_value,
                f"{s.throughput:.2f}",
                f"{s.send_rate:.2f}",
                f"{s.latency_avg_us:.0f}",
                f"{s.percentiles_us.get(50, 0):.0f}",
                f"{s.percentiles_us.get(90, 0):.0f}",
                f"{s.percentiles_us.get(95, 0):.0f}",
                f"{s.percentiles_us.get(99, 0):.0f}",
                s.completed_requests,
                s.error_count,
                s.delayed_count,
                int(s.stable),
            ]
            if verbose:
                srv = s.server_stats
                cnt = max(srv.get("success_count", 0), 1)
                row += [
                    f"{srv.get('queue_ns', 0) / cnt / 1e3:.0f}",
                    f"{srv.get('compute_input_ns', 0) / cnt / 1e3:.0f}",
                    f"{srv.get('compute_infer_ns', 0) / cnt / 1e3:.0f}",
                    f"{srv.get('compute_output_ns', 0) / cnt / 1e3:.0f}",
                    str(srv.get("cache_hit_count", 0)),
                ]
            if has_prefix:
                row += (
                    [f"{s.lm_prefix['prefix_hit_pct']:.2f}",
                     f"{s.lm_prefix['prefill_tokens_saved_pct']:.2f}"]
                    if s.lm_prefix else ["", ""]
                )
            if has_spec:
                row += (
                    [f"{s.lm_spec['spec_acceptance_pct']:.2f}",
                     f"{s.lm_spec['spec_tokens_per_sec']:.1f}"]
                    if s.lm_spec else ["", ""]
                )
            for name in composing:
                counters = s.ensemble_stats.get(name)
                if not counters:
                    row += ["", ""]
                    continue
                cnt = max(counters.get("success_count", 0), 1)
                row += [
                    f"{counters.get('queue_ns', 0) / cnt / 1e3:.0f}",
                    f"{counters.get('compute_infer_ns', 0) / cnt / 1e3:.0f}",
                ]
            for gauge in gauges:
                agg = s.tpu_metrics.get(gauge)
                row += ([f"{agg['avg']:.1f}", f"{agg['max']:.1f}"]
                        if agg else ["", ""])
            w.writerow(row)


def status_record(s):
    """One sweep point as a JSON-ready dict (every field PerfStatus
    carries; percentile keys stringified for stable JSON)."""
    return {
        "level_label": s.level_label,
        "level_value": s.level_value,
        "throughput_infer_per_sec": s.throughput,
        "send_rate_req_per_sec": s.send_rate,
        "latency_avg_us": s.latency_avg_us,
        "percentiles_us": {
            str(p): v for p, v in sorted(s.percentiles_us.items())
        },
        "completed_requests": s.completed_requests,
        "error_count": s.error_count,
        "delayed_count": s.delayed_count,
        "stable": bool(s.stable),
        "client_window_s": s.client_window_s,
        "overhead_pct": s.overhead_pct,
        "per_endpoint": s.per_endpoint,
        "per_tenant": s.per_tenant,
        "tpu_metrics": s.tpu_metrics,
        "server_stats": s.server_stats,
        "ensemble_stats": s.ensemble_stats,
        "lm_prefix": s.lm_prefix,
        "lm_spec": s.lm_spec,
    }


def write_json(path, results, extra=None):
    """Per-sweep-point JSON export: ``{"results": [record, ...]}`` plus
    any ``extra`` top-level keys (e.g. the SLO search's best level)."""
    doc = dict(extra or {})
    doc["results"] = [status_record(s) for s in results]
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
