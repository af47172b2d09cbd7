"""Prometheus-style metrics for the port's in-process server.

Counterpart of client_tpu/serve/metrics.py: the thread-safe
:class:`Registry` (counters and gauges), the fixed-bucket
:class:`Histogram` behind the per-model latency and batch-size
distributions, the help catalogs of the series the LM engine, its prefix
cache, speculative verify, the phase profiler, the SLO watchdog and the
flight recorder register (``LM_PREFIX_HELP``, ``LM_SPEC_HELP``,
``PROF_HELP``, ``SLO_HELP``), the fleet tier's and the autoscaler's
(``FLEET_HELP``, ``AUTOSCALE_HELP``: the JAX package's series names,
so dashboards read both servers alike), and :func:`render_metrics`, the ``/metrics``
payload: per-model counters and histograms, live gauges (batcher queue
depth per model and tenant, in-flight requests, draining, the duty
cycle), per-GPU memory, then every series in the engine's registry.

Where the JAX package reports ``ctpu_tpu_memory_*`` from PJRT's
``memory_stats``, the port reports ``ctpu_gpu_memory_*`` from
``torch.cuda.memory_stats``, and only once torch is loaded and CUDA
initialized in the process: a scrape never imports torch or creates a
CUDA context.  Client-side series
live in the module's ``RESILIENCE`` registry, rendered at the end of
every scrape: :class:`ResilienceMetricsObserver` (retries, circuit
state per endpoint) and :class:`BalancerMetricsObserver` (the replica
set's routing, failovers, health, membership and gossiped pressure,
fed by ``client_tpu_torch.balance.EndpointPool``).

Every label value passes through :func:`escape_label`: the exposition
format reserves ``\\``, ``"`` and newline inside quoted label values.
"""

import bisect
import threading
import time

from client_tpu_torch import loaded_torch
from client_tpu_torch.utils import escape_label


# Request/queue duration buckets (microseconds) and batch-size buckets.
DURATION_BUCKETS_US = (
    50, 100, 250, 500, 1000, 2500, 5000, 10000, 25000, 50000,
    100000, 250000, 500000, 1000000, 2500000, 10000000,
)
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)

# CircuitBreaker state -> gauge value (closed/half-open/open).
CIRCUIT_STATE_VALUES = {"closed": 0, "half-open": 1, "open": 2}

# Endpoint health state -> gauge value (client_tpu_torch.utils server states).
ENDPOINT_STATE_VALUES = {"READY": 0, "NOT_READY": 1, "UNREACHABLE": 2}

# Endpoint membership phase -> gauge value (client_tpu_torch.balance.pool).
ENDPOINT_PHASE_VALUES = {"active": 0, "probation": 1, "retiring": 2}

# LM prefix-cache + preemption series (written by serve/lm/prefix.py and
# serve/lm/engine.py into whichever registry the engine is bound to; the
# help text lives here so the catalog has one source of truth).
LM_PREFIX_HELP = {
    "ctpu_lm_prefix_hits_total":
        "Prompt-prefix KV blocks adopted by reference from the cache",
    "ctpu_lm_prefix_misses_total":
        "Shareable full prompt blocks that had no cached match",
    "ctpu_lm_prefix_evictions_total":
        "Cached prefix blocks evicted under pool pressure",
    "ctpu_lm_prefix_cached_blocks":
        "KV blocks currently held warm by the prefix cache",
    "ctpu_lm_prefill_tokens_total":
        "Prompt tokens actually computed by prefill chunks",
    "ctpu_lm_prefill_tokens_saved_total":
        "Prompt tokens skipped via prefix-cache adoption",
    "ctpu_lm_preemptions_total":
        "Decode lanes preempted (KV swapped out) under priority pressure",
    "ctpu_lm_swapped_blocks":
        "KV blocks currently parked in the host-side swap store",
}

# Speculative-decoding series (written by serve/lm/engine.py's verify
# pass when a model enables ``speculative={...}``; serve/lm/spec.py owns
# the drafter/adaptive-k policy).  Acceptance rate is the cumulative
# accepted/proposed ratio — the per-lane adaptive controller uses its
# own rolling window.
LM_SPEC_HELP = {
    "ctpu_lm_spec_proposed_tokens_total":
        "Draft tokens proposed to the speculative verify tick",
    "ctpu_lm_spec_accepted_tokens_total":
        "Draft tokens the verify tick accepted (target-model-exact)",
    "ctpu_lm_spec_rejected_tokens_total":
        "Draft tokens the verify tick rejected (KV rewound, not leaked)",
    "ctpu_lm_spec_acceptance_rate":
        "Cumulative speculative acceptance rate (accepted / proposed)",
}

# Continuous-profiler series (written by serve/prof.py's PhaseProfiler
# into whichever registry the profiler is bound to; engine label is the
# profiler name — "serve" for the unary engine, "lm" for an LM
# scheduler, "perf_client" for the perf harness's client-side splits).
PROF_HELP = {
    "ctpu_prof_ticks_total":
        "Profiler ticks committed (by engine and tick kind)",
    "ctpu_prof_phase_seconds_total":
        "Cumulative seconds attributed to each profiled phase",
    "ctpu_prof_mfu_pct":
        "Model FLOP utilization over measured device time (vs "
        "device_peak_tflops; cpu_fallback peak off-TPU)",
    "ctpu_prof_compute_share_pct":
        "Share of measured device time attributed to each model",
}


# SLO watchdog + flight recorder series (written by serve/slo.py and
# serve/flight.py into the engine registry; one help catalog so
# /metrics, README and tests agree).
SLO_HELP = {
    "ctpu_slo_p50_ms":
        "Windowed p50 request latency per model/tenant (sketch quantile)",
    "ctpu_slo_p95_ms":
        "Windowed p95 request latency per model/tenant (sketch quantile)",
    "ctpu_slo_p99_ms":
        "Windowed p99 request latency per model/tenant (sketch quantile)",
    "ctpu_slo_error_rate":
        "Windowed server-fault rate per model/tenant (5xx/transport only)",
    "ctpu_slo_breaches_total":
        "SLO objective breaches (by model/tenant and objective kind)",
    "ctpu_flight_dumps_total":
        "Flight-recorder dumps written (by trigger reason)",
}


# Fleet cache-tier series (written by serve/fleet.py and the fleet hooks
# in serve/lm/engine.py + model_runtime into whichever registry the tier
# is bound to; one help catalog so /metrics, README and tests agree).
FLEET_HELP = {
    "ctpu_fleet_peer_hits_total":
        "Peer lookups answered with content (by op: cache/prefix)",
    "ctpu_fleet_peer_misses_total":
        "Peer lookups every reachable peer missed (by op)",
    "ctpu_fleet_peer_errors_total":
        "Peer RPCs that failed or timed out (circuit strikes)",
    "ctpu_fleet_peer_skips_total":
        "Peer lookups skipped behind an open per-peer circuit",
    "ctpu_fleet_prefix_blocks_total":
        "KV prefix blocks installed from a peer replica's cache tier",
    "ctpu_fleet_prefix_tokens_saved_total":
        "Prefill tokens skipped via peer-fetched KV prefix blocks",
    "ctpu_fleet_cache_hits_total":
        "Unary responses served from a peer replica's response cache",
    "ctpu_fleet_store_blocks":
        "KV blocks exported into this replica's host-side fleet store",
    "ctpu_fleet_gossip_rounds_total":
        "Fleet gossip rounds pushed (tenant counters + digest summaries)",
    "ctpu_fleet_sessions_migrated_total":
        "Parked LM streams exported to the fleet tier at planned retire",
    "ctpu_fleet_seq_snapshots_total":
        "Durable sequence snapshots pushed to peer replicas",
    "ctpu_fleet_seq_resumes_total":
        "Sequences resumed from a fleet-replicated snapshot",
    "ctpu_fleet_seq_stale_total":
        "Stale sequence snapshots rejected by the replicated store",
    "ctpu_fleet_seq_heals_total":
        "Skips-ahead gaps healed by re-looking up a fresher snapshot",
    "ctpu_fleet_replicated_items_total":
        "Anti-entropy items proactively pushed to peers (by kind)",
    "ctpu_fleet_replicated_bytes_total":
        "Anti-entropy payload bytes proactively pushed to peers",
    "ctpu_fleet_pressure_queue_depth":
        "Gossiped per-replica queued+inflight work (autoscaling signal)",
    "ctpu_fleet_pressure_prefix":
        "Gossiped per-replica prefix-affinity pressure (hot chains held)",
    "ctpu_fleet_seq_quorum_acks_total":
        "Durable sequence steps acked with write quorum satisfied",
    "ctpu_fleet_seq_quorum_refusals_total":
        "Durable sequence steps refused (503) for unreachable quorum",
}

# Autoscaler control-loop series (written by serve/autoscale.py into the
# registry it is constructed with).
AUTOSCALE_HELP = {
    "ctpu_autoscale_scale_ups_total":
        "Autoscaler scale-up actions taken (replicas spawned)",
    "ctpu_autoscale_scale_downs_total":
        "Autoscaler scale-down actions taken (replicas drained+retired)",
    "ctpu_autoscale_flap_suppressed_total":
        "Autoscaler decisions suppressed by cooldown/hysteresis",
    "ctpu_autoscale_replicas":
        "Current replica count the autoscaler is steering",
}


def format_labels(labels):
    """{'model': 'm'} -> '{model="m"}' with every value escaped."""
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{escape_label(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class Histogram:
    """Fixed-bucket histogram (Prometheus semantics: cumulative buckets at
    render time, plus sum and count).  Not internally locked — callers
    (ModelStats) guard observations with their own lock."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets=DURATION_BUCKETS_US):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)  # +Inf tail
        self.sum = 0.0
        self.count = 0

    def observe(self, value):
        self.counts[bisect.bisect_left(self.buckets, value)] += 1
        self.sum += value
        self.count += 1

    def snapshot(self):
        """(bucket_bounds, cumulative_counts, sum, count)."""
        cumulative = []
        total = 0
        for c in self.counts:
            total += c
            cumulative.append(total)
        return self.buckets, cumulative, self.sum, self.count


class Registry:
    """Thread-safe counter/gauge registry rendering to exposition format.

    One instance per engine holds its server-side series: sheds, drain,
    the front door's, the SLO watchdog's, the profiler's and the LM
    engine's (bound through ``Model.binder``).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families = {}  # name -> {"type","help","samples":{labels:v}}

    def _family(self, name, type_, help_):
        fam = self._families.get(name)
        if fam is None:
            fam = {"type": type_, "help": help_, "samples": {}}
            self._families[name] = fam
        return fam

    def inc(self, name, labels=None, value=1, help_=""):
        key = format_labels(labels)
        with self._lock:
            samples = self._family(name, "counter", help_)["samples"]
            samples[key] = samples.get(key, 0) + value

    def set(self, name, labels=None, value=0.0, help_=""):
        key = format_labels(labels)
        with self._lock:
            self._family(name, "gauge", help_)["samples"][key] = value

    def get(self, name, labels=None):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return None
            return fam["samples"].get(format_labels(labels))

    def remove(self, name, labels=None):
        """Drop one labeled sample (gauges for departed label values —
        e.g. an evicted endpoint's phase/state — must not sit on /metrics
        at their last value forever, nor accumulate without bound under
        membership churn)."""
        key = format_labels(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                fam["samples"].pop(key, None)

    def render_into(self, lines):
        with self._lock:
            for name in sorted(self._families):
                fam = self._families[name]
                lines.append(f"# HELP {name} {fam['help'] or name}")
                lines.append(f"# TYPE {name} {fam['type']}")
                for labels, value in sorted(fam["samples"].items()):
                    lines.append(f"{name}{labels} {_fmt(value)}")


# Client-side resilience series (retries, circuit state) for clients
# living in the same process as the server — the hermetic/in-process
# deployment this framework's fake-server role serves.
RESILIENCE = Registry()


class ResilienceMetricsObserver:
    """Adapter feeding resilience events into a metrics registry.

    Attach one instance per endpoint as BOTH the retry-policy observer and
    the circuit-breaker observer::

        obs = ResilienceMetricsObserver("127.0.0.1:8000")
        breaker = CircuitBreaker(observer=obs)
        policy = RetryPolicy(circuit_breaker=breaker, observer=obs)
    """

    def __init__(self, endpoint, registry=None):
        self.endpoint = endpoint
        self.registry = registry if registry is not None else RESILIENCE
        self.registry.set(
            "ctpu_client_circuit_state", {"endpoint": endpoint}, 0,
            help_="Circuit breaker state per endpoint "
                  "(0=closed, 1=half-open, 2=open)",
        )

    # retry-policy hooks -----------------------------------------------------

    def on_backoff(self, attempt, delay_s, exc):
        self.registry.inc(
            "ctpu_client_retries_total", {"endpoint": self.endpoint},
            help_="Client retry attempts (one per backoff sleep)",
        )

    def on_giveup(self, attempt, exc):
        self.registry.inc(
            "ctpu_client_request_failures_total",
            {"endpoint": self.endpoint},
            help_="Client calls that exhausted their retry policy",
        )

    def on_success(self, attempt):
        pass

    # circuit-breaker hook ---------------------------------------------------

    def on_state_change(self, old, new):
        self.registry.set(
            "ctpu_client_circuit_state", {"endpoint": self.endpoint},
            CIRCUIT_STATE_VALUES.get(new, -1),
            help_="Circuit breaker state per endpoint "
                  "(0=closed, 1=half-open, 2=open)",
        )
        self.registry.inc(
            "ctpu_client_circuit_transitions_total",
            {"endpoint": self.endpoint, "to": new},
            help_="Circuit breaker state transitions",
        )


class BalancerMetricsObserver:
    """Adapter feeding replica-set routing events into a metrics registry.

    Attach one instance as the ``observer`` of a
    ``client_tpu_torch.balance.EndpointPool``::

        obs = BalancerMetricsObserver()
        pool = EndpointPool(urls, observer=obs)

    Series (all per-endpoint): ``ctpu_client_routed_total`` (requests the
    balancer sent to each replica — the convergence proof when replicas
    die), ``ctpu_client_failovers_total`` (attempts that failed retryably
    on a replica and rotated off it), ``ctpu_client_endpoint_state``
    (the pool's READY/NOT_READY/UNREACHABLE health view),
    ``ctpu_client_endpoint_phase`` (membership lifecycle:
    active/probation/retiring), ``ctpu_client_membership_changes_total``
    (discovery add/retire/unretire/promote/retain/evict events),
    ``ctpu_client_pool_endpoints`` (pool size per phase), and the
    streaming-reconnect pair ``ctpu_client_stream_reconnects_total`` /
    ``ctpu_client_stream_replayed_requests_total``.
    """

    def __init__(self, registry=None):
        self.registry = registry if registry is not None else RESILIENCE

    def on_route(self, endpoint):
        self.registry.inc(
            "ctpu_client_routed_total", {"endpoint": endpoint},
            help_="Requests routed to each replica by the client balancer",
        )

    def on_failover(self, endpoint):
        self.registry.inc(
            "ctpu_client_failovers_total", {"endpoint": endpoint},
            help_="Attempts that failed retryably on a replica and were "
                  "failed over",
        )

    def on_endpoint_state(self, endpoint, state):
        self.registry.set(
            "ctpu_client_endpoint_state", {"endpoint": endpoint},
            ENDPOINT_STATE_VALUES.get(state, -1),
            help_="Pool health view per endpoint "
                  "(0=ready, 1=not-ready/draining, 2=unreachable)",
        )

    # membership / discovery hooks -------------------------------------------

    def on_endpoint_phase(self, endpoint, phase):
        self.registry.set(
            "ctpu_client_endpoint_phase", {"endpoint": endpoint},
            ENDPOINT_PHASE_VALUES.get(phase, -1),
            help_="Pool membership phase per endpoint "
                  "(0=active, 1=probation, 2=retiring)",
        )

    def on_membership(self, op, endpoint):
        self.registry.inc(
            "ctpu_client_membership_changes_total",
            {"op": op, "endpoint": endpoint},
            help_="Discovery-driven membership events "
                  "(add/retire/unretire/promote/retain/evict)",
        )
        if op == "evict":
            # the endpoint is gone: its per-endpoint gauges must not park
            # at their last value (counters stay — they are history)
            labels = {"endpoint": endpoint}
            self.registry.remove("ctpu_client_endpoint_phase", labels)
            self.registry.remove("ctpu_client_endpoint_state", labels)
            self.registry.remove("ctpu_fleet_pressure_queue_depth", labels)
            self.registry.remove("ctpu_fleet_pressure_prefix", labels)

    def on_endpoint_pressure(self, endpoint, pressure):
        """Gossiped autoscaling signals (probe-piggybacked; see
        ``FleetTier.local_summary`` / ``EndpointPool.set_pressure``)."""
        labels = {"endpoint": endpoint}
        self.registry.set(
            "ctpu_fleet_pressure_queue_depth", labels,
            float(pressure.get("queue_depth", 0) or 0),
            help_=FLEET_HELP["ctpu_fleet_pressure_queue_depth"],
        )
        self.registry.set(
            "ctpu_fleet_pressure_prefix", labels,
            float(pressure.get("prefix_hot", 0) or 0),
            help_=FLEET_HELP["ctpu_fleet_pressure_prefix"],
        )

    def on_pool_size(self, active, probation, retiring):
        for phase, count in (
            ("active", active), ("probation", probation),
            ("retiring", retiring),
        ):
            self.registry.set(
                "ctpu_client_pool_endpoints", {"phase": phase}, count,
                help_="Replica-set pool size per membership phase",
            )

    # streaming-reconnect hooks ----------------------------------------------

    def on_stream_reconnect(self, endpoint):
        self.registry.inc(
            "ctpu_client_stream_reconnects_total", {"endpoint": endpoint},
            help_="Streams that died connection-level on this replica and "
                  "reconnected to a fresh one",
        )

    def on_stream_replayed(self, endpoint, count):
        self.registry.inc(
            "ctpu_client_stream_replayed_requests_total",
            {"endpoint": endpoint}, value=count,
            help_="Unacknowledged stream requests replayed onto this "
                  "replica after a reconnect",
        )


def _fmt(value):
    if isinstance(value, float) and not value.is_integer():
        return f"{value:.6f}"
    return str(int(value))


class _FamilyBuffer:
    """Groups samples per metric family so the exposition output keeps all
    lines of one family contiguous (required by the text format — parsers
    keying families by name reject or drop interleaved groups)."""

    def __init__(self):
        self._families = {}  # name -> [type, help, [sample lines]]

    def declare(self, name, type_, help_):
        self._families.setdefault(name, [type_, help_, []])

    def add(self, name, labels, value):
        self._families[name][2].append(
            f"{name}{format_labels(labels)} {_fmt(value)}"
        )

    def add_raw(self, name, line):
        self._families[name][2].append(line)

    def emit(self, lines):
        for name, (type_, help_, samples) in self._families.items():
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {type_}")
            lines.extend(samples)


def _device_lines(buf):
    """Per-GPU memory gauges from the caching allocator.  Only once torch
    is loaded and CUDA initialized in this process: a server serving on
    the card has done both; importing torch or creating a CUDA context
    (hundreds of MB, seconds) inside the /metrics handler would stall
    the first scrape of a numpy-only or CPU-served process.  Reads the
    allocator's host-side counters: no device work, no sync."""
    torch = loaded_torch()
    if torch is None or not torch.cuda.is_initialized():
        return
    buf.declare(
        "ctpu_gpu_memory_used_bytes", "gauge",
        "GPU memory bytes allocated by tensors",
    )
    buf.declare(
        "ctpu_gpu_memory_total_bytes", "gauge", "GPU memory byte capacity",
    )
    buf.declare(
        "ctpu_gpu_memory_peak_bytes", "gauge",
        "Peak GPU memory bytes allocated by tensors",
    )
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        stats = torch.cuda.memory_stats(i)
        labels = {"device": i, "kind": props.name}
        buf.add("ctpu_gpu_memory_used_bytes", labels,
                stats.get("allocated_bytes.all.current", 0))
        buf.add("ctpu_gpu_memory_total_bytes", labels, props.total_memory)
        buf.add("ctpu_gpu_memory_peak_bytes", labels,
                stats.get("allocated_bytes.all.peak", 0))


def _histogram_lines(buf, name, labels, snapshot):
    buckets, cumulative, total, count = snapshot
    for bound, c in zip(buckets, cumulative[:-1]):
        le = format_labels(dict(labels, le=bound))
        buf.add_raw(name, f"{name}_bucket{le} {c}")
    inf = format_labels(dict(labels, le="+Inf"))
    buf.add_raw(name, f"{name}_bucket{inf} {cumulative[-1]}")
    lbl = format_labels(labels)
    buf.add_raw(name, f"{name}_sum{lbl} {_fmt(total)}")
    buf.add_raw(name, f"{name}_count{lbl} {count}")


_COUNTER_HELP = [
    ("ctpu_inference_request_success", "Successful inference requests"),
    ("ctpu_inference_request_failure", "Failed inference requests"),
    ("ctpu_inference_count", "Inferences performed (batch aware)"),
    ("ctpu_inference_exec_count", "Model executions (batches count once)"),
    ("ctpu_inference_duration_us",
     "Cumulative successful request duration"),
    ("ctpu_inference_fail_duration_us",
     "Cumulative failed request duration"),
    ("ctpu_inference_queue_duration_us",
     "Cumulative scheduling-queue wait"),
    ("ctpu_inference_compute_input_duration_us",
     "Cumulative input-preparation time"),
    ("ctpu_inference_compute_infer_duration_us",
     "Cumulative model-execution time"),
    ("ctpu_inference_compute_output_duration_us",
     "Cumulative output-rendering time"),
]

_HISTOGRAM_HELP = [
    ("ctpu_request_duration_us",
     "Per-request end-to-end duration distribution"),
    ("ctpu_queue_duration_us",
     "Per-request dynamic-batcher queue-time distribution"),
    ("ctpu_batch_size", "Execution batch-size (rows) distribution"),
]


def render_metrics(engine):
    """The /metrics payload (Prometheus text exposition format).

    All samples of one metric family are emitted as a single contiguous
    block (HELP/TYPE then every sample) — the text format requires it, and
    family-keyed parsers drop or reject interleaved groups.  Reads host
    state only: counters, histograms, gauges and the allocator's
    counters."""
    buf = _FamilyBuffer()
    for name, help_ in _COUNTER_HELP:
        buf.declare(name, "counter", help_)
    for ms in engine.statistics():
        labels = {"model": ms.get("name", ""), "version": ms.get("version", "")}
        agg = ms.get("inference_stats", {})
        success = agg.get("success", {})
        fail = agg.get("fail", {})
        buf.add(
            "ctpu_inference_request_success", labels,
            int(success.get("count", 0)),
        )
        buf.add(
            "ctpu_inference_request_failure", labels,
            int(fail.get("count", 0)),
        )
        buf.add("ctpu_inference_count", labels, int(ms.get("inference_count", 0)))
        buf.add(
            "ctpu_inference_exec_count", labels,
            int(ms.get("execution_count", 0)),
        )
        buf.add(
            "ctpu_inference_duration_us", labels,
            int(success.get("ns", 0)) // 1000,
        )
        buf.add(
            "ctpu_inference_fail_duration_us", labels,
            int(fail.get("ns", 0)) // 1000,
        )
        for phase in ("queue", "compute_input", "compute_infer",
                      "compute_output"):
            buf.add(
                f"ctpu_inference_{phase}_duration_us", labels,
                int(agg.get(phase, {}).get("ns", 0)) // 1000,
            )
    # per-model histograms (request/queue durations, batch sizes)
    for name, help_ in _HISTOGRAM_HELP:
        buf.declare(name, "histogram", help_)
    for name, version, model_stats_obj in engine.stats_objects():
        labels = {"model": name, "version": version}
        request_us, queue_us, batch_rows = model_stats_obj.histograms()
        _histogram_lines(buf, "ctpu_request_duration_us", labels, request_us)
        _histogram_lines(buf, "ctpu_queue_duration_us", labels, queue_us)
        _histogram_lines(buf, "ctpu_batch_size", labels, batch_rows)
    # live gauges: scheduler queue depth, in-flight work, drain state
    buf.declare(
        "ctpu_queue_depth", "gauge",
        "Requests waiting in the dynamic batcher",
    )
    for name, depth in sorted(engine.queue_depths().items()):
        buf.add("ctpu_queue_depth", {"model": name}, depth)
    buf.declare(
        "ctpu_tenant_queue_depth", "gauge",
        "Requests waiting per tenant fair-queue lane",
    )
    for (model, tenant), depth in sorted(engine.tenant_queue_depths().items()):
        buf.add(
            "ctpu_tenant_queue_depth",
            {"model": model, "tenant": tenant}, depth,
        )
    buf.declare(
        "ctpu_inflight_requests", "gauge", "Requests currently executing"
    )
    buf.add("ctpu_inflight_requests", None, engine.inflight_count())
    buf.declare("ctpu_draining", "gauge", "1 once graceful drain has begun")
    buf.add("ctpu_draining", None, 0 if engine.ready() else 1)
    _device_lines(buf)
    buf.declare(
        "ctpu_server_busy_ns", "counter",
        "Wall-clock ns with >=1 model execution in flight (duty cycle: "
        "rate(ctpu_server_busy_ns)/1e9 = utilization)",
    )
    buf.add("ctpu_server_busy_ns", None, engine.busy.busy_ns())
    buf.declare(
        "ctpu_scrape_timestamp_seconds", "gauge",
        "Wall time of this scrape",
    )
    buf.add_raw(
        "ctpu_scrape_timestamp_seconds",
        f"ctpu_scrape_timestamp_seconds {time.time():.3f}",
    )
    lines = []
    buf.emit(lines)
    # the engine's own series (sheds, drain, front door, SLO, profiler,
    # the LM engine's), then any client resilience series registered in
    # this process: each registry renders its families as contiguous
    # blocks of its own
    engine.metrics.render_into(lines)
    RESILIENCE.render_into(lines)
    return "\n".join(lines) + "\n"
