"""Prometheus-style metrics registry for the port's serving stack.

Counterpart of client_tpu/serve/metrics.py, cut to what the
continuous-batching LM engine writes: the thread-safe :class:`Registry`
(counters and gauges rendered in the exposition format) and the help
catalogs of the series the engine, its prefix cache, speculative verify
and phase profiler register (``LM_PREFIX_HELP``, ``LM_SPEC_HELP``,
``PROF_HELP``).  The rest of the module (histograms, the per-model and
device series, ``render_metrics``) waits for the slice that ports the
server's ``/metrics`` endpoint, and ``FLEET_HELP`` for the fleet tier.

Every label value passes through :func:`escape_label`: the exposition
format reserves ``\\``, ``"`` and newline inside quoted label values.
"""

import threading


def escape_label(value):
    """Escape a Prometheus label value (backslash, quote, newline)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


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


def format_labels(labels):
    """{'model': 'm'} -> '{model="m"}' with every value escaped."""
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{escape_label(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class Registry:
    """Thread-safe counter/gauge registry rendering to exposition format.

    One instance per engine holds server-side series (sheds, drain); the
    module-level :data:`RESILIENCE` registry holds client-side series fed
    by :class:`ResilienceMetricsObserver` so in-process clients' retry and
    circuit activity is scrapeable from the same /metrics payload.
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



def _fmt(value):
    if isinstance(value, float) and not value.is_integer():
        return f"{value:.6f}"
    return str(int(value))

