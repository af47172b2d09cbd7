"""The port's tracing, flight recorder and SLO watchdog
(client_tpu_torch.tracing, client_tpu_torch.serve.{tracing,flight,slo})
held against the JAX package's.

- ``normalize_trace_settings`` gives equal output, or the same 400, on a
  table of valid and malformed updates (mirrors
  test_observability.py::TestTraceSettingsFidelity's normalization);
  ``traceparent`` parse and format agree (TestTraceparentHelpers);
  ``Tracer`` samples the same requests under the same rate and count
  budget, and its tick spans keep out of the request budget (the tick half
  of test_lm.py::test_engine_metrics_and_tick_spans).
- ``LatencySketch`` gives equal quantiles, counts and bucket vectors on
  seeded samples; ``SloWatchdog`` equal gauges, summaries and breach
  counts (test_traceview.py::TestLatencySketch, TestSloWatchdog).
- ``FlightRecorder.render`` gives equal records apart from ``ts``, the
  profiler's ``prof_tick`` records included (TestFlightRecorder).
- The watchdog's first breach dumps whatever the host's uptime: with
  ``time.monotonic`` at 5 s the port's copy of
  ``test_breach_counts_and_dumps_once_per_interval`` writes exactly one
  dump.  (The JAX watchdog starts its interval at monotonic 0, so on a
  host up for less than ``dump_interval_s`` its first breach wrote none.)

Sketch quantiles are bucket bounds: equal exactly, no tolerance.
"""

import json

import numpy as np
import pytest

from client_tpu import tracing as jtracing
from client_tpu.serve import flight as jflight
from client_tpu.serve import slo as jslo
from client_tpu.serve import tracing as jstracing
from client_tpu.serve.metrics import Registry as JRegistry
from client_tpu.serve.prof import PhaseProfiler as JPhaseProfiler
from client_tpu_torch import tracing
from client_tpu_torch.serve import flight, slo
from client_tpu_torch.serve import tracing as stracing
from client_tpu_torch.serve.metrics import Registry
from client_tpu_torch.serve.prof import PhaseProfiler

# -- trace settings ------------------------------------------------------------

SETTINGS_CASES = [
    {"trace_rate": 250, "trace_level": "timestamps"},
    {"trace_rate": "99", "trace_level": ["TENSORS"]},
    {"trace_level": ["timestamps", "tensors"], "trace_count": -1},
    {"trace_count": ["7"], "log_frequency": 0},
    {"trace_file": ["/tmp/x.jsonl"]},
    {"trace_file": "", "trace_rate": None},
    {"trace_rate": []},
    {},
    {"trace_rate": "lots"},
    {"trace_level": ["LOUD"]},
    {"trace_level": []},
    {"log_frequency": 1.5},
    {"trace_mode": "x"},
]


def _normalize(fn, updates):
    try:
        return ("ok", fn(updates))
    except Exception as e:  # both packages' InferenceServerException
        return (e.status(), e.message())


@pytest.mark.parametrize("updates", SETTINGS_CASES, ids=str)
def test_normalize_trace_settings_equals_jax(updates):
    got = _normalize(stracing.normalize_trace_settings, updates)
    want = _normalize(jstracing.normalize_trace_settings, updates)
    assert got == want


def test_trace_setting_defaults_equal_jax():
    assert stracing.TRACE_SETTING_DEFAULTS == \
        jstracing.TRACE_SETTING_DEFAULTS


@pytest.mark.parametrize("header", [
    "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
    " 00-" + "A1" * 16 + "-" + "0f" * 8 + "-00 ",
    "", None, "zz", "00-short-span-01", "oo-" + "0" * 53,
])
def test_traceparent_equals_jax(header):
    assert tracing.parse_traceparent(header) == \
        jtracing.parse_traceparent(header)
    trace_id, span_id = tracing.gen_trace_id(), tracing.gen_span_id()
    formatted = tracing.format_traceparent(trace_id, span_id)
    assert formatted == jtracing.format_traceparent(trace_id, span_id)
    assert tracing.parse_traceparent(formatted) == (trace_id, span_id)


def _tracer_run(tracer_cls, settings):
    """Which of 12 requests the tracer samples, then 40 ticks."""
    tracer = tracer_cls(settings)
    parent = "00-" + "c" * 32 + "-" + "d" * 16 + "-01"
    sampled = []
    for i in range(12):
        t = tracer.sample(parent if i % 2 else None, model_name="m",
                          protocol="http")
        sampled.append(None if t is None else (
            t.trace_id == "c" * 32, t.parent_span_id, t.seq))
        if t is not None:
            t.event("REQUEST_START")
            tracer.complete(t)
    for _ in range(20):
        tracer.tick_span("decode", 1.0, 1.002)
        tracer.tick_span("prefill_chunk", 1.0, 1.01)
    ticks = [(s.model_name, [e["name"] for e in s.timestamps])
             for s in tracer.tick_completed]
    return sampled, len(tracer.completed), ticks


@pytest.mark.parametrize("rate,count,level", [
    ("1", "-1", ["TIMESTAMPS"]), ("3", "2", ["TIMESTAMPS"]),
    ("1", "0", ["TENSORS"]), ("1", "-1", ["OFF"]),
])
def test_tracer_sampling_equals_jax(rate, count, level):
    settings = dict(jstracing.TRACE_SETTING_DEFAULTS, trace_rate=rate,
                    trace_count=count, trace_level=level)
    got = _tracer_run(stracing.Tracer, dict(settings))
    want = _tracer_run(jstracing.Tracer, dict(settings))
    assert got == want
    if level != ["OFF"]:
        # tick spans never touch the request budget or its deque
        assert {name for name, _ in got[2]} == {
            "__lm_decode__", "__lm_prefill_chunk__"}
        assert all(names == ["COMPUTE_START", "COMPUTE_END"]
                   for _, names in got[2])


def test_tracer_writes_the_trace_file(tmp_path):
    path = tmp_path / "trace.jsonl"
    settings = dict(stracing.TRACE_SETTING_DEFAULTS, trace_rate="1",
                    trace_level=["TIMESTAMPS"], trace_file=str(path),
                    log_frequency="3")
    tracer = stracing.Tracer(settings)
    span_ids = []
    for _ in range(4):
        t = tracer.sample(model_name="m")
        t.tenant = "gold"
        span_ids.append(t.span_id)
        tracer.complete(t)
    def records():
        return [json.loads(line) for line in path.read_text().splitlines()]

    assert len(records()) == 3  # buffered by 3
    tracer.flush()
    records = records()
    assert [r["span_id"] for r in records] == span_ids
    assert records[0]["tenant"] == "gold"
    assert records[0]["source"] == "server"


def test_push_trace_nests_and_restores():
    a, b = object(), object()
    assert stracing.current_trace() is None
    with stracing.push_trace(a):
        with stracing.push_trace(b):
            assert stracing.current_trace() is b
        assert stracing.current_trace() is a
    assert stracing.current_trace() is None


# -- sketches and the watchdog --------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_latency_sketch_equals_jax(seed):
    rng = np.random.default_rng(seed)
    ms = np.concatenate([rng.lognormal(0.0, 1.5, 500),
                         rng.uniform(0.0, 40_000.0, 20)]).tolist()
    errors = (rng.random(len(ms)) < 0.1).tolist()
    got, want = slo.LatencySketch(), jslo.LatencySketch()
    for v, e in zip(ms, errors):
        got.observe(v, error=e)
        want.observe(v, error=e)
    for q in (0.0, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert got.quantile(q) == want.quantile(q)
    assert got.to_json() == want.to_json()
    assert got.error_rate() == want.error_rate()
    half = slo.LatencySketch()
    for v in ms[:100]:
        half.observe(v)
    jhalf = jslo.LatencySketch()
    for v in ms[:100]:
        jhalf.observe(v)
    assert got.merged(half).to_json() == want.merged(jhalf).to_json()
    assert slo.BOUNDS_MS == jslo.BOUNDS_MS


def _watch(pkg, objectives, samples, **kw):
    mod, reg_cls = {"jax": (jslo, JRegistry), "torch": (slo, Registry)}[pkg]
    reg = reg_cls()
    dog = mod.SloWatchdog(objectives=objectives, registry=reg, **kw)
    for model, tenant, latency_s, error in samples:
        dog.observe(model, tenant, latency_s, error=error)
    lines = []
    reg.render_into(lines)
    return dog.breaches, dog.check_now(), lines


WATCH_CASES = {
    "gauges": ({}, [("m", "gold", 0.010, False)], {"check_every": 1}),
    "p99_breach": ({"*": {"p99_ms": 5.0}},
                   [("m", "", 0.100, False)] * 16,
                   {"min_samples": 4, "check_every": 4}),
    "error_rate": ({"m": {"error_rate": 0.05}},
                   [("m", "", 0.001, i % 2 == 0) for i in range(8)],
                   {"min_samples": 4, "check_every": 4}),
    "exact_beats_star": ({"*": {"p99_ms": 1.0}, "m": {"p99_ms": 1e9}},
                         [("m", "", 0.5, False), ("o", "", 0.5, False)] * 8,
                         {"min_samples": 1, "check_every": 1}),
    "observe_only": ({}, [("m", "", 10.0, False)] * 8,
                     {"check_every": 1, "min_samples": 1}),
    "key_cap": ({}, [(f"m{i}", "", 0.001, False) for i in range(6)],
                {"max_keys": 3}),
}


@pytest.mark.parametrize("case", sorted(WATCH_CASES))
def test_slo_watchdog_equals_jax(case):
    """TestSloWatchdog: breach counts, the summary and every gauge and
    counter line agree (no flight recorder: dumps are the next test's)."""
    objectives, samples, kw = WATCH_CASES[case]
    got = _watch("torch", objectives, samples, **kw)
    want = _watch("jax", objectives, samples, **kw)
    assert got == want


def test_breach_counts_and_dumps_once_per_interval(tmp_path, monkeypatch):
    """The port's copy of test_traceview.py's test, with the host's
    uptime at 5 s: the first breach dumps (the JAX watchdog's interval
    starts at monotonic 0, so there it waits 3600 s), the next are
    rate-limited."""
    clock = [5.0]

    class _Time:  # the watchdog module's clock, at 5 s of uptime
        @staticmethod
        def monotonic():
            return clock[0]

    monkeypatch.setattr(slo, "time", _Time)
    registry = Registry()
    recorder = flight.FlightRecorder(dump_dir=str(tmp_path))
    watchdog = slo.SloWatchdog(
        objectives={"*": {"p99_ms": 5.0}}, registry=registry,
        flight=recorder, min_samples=4, check_every=4,
        dump_interval_s=3600.0,
    )
    for _ in range(16):
        watchdog.observe("m", "", 0.100)  # 100ms >> 5ms objective
        clock[0] += 0.01
    assert watchdog.breaches >= 1
    assert registry.get(
        "ctpu_slo_breaches_total",
        {"model": "m", "tenant": "", "kind": "p99_ms"},
    ) >= 1
    assert len(recorder.dumps) == 1  # rate-limited
    breach_notes = [
        r for r in recorder.snapshot() if r["kind"] == "slo_breach"
    ]
    assert breach_notes and breach_notes[0]["objective"] == 5.0
    clock[0] += 3600.0
    for _ in range(4):
        watchdog.observe("m", "", 0.100)
    assert len(recorder.dumps) == 2  # the interval has passed


# -- flight recorder ---------------------------------------------------------------


def _flight_render(pkg, tmp_path):
    rec_cls, prof_cls, reg_cls = {
        "jax": (jflight.FlightRecorder, JPhaseProfiler, JRegistry),
        "torch": (flight.FlightRecorder, PhaseProfiler, Registry)}[pkg]
    prof = prof_cls(name="serve")
    child = prof_cls(name="lm")
    prof.adopt(child)
    prof.commit("unary", 0.002, phases={"host": 0.001, "compute": 0.001},
                model="m", items=2)
    child.commit("decode", 0.0006, phases={"dispatch": 0.0006})
    reg = reg_cls()
    rec = rec_cls(capacity=4, dump_dir=str(tmp_path / pkg), registry=reg,
                  name="r1", prof=prof)
    for i in range(6):
        rec.note("e", i=i)
    rec.note("fault", kind_detail="kill", nested={"a": [1, 2]})
    span = (jstracing if pkg == "jax" else stracing).RequestTrace(
        "a" * 32, "b" * 16, model_name="m", seq=3)
    span.event("COMPUTE_START", 10)
    rec.note_span(span)
    body = rec.render("unit test!")
    path = rec.dump("unit test!")
    records = [json.loads(line) for line in body.splitlines()]
    for r in records:
        r.pop("ts", None)
    lines = []
    reg.render_into(lines)
    dumped = [json.loads(line) for line in open(path)]
    return records, len(dumped), rec.events_noted, lines


def test_flight_render_equals_jax(tmp_path):
    got = _flight_render("torch", tmp_path)
    want = _flight_render("jax", tmp_path)
    assert got == want
    records = got[0]
    assert records[0]["kind"] == "flight_dump"
    assert records[0]["reason"] == "unit test!"
    assert [r["kind"] for r in records[1:]] == (
        ["e", "e", "fault", "span", "prof_tick", "prof_tick"])
    assert {r["engine"] for r in records[-2:]} == {"serve", "lm"}


def test_flight_dump_failure_returns_none_and_env_dir(tmp_path,
                                                      monkeypatch):
    recorder = flight.FlightRecorder(dump_dir="/proc/definitely/not/here")
    assert recorder.dump("x") is None and recorder.dumps == []
    monkeypatch.setenv("TPU_FLIGHT_DIR", str(tmp_path / "env"))
    path = flight.FlightRecorder().dump("envtest")
    assert path is not None and str(tmp_path / "env") in path
