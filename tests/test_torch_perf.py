"""The port's perf_analyzer (client_tpu_torch.perf) held against the JAX
package's (client_tpu.perf), on the CPU.

- The data loader gives the JAX loader's arrays exactly, for the same
  seed and flags; the sequence manager, the request-rate schedules and
  ``_validate_result`` decide as JAX's do.
- ``ModelParser`` on ``simple``, ``cnn_classifier`` and
  ``lm_streaming_batched`` through the port's gRPC backend on the port's
  server gives the fields the JAX parser gives through the JAX backend on
  the JAX server.
- The profiler's window and summary arithmetic on fixed records, and the
  report's CSV, JSON and stdout text for the same results: equal, but for
  the gauge names (``ctpu_gpu_memory_*`` where JAX's are
  ``ctpu_tpu_memory_*``).
- ``parse_prometheus``/``summarize`` on the port server's own /metrics
  text equal JAX's; the local GPU snapshot and the probe refuse to run
  without CUDA, and the probe on ``device="cpu"`` flows into a summary.
- The in-process backend over the port's engine against JAX's over the
  JAX engine: ``simple`` equal, a float32 ``lm_streaming_batched`` on
  weights carried from JAX gives the same tokens; a decoupled model over
  gRPC is refused alike.
- The CUDA shared-memory data manager on CPU regions (the in-process
  broker): ``cnn_classifier`` bit-equal to the wire answer, within 1e-2
  of the JAX engine's over TPU shared memory (tests/test_torch_shared_
  memory.py's tolerance).
- The CLI: hermetic sweeps on ``--device cpu`` with their exports, the
  refusal without it, every option that is not ported yet refused, the
  gRPC legs with system and CUDA regions, ``--speculative`` through
  ``model_sets(..., speculative=)``, a ``--url`` replica list over two
  port servers on both transports (each endpoint's count its server's)
  and ``--churn-soak``, and every replica-list refusal with the JAX
  CLI's message.  (``--async``, ``--service-kind``
  and ``--world-size`` have files of their own:
  tests/test_torch_perf_async.py, test_torch_backends.py and
  test_torch_rendezvous.py.)

Wall-clock waits are count windows or mocks; no stability case waits on
the clock.
"""

import dataclasses
import json
import os
import time
import urllib.request

import jax
import numpy as np
import pytest
import torch

import client_tpu.perf as jperf
from client_tpu.perf import client_backend as jbackend
from client_tpu.perf import load_manager as jload
from client_tpu.perf import metrics_manager as jmetrics
from client_tpu.perf import profiler as jprofiler
from client_tpu.perf import report as jreport
from client_tpu.perf.__main__ import main as jmain
from client_tpu.perf.model_parser import ModelParser as JaxParser
import client_tpu.serve as jserve
from client_tpu.serve import Server as JaxServer
import client_tpu.serve.models as jmodels
from client_tpu.serve.models import language as jlanguage
from client_tpu.serve.models import transformer as jtfm
from client_tpu.serve.models import vision as jvision
from client_tpu.utils import InferenceServerException as JaxError
import client_tpu_torch.perf as perf
from client_tpu_torch import convert
from client_tpu_torch.perf import client_backend as backend
from client_tpu_torch.perf import load_manager
from client_tpu_torch.perf import metrics_manager
from client_tpu_torch.perf import profiler
from client_tpu_torch.perf import report
from client_tpu_torch.perf.__main__ import main
from client_tpu_torch.perf.model_parser import ModelParser
import client_tpu_torch.serve as tserve
from client_tpu_torch.serve import Server
import client_tpu_torch.serve.models as tmodels
from client_tpu_torch.serve.models import language, model_sets, vision
from client_tpu_torch.serve.models import transformer as tfm
from client_tpu_torch.utils import InferenceServerException as PortError

META = [{"name": "INPUT0", "datatype": "FP32", "shape": [1, 4]}]
OUT_META = [{"name": "OUTPUT0", "datatype": "FP32", "shape": [1, 4]}]
FORWARD_BF16_TOL = 1e-2  # of the largest score (tests/test_torch_vision.py)
IMAGE = 32


def _same_arrays(a, b):
    """Exact equality of two arrays: dtype, shape and every element."""
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tolist() == b.tolist()


def _same_streams(got, want):
    assert len(got) == len(want)
    for steps, jsteps in zip(got, want):
        assert len(steps) == len(jsteps)
        for step, jstep in zip(steps, jsteps):
            assert sorted(step) == sorted(jstep)
            for name in step:
                _same_arrays(step[name].array, jstep[name].array)


# -- the data loader, sequences, schedules, validation --------------------------

_LOADER_META = [
    {"name": "F", "datatype": "FP32", "shape": [-1, 3]},
    {"name": "H", "datatype": "FP16", "shape": [2]},
    {"name": "I", "datatype": "INT32", "shape": [4]},
    {"name": "U", "datatype": "UINT8", "shape": [-1, 2]},
    {"name": "L", "datatype": "INT64", "shape": [1]},
    {"name": "B", "datatype": "BOOL", "shape": [3]},
    {"name": "S", "datatype": "BYTES", "shape": [2]},
]


@pytest.mark.parametrize("kw", [
    {}, {"zero_data": True}, {"string_length": 5, "num_steps": 3},
])
@pytest.mark.parametrize("batch", [1, 3])
def test_generated_data_equals_jax(kw, batch):
    """DataLoader.generate_data: random and zero tensors of every
    datatype, BYTES strings included, exactly JAX's for the same seed."""
    got = perf.DataLoader(_LOADER_META, batch_size=batch)
    want = jperf.DataLoader(_LOADER_META, batch_size=batch)
    got.generate_data(**kw)
    want.generate_data(**kw)
    _same_streams(got.streams, want.streams)


@pytest.mark.parametrize("share,pool,prompts", [
    (0.0, 4, 3), (0.5, 2, 6), (0.8, 1, 4), (1.0, 3, 5),
])
@pytest.mark.parametrize("shape", [None, [1, 128], [40]])
def test_prefix_share_equals_jax(share, pool, prompts, shape):
    """DataLoader.generate_prefix_share on the batched LM's inputs
    (TOKENS [-1], MAX_TOKENS [1]), with --shape overrides: JAX's prompts
    and budgets exactly."""
    meta = [{"name": "TOKENS", "datatype": "INT32", "shape": [-1]},
            {"name": "MAX_TOKENS", "datatype": "INT32", "shape": [1]}]
    overrides = {"TOKENS": shape} if shape else {}
    got = perf.DataLoader(meta, shape_overrides=overrides)
    want = jperf.DataLoader(meta, shape_overrides=overrides)
    got.generate_prefix_share(share, num_prompts=prompts, shared_pool=pool)
    want.generate_prefix_share(share, num_prompts=prompts, shared_pool=pool)
    _same_streams(got.streams, want.streams)
    assert all(s[0]["MAX_TOKENS"].array.tolist() == [16] for s in got.streams)


def test_prefix_share_refusals_equal_jax():
    """DataLoader.generate_prefix_share refuses a model without an integer
    token input and a share outside [0, 1] with JAX's messages."""
    for meta, share in (([{"name": "X", "datatype": "FP32", "shape": [4]}],
                         0.5),
                        ([{"name": "T", "datatype": "INT32", "shape": [4]}],
                         1.5)):
        with pytest.raises(PortError) as p:
            perf.DataLoader(meta).generate_prefix_share(share)
        with pytest.raises(JaxError) as j:
            jperf.DataLoader(meta).generate_prefix_share(share)
        assert p.value.message() == j.value.message()


_JSON_DOC = {
    "data": [
        [{"INPUT0": [1, 2, 3, 4], "TEXT": ["a", "bc"]},
         {"INPUT0": {"content": [5, 6, 7, 8], "shape": [1, 4]},
          "TEXT": {"b64": "AQAAAHgCAAAAeXo=", "shape": [2]}}],
        {"INPUT0": {"b64": "AACAPwAAAEAAAEBAAACAQA=="},
         "TEXT": ["q", "r"]},
    ],
    "validation_data": [
        [{"OUTPUT0": [2, 4, 6, 8]}, {"OUTPUT0": [10, 12, 14, 16]}],
        {"OUTPUT0": [2, 4, 6, 8]},
    ],
}
_JSON_META = [{"name": "INPUT0", "datatype": "FP32", "shape": [1, 4]},
              {"name": "TEXT", "datatype": "BYTES", "shape": [2]}]


def test_json_streams_equal_jax(tmp_path):
    """read_data_from_json: typed lists, content/shape dicts and b64, two
    streams, validation data; and read_data_from_dir on raw files."""
    path = tmp_path / "data.json"
    path.write_text(json.dumps(_JSON_DOC))
    got, want = perf.DataLoader(_JSON_META), jperf.DataLoader(_JSON_META)
    got.read_data_from_json(str(path))
    want.read_data_from_json(str(path))
    _same_streams(got.streams, want.streams)
    _same_streams(got.expected_outputs, want.expected_outputs)
    assert got.num_streams == 2 and got.num_steps(0) == 2
    for s, t in ((0, 1), (1, 0), (5, 5)):
        a, b = got.get_expected_outputs(s, t), want.get_expected_outputs(s, t)
        assert sorted(a) == sorted(b)
    raw = tmp_path / "raw"
    raw.mkdir()
    (raw / "INPUT0").write_bytes(np.arange(4, dtype=np.float32).tobytes())
    (raw / "TEXT").write_bytes(b"\x01\x00\x00\x00a\x02\x00\x00\x00bc")
    got.read_data_from_dir(str(raw))
    want.read_data_from_dir(str(raw))
    _same_streams(got.streams, want.streams)


@pytest.mark.parametrize("variation,streams", [(0.0, 1), (40.0, 3)])
def test_sequence_manager_equals_jax(variation, streams):
    """SequenceManager: ids with wraparound, stream choice, lengths with
    variation and start/end flags exactly JAX's for the same seed."""
    kw = dict(start_sequence_id=7, sequence_id_range=5, sequence_length=6,
              sequence_length_variation=variation,
              sequence_length_specified=True, num_streams=streams)
    got, want = perf.SequenceManager(**kw), jperf.SequenceManager(**kw)
    for slot in range(12):
        a = got.begin_sequence(slot % 3, [2, 4, 1])
        b = want.begin_sequence(slot % 3, [2, 4, 1])
        assert (a.seq_id, a.data_stream_id, a.remaining_queries) == (
            b.seq_id, b.data_stream_id, b.remaining_queries)
        flags = [got.advance(a) for _ in range(a.remaining_queries)]
        assert flags == [want.advance(b) for _ in range(b.remaining_queries)]


def _mock_manager(mod, cls, stats, **kwargs):
    def factory():
        return mod.MockClientBackend(stats=stats)

    loader = mod.DataLoader(META)
    loader.generate_data()
    dm = mod.create_infer_data_manager(factory(), loader, META, OUT_META)
    dm.init()
    return cls(backend_factory=factory, data_loader=loader, data_manager=dm,
               model_name="mock", **kwargs)


@pytest.mark.parametrize("distribution", ["constant", "poisson"])
def test_request_rate_schedule_equals_jax(distribution):
    """RequestRateManager._make_schedule: JAX's gaps exactly (same seed)."""
    got = _mock_manager(perf, perf.RequestRateManager, perf.MockStats(),
                        distribution=distribution)
    want = _mock_manager(jperf, jperf.RequestRateManager, jperf.MockStats(),
                         distribution=distribution)
    _same_arrays(got._make_schedule(250.0, horizon=64),
                 want._make_schedule(250.0, horizon=64))


def test_load_managers_on_the_mock_backend():
    """Mirrors tests/test_perf.py's TestConcurrencyManager and
    TestCustomLoadManager cases on the port's mock backend: concurrency
    workers send, count and swap records; a failed request
    is counted, not fatal; a level above max_threads is refused; a custom
    interval schedule replays its gaps (the mock backend: no server)."""
    stats = perf.MockStats()
    mgr = _mock_manager(perf, perf.ConcurrencyManager, stats, max_threads=4)
    try:
        mgr.change_concurrency_level(2)
        deadline = time.monotonic() + 10
        while stats.num_infer_calls < 20 and time.monotonic() < deadline:
            time.sleep(0.01)
        mgr.stop_workers()
        records = mgr.swap_timestamps()
        assert len(records) >= 20 and all(r.ok for r in records)
        with pytest.raises(PortError, match="max_threads"):
            mgr.change_concurrency_level(5)
    finally:
        mgr.cleanup()

    failing = perf.MockStats()

    def factory():
        return perf.MockClientBackend(error_schedule=[True, False, True],
                                      stats=failing)

    loader = perf.DataLoader(META)
    loader.generate_data()
    dm = perf.create_infer_data_manager(factory(), loader, META, OUT_META)
    dm.init()
    ctx = load_manager.InferContext(0, factory(), dm, loader, "mock", "")
    for _ in range(4):
        ctx.send()
    assert [r.ok for r in ctx.stat.records] == [False, True, False, True]

    custom = _mock_manager(perf, perf.CustomLoadManager, perf.MockStats(),
                           intervals_ns=[1_000_000, 2_000_000])
    try:
        custom.start(num_threads=1, repeats=3)
        deadline = time.monotonic() + 10
        while custom.get_and_reset_num_sent() < 1 and (
                time.monotonic() < deadline):
            time.sleep(0.005)
        assert custom._gaps_ns.tolist() == np.cumsum(
            [1_000_000, 2_000_000] * 3).tolist()
    finally:
        custom.cleanup()


class _Result:
    def __init__(self, arrays):
        self._arrays = arrays

    def as_numpy(self, name):
        return self._arrays.get(name)


@pytest.mark.parametrize("got", [
    None, {"OUTPUT0": np.array([2.0, 4.0, 6.0, 8.0], np.float32)},
    {"OUTPUT0": np.array([2.0, 4.0, 6.0, 8.00001], np.float32)},
    {"OUTPUT0": np.array([2.0, 4.0, 6.0, 9.0], np.float32)},
    {"OUTPUT0": np.array([2.0, 4.0], np.float32)}, {},
])
def test_validate_result_equals_jax(got, tmp_path):
    """load_manager._validate_result decides as JAX's (its rtol 1e-5,
    atol 1e-6 against the validation data) on every case."""
    path = tmp_path / "data.json"
    path.write_text(json.dumps(_JSON_DOC))
    loaders = []
    for mod in (perf, jperf):
        loader = mod.DataLoader(_JSON_META)
        loader.read_data_from_json(str(path))
        loaders.append(loader)
    result = None if got is None else _Result(got)
    for stream, step in ((0, 0), (1, 0), (0, 1)):
        assert load_manager._validate_result(
            loaders[0], result, stream, step) == jload._validate_result(
            loaders[1], result, stream, step)


# -- the profiler's arithmetic and the report ------------------------------------

_T0 = 10**12
_WINDOW = (_T0, _T0 + 100_000_000)


def _records(mod, seed):
    """Fixed synthetic records: latencies, a few failures, stale and
    future completions, two endpoints and three tenants."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(60):
        end = _T0 + int(rng.integers(-5_000_000, 110_000_000))
        lat = int(rng.integers(200_000, 9_000_000))
        out.append(mod.RequestRecord(
            end - lat, end, bool(i % 7), sequence_id=i % 3,
            delayed=bool(i % 5 == 0), endpoint=f"ep{i % 2}",
            tenant=("gold", "bronze", "")[i % 3]))
    return out


class _Manager:
    model_name = "mock"
    concurrency = 4


def _status(mod, prof_mod, seeds, label="concurrency", percentile=None):
    prof = prof_mod.InferenceProfiler(_Manager(), percentile=percentile)
    window = [prof._window_measurement(_records(mod, s), *_WINDOW, 70)
              for s in seeds]
    status = prof._summarize(label, 4, window, stable=prof._is_stable(window))
    return prof, window, status


@pytest.mark.parametrize("seeds", [(0,), (1, 2, 3), (4, 4, 4)])
@pytest.mark.parametrize("percentile", [None, 95])
@pytest.mark.parametrize("label", ["concurrency", "request_rate"])
def test_profiler_windows_and_summary_equal_jax(seeds, percentile, label):
    """_window_measurement (clipping to the window, errors, delayed, busy
    time, per-endpoint/tenant groups), _is_stable and _summarize on the
    same records: the JAX profiler's numbers, every field."""
    prof, window, status = _status(load_manager, profiler, seeds, label,
                                   percentile)
    jprof, jwindow, jstatus = _status(jload, jprofiler, seeds, label,
                                      percentile)
    for m, j in zip(window, jwindow):
        assert (m.throughput, m.latency_avg_ns, m.errors, m.delayed,
                m.window_s, m.send_rate, m.busy_ns) == (
            j.throughput, j.latency_avg_ns, j.errors, j.delayed, j.window_s,
            j.send_rate, j.busy_ns)
        _same_arrays(m.latencies_ns, j.latencies_ns)
    assert prof._is_stable(window) == jprof._is_stable(jwindow)
    assert report.status_record(status) == jreport.status_record(jstatus)


def test_profiler_probe_deltas_and_stats_equal_jax():
    """InferenceProfiler._prefix_delta, _spec_delta and _flatten_stats:
    JAX's dicts exactly."""
    got = profiler.InferenceProfiler(_Manager())
    want = jprofiler.InferenceProfiler(_Manager())
    counters = iter([{"hits": 3, "misses": 5, "prefill_tokens": 40,
                      "saved_tokens": 8},
                     {"hits": 9, "misses": 6, "prefill_tokens": 90,
                      "saved_tokens": 40}] * 2)
    got.prefix_probe = want.prefix_probe = lambda: next(counters)
    before = got.prefix_probe()
    a = got._prefix_delta(before)
    assert a == want._prefix_delta(want.prefix_probe())
    assert a["prefix_hit_pct"] == 85.71
    spec = iter([{"proposed": 10, "accepted": 4, "lm_tokens": 100},
                 {"proposed": 50, "accepted": 24, "lm_tokens": 300}] * 2)
    got.spec_probe = want.spec_probe = lambda: next(spec)
    assert got._spec_delta(got.spec_probe(), 2.0) == want._spec_delta(
        want.spec_probe(), 2.0)
    stats = {"model_stats": [{"inference_stats": {
        "success": {"count": 4, "ns": 4000}, "queue": {"count": 4, "ns": 80},
        "cache_hit": {"count": 1, "ns": 9}}}] * 2}
    assert profiler._flatten_stats(stats) == jprofiler._flatten_stats(stats)
    assert profiler._flatten_stats(stats["model_stats"]) == (
        jprofiler._flatten_stats(stats["model_stats"]))


def _report_status(mod, memory):
    s = mod.PerfStatus("concurrency", 8)
    s.throughput, s.send_rate, s.latency_avg_us = 812.25, 815.5, 9_812.4
    s.percentiles_us = {50: 9_000.0, 90: 12_000.5, 95: 13_100.0, 99: 20_040.9}
    s.completed_requests, s.error_count, s.delayed_count = 2437, 2, 1
    s.stable, s.client_window_s, s.overhead_pct = True, 3.0, 1.25
    s.per_endpoint = {"a:1": {"count": 3, "throughput": 1.0, "avg_us": 2.0,
                              "p99_us": 3.0, "errors": 0},
                      "b:2": {"count": 1, "throughput": 0.5, "avg_us": 2.5,
                              "p99_us": 4.0, "errors": 1}}
    s.per_tenant = {"gold": {"count": 3, "throughput": 1.0, "avg_us": 2.0,
                             "p99_us": 3.0, "errors": 0}}
    s.server_stats = {"success_count": 10, "queue_ns": 5000,
                      "compute_input_ns": 100, "compute_infer_ns": 90000,
                      "compute_output_ns": 70, "cache_hit_count": 2,
                      "cache_miss_count": 8, "cache_hit_ns": 40}
    s.ensemble_stats = {"stage": {"success_count": 10, "queue_ns": 10,
                                  "compute_infer_ns": 800}}
    # the memory gauges only: a renamed gauge sorts among them as before
    s.tpu_metrics = {f"ctpu_{memory}_memory_{kind}_bytes": {"avg": avg,
                                                           "max": 2 * avg}
                     for kind, avg in (("used", 1e9), ("total", 8e10),
                                       ("peak", 3.5e9))}
    s.lm_prefix = {"prefix_hit_pct": 42.86, "prefill_tokens_saved_pct": 37.5}
    s.lm_spec = {"spec_acceptance_pct": 6.06, "spec_tokens_per_sec": 64.8}
    return s


@pytest.mark.parametrize("verbose", [False, True])
def test_report_text_equals_jax_but_the_gauge_names(tmp_path, capsys,
                                                    verbose):
    """write_csv, write_json and print_summary on the same results give
    the JAX text, with ctpu_gpu_memory_* where JAX writes
    ctpu_tpu_memory_*."""
    got, want = [_report_status(profiler, "gpu")], [
        _report_status(jprofiler, "tpu")]
    texts = []
    for mod, results, name in ((report, got, "port"), (jreport, want, "jax")):
        mod.write_csv(tmp_path / f"{name}.csv", results, verbose=verbose)
        mod.write_json(tmp_path / f"{name}.json", results,
                       extra={"slo_search": {"best": 4}})
        mod.print_summary(results, percentile=95)
        texts.append([(tmp_path / f"{name}.csv").read_text(),
                      (tmp_path / f"{name}.json").read_text(),
                      capsys.readouterr().out])
    assert all("ctpu_gpu_memory_used_bytes" in t for t in texts[0])
    assert texts[0] == [t.replace("ctpu_tpu_memory", "ctpu_gpu_memory")
                        for t in texts[1]]


# -- /metrics, local gauges, the probe -------------------------------------------


@pytest.fixture(scope="module")
def metrics_server():
    with Server(device="cpu", http_port=0) as s:
        yield s


def _scrape_text(server):
    with urllib.request.urlopen(f"http://{server.http_address}/metrics",
                                timeout=60) as r:
        return r.read().decode()


def _infer_simple(engine, n):
    a = np.ones((1, 16), np.int32).tobytes()
    request = {"inputs": [
        {"name": n_, "datatype": "INT32", "shape": [1, 16],
         "parameters": {"binary_data_size": 64}} for n_ in ("INPUT0",
                                                            "INPUT1")]}
    for _ in range(n):
        engine.execute("simple", "", request, a + a)


def test_parse_and_summarize_the_port_servers_metrics(metrics_server):
    """parse_prometheus on the port server's own /metrics text, and
    summarize over its scrapes (with GPU gauges added to the text as a
    GPU server would write them): JAX's results, its gauge list renamed."""
    snaps, jsnaps = [], []
    for i in range(3):
        _infer_simple(metrics_server.engine, 2 + i)
        text = _scrape_text(metrics_server) + (
            f'ctpu_gpu_memory_used_bytes{{device="0",kind="H"}} {100 * i}\n'
            f'ctpu_gpu_memory_total_bytes{{device="0",kind="H"}} 1000\n'
            f'ctpu_probe_busy{{device="0",source="probe"}} {i % 2}\n')
        snaps.append(metrics_manager.parse_prometheus(text))
        jsnaps.append(jmetrics.parse_prometheus(text))
        time.sleep(0.02)
    assert snaps == jsnaps
    assert "ctpu_inference_request_success" in snaps[0]
    got = metrics_manager.MetricsManager.summarize(snaps)
    want = jmetrics.MetricsManager.summarize(jsnaps, gauges=(
        "ctpu_gpu_memory_used_bytes", "ctpu_gpu_memory_total_bytes",
        "ctpu_gpu_memory_peak_bytes", "ctpu_probe_queue_delay_us"))
    assert got == want
    assert got["ctpu_gpu_memory_used_bytes"] == {"avg": 100.0, "max": 200.0}
    assert "ctpu_server_queue_us_per_infer" in got
    assert got["ctpu_probe_utilization_pct"]["avg"] == pytest.approx(100 / 3)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_local_gpu_gauges_and_the_probe_refuse_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="need CUDA"):
        metrics_manager.local_device_snapshot()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        metrics_manager.DeviceUtilizationProbe()


def test_probe_on_the_cpu_flows_through_scrape_and_summary(metrics_server):
    """Mirrors tests/test_metrics_rendezvous.py::TestMetricsEndpoint::
    test_probe_gauges_flow_through_scrape_and_summary with the probe on
    ``device="cpu"``: samples on every scrape, the no-/metrics path too,
    and a busy percent in the summary."""
    probe = metrics_manager.DeviceUtilizationProbe(device="cpu")
    assert probe.baseline_s > 0 and probe.device_id == 0
    for _ in range(5):
        delay_us, busy = probe.sample()
        assert delay_us >= 0.0 and busy in (0.0, 1.0)
    mm = metrics_manager.MetricsManager(
        f"http://{metrics_server.http_address}/metrics",
        utilization_probe=probe)
    snap = mm.scrape()
    assert 'source="probe"' in snap["ctpu_probe_busy"][0][0]
    dead = metrics_manager.MetricsManager(
        "http://127.0.0.1:9/metrics", timeout_s=0.2, utilization_probe=probe)
    fallback = dead.scrape()
    assert "ctpu_probe_busy" in fallback and dead.scrape_errors == 1
    agg = metrics_manager.MetricsManager.summarize([snap, fallback])
    assert 0.0 <= agg["ctpu_probe_utilization_pct"]["avg"] <= 100.0
    assert "ctpu_probe_queue_delay_us" in agg

    local = metrics_manager.MetricsManager(
        f"http://{metrics_server.http_address}/metrics",
        include_local_devices=True)
    local._local_snapshot = lambda: {
        "ctpu_gpu_memory_used_bytes": [('{device="0",source="local"}', 7.0)],
        "ctpu_inference_request_success": [('{source="local"}', -1.0)],
    }
    filled = local.scrape()
    assert filled["ctpu_gpu_memory_used_bytes"] == [
        ('{device="0",source="local"}', 7.0)]
    assert all(v >= 0 for _, v in filled["ctpu_inference_request_success"])


# -- the parser and the backends against the JAX package -------------------------

_LM_JCFG = jtfm.TransformerConfig(
    vocab_size=258, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq=64, dtype="float32",
)


@pytest.fixture(scope="module")
def lm_runners():
    """The JAX LM's float32 weights from a seed, carried into the port
    (convert.params_from_numpy): the port's runner and JAX's."""
    jparams = jtfm.init_params(jax.random.PRNGKey(0), _LM_JCFG)
    jrunner = jlanguage._LmRunner(cfg=_LM_JCFG, params=jparams)
    runner = language._LmRunner(
        cfg=tfm.TransformerConfig(**dataclasses.asdict(_LM_JCFG)),
        params=convert.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), "cpu"),
        device="cpu")
    return runner, jrunner


def _lm_batched(runners, which, **kwargs):
    """The port's (0) or JAX's (1) lm_streaming_batched on the carried
    weights."""
    mod = (language, jlanguage)[which]
    return mod.lm_streaming_batched_model(runner=runners[which], max_slots=4,
                                          lane_counts=(4,), **kwargs)


@pytest.fixture(scope="module")
def lm_models(lm_runners):
    return _lm_batched(lm_runners, 0), _lm_batched(lm_runners, 1)


@pytest.fixture(scope="module")
def cnn_models():
    """The JAX CNN at image 32; its bfloat16 parameters carried into the
    port's."""
    jmodel = jvision.cnn_classifier_model(image_size=IMAGE, max_batch_size=8)
    model = vision.cnn_classifier_model(image_size=IMAGE, max_batch_size=8,
                                        device="cpu")
    model.fn.params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jmodel.fn.params), "cpu")
    return model, jmodel


@pytest.fixture(scope="module")
def servers(lm_models, cnn_models):
    """Both packages' servers over gRPC: the builtin set, the CNN and the
    float32 batched LM; ``.engine`` is each one's in-process engine."""
    with Server(models=[cnn_models[0], lm_models[0]], device="cpu",
                http_port=0, grpc_port=0) as port, \
            JaxServer(models=[cnn_models[1], lm_models[1]], http_port=0,
                      grpc_port=0) as ref:
        yield port, ref


@pytest.fixture(scope="module")
def engines(servers):
    return servers[0].engine, servers[1].engine


@pytest.mark.parametrize("model", ["simple", "cnn_classifier",
                                   "lm_streaming_batched", "simple_sequence",
                                   "repeat_int32"])
def test_model_parser_over_grpc_equals_jax(servers, model):
    """ModelParser.create through each package's gRPC backend on its own
    server: the same tensors, batch size, scheduler and decoupled flag."""
    fields = []
    for server, mod, parser_cls in ((servers[0], backend, ModelParser),
                                    (servers[1], jbackend, JaxParser)):
        b = mod.ClientBackendFactory.create(
            mod.BackendKind.TRITON_GRPC, url=server.grpc_address)
        try:
            p = parser_cls.create(b, model, batch_size=2)
        finally:
            b.close()
        fields.append((p.inputs, p.outputs, p.max_batch_size,
                       p.scheduler_type, p.is_decoupled,
                       p.composing_models, p.response_cache_enabled,
                       p.requires_sequence_flags()))
    assert fields[0] == fields[1]


def _inputs(mod_cls, arrays):
    out = []
    for name, arr, datatype in arrays:
        inp = mod_cls(name, list(arr.shape), datatype)
        inp.set_data_from_numpy(arr)
        out.append(inp)
    return out


def test_inprocess_simple_equals_jax(engines):
    """_InprocessBackend over the port's engine against JAX's over the
    JAX engine: the same response, outputs, metadata and config."""
    got_b = backend.ClientBackendFactory.create(
        backend.BackendKind.INPROCESS, engine=engines[0])
    want_b = jbackend.ClientBackendFactory.create(
        jbackend.BackendKind.INPROCESS, engine=engines[1])
    arrays = [("INPUT0", np.arange(16, dtype=np.int32).reshape(1, 16), "INT32"),
              ("INPUT1", np.full((1, 16), -3, np.int32), "INT32")]
    got = got_b.infer("simple", _inputs(got_b.infer_input_cls, arrays),
                      request_id="a")
    want = want_b.infer("simple", _inputs(want_b.infer_input_cls, arrays),
                        request_id="a")
    assert got.get_response() == want.get_response()
    for name in ("OUTPUT0", "OUTPUT1"):
        _same_arrays(got.as_numpy(name), want.as_numpy(name))
    assert got_b.model_metadata("simple") == want_b.model_metadata("simple")
    assert got_b.model_config("simple") == want_b.model_config("simple")


@pytest.mark.parametrize("prompt,n", [("hello, perf", 6), ("abc", 9)])
def test_inprocess_lm_stream_equals_jax(engines, prompt, n):
    """A decoupled model answers the in-process backend with a list, one
    view a response: the float32 batched LM on the carried weights gives
    the JAX engine's tokens."""
    tokens = jlanguage.encode_text(prompt).astype(np.int32)
    arrays = [("TOKENS", tokens, "INT32"),
              ("MAX_TOKENS", np.array([n], np.int32), "INT32")]
    streams = []
    for mod, engine in ((backend, engines[0]), (jbackend, engines[1])):
        b = mod.ClientBackendFactory.create(mod.BackendKind.INPROCESS,
                                            engine=engine)
        views = b.infer("lm_streaming_batched",
                        _inputs(b.infer_input_cls, arrays))
        assert isinstance(views, list)
        streams.append([int(v.as_numpy("TOKEN")[0]) for v in views])
    assert streams[0] == streams[1]
    assert len(streams[0]) == n


@pytest.mark.parametrize("model", ["repeat_int32", "lm_streaming_batched"])
def test_decoupled_over_grpc_is_refused_as_by_jax(servers, model):
    """ModelInfer on a decoupled model: each package's gRPC backend gets
    INVALID_ARGUMENT and the same message from its own server, so a perf
    run against it counts every request as failed, as JAX's does."""
    answers = []
    arrays = ([("IN", np.array([3], np.int32), "INT32")]
              if model == "repeat_int32" else
              [("TOKENS", np.array([5, 6], np.int32), "INT32"),
               ("MAX_TOKENS", np.array([2], np.int32), "INT32")])
    for server, mod in ((servers[0], backend), (servers[1], jbackend)):
        b = mod.ClientBackendFactory.create(mod.BackendKind.TRITON_GRPC,
                                            url=server.grpc_address)
        try:
            with pytest.raises((PortError, JaxError)) as e:
                b.infer(model, _inputs(b.infer_input_cls, arrays))
        finally:
            b.close()
        answers.append((e.value.status(), e.value.message()))
    assert answers[0] == answers[1]
    assert answers[0][0] == "INVALID_ARGUMENT"


def test_cuda_shm_data_manager_equals_wire_and_jax_tpushm(engines):
    """CudaShmInferDataManager on CPU regions, in process: the regions
    resolve through the broker (the registry opened nothing), the CNN's
    scores read from the output region equal the wire answer bit for bit
    and the JAX engine's over TPU shared memory within 1e-2 of the
    largest score; sync_outputs reads every output region."""
    meta = [{"name": "INPUT0", "datatype": "FP32",
             "shape": [1, 3, IMAGE, IMAGE]}]
    out_meta = [{"name": "OUTPUT0", "datatype": "FP32", "shape": [1, 1000]}]
    scores = {}
    for pkg, mod, engine, kind in (("wire", perf, engines[0], "none"),
                                   ("cuda", perf, engines[0], "cuda"),
                                   ("tpu", jperf, engines[1], "tpu")):
        b = mod.ClientBackendFactory.create(mod.BackendKind.INPROCESS,
                                            engine=engine)
        loader = mod.DataLoader(meta)
        loader.generate_data()
        kw = {"device": "cpu"} if kind == "cuda" else {}
        dm = mod.create_infer_data_manager(
            b, loader, meta, out_meta, shared_memory=kind,
            output_shm_byte_size=4000, **kw)
        dm.init()
        try:
            data = dm.get_infer_data(0, 0)
            result = b.infer("cnn_classifier", data.inputs,
                             outputs=data.outputs)
            if kind == "none":
                scores[pkg] = result.as_numpy("OUTPUT0")
                continue
            assert result.as_numpy("OUTPUT0") is None
            (handle, size), = dm._out_handles
            if kind == "cuda":
                assert engine.shm.cuda_status() == {
                    name: {"name": name, "device_id": 0, "byte_size": n}
                    for name, n in ((f"{dm.prefix}_0_0_INPUT0",
                                     3 * IMAGE * IMAGE * 4),
                                    (f"{dm.prefix}_out_OUTPUT0", 4000))}
                assert dm.prefix.startswith(f"perf_cudashm_{os.getpid()}_")
                assert not any(e["opened"]
                               for e in engine.shm._cuda.values())
                reads = []
                handle.read = (lambda real: lambda *a: reads.append(a)
                               or real(*a))(handle.read)
                dm.sync_outputs()
                assert reads == [(0, 4000)]
            scores[pkg] = np.frombuffer(handle.read(0, size),
                                        np.float32).reshape(1, 1000)
        finally:
            dm.cleanup()
    _same_arrays(scores["cuda"], scores["wire"])
    err = np.abs(scores["cuda"] - scores["tpu"]).max()
    assert err <= FORWARD_BF16_TOL * np.abs(scores["tpu"]).max(), err
    assert engines[0].shm.cuda_status() == {}


@pytest.mark.parametrize("kind", ["system", "cuda"])
def test_two_shm_data_managers_at_once_keep_their_own_regions(engines, kind):
    """Two managers alive at once on one server (two runs on one host):
    their region names and /dev/shm keys differ, each one's ``simple``
    sums, read from its own output region, are its own inputs' sums, and
    one's cleanup leaves the other's regions registered.
    JAX's managers name regions by a fixed prefix; the tolerance is exact
    equality."""
    from client_tpu_torch.utils import shared_memory as sysshm

    meta = [{"name": n, "datatype": "INT32", "shape": [1, 16]}
            for n in ("INPUT0", "INPUT1")]
    out_meta = [{"name": "OUTPUT0", "datatype": "INT32", "shape": [1, 16]}]
    b = backend.ClientBackendFactory.create(backend.BackendKind.INPROCESS,
                                            engine=engines[0])
    managers, loaders = [], []
    kw = {"device": "cpu"} if kind == "cuda" else {}
    try:
        for seed in (1, 2):
            loader = perf.DataLoader(meta, rng_seed=seed)
            loader.generate_data()
            dm = perf.create_infer_data_manager(
                b, loader, meta, out_meta, shared_memory=kind,
                output_shm_byte_size=64, **kw)
            managers.append(dm)
            loaders.append(loader)
            dm.init()
        names = [set(n for n, _ in dm._regions.values())
                 | set(n for n, _ in dm._out_regions.values())
                 for dm in managers]
        assert len(names[0]) == len(names[1]) == 3
        assert not names[0] & names[1]
        if kind == "system":
            keys = [{h._shm_key for h in dm._handles} for dm in managers]
            assert not keys[0] & keys[1]
        for dm, loader in zip(managers, loaders):
            data = dm.get_infer_data(0, 0)
            b.infer("simple", data.inputs, outputs=data.outputs)
        for dm, loader in zip(managers, loaders):
            step = loader.get_input_data(0, 0)
            want = step["INPUT0"].array + step["INPUT1"].array
            if kind == "system":
                out = sysshm.get_contents_as_numpy(dm._handles[-1], "INT32",
                                                   [1, 16])
            else:
                (handle, size), = dm._out_handles
                out = np.frombuffer(handle.read(0, size),
                                    np.int32).reshape(1, 16)
            _same_arrays(out, want)
        status = getattr(engines[0].shm, f"{kind}_status")
        assert set(status()) == names[0] | names[1]
        managers[0].cleanup()
        assert set(status()) == names[1]
    finally:
        for dm in managers:
            dm.cleanup()
    assert engines[0].shm.system_status() == {}
    assert engines[0].shm.cuda_status() == {}


def test_model_sets_threads_speculative_to_the_batched_engines():
    """model_sets(..., speculative=) reaches the language set's batched
    engine, as client_tpu/serve/models/__init__.py:43 does."""
    models = {m.name: m for m in model_sets(
        "language", device="cpu", speculative={"k": 2, "drafter": "bigram"})}
    try:
        spec = models["lm_streaming_batched"].closer.__self__._spec
        assert spec.k == 2
        assert type(spec.drafter).__name__ == "BigramDrafter"
    finally:
        for m in models.values():
            if m.closer is not None:
                m.closer()


# -- the CLI ---------------------------------------------------------------------

_COUNT = ["--measurement-mode", "count_windows",
          "--measurement-request-count", "4", "--measurement-interval", "300",
          "--max-trials", "3", "-s", "90"]


def test_cli_hermetic_sweep_and_exports(tmp_path, capsys):
    csv_path, json_path = tmp_path / "r.csv", tmp_path / "r.json"
    rc = main(["-m", "simple", "--hermetic", "--device", "cpu",
               "--concurrency-range", "1:2", *_COUNT, "-f", str(csv_path),
               "--json-export", str(json_path), "--trace-level",
               "TIMESTAMPS", "--trace-rate", "500", "-v"])
    captured = capsys.readouterr()
    assert rc == 0
    assert "Concurrency: 1" in captured.out and "Concurrency: 2" in (
        captured.out)
    assert "'trace_rate': '500'" in captured.err
    lines = csv_path.read_text().strip().splitlines()
    assert lines[0].startswith("Level,Inferences/Second") and len(lines) == 3
    doc = json.loads(json_path.read_text())
    assert [r["level_value"] for r in doc["results"]] == [1, 2]
    assert all(r["error_count"] == 0 and r["completed_requests"] >= 4
               for r in doc["results"])


def test_cli_request_rate_and_sequences_on_the_cpu(capsys):
    """Mirrors tests/test_perf.py::TestEndToEndInprocess::
    test_request_rate_mode with a sequence workload, count windows."""
    rc = main(["-m", "simple_sequence", "--hermetic", "--device", "cpu",
               "--sequence", "--sequence-length", "3",
               "--request-rate-range", "200", *_COUNT])
    assert rc == 0
    assert "Request Rate: 200.0" in capsys.readouterr().out


def test_cli_refuses_without_cuda_unless_asked_for_the_cpu(no_cuda):
    """Hermetic models, CUDA regions, the probe and the local GPU gauges
    refuse to run without CUDA (the gauges even with --device cpu)."""
    for argv in (["-m", "simple", "--hermetic"],
                 ["-m", "simple", "--shared-memory", "cuda"],
                 ["-m", "simple", "--collect-metrics",
                  "--probe-device-utilization"],
                 ["-m", "simple", "--collect-metrics", "--device", "cpu",
                  "--collect-local-gpu-metrics"]):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert "CUDA" in str(e.value) or "cpu" in str(e.value), argv


@pytest.mark.parametrize("flags", [
    ["-i", "http", "--ssl-https-ca-certificates-file", "ca.pem"],
    ["--native-loadgen"],
    ["--ssl-grpc-use-ssl"], ["--ssl-https-verify-peer", "0"],
    ["--ssl-grpc-root-certifications-file", "ca.pem"],
])
def test_cli_refuses_what_is_not_ported(flags):
    """Every option the port does not have yet exits with a message that
    names ROADMAP.md's queue; none is ignored."""
    with pytest.raises(SystemExit) as e:
        main(["-m", "simple", "--hermetic", "--device", "cpu", *flags])
    assert "is not in the port yet" in str(e.value)
    assert "ROADMAP.md" in str(e.value)


_PAIR = ["-u", "localhost:1,localhost:2"]


@pytest.mark.parametrize("flags,jax_only,port_only", [
    (_PAIR + ["--hermetic"], [], ["--device", "cpu"]),
    (_PAIR + ["--async"], [], []),
    (_PAIR + ["--service-kind", "torchserve"], [], []),
    (_PAIR + ["-i", "http", "--service-kind", "tfserve_rest"], [], []),
    (_PAIR + ["--shared-memory", "system"], [], []),
    (_PAIR, ["--shared-memory", "tpu"],
     ["--shared-memory", "cuda", "--device", "cpu"]),
    (["-u", "localhost:1,localhost:1"], [], []),
    (["-u", "localhost:1, localhost:2,localhost:1"], [], []),
    (["--churn-soak", "1"], [], []),
    (["-u", "localhost:1", "--churn-soak", "0.5"], [], []),
], ids=["hermetic", "async", "torchserve", "tfserve_rest", "shm-system",
        "shm-device", "duplicate", "duplicate-spaced", "churn-alone",
        "churn-one-url"])
def test_cli_replica_list_refusals_equal_jax(flags, jax_only, port_only):
    """Every refusal of a --url replica list and of --churn-soak exits
    with the JAX CLI's message, word for word, in the reference's order
    (device regions are ``tpu`` in JAX's and ``cuda`` in the port's; the
    port's ``--device cpu`` only lets a CUDA-implying flag reach the
    check on this CPU)."""
    messages = []
    for run, extra in ((jmain, jax_only), (main, port_only)):
        with pytest.raises(SystemExit) as e:
            run(["-m", "simple", *flags, *extra])
        messages.append(str(e.value))
    assert messages[1] == messages[0]
    assert messages[0].startswith("error: ")


def test_cli_replica_list_with_native_loadgen_is_not_ported():
    """--native-loadgen still refuses first, whatever else is given."""
    with pytest.raises(SystemExit) as e:
        main(["-m", "simple", *_PAIR, "--native-loadgen"])
    assert str(e.value).startswith("error: --native-loadgen is not in the "
                                   "port yet")


def _simple_successes(server):
    return server.engine.statistics("simple")[0]["inference_stats"][
        "success"]["count"]


@pytest.mark.parametrize("protocol", ["grpc", "http"])
def test_cli_replica_list_counts_match_each_server(protocol, tmp_path,
                                                   capsys):
    """-i grpc|http -u A,B against two port servers on the CPU: workers
    are spread round-robin over the list, the summary prints the
    per-endpoint split, and each endpoint's count of the whole run (the
    export's ``requests.per_endpoint``) is its server's success count;
    the two sum to the run's ``requests``."""
    json_path = tmp_path / "r.json"
    with Server(device="cpu", http_port=0, grpc_port=0) as a, \
            Server(device="cpu", http_port=0, grpc_port=0) as b:
        urls = [getattr(s, f"{protocol}_address") for s in (a, b)]
        rc = main(["-m", "simple", "-i", protocol, "-u", ",".join(urls),
                   "--concurrency-range", "4", *_COUNT,
                   "--json-export", str(json_path)])
        counts = {url: _simple_successes(s) for url, s in zip(urls, (a, b))}
    out = capsys.readouterr().out
    assert rc == 0
    doc = json.loads(json_path.read_text())
    (record,) = doc["results"]
    assert record["error_count"] == 0
    per = doc["requests"]["per_endpoint"]
    assert sorted(per) == sorted(urls)
    for url in urls:
        assert per[url] == {"completed": counts[url], "failed": 0}
        assert counts[url] > 0
        assert f"    endpoint {url}: " in out
        assert f"Requests at {url}: {counts[url]} completed, 0 failed" in out
    assert sum(counts.values()) == doc["requests"]["completed"]


def test_cli_churn_soak_rotates_membership_with_no_error(monkeypatch,
                                                        tmp_path):
    """--churn-soak over two port servers: the discovery loop retires
    and re-adds replicas while the load runs; the run exits 0 with no
    error and the pool saw add and retire events."""
    from client_tpu_torch import balance

    events = []

    class Recording:
        def on_membership(self, op, endpoint):
            events.append((op, endpoint))

    class ObservedPool(balance.EndpointPool):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, observer=Recording(), **kwargs)

    monkeypatch.setattr(balance, "EndpointPool", ObservedPool)
    json_path = tmp_path / "r.json"
    with Server(device="cpu", http_port=0) as a, \
            Server(device="cpu", http_port=0) as b:
        rc = main(["-m", "simple", "-i", "http", "-u",
                   f"{a.http_address},{b.http_address}",
                   "--concurrency-range", "2", "--churn-soak", "0.05",
                   "--measurement-interval", "300", "--max-trials", "3",
                   "-s", "100", "--json-export", str(json_path)])
    assert rc == 0
    doc = json.loads(json_path.read_text())
    assert all(r["error_count"] == 0 for r in doc["results"])
    assert doc["requests"]["failed"] == 0
    ops = {op for op, _ in events}
    assert {"add", "retire"} <= ops, events


@pytest.mark.parametrize("shm", ["system", "cuda"])
def test_cli_grpc_legs_with_shared_memory(cnn_models, shm, tmp_path):
    """-i grpc against an in-process Server(grpc_port=0, device="cpu"):
    inputs and outputs in system or CPU CUDA regions (the broker), metrics
    scraped with the CPU probe; the server's success count is the
    client's count of the whole run, and neither saw a failure."""
    json_path = tmp_path / "r.json"
    with Server(models=[cnn_models[0]], device="cpu", http_port=0,
                grpc_port=0, with_default_models=False) as s:
        rc = main(["-m", "cnn_classifier", "-u", s.grpc_address,
                   "--shared-memory", shm, "--device", "cpu",
                   "--output-shared-memory-size", "4000",
                   "--concurrency-range", "2", *_COUNT,
                   "--collect-metrics", "--metrics-interval", "50",
                   "--metrics-url", f"http://{s.http_address}/metrics",
                   "--probe-device-utilization",
                   "--json-export", str(json_path)])
        stats = s.engine.statistics("cnn_classifier")[0]
        assert s.engine.shm.cuda_status() == {}
        assert s.engine.shm.system_status() == {}
    assert rc == 0
    doc = json.loads(json_path.read_text())
    (record,) = doc["results"]
    assert record["error_count"] == 0
    assert doc["requests"]["failed"] == 0
    assert stats["inference_stats"]["fail"]["count"] == 0
    assert (stats["inference_stats"]["success"]["count"]
            == doc["requests"]["completed"]
            >= record["completed_requests"] > 0)
    assert "ctpu_probe_utilization_pct" in record["tpu_metrics"]


@pytest.mark.parametrize("shm", ["none", "system"])
def test_cli_http_legs_equal_jax_report_fields(cnn_models, shm, tmp_path):
    """-i http through the port's HTTP client against an in-process
    Server(device="cpu"), and the JAX CLI's -i http against the JAX
    server, on the same CNN weights: each run completes with no error and
    no failed request on either side; the port's server counts every
    request of its run (the export's ``requests``, which the port adds to
    JAX's fields); the records and CSV headers carry the same fields."""
    docs, headers, successes = [], [], []
    for run, server_cls, model, kw in (
            (main, Server, cnn_models[0], {"device": "cpu"}),
            (jmain, JaxServer, cnn_models[1], {})):
        json_path = tmp_path / f"{run.__module__}.json"
        csv_path = tmp_path / f"{run.__module__}.csv"
        argv = ["-m", "cnn_classifier", "-i", "http",
                "--shared-memory", shm, "--output-shared-memory-size",
                "4000", "--concurrency-range", "2", *_COUNT,
                "-f", str(csv_path), "--json-export", str(json_path)]
        with server_cls(models=[model], http_port=0,
                        with_default_models=False, **kw) as s:
            rc = run(["-u", s.http_address, *argv]
                     + (["--device", "cpu"] if run is main else []))
            stats = s.engine.statistics("cnn_classifier")[0]
            assert s.engine.shm.system_status() == {}
        assert rc == 0
        doc = json.loads(json_path.read_text())
        (record,) = doc["results"]
        assert record["error_count"] == 0
        assert stats["inference_stats"]["fail"]["count"] == 0
        assert (stats["inference_stats"]["success"]["count"]
                >= record["completed_requests"] > 0)
        docs.append(doc)
        headers.append(csv_path.read_text().splitlines()[0])
        successes.append(stats["inference_stats"]["success"]["count"])
    assert docs[0]["requests"]["failed"] == 0
    assert successes[0] == docs[0]["requests"]["completed"]
    assert set(docs[0]) == set(docs[1]) | {"requests"}
    assert set(docs[0]["results"][0]) == set(docs[1]["results"][0])
    assert headers[0] == headers[1]


def test_cli_speculative_and_prefix_share_report_their_columns(tmp_path,
                                                               capsys):
    """--speculative 2 --hermetic --device cpu on the language set's
    lm_streaming_batched (MAX_TOKENS 16, the prefix-share budget; prompts
    of 128 tokens half shared): the summary, CSV and JSON carry the
    speculative and prefix columns, as JAX's __main__ wires them."""
    csv_path, json_path = tmp_path / "lm.csv", tmp_path / "lm.json"
    rc = main(["-m", "lm_streaming_batched", "--hermetic",
               "--hermetic-models", "language", "--device", "cpu",
               "--speculative", "2", "--prefix-share", "0.5",
               "--shape", "TOKENS:1,128", "--concurrency-range", "2",
               "--measurement-mode", "count_windows",
               "--measurement-request-count", "2",
               "--measurement-interval", "500", "--max-trials", "3",
               "-s", "90", "-f", str(csv_path),
               "--json-export", str(json_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "speculative:" in out and "prefix cache:" in out
    header = csv_path.read_text().splitlines()[0]
    assert "Spec Acceptance %" in header and "Prefix Hit %" in header
    (record,) = json.loads(json_path.read_text())["results"]
    spec, prefix = record["lm_spec"], record["lm_prefix"]
    assert 0 <= spec["accepted"] <= spec["proposed"] and spec["proposed"] > 0
    assert 0.0 <= spec["spec_acceptance_pct"] <= 100.0
    assert spec["lm_tokens"] > 0 and prefix["hits"] > 0
    assert prefix["saved_tokens"] > 0


def test_cli_speculative_counts_equal_jax(lm_runners, monkeypatch, capsys):
    """--speculative 2 --hermetic at concurrency 1 on the carried float32
    weights, through both CLIs (client_tpu/perf/__main__.py:744-780):
    every request is the one prompt (one stream), so each engine's
    proposed, accepted and LM-token counters over its whole run, per
    successful request, are equal exactly; each CLI's speculative column
    lies in [0, 100]."""
    engines = []
    for i, (serve_mod, models_mod) in enumerate(((tserve, tmodels),
                                                 (jserve, jmodels))):
        class _Kept(serve_mod.InferenceEngine):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                engines.append(self)

        def _sets(names, device=None, speculative=None, _i=i):
            return [_lm_batched(lm_runners, _i, speculative=speculative)]

        monkeypatch.setattr(serve_mod, "InferenceEngine", _Kept)
        monkeypatch.setattr(models_mod, "model_sets", _sets)
    argv = ["-m", "lm_streaming_batched", "--hermetic",
            "--hermetic-models", "language", "--speculative", "2",
            "--prefix-share", "0", "--prefix-prompts", "1",
            "--shape", "TOKENS:1,16", "--concurrency-range", "1",
            "--measurement-mode", "count_windows",
            "--measurement-request-count", "2",
            "--measurement-interval", "500", "--max-trials", "3", "-s", "90"]
    assert main(argv + ["--device", "cpu"]) == 0
    assert jmain(argv) == 0
    out = capsys.readouterr().out
    assert out.count("speculative:") == 2
    per_request = []
    for engine in engines:
        (stats,) = [m for m in engine.statistics()
                    if m["name"] == "lm_streaming_batched"]
        n = stats["inference_stats"]["success"]["count"]
        assert n > 0
        totals = [int(engine.metrics.get(name) or 0) for name in (
            "ctpu_lm_spec_proposed_tokens_total",
            "ctpu_lm_spec_accepted_tokens_total", "ctpu_lm_tokens_total")]
        assert all(t % n == 0 for t in totals), (totals, n)
        per_request.append([t // n for t in totals])
    assert per_request[0] == per_request[1]
    assert per_request[0][0] > 0 and per_request[0][2] == 16


def test_cli_speculative_needs_hermetic():
    """client_tpu/perf/__main__.py's --speculative checks, word for word."""
    with pytest.raises(SystemExit, match="add --hermetic"):
        main(["-m", "lm_streaming_batched", "--speculative", "2"])
    with pytest.raises(SystemExit, match=">= 1"):
        main(["-m", "lm_streaming_batched", "--hermetic", "--device", "cpu",
              "--speculative", "0"])

