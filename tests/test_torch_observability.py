"""The port's operational surface held against the JAX server's.

The same request sequence goes over HTTP to a JAX server
(client_tpu.serve.Server) and to a port server
(client_tpu_torch.serve.Server), each with a response cache, coalescing,
tenant QoS and an armed SLO objective, over the same three models (a
unary identity, a dynamically batched doubler, a decoupled stream):

- ``/metrics`` has the same set of (family, TYPE) pairs in both, apart
  from the device-memory rename (``ctpu_tpu_memory_*`` there,
  ``ctpu_gpu_memory_*`` here: neither appears on a CPU server) and the
  client-side resilience series only the JAX package has; every family
  has HELP and TYPE and is contiguous (mirrors
  test_observability.py::TestMetricsSurface);
- ``/v2/models/stats`` has the same JSON keys and the same counts (every
  ``count``, ``inference_count``, ``execution_count``; not durations);
- the settings, repository and debug routes answer alike;
- shed and drain counters (TestShedAndDrainCounters), 429 and 503 with an
  integer ``Retry-After`` (JAX http_server.py:_send_error_json);
- the served LM engine's tick spans, flight recorder, profiler and the
  ``tenant_lane_share`` quota reach it through ``bind``
  (test_lm.py::test_engine_metrics_and_tick_spans, tick half;
  test_tenant_lane_quota_bounds_flood_integration).

Counts compare exactly.  No test waits longer than a blocked request's
release.
"""

import itertools
import json
import re
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import client_tpu.serve as jserve
from client_tpu.serve import frontdoor as jfd
from client_tpu.serve import slo as jslo
from client_tpu.serve.metrics import RESILIENCE
from client_tpu_torch.serve import Model, Server, TensorSpec
from client_tpu_torch.serve import frontdoor as tfd
from client_tpu_torch.serve import slo as tslo
from client_tpu_torch.serve.metrics import render_metrics
from client_tpu_torch.serve.models import language
from client_tpu_torch.serve.models import transformer as tfm

TRACEPARENT = "00-" + "5" * 32 + "-" + "6" * 16 + "-01"


def _models(pkg):
    """The same three models in each package."""
    model_cls, spec = ((jserve.Model, jserve.TensorSpec) if pkg == "jax"
                       else (Model, TensorSpec))

    def ident(inputs, params, ctx):
        return {"OUT": np.asarray(inputs["IN"])}

    def double(inputs, params, ctx):
        return {"OUT": np.asarray(inputs["IN"]) * 2}

    def stream(inputs, params, ctx):
        yield {"OUT": np.asarray(inputs["IN"]) + 1}

    return [
        model_cls("ident", inputs=[spec("IN", "FP32", [-1])],
                  outputs=[spec("OUT", "FP32", [-1])], fn=ident),
        model_cls("batched", inputs=[spec("IN", "FP32", [4])],
                  outputs=[spec("OUT", "FP32", [4])], fn=double,
                  max_batch_size=8, dynamic_batching=True),
        model_cls("stream", inputs=[spec("IN", "FP32", [-1])],
                  outputs=[spec("OUT", "FP32", [-1])], fn=stream,
                  decoupled=True),
    ]


def _server(pkg, **kw):
    if pkg == "jax":
        return jserve.Server(
            models=_models("jax"), with_default_models=False,
            response_cache=jfd.ResponseCache(), coalescing=True,
            qos=jfd.TenantQoS(default_max_inflight=4),
            slo=jslo.SloWatchdog(objectives={"*": {"p99_ms": 1e-3}},
                                 min_samples=1, check_every=1), **kw)
    return Server(
        models=_models("torch"), with_default_models=False,
        response_cache=tfd.ResponseCache(),
        coalescing=True, qos=tfd.TenantQoS(default_max_inflight=4),
        slo=tslo.SloWatchdog(objectives={"*": {"p99_ms": 1e-3}},
                             min_samples=1, check_every=1), **kw)


def _http(addr, path, body=None, headers=None):
    """(status, body bytes, headers), errors included."""
    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(f"http://{addr}{path}", data=data,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _infer_body(values, shape=None):
    x = np.asarray(values, np.float32)
    return {"inputs": [{"name": "IN", "shape": list(shape or x.shape),
                        "datatype": "FP32", "data": x.ravel().tolist()}]}


def _drive(addr):
    """The request sequence both servers answer; returns the statuses."""
    statuses = []

    def go(path, body=None, headers=None):
        statuses.append(_http(addr, path, body, headers)[0])

    go("/v2/trace/setting", {"trace_level": ["TIMESTAMPS"],
                             "trace_rate": "1"})
    for tenant, value in (("a", 1.0), ("a", 1.0), ("b", 2.0), ("", 1.0)):
        go("/v2/models/ident/infer", _infer_body([value, 3.0]),
           {"x-tenant-id": tenant, "traceparent": TRACEPARENT})
    for i in range(4):
        go("/v2/models/batched/infer", _infer_body([[i, 1, 2, 3]]),
           {"x-tenant-id": "b"})
    for i in range(2):
        go("/v2/models/stream/infer", _infer_body([float(i)]),
           {"x-tenant-id": "a"})
    go("/v2/models/ident/infer", {"inputs": []})  # missing input: 400
    go("/v2/models/nope/infer", _infer_body([1.0]))  # unknown model: 400
    return statuses


_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _parse(text):
    """{family: {"help", "type", "samples": [(name, labels, value)]}} and
    the order of families over the sample lines."""
    meta, order = {}, []
    for line in text.splitlines():
        if line.startswith("# HELP "):
            name, help_ = line[7:].split(" ", 1)
            meta.setdefault(name, {"samples": []})["help"] = help_
        elif line.startswith("# TYPE "):
            name, type_ = line[7:].split(" ", 1)
            meta.setdefault(name, {"samples": []})["type"] = type_
        elif line.strip():
            name_part, _, value = line.rpartition(" ")
            name = name_part.split("{")[0]
            family = name
            for suffix in ("_bucket", "_sum", "_count"):
                if name.endswith(suffix) and name[:-len(suffix)] in meta:
                    family = name[:-len(suffix)]
            labels = dict(_LABEL_RE.findall(name_part))
            meta[family]["samples"].append((name, labels, float(value)))
            order.append(family)
    return meta, order


def _families(text, exclude=()):
    meta, _ = _parse(text)
    return {(name, info["type"]) for name, info in meta.items()
            if name not in exclude
            and not name.startswith(("ctpu_tpu_memory_", "ctpu_gpu_memory_"))}


def _counts(stats):
    """Every key path of a statistics answer, with the value where it is
    a count."""
    out = {}

    def walk(obj, path):
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(v, path + (k,))
        elif path[-1] in ("count", "inference_count", "execution_count",
                          "name", "version"):
            out[path] = obj
        else:
            out[path] = type(obj).__name__

    for entry in stats:
        walk(entry, (entry["name"],))
    return out


@pytest.fixture(scope="module")
def served():
    """Both servers after the same request sequence: {pkg: (server,
    statuses, /metrics text, stats)}."""
    out = {}
    servers = {pkg: _server(pkg).start() for pkg in ("jax", "torch")}
    try:
        for pkg, server in servers.items():
            statuses = _drive(server.http_address)
            server.engine.slo.check_now()
            server.engine.prof.report()  # flushes every profiler's series
            _, text, _ = _http(server.http_address, "/metrics")
            _, stats, _ = _http(server.http_address, "/v2/models/stats")
            out[pkg] = (server, statuses, text.decode(),
                        json.loads(stats)["model_stats"])
        yield out
    finally:
        for server in servers.values():
            server.stop()


def test_same_answers_to_the_sequence(served):
    assert served["torch"][1] == served["jax"][1]
    assert served["torch"][1].count(200) == 11


def test_metrics_family_set_equals_jax(served):
    """TestMetricsSurface: the same (family, TYPE) pairs in both scrapes
    (apart from the memory rename and the JAX client-side series)."""
    client_side = set(RESILIENCE._families)
    got = _families(served["torch"][2])
    want = _families(served["jax"][2], exclude=client_side)
    assert got == want
    names = {name for name, _ in got}
    for prefix in ("ctpu_slo_", "ctpu_prof_", "ctpu_cache_",
                   "ctpu_tenant_", "ctpu_request_duration_us"):
        assert any(n.startswith(prefix) for n in names), prefix


def test_every_family_has_help_type_and_is_contiguous(served):
    meta, order = _parse(served["torch"][2])
    for name, info in meta.items():
        assert info.get("help") and info.get("type"), name
    runs = [k for k, _ in itertools.groupby(order)]
    assert len(runs) == len(set(runs)), runs


def test_statistics_keys_and_counts_equal_jax(served):
    got, want = served["torch"][3], served["jax"][3]
    assert _counts(got) == _counts(want)
    by = {e["name"]: e for e in got}
    # the default tenant's request repeats tenant a's: a hit as well
    assert by["ident"]["inference_stats"]["cache_hit"]["count"] == 2
    assert by["ident"]["inference_stats"]["fail"]["count"] == 1
    assert by["batched"]["execution_count"] == 4
    assert by["stream"]["inference_stats"]["success"]["count"] == 2


def test_metric_values_equal_jax(served):
    """The per-model request counters, the tenant counters and the SLO
    breach counts carry the same values."""
    def values(text, family):
        meta, _ = _parse(text)
        return sorted((tuple(sorted(labels.items())), v)
                      for _, labels, v in meta[family]["samples"])

    for family in ("ctpu_inference_request_success",
                   "ctpu_inference_request_failure", "ctpu_inference_count",
                   "ctpu_inference_exec_count", "ctpu_tenant_requests_total",
                   "ctpu_cache_hits_total", "ctpu_slo_breaches_total",
                   "ctpu_draining", "ctpu_inflight_requests"):
        assert values(served["torch"][2], family) == \
            values(served["jax"][2], family), family


def test_traced_requests_join_the_client_trace(served):
    tracer = served["torch"][0].engine.tracer
    spans = [t for t in tracer.completed
             if t.model_name == "ident" and t.trace_id == "5" * 32]
    assert len(spans) == 4
    assert {t.trace_id for t in spans} == {"5" * 32}
    assert {t.parent_span_id for t in spans} == {"6" * 16}
    assert {t.tenant for t in spans} == {"a", "b", ""}
    names = [e["name"] for e in spans[0].timestamps]
    assert names[0] == "REQUEST_START" and names[-1] == "RESPONSE_SENT"
    hit = [e["name"] for e in spans[1].timestamps]
    assert "CACHE_HIT" in hit
    batched = [t for t in tracer.completed if t.model_name == "batched"]
    assert all({"QUEUE_END", "COMPUTE_START", "COMPUTE_END"} <=
               {e["name"] for e in t.timestamps} for t in batched)


def test_debug_endpoints(served, tmp_path):
    server = served["torch"][0]
    addr = server.http_address
    status, body, headers = _http(addr, "/v2/debug/flight")
    assert status == 200 and headers["Content-Type"] == "application/jsonl"
    records = [json.loads(line) for line in body.decode().splitlines()]
    kinds = {r["kind"] for r in records}
    assert records[0]["kind"] == "flight_dump"
    assert {"span", "slo_breach", "prof_tick"} <= kinds
    server.engine.flight.dump_dir = str(tmp_path)
    _, body, _ = _http(addr, "/v2/debug/flight?dump=1")
    dumped = json.loads(body)["dumped"]
    assert dumped and dumped.startswith(str(tmp_path))
    _, body, _ = _http(addr, "/v2/debug/prof?window=0")
    engines = {e["engine"]: e for e in json.loads(body)["engines"]}
    assert {"serve", "wire"} <= set(engines)
    assert engines["wire"]["kinds"]["http"] >= 11
    _, body, _ = _http(addr, "/v2/debug/slo")
    slo = json.loads(body)
    assert slo["ident|a"]["breaches"] >= 1
    jaddr = served["jax"][0].http_address
    assert set(slo) == set(json.loads(_http(jaddr, "/v2/debug/slo")[1]))


def test_settings_and_repository_routes_equal_jax():
    """GET/POST logging and trace settings (server-wide and per model),
    the repository index, unload and load with a config override answer
    with the same JSON in both servers."""
    answers = {}
    for pkg in ("jax", "torch"):
        with _server(pkg) as server:
            addr = server.http_address
            seq = [
                ("/v2/logging", None),
                ("/v2/logging", {"log_verbose_level": 1, "log_info": None}),
                ("/v2/trace/setting", None),
                ("/v2/trace/setting", {"trace_rate": 7, "trace_count": "3"}),
                ("/v2/models/ident/trace/setting", {"trace_level": "off"}),
                ("/v2/models/ident/trace/setting", None),
                ("/v2/trace/setting", {"trace_rate": "x"}),
                ("/v2/repository/index", {}),
                ("/v2/repository/models/ident/unload", {}),
                ("/v2/repository/index", {"ready": True}),
                ("/v2/models/ident/infer", _infer_body([1.0])),
                ("/v2/repository/models/ident/load", {"parameters": {
                    "config": json.dumps({"max_batch_size": 4})}}),
                ("/v2/repository/models/ident/load", {"parameters": {
                    "file:weights.bin": "AAAA"}}),
                ("/v2/models/ident/infer", _infer_body([1.0])),
            ]
            got = []
            for path, body in seq:
                status, raw, _ = _http(addr, path, body)
                got.append((status, json.loads(raw) if status == 200
                            else None))
            _, raw, _ = _http(addr, "/v2/models/ident/config")
            got.append(json.loads(raw)["max_batch_size"])
            answers[pkg] = got
    assert answers["torch"] == answers["jax"]


def _blocking_server(**kw):
    gate = threading.Event()

    def slow(inputs, params, ctx):
        gate.wait(timeout=30)
        return {"OUT": np.asarray(inputs["IN"])}

    model = Model("slow", inputs=[TensorSpec("IN", "FP32", [-1])],
                  outputs=[TensorSpec("OUT", "FP32", [-1])], fn=slow)
    return Server(models=[model], with_default_models=False,
                  **kw).start(), gate


def _hold(addr, headers, n):
    """Start n requests that block in the model; return their threads."""
    threads = [threading.Thread(
        target=_http, args=(addr, "/v2/models/slow/infer",
                            _infer_body([float(i)]), headers), daemon=True)
        for i in range(n)]
    for t in threads:
        t.start()
    return threads


def _wait_inflight(engine, n):
    deadline = time.monotonic() + 30
    while engine.inflight_count() < n and time.monotonic() < deadline:
        time.sleep(0.002)
    assert engine.inflight_count() == n


def test_tenant_over_its_cap_gets_429_with_retry_after():
    server, gate = _blocking_server(qos=tfd.TenantQoS(default_max_inflight=2))
    try:
        threads = _hold(server.http_address, {"x-tenant-id": "lo"}, 2)
        _wait_inflight(server.engine, 2)
        status, body, headers = _http(
            server.http_address, "/v2/models/slow/infer", _infer_body([9.0]),
            {"x-tenant-id": "lo"})
        assert status == 429 and "in-flight cap" in json.loads(body)["error"]
        assert int(headers["Retry-After"]) >= 1
        gate.set()
        for t in threads:
            t.join(timeout=30)
        text = render_metrics(server.engine)
        assert 'ctpu_tenant_shed_total{reason="inflight",tenant="lo"} 1' \
            in text
    finally:
        gate.set()
        server.stop()


def test_overload_shed_counter_and_retry_after():
    """TestShedAndDrainCounters.test_overload_shed_counter."""
    server, gate = _blocking_server(max_inflight=0)
    gate.set()
    try:
        status, _, headers = _http(server.http_address,
                                   "/v2/models/slow/infer", _infer_body([1.]))
        assert status == 503 and headers["Retry-After"] == "1"
        meta, _ = _parse(render_metrics(server.engine))
        assert any(labels.get("reason") == "overload" and v >= 1
                   for _, labels, v in meta["ctpu_requests_shed_total"][
                       "samples"])
    finally:
        server.stop()


def test_drain_waits_for_inflight_then_refuses_with_retry_after():
    """TestShedAndDrainCounters.test_drain_flips_gauge_and_counts, with a
    request in flight while the drain starts."""
    server, gate = _blocking_server()
    try:
        threads = _hold(server.http_address, {}, 1)
        _wait_inflight(server.engine, 1)
        assert not server.engine.drain(timeout_s=0.01)  # still in flight
        assert _http(server.http_address, "/v2/health/ready")[0] == 503
        status, _, headers = _http(server.http_address,
                                   "/v2/models/slow/infer", _infer_body([1.]))
        assert status == 503 and headers["Retry-After"] == "1"
        gate.set()
        for t in threads:
            t.join(timeout=30)
        assert server.engine.drain(timeout_s=5.0)
        meta, _ = _parse(render_metrics(server.engine))
        assert meta["ctpu_draining"]["samples"][0][2] == 1
        assert meta["ctpu_drain_total"]["samples"][0][2] == 2
    finally:
        gate.set()
        server.stop()


def test_cpu_scrape_does_not_initialize_cuda(served):
    assert "ctpu_gpu_memory" not in served["torch"][2]
    assert not torch.cuda.is_initialized()


# -- the served LM engine's hooks through bind ----------------------------------

_TINY = tfm.TransformerConfig(
    vocab_size=258, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq=64, dtype="float32",
)


def test_engine_hooks_and_lane_quota_reach_the_engine_through_bind():
    """The tick half of test_engine_metrics_and_tick_spans and
    test_tenant_lane_quota_bounds_flood_integration, through the served
    model: tenant "a" floods 4 long streams on a 2-lane engine, "b" sends
    one short one, and with lane_share 0.5 from the server's TenantQoS
    (and the x-tenant-id identity reaching the engine as __tenant__) b
    finishes before a's flood drains."""
    runner = language._LmRunner(cfg=_TINY, device="cpu")
    model = language.lm_streaming_batched_model(
        runner=runner, max_slots=2, lane_counts=(2,), block_size=8,
        prefill_chunk=16, min_bucket=4)
    with Server(models=[model], with_default_models=False,
                qos=tfd.TenantQoS(default_lane_share=0.5)) as server:
        engine = server.engine
        sched = model.closer.__self__
        assert sched.tracer is engine.tracer
        assert sched.flight is engine.flight
        assert sched.prof in engine.prof._children
        assert sched.tenant_lane_share("a") == 0.5
        engine.update_trace_settings({"trace_level": ["TIMESTAMPS"],
                                      "trace_rate": "1"})
        done, streams = {}, {}

        def stream(name, tenant, prompt, n):
            req = {"inputs": [
                {"name": "TOKENS", "shape": [len(prompt)],
                 "datatype": "INT32", "data": prompt},
                {"name": "MAX_TOKENS", "shape": [1], "datatype": "INT32",
                 "data": [n]}]}
            got = [r[0]["outputs"][0]["data"][0] for r in engine.execute(
                "lm_streaming_batched", "", req, b"", tenant=tenant)]
            done[name] = time.monotonic()
            streams[name] = (got, prompt, n)

        threads = [threading.Thread(target=stream,
                                    args=(f"a{i}", "a", [i + 1, i + 2], 40))
                   for i in range(4)]
        for t in threads:
            t.start()
        while sched.pressure()["inflight"] < 2:  # a holds both lanes
            time.sleep(0.001)
        threads.append(threading.Thread(target=stream,
                                        args=("b", "b", [9, 9], 5)))
        threads[-1].start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        assert done["b"] < max(v for k, v in done.items() if k != "b")
        assert len(streams) == 5
        for got, prompt, n in streams.values():  # float32: the serial tokens
            assert got == list(runner.stream(prompt, n))
        kinds = {t.model_name for t in engine.tracer.tick_completed}
        assert {"__lm_decode__", "__lm_prefill_chunk__"} <= kinds
        assert not any(t.model_name.startswith("__lm_")
                       for t in engine.tracer.completed)
        ring = engine.flight.snapshot()
        assert any(r["kind"] == "span"
                   and r["span"]["model_name"] == "__lm_decode__"
                   for r in ring)
        report = engine.prof.report(window_s=0)
        lm = next(e for e in report["engines"] if e["engine"] == "lm")
        assert lm["kinds"].get("sched", 0) > 0
        assert engine.inflight_count() == 0
