"""The port's postmortem tools, client_tpu_torch.traceview and
client_tpu_torch.profview, held against client_tpu.traceview and
client_tpu.profview.

- The same files go through both packages' ``main``: trace files written
  by each package's server and client tracers over a few traced HTTP
  requests, plus a hand-written file with peer, scheduler-tick, error and
  tagged spans; the prof report (``/v2/debug/prof``) and the flight dump
  (``/v2/debug/flight``) of each package's server, plus a profiler
  report with an adopted child engine.  The text, the ``--format json``
  lines and the exit codes are equal, for each of the tools' options:
  exact, this is formatting.
- ``python -m client_tpu_torch.profview --live --device cpu`` renders the
  cnn report with the reference's keys, tick kinds, phases and model;
  without CUDA and without ``--device cpu`` it refuses with exit code 2.
"""

import json
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

import client_tpu.http as jhttp
import client_tpu.serve as jserve
import client_tpu.tracing as jtracing
from client_tpu import profview as jprofview
from client_tpu import traceview as jtraceview
import client_tpu_torch.http as thttp
import client_tpu_torch.serve as tserve
import client_tpu_torch.tracing as ttracing
import client_tpu_torch.utils as tserve_utils
from client_tpu_torch import profview, traceview
from client_tpu_torch.serve.prof import PhaseProfiler

PKGS = {
    "jax": (jserve, jhttp, jtracing, {}),
    "port": (tserve, thttp, ttracing, {"device": "cpu"}),
}


def _double(inputs, params, ctx):
    return {"OUT": np.asarray(inputs["IN"]) * 2.0}


def _get(addr, path):
    with urllib.request.urlopen(f"http://{addr}{path}", timeout=30) as r:
        return r.read()


def _served_files(pkg, tmp):
    """One package's server and client, tracing every request into its
    own file, after three infers; then its prof report and flight dump."""
    serve, http, tracing, kw = PKGS[pkg]
    model = serve.Model(
        "double", inputs=[serve.TensorSpec("IN", "FP32", [-1, 4])],
        outputs=[serve.TensorSpec("OUT", "FP32", [-1, 4])], fn=_double)
    server = serve.Server(models=[model], with_default_models=False,
                          **kw).start()
    files = {kind: str(tmp / f"{pkg}-{kind}") for kind in
             ("server.jsonl", "client.jsonl", "prof.json", "flight.jsonl")}
    try:
        server.engine.update_trace_settings({
            "trace_level": ["TIMESTAMPS"], "trace_rate": "1",
            "trace_count": "-1", "trace_file": files["server.jsonl"],
        })
        tracer = tracing.ClientTracer(trace_file=files["client.jsonl"],
                                      trace_rate=1)
        client = http.InferenceServerClient(server.http_address,
                                            tracer=tracer)
        try:
            for i in range(3):
                inp = http.InferInput("IN", [1, 4], "FP32")
                inp.set_data_from_numpy(np.full((1, 4), i, np.float32))
                client.infer("double", [inp])
        finally:
            client.close()
        with open(files["prof.json"], "wb") as f:
            f.write(_get(server.http_address, "/v2/debug/prof?window=0"))
        with open(files["flight.jsonl"], "wb") as f:
            f.write(_get(server.http_address, "/v2/debug/flight"))
    finally:
        server.stop()
    return files


def _synthetic_trace(path):
    """Spans the served run does not make: a peer fetch, a scheduler
    tick, an error, tags, an endpoint, and a second trace."""
    def span(trace, span_id, source, model, events, **extra):
        return dict(trace_id=trace, span_id=span_id, source=source,
                    model_name=model, timestamps=[
                        {"name": n, "ns": ns, **e} for n, ns, e in events],
                    **extra)

    t = "a" * 32
    records = [
        span(t, "1", "client", "lm", [
            ("CLIENT_REQUEST_START", 1_000_000, {}),
            ("ATTEMPT_START", 1_100_000, {"endpoint": "10.0.0.1:8000"}),
            ("CLIENT_REQUEST_END", 9_000_000, {})], tenant="gold"),
        span(t, "2", "server", "lm", [
            ("REQUEST_START", 2_000_000, {}),
            ("QUEUE_START", 2_100_000, {}), ("QUEUE_END", 3_000_000, {}),
            ("COMPUTE_START", 3_000_000, {}),
            ("COMPUTE_END", 7_000_000, {}),
            ("RESPONSE_SENT", 7_500_000, {})],
            tags={"sequence_id": 7, "hit": True}),
        span(t, "3", "server", "__peer_prefix__", [
            ("PEER_START", 3_200_000, {}), ("PEER_END", 4_200_000, {})],
            tags={"peer": "10.0.0.2:9000", "op": "prefix", "bytes": 4096}),
        span(t, "4", "server", "__lm_tick__", [
            ("COMPUTE_START", 4_000_000, {}),
            ("COMPUTE_END", 5_000_000, {})]),
        span("b" * 32, "5", "server", "ident", [
            ("REQUEST_START", 10_000_000, {}),
            ("COMPUTE_START", 10_500_000, {}),
            ("COMPUTE_END", 11_000_000, {})], error="boom"),
        span("c" * 32, "6", "server", "empty", []),
    ]
    with open(path, "w") as f:
        for record in records:
            f.write(json.dumps(record) + "\n")
    return str(path)


def _adopted_report(path):
    """A profiler report with an adopted child engine (the served LM's
    shape: the server's profiler adopts each engine's)."""
    parent, child = PhaseProfiler(name="serve"), PhaseProfiler(name="lm")
    parent.adopt(child)
    for i in range(4):
        parent.commit("unary", 1e-3, phases={"host": 2e-4, "compute": 8e-4},
                      model="m", items=1)
        child.commit("decode", 2e-3, phases={"decode_dispatch": 1.5e-3,
                                             "device_wait": 5e-4})
    path.write_text(json.dumps(parent.report(window_s=0)))
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("postmortem")
    out = {pkg: _served_files(pkg, tmp) for pkg in PKGS}
    out["synthetic"] = {"trace.jsonl": _synthetic_trace(tmp / "syn.jsonl"),
                        "prof.json": _adopted_report(tmp / "adopted.json")}
    return out


def _run(main, argv, capsys):
    rc = main(list(argv))
    captured = capsys.readouterr()
    return rc, captured.out, captured.err


def _both(tool, argv, capsys):
    """(port, reference) (exit code, stdout, stderr) of one command."""
    port, ref = {"traceview": (traceview, jtraceview),
                 "profview": (profview, jprofview)}[tool]
    return _run(port.main, argv, capsys), _run(ref.main, argv, capsys)


def _trace_files(files, source):
    if source == "synthetic":
        return [files["synthetic"]["trace.jsonl"]]
    return [files[source]["client.jsonl"], files[source]["server.jsonl"]]


@pytest.mark.parametrize("source", ["jax", "port", "synthetic"])
@pytest.mark.parametrize("options", [[], ["--format", "json"],
                                     ["--min-spans", "2"],
                                     ["--trace", "a"], ["--trace", "f"]])
def test_traceview_equals_jax(files, source, options, capsys):
    paths = _trace_files(files, source)
    port, ref = _both("traceview", options + paths, capsys)
    assert port == ref
    if options[:1] != ["--trace"]:
        assert port[0] == 0 and port[1]


def test_traceview_joins_client_and_server_of_each_request(files, capsys):
    """Each traced request of the served run is one trace of a client and
    a server span, its queue, compute and wire parts inside the client's
    duration."""
    for source in ("jax", "port"):
        rc, out, _ = _run(traceview.main, ["--format", "json"]
                          + _trace_files(files, source), capsys)
        docs = [json.loads(line) for line in out.splitlines()]
        assert rc == 0 and len(docs) == 3
        for doc in docs:
            assert doc["sources"] == ["client", "server"]
            cp = doc["critical_path"]
            assert cp["total_ms"] > 0
            assert (cp["queue_ms"] + cp["compute_ms"] + cp["wire_ms"]
                    <= cp["total_ms"] + 1e-6)


def test_traceview_unreadable_input_equals_jax(tmp_path, capsys):
    bad = tmp_path / "bad.jsonl"
    bad.write_text("{not json\n")
    for argv in ([str(tmp_path / "missing.jsonl")], [str(bad)]):
        port, ref = _both("traceview", argv, capsys)
        assert port[0] == ref[0] == 2


@pytest.mark.parametrize("source, name", [
    ("jax", "prof.json"), ("port", "prof.json"), ("jax", "flight.jsonl"),
    ("port", "flight.jsonl"), ("synthetic", "prof.json")])
@pytest.mark.parametrize("options", [[], ["--format", "json"],
                                     ["--engine", "lm"],
                                     ["--engine", "nothing"]])
def test_profview_equals_jax(files, source, name, options, capsys):
    port, ref = _both("profview", options + [files[source][name]], capsys)
    assert port == ref
    # only the adopted report has an ``lm`` engine; nothing has ``nothing``
    unmatched = options[:1] == ["--engine"] and (
        options[1] == "nothing" or source != "synthetic")
    assert port[0] == (1 if unmatched else 0) and (unmatched or port[1])


def test_profview_exit_codes_equal_jax(tmp_path, capsys):
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps(PhaseProfiler(name="quiet").report(
        window_s=0)))
    for argv in ([str(tmp_path / "missing.json")], [str(empty)]):
        port, ref = _both("profview", argv, capsys)
        assert port == ref
    assert port[0] == 1 and "no prof data found" in port[2]


def _shape(rollup):
    """The keys, kinds, phases and models of one engine rollup, and the
    type of each value."""
    return {
        "keys": {k: type(v).__name__ for k, v in rollup.items()},
        "kinds": sorted(rollup["kinds"]),
        "phases": sorted(rollup["phases"]),
        "models": {m: sorted(row) for m, row in rollup["models"].items()},
        "attribution": sorted(rollup["attribution"] or ()),
    }


def test_profview_live_cpu_has_jax_keys_and_kinds(capsys):
    """``profview --live --device cpu``: the port's cnn report, rendered
    by its own main, against the reference's ``live_report`` (on its CPU
    backend): the same engines, keys, tick kinds, phases and model row,
    with every one of its 64 requests a tick."""
    rc, out, err = _run(profview.main, ["--live", "--device", "cpu",
                                        "--format", "json"], capsys)
    assert rc == 0, err
    mine = [json.loads(line) for line in out.splitlines()]
    ref = [e for e in jprofview.live_report()["engines"] if e.get("ticks")]
    assert [e["engine"] for e in mine] == [e["engine"] for e in ref]
    assert [_shape(e) for e in mine] == [_shape(e) for e in ref]
    assert mine[0]["ticks"] == ref[0]["ticks"] == 64
    assert mine[0]["models"]["cnn_classifier"]["items"] == 64
    assert mine[0]["models"]["cnn_classifier"]["compute_share_pct"] > 0
    rc, out, _ = _run(profview.main, ["--live", "--device", "cpu"], capsys)
    assert rc == 0 and "engine serve" in out and "model cnn_classifier" in out


def test_profview_live_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run(profview.main, ["--live"], capsys)
    assert rc == 2 and not out
    assert "pass device='cpu'" in err
    with pytest.raises(SystemExit):
        profview.main(["--device", "cpu", "some.json"])


def test_profview_module_runs_as_a_program():
    """``python -m client_tpu_torch.profview --live --device cpu`` exits 0
    (the batcher's completion workers are joined at close: none is left
    alive to abort the interpreter's exit)."""
    proc = subprocess.run(
        [sys.executable, "-m", "client_tpu_torch.profview", "--live",
         "--device", "cpu"], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "engine serve" in proc.stdout


def test_each_reader_reads_both_packages_files(files):
    """Both packages' trace readers read each package's files alike (one
    format)."""
    for source in ("jax", "port"):
        paths = _trace_files(files, source)
        assert (traceview.load_records(paths)
                == jtraceview.load_records(paths))


def test_batcher_close_joins_its_completion_workers():
    """Found by ``profview --live``: the dynamic batcher's host-group
    completion workers outlived ``InferenceEngine.close()`` (the
    reference's do too, client_tpu/serve/dynamic_batcher.py ``close``),
    and a worker that ran torch ops still alive at interpreter exit
    aborted the process.  close() now joins them."""
    import threading

    from client_tpu_torch.serve.model_runtime import InferenceEngine
    from client_tpu_torch.serve.models.vision import cnn_classifier_model

    engine = InferenceEngine(models=[cnn_classifier_model(
        image_size=32, device="cpu")])
    arr = np.zeros((1, 3, 32, 32), np.float32)
    raw = tserve_utils.to_wire_bytes(arr, "FP32")
    request = {"id": "", "inputs": [{
        "name": "INPUT0", "datatype": "FP32", "shape": list(arr.shape),
        "parameters": {"binary_data_size": len(raw)}}]}
    for _ in range(8):
        engine.execute("cnn_classifier", "", dict(request), raw)
    assert any(t.name == "batcher-cnn_classifier-done"
               for t in threading.enumerate())
    engine.close()
    assert not [t for t in threading.enumerate()
                if t.name == "batcher-cnn_classifier-done"]
