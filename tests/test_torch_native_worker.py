"""The port's native load path (client_tpu_torch.perf.native_worker and the
CLI's --native-loadgen) held against the JAX package's
(client_tpu.perf.native_worker, client_tpu/perf/__main__.py), on the CPU.

- ``native_windows_stable`` decides as JAX's on hypothesis-drawn windows
  (exact: the same arithmetic).
- ``run_native_worker`` runs the same command line as JAX's for the same
  arguments (a stub binary that echoes its argv; exact), and fails alike.
- The port's worker, built once for this file by
  ``native_worker.build_native_worker`` (g++ alone: the unedited
  ``src/cpp/perf/perf_worker.cc`` over the port's protobuf-free client in
  ``client_tpu_torch/perf/csrc``) into ``build/torch_cpp`` (the module
  fixture), links no libprotobuf (``ldd``) and runs no ``protoc`` (a
  build from scratch with a recording ``protoc`` first on ``PATH``).
- The reference worker, built by the Makefile from ``src/cpp`` with
  protoc and libprotobuf (the ``reference_binary`` fixture, into
  ``build/torch_ref_cpp``), and the port's send equal first requests
  (each parsed into a ``ModelInferRequest``) for the same arguments, to a
  grpcio generic handler that keeps the raw bytes: wire inputs, shm
  inputs and outputs, a decoupled stream, a sequence stream.
- The port's worker drives the port's CPU server in every mode of
  tests/test_cpp_client.py:166-300 (the JAX tests, which skip while
  ``build/cpp`` is not built) and decoupled against
  ``lm_streaming_int8``: no error, its windowed count at most the
  server's successes.
- ``--native-loadgen`` from the wire and from system regions: the port's
  CLI (its own worker) against the port's server and the JAX CLI (its
  ``_DEFAULT_BINARY`` pointed at the reference worker) against the JAX
  server print the same levels in the same line format, with 0 errors
  and no server failure.
- Every refusal of JAX's CLI, word for word (device regions are ``cuda``
  in the port's wire-mode message where JAX's are ``tpu``), and a failed
  build that raises and registers nothing.

The file is one unit under ``--dist loadfile``: each build runs once.
"""

import json
import os
import re
import stat
import subprocess
import sys
import threading

import grpc
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from client_tpu.perf import native_worker as jnative
from client_tpu.perf.__main__ import main as jmain
from client_tpu.serve import Server as JaxServer
from client_tpu.utils import InferenceServerException as JaxError
from client_tpu_torch._proto import inference_pb2 as pb
from client_tpu_torch.perf import native_worker as native
from client_tpu_torch.perf.__main__ import main
from client_tpu_torch.serve import Server
from client_tpu_torch.serve.models import language
from client_tpu_torch.utils import InferenceServerException

SIMPLE = [("INPUT0", "INT32", [1, 16]), ("INPUT1", "INT32", [1, 16])]


@pytest.fixture(scope="module")
def binary():
    return native.build_native_worker()


_REF_BUILD = "build/torch_ref_cpp"


@pytest.fixture(scope="module")
def reference_binary():
    """The JAX package's worker as the Makefile builds it: protoc's KServe
    messages and libprotobuf (its own build directories, so build/cpp
    stays the JAX tests' own)."""
    proc = subprocess.run(
        ["make", f"CPP_BUILD={_REF_BUILD}",
         "PB_CPP=build/torch_ref_proto_cpp", f"{_REF_BUILD}/perf_worker",
         f"-j{min(os.cpu_count() or 1, 4)}"],
        cwd=native._ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return os.path.join(native._ROOT, _REF_BUILD, "perf_worker")


def _ldd(path):
    return subprocess.run(["ldd", path], capture_output=True, text=True,
                          check=True).stdout


@pytest.fixture(scope="module")
def port_server():
    with Server(http_port=0, grpc_port=0, device="cpu") as s:
        yield s


@pytest.fixture(scope="module")
def lm_server():
    models = language.language_models(device="cpu", int8_batched=True)
    with Server(models=models, grpc_port=0, device="cpu",
                with_default_models=False) as s:
        yield s


@pytest.fixture(scope="module")
def jax_server():
    with JaxServer(http_port=0, grpc_port=0) as s:
        yield s


def _counts(server, model):
    stats = server.engine.statistics(model)[0]["inference_stats"]
    return stats["success"]["count"], stats["fail"]["count"]


# -- native_windows_stable --------------------------------------------------

_window = st.fixed_dictionaries({
    "throughput": st.floats(0, 1e4, allow_nan=False),
    "p99_us": st.floats(0, 1e6, allow_nan=False),
})


@settings(max_examples=300, deadline=None)
@given(windows=st.lists(_window, max_size=7),
       threshold=st.sampled_from([0.0, 0.05, 0.1, 0.5]),
       count=st.integers(1, 4))
def test_windows_stable_decides_as_jax(windows, threshold, count):
    assert (native.native_windows_stable(windows, threshold, count)
            == jnative.native_windows_stable(windows, threshold, count))


# -- run_native_worker's command line ---------------------------------------

_ECHO = """#!{python}
import json, sys
print(json.dumps({{"window": 0, "ok": 1, "errors": 0, "throughput": 2.0,
                  "p50_us": 1.0, "p99_us": 1.0}}))
print("not json")
print(json.dumps({{"ok": 1, "errors": 0, "argv": sys.argv[1:]}}))
"""


def _stub(tmp_path, text):
    path = tmp_path / "perf_worker_stub"
    path.write_text(text.format(python=sys.executable))
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


@pytest.mark.parametrize("kw", [
    dict(concurrency=8, duration_s=1.5, warmup_s=0.3, wire_inputs=SIMPLE),
    dict(concurrency=8, duration_s=2.0, request_rate=100.0,
         distribution="poisson", wire_inputs=SIMPLE),
    dict(concurrency=4, duration_s=2.0, window_interval_s=0.5,
         completion_sync=True,
         shm_inputs=[("INPUT0", "FP32", [1, 3, 32, 32], "r_in", 12288)],
         shm_outputs=[("OUTPUT0", "r_out", 4000)]),
    dict(concurrency=1, duration_s=2.0, sequences=4, seq_steps=5,
         wire_inputs=[("INPUT", "INT32", [1])]),
    dict(concurrency=4, duration_s=2.0, decoupled=True,
         wire_inputs=[("TOKENS", "INT32", [64], 7),
                      ("MAX_TOKENS", "INT32", [1], 16)]),
], ids=["concurrency", "rate", "shm-windows-sync", "sequences",
        "decoupled"])
def test_command_line_and_report_equal_jax(tmp_path, kw):
    stub = _stub(tmp_path, _ECHO)
    got = native.run_native_worker("h:1", "m", binary=stub, **kw)
    want = jnative.run_native_worker("h:1", "m", binary=stub, **kw)
    assert got == want
    assert got["argv"][:4] == ["-u", "h:1", "-m", "m"]
    assert got["windows"][0]["window"] == 0


@pytest.mark.parametrize("text,match", [
    ("#!/bin/sh\necho boom >&2\nexit 3\n", "failed \\(3\\): boom"),
    ("#!/bin/sh\necho nope\n", "malformed native worker report"),
])
def test_worker_failures_raise_as_in_jax(tmp_path, text, match):
    stub = _stub(tmp_path, text)
    with pytest.raises(InferenceServerException, match=match):
        native.run_native_worker("h:1", "m", binary=stub, concurrency=1,
                                 duration_s=0.1, wire_inputs=SIMPLE)
    with pytest.raises(JaxError, match=match):
        jnative.run_native_worker("h:1", "m", binary=stub, concurrency=1,
                                  duration_s=0.1, wire_inputs=SIMPLE)


def test_a_failed_build_raises_and_registers_nothing(monkeypatch, port_server,
                                                     capsys):
    """No fallback to the Python engine: the compiler's failure raises
    with its output, and the CLI exits 2 with it before any region is
    registered."""
    monkeypatch.setattr(native, "CXXFLAGS",
                        [*native.CXXFLAGS, "-fno-such-option"])
    with pytest.raises(InferenceServerException,
                       match="(?s)building the native perf worker failed.*"
                             "no-such-option"):
        native.build_native_worker()
    before = _counts(port_server, "simple")
    rc = main(["-m", "simple", "-u", port_server.grpc_address,
               "--native-loadgen", "--shared-memory", "system",
               "--output-shared-memory-size", "64"])
    assert rc == 2
    assert "building the native perf worker failed" in capsys.readouterr().err
    assert _counts(port_server, "simple") == before
    assert not port_server.engine.shm.system_status()


# -- the port's worker beside the reference's ---------------------------------

def test_port_worker_links_no_protobuf_and_runs_no_protoc(binary, tmp_path,
                                                          monkeypatch):
    """The worker builds from scratch with g++ alone: a ``protoc`` first
    on PATH that records its calls is never called, no command names
    protoc or protobuf, and neither that binary nor the module's links
    libprotobuf (the reference's does)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    calls = tmp_path / "protoc_calls"
    protoc = bin_dir / "protoc"
    protoc.write_text(f"#!/bin/sh\necho \"$@\" >> {calls}\nexit 1\n")
    protoc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    fresh = native.build_native("perf_worker", native.WORKER_SOURCES,
                                build_dir=str(tmp_path / "build"))
    commands = native.last_build["commands"]
    assert len(commands) == len(native.WORKER_SOURCES) + 1
    assert all(cmd[0] == native.CXX for cmd in commands)
    assert not any("protoc" in arg or "protobuf" in arg
                   for cmd in commands for arg in cmd)
    assert not calls.exists()
    for path in (fresh, binary):
        libraries = _ldd(path)
        assert "libprotobuf" not in libraries, libraries
        assert "libstdc++" in libraries
    # the worker is the reference's own source, compiled unedited
    assert native.WORKER_SOURCES[0].endswith(
        os.path.join("src", "cpp", "perf", "perf_worker.cc"))


def test_reference_worker_links_protobuf(reference_binary):
    assert "libprotobuf" in _ldd(reference_binary)


class _FirstRequests:
    """A grpcio server whose generic handler keeps the raw bytes of every
    ModelInfer and ModelStreamInfer request: unary calls answer an empty
    response, stream requests one response carrying their id and
    ``triton_final_response`` (the decoupled marker)."""

    PREFIX = "/inference.GRPCInferenceService/"

    def __init__(self):
        self.requests = []
        self._lock = threading.Lock()
        outer = self

        class Handler(grpc.GenericRpcHandler):
            def service(self, details):
                if details.method == outer.PREFIX + "ModelInfer":
                    return grpc.unary_unary_rpc_method_handler(outer._unary)
                if details.method == outer.PREFIX + "ModelStreamInfer":
                    return grpc.stream_stream_rpc_method_handler(
                        outer._stream)
                return None

        from concurrent import futures

        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        self.server.add_generic_rpc_handlers((Handler(),))
        port = self.server.add_insecure_port("127.0.0.1:0")
        self.address = f"127.0.0.1:{port}"
        self.server.start()

    def _keep(self, raw):
        with self._lock:
            self.requests.append(raw)

    def _unary(self, raw, context):
        self._keep(raw)
        return b""

    def _stream(self, raws, context):
        for raw in raws:
            self._keep(raw)
            resp = pb.ModelInferResponse(
                id=pb.ModelInferRequest.FromString(raw).id)
            resp.parameters["triton_final_response"].bool_param = True
            yield pb.ModelStreamInferResponse(
                infer_response=resp).SerializeToString()

    def first(self):
        with self._lock:
            assert self.requests, "no request reached the handler"
            return self.requests[0]

    def stop(self):
        self.server.stop(None)


@pytest.mark.parametrize("args", [
    ["-m", "simple", "--wire-input", "INPUT0:INT32:1,16",
     "--wire-input", "INPUT1:FP32:2,3,4"],
    ["-m", "resnet50", "--shm-input", "INPUT:FP32:1,3,224,224:r_in:602112",
     "--shm-output", "OUTPUT:r_out:4000"],
    ["-m", "resnet50", "--completion-sync",
     "--shm-input", "INPUT:FP32:1,3,224,224:r_in:602112",
     "--shm-output", "OUTPUT:r_out:4000"],
    ["-m", "lm_streaming_int8", "--decoupled",
     "--wire-input", "TOKENS:INT32:64=7", "--wire-input", "MAX_TOKENS:INT32:1=16"],
    ["-m", "simple_sequence", "--sequences", "2", "--seq-steps", "3",
     "--wire-input", "INPUT:INT32:1"],
], ids=["wire", "shm", "shm-sync", "decoupled", "sequence"])
def test_first_request_equals_the_reference_workers(binary, reference_binary,
                                                    args):
    """The port's worker and the reference's, run with the same arguments
    against the same raw-bytes handler, send first requests that parse to
    equal ModelInferRequests (the random wire payloads are the worker's
    seeded ones, so raw contents compare too)."""
    firsts = []
    for path in (binary, reference_binary):
        sink = _FirstRequests()
        try:
            proc = subprocess.run(
                [path, "-u", sink.address, "-c", "1", "-d", "0.3", "-w", "0",
                 *args], capture_output=True, text=True, timeout=120)
            assert proc.returncode == 0, proc.stderr
            assert json.loads(proc.stdout.strip().splitlines()[-1])["ok"] > 0
            firsts.append(pb.ModelInferRequest.FromString(sink.first()))
        finally:
            sink.stop()
    port, reference = firsts
    assert port == reference
    assert port.model_name == args[1] and port.inputs


# -- the built worker against the port's server -----------------------------

def test_worker_concurrency(binary, port_server):
    """tests/test_cpp_client.py::test_native_perf_worker on the port."""
    before = _counts(port_server, "simple")
    report = native.run_native_worker(
        port_server.grpc_address, "simple", concurrency=8, duration_s=1.5,
        warmup_s=0.3, wire_inputs=SIMPLE)
    after = _counts(port_server, "simple")
    assert report["mode"] == "concurrency" and report["errors"] == 0
    assert 50 < report["ok"] <= after[0] - before[0]
    assert after[1] == before[1]
    assert report["throughput"] > 0
    assert 0 < report["p50_us"] <= report["p99_us"]


@pytest.mark.parametrize("distribution", ["constant", "poisson"])
def test_worker_rate_mode(binary, port_server, distribution):
    """tests/test_cpp_client.py::test_native_perf_worker_rate_mode: the
    achieved rate tracks the schedule (the JAX test's band)."""
    report = native.run_native_worker(
        port_server.grpc_address, "simple", concurrency=8, duration_s=2.0,
        warmup_s=0.3, request_rate=100.0, distribution=distribution,
        wire_inputs=SIMPLE)
    assert report["mode"] == "rate" and report["errors"] == 0
    assert "delayed" in report
    assert 60.0 < report["throughput"] < 140.0, report


def test_worker_windows(binary, port_server):
    """tests/test_cpp_client.py::test_native_perf_worker_windows."""
    report = native.run_native_worker(
        port_server.grpc_address, "simple", concurrency=4, duration_s=2.0,
        warmup_s=0.3, window_interval_s=0.5, wire_inputs=SIMPLE)
    assert report["ok"] > 0
    assert len(report.get("windows", [])) >= 2
    for w in report["windows"]:
        assert w["throughput"] > 0
        assert 0 < w["p50_us"] <= w["p99_us"]


def test_worker_sequences(binary, port_server):
    """tests/test_cpp_client.py::test_native_perf_worker_sequences."""
    before = _counts(port_server, "simple_sequence")
    report = native.run_native_worker(
        port_server.grpc_address, "simple_sequence", concurrency=1,
        duration_s=2.0, warmup_s=0.3, sequences=4, seq_steps=5,
        wire_inputs=[("INPUT", "INT32", [1])])
    after = _counts(port_server, "simple_sequence")
    assert report["mode"] == "sequence" and report["errors"] == 0
    assert 50 < report["ok"] <= after[0] - before[0]
    assert 0 < report["p50_us"] <= report["p99_us"]


def test_worker_decoupled(binary, port_server):
    """tests/test_cpp_client.py::test_native_perf_worker_decoupled: 5
    responses a request of repeat_int32 (IN=5 by constant fill)."""
    report = native.run_native_worker(
        port_server.grpc_address, "repeat_int32", concurrency=4,
        duration_s=2.0, warmup_s=0.3, decoupled=True,
        wire_inputs=[("IN", "INT32", [1], 5)])
    assert report["mode"] == "decoupled" and report["errors"] == 0
    assert report["ok"] > 20
    assert report["responses"] >= max(report["ok"] - 4, 1) * 5
    assert 0 < report["p50_us"] <= report["p99_us"]


def test_worker_decoupled_int8_lm(binary, lm_server):
    """The worker's token streams on the port's lm_streaming_int8 (the
    engine's int8 and paged path, on the CPU through the plain versions):
    MAX_TOKENS responses a stream, none failed."""
    before = _counts(lm_server, "lm_streaming_int8")
    report = native.run_native_worker(
        lm_server.grpc_address, "lm_streaming_int8", concurrency=4,
        duration_s=2.0, warmup_s=0.5, decoupled=True,
        wire_inputs=[("TOKENS", "INT32", [64], 7),
                     ("MAX_TOKENS", "INT32", [1], 8)])
    after = _counts(lm_server, "lm_streaming_int8")
    assert report["mode"] == "decoupled" and report["errors"] == 0
    assert 0 < report["ok"] <= after[0] - before[0]
    assert after[1] == before[1]
    assert report["responses"] >= max(report["ok"] - 4, 1) * 8


# -- --native-loadgen, the port's CLI beside JAX's ---------------------------

_LINE = re.compile(
    r"^Concurrency: (\d+), throughput: \d+\.\d infer/sec \(native\), "
    r"p50 \d+ usec, p99 \d+ usec, errors (\d+), (?:stable|UNSTABLE) over "
    r"\d+ windows$")
_BEST = re.compile(r"^Best: concurrency=(\d+) -> \d+\.\d infer/sec, "
                   r"avg latency \d+ usec$")


def _sweep(out):
    lines = [ln for ln in out.splitlines() if ln.strip()]
    levels = [_LINE.match(ln).groups() for ln in lines[:-1]]
    assert _BEST.match(lines[-1]), lines[-1]
    return levels


@pytest.mark.parametrize("shm", ["none", "system"])
def test_cli_sweep_equals_jax(binary, reference_binary, port_server,
                              jax_server, monkeypatch, capsys, shm):
    monkeypatch.setattr(jnative, "_DEFAULT_BINARY", reference_binary)
    flags = ["-m", "simple", "--native-loadgen", "--concurrency-range",
             "2:4:2", "--measurement-interval", "500", "--max-trials", "3",
             "--shared-memory", shm, "--output-shared-memory-size", "64"]
    sweeps = []
    for run, server in ((main, port_server), (jmain, jax_server)):
        before = _counts(server, "simple")
        assert run(flags + ["-u", server.grpc_address]) == 0
        after = _counts(server, "simple")
        assert after[0] > before[0] and after[1] == before[1]
        sweeps.append(_sweep(capsys.readouterr().out))
    assert sweeps[0] == sweeps[1] == [("2", "0"), ("4", "0")]
    if shm == "system":
        assert not port_server.engine.shm.system_status()


# -- refusals ---------------------------------------------------------------

def _two_step_json(tmp_path):
    path = tmp_path / "two.json"
    step = {"INPUT0": [1] * 16, "INPUT1": [2] * 16}
    path.write_text(json.dumps({"data": [step, step]}))
    return str(path)


@pytest.mark.parametrize("flags", [
    ["--hermetic"],
    ["-i", "http"],
    ["--async"],
    ["--request-intervals", "INTERVALS"],
    ["--async", "--request-rate-range", "10"],
    ["-f", "x.csv"],
    ["--json-export", "x.json"],
    ["--latency-threshold", "5"],
    ["--binary-search"],
    ["--collect-metrics"],
    ["--world-size", "2"],
    ["--measurement-mode", "count_windows"],
    ["-f", "x.csv", "--binary-search", "--world-size", "2"],
    ["--request-rate-range", "10", "--sequence"],
    ["--input-data", "zero"],
    ["--shared-memory", "system", "--input-data", "TWO_STEPS"],
    ["--prefix-share", "0.5"],
    ["--tenants", "gold:2,bronze"],
    ["-u", "localhost:1,localhost:2"],
], ids=["hermetic", "http", "async", "intervals", "async-rate", "csv",
        "json", "latency", "binary", "metrics", "world", "count-windows",
        "several", "rate-sequence", "wire-input-data", "two-steps",
        "prefix-share", "tenants", "replica-list"])
def test_native_refusals_equal_jax(flags, port_server, jax_server, tmp_path):
    """Each refusal of --native-loadgen exits with the JAX CLI's message,
    word for word, in the reference's order (``-u`` names each package's
    own server; the port's ``--device cpu`` lets --hermetic start on this
    CPU)."""
    intervals = tmp_path / "intervals.txt"
    intervals.write_text("1000000\n")
    flags = [str(intervals) if f == "INTERVALS" else
             _two_step_json(tmp_path) if f == "TWO_STEPS" else f
             for f in flags]
    messages = []
    for run, server, extra in ((jmain, jax_server, []),
                               (main, port_server, ["--device", "cpu"])):
        url = (server.http_address if "http" in flags
               else server.grpc_address)
        argv = ["-m", "simple", "-u", url, "--native-loadgen", *flags]
        if "--hermetic" in flags:
            argv += extra
        with pytest.raises(SystemExit) as e:
            run(argv)
        messages.append(str(e.value))
    assert messages[1] == messages[0].replace("system/tpu", "system/cuda")
    assert messages[0].startswith("error: ")
    assert not port_server.engine.shm.system_status()
