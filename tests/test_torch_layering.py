"""The port's framework-free layer: what the reference imports and runs
without jax, the port imports and runs without torch.

pytest has already imported torch in this process, so every torch-free
check runs in a fresh interpreter that sets ``sys.modules["torch"] =
None`` before its first import (the reference's side sets it for jax):

- (a) each of the reference's jax-free modules (REFERENCE_JAX_FREE,
  recomputed from client_tpu/ by its own case) has a port counterpart
  that imports with torch blocked, one interpreter a package; the
  port's other modules are the torch-bound ones and fail on torch alone;
- (b) the port's ``Server()`` serves its numpy builtins torch-free, and
  the port's HTTP and gRPC clients' outputs equal, byte for byte, the
  reference's server and clients' run jax-free on the same seeded
  inputs; a dynamically batched numpy model too (the reference's batcher
  needs jax, so numpy is its reference);
- (c) ``python -m client_tpu_torch.perf -i http`` and ``-i grpc``
  against that server, torch blocked (tools/torch_free.py), exit 0 with
  no failed request, their counts equal to the server's;
- (d) the port's analyser reports 0 findings torch-free;
- (e) torch-bound features refuse with a message naming torch, and with
  torch installed nothing quietly changes.
"""

import base64
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
TORCH_FREE = ROOT / "tools" / "torch_free.py"

# client_tpu's modules that import with jax blocked (93 modules, 75 here)
REFERENCE_JAX_FREE = (
    "client_tpu", "client_tpu._codec", "client_tpu._grpc_infer",
    "client_tpu._grpc_service", "client_tpu._infer_types",
    "client_tpu._proto", "client_tpu._proto.inference_pb2",
    "client_tpu._proto.model_config_pb2", "client_tpu._proto.tfserve_pb2",
    "client_tpu._version", "client_tpu.analysis",
    "client_tpu.analysis.__main__", "client_tpu.analysis.baseline",
    "client_tpu.analysis.cache", "client_tpu.analysis.callgraph",
    "client_tpu.analysis.concurrency", "client_tpu.analysis.core",
    "client_tpu.analysis.locksets", "client_tpu.analysis.report",
    "client_tpu.analysis.resources", "client_tpu.analysis.rules",
    "client_tpu.analysis.witness", "client_tpu.balance",
    "client_tpu.balance.discovery", "client_tpu.balance.policy",
    "client_tpu.balance.pool", "client_tpu.balance.replicated",
    "client_tpu.balance.stream", "client_tpu.grpc", "client_tpu.grpc.aio",
    "client_tpu.http", "client_tpu.http.aio", "client_tpu.perf",
    "client_tpu.perf.__main__", "client_tpu.perf.client_backend",
    "client_tpu.perf.data_loader", "client_tpu.perf.fake_endpoints",
    "client_tpu.perf.infer_data", "client_tpu.perf.load_manager",
    "client_tpu.perf.metrics_manager", "client_tpu.perf.model_parser",
    "client_tpu.perf.native_worker", "client_tpu.perf.procpool",
    "client_tpu.perf.profiler", "client_tpu.perf.rendezvous",
    "client_tpu.perf.report", "client_tpu.perf.sequence_manager",
    "client_tpu.profview", "client_tpu.resilience", "client_tpu.serve",
    "client_tpu.serve.__main__", "client_tpu.serve._completion",
    "client_tpu.serve.autoscale", "client_tpu.serve.builtins",
    "client_tpu.serve.dynamic_batcher", "client_tpu.serve.fleet",
    "client_tpu.serve.flight", "client_tpu.serve.frontdoor",
    "client_tpu.serve.grpc_server", "client_tpu.serve.http_server",
    "client_tpu.serve.metrics", "client_tpu.serve.model_runtime",
    "client_tpu.serve.models", "client_tpu.serve.pipeline",
    "client_tpu.serve.prof", "client_tpu.serve.slo",
    "client_tpu.serve.tracing", "client_tpu.testing",
    "client_tpu.testing.chaos", "client_tpu.testing.faults",
    "client_tpu.traceview", "client_tpu.tracing", "client_tpu.utils",
    "client_tpu.utils.shared_memory", "client_tpu.utils.tpu_shared_memory",
)
# the port's modules beyond the counterparts that import without torch:
# the launch counters and capture lock (client_tpu.ops imports jax) and
# the two build modules, which import torch when they build
PORT_ONLY_TORCH_FREE = (
    "client_tpu_torch.ops", "client_tpu_torch.ops._build",
    "client_tpu_torch.utils.cuda_shared_memory._build",
)


def counterpart(name):
    """The port module of a reference module: the same path, the TPU
    regions' module mapped to the CUDA one (UNPAIRED in
    tests/test_torch_guards.py)."""
    port = "client_tpu_torch" + name[len("client_tpu"):]
    return port.replace(".tpu_shared_memory", ".cuda_shared_memory")


def modules(package):
    """Dotted names of every module of *package* under the repo root."""
    base = ROOT / package
    names = []
    for path in sorted(base.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def fresh(code, *args, timeout=300, env=None):
    """Run *code* in a fresh interpreter at the repo root."""
    return subprocess.run(
        [sys.executable, "-c", code, *args], capture_output=True, text=True,
        timeout=timeout, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT), **(env or {})})


IMPORT_ALL = r"""
import importlib, json, sys
sys.modules[sys.argv[1]] = None
names = json.loads(sys.argv[2])
ok, failed = [], {}
for name in names:
    try:
        importlib.import_module(name)
        ok.append(name)
    except BaseException as e:
        failed[name] = [type(e).__name__, getattr(e, "name", None), str(e)]
print(json.dumps({"ok": ok, "failed": failed,
                  "loaded": sorted(m for m, v in sys.modules.items()
                                   if m.split(".")[0] == sys.argv[1]
                                   and v is not None)}))
"""


def import_all(blocked, names):
    out = fresh(IMPORT_ALL, blocked, json.dumps(names))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def reference_without_jax():
    """One interpreter, jax blocked, importing every reference module."""
    return import_all("jax", modules("client_tpu"))


@pytest.fixture(scope="module")
def port_without_torch():
    """One interpreter, torch blocked, importing every port module."""
    return import_all("torch", modules("client_tpu_torch"))


def test_reference_jax_free_list_is_the_reference_package(
        reference_without_jax):
    """The written list is what client_tpu/ imports with jax blocked now;
    every other reference module fails on jax alone."""
    assert tuple(sorted(reference_without_jax["ok"])) == REFERENCE_JAX_FREE
    assert len(REFERENCE_JAX_FREE) == 75
    assert all(err[:2] == ["ModuleNotFoundError", "jax"]
               for err in reference_without_jax["failed"].values())
    assert reference_without_jax["loaded"] == []


@pytest.mark.parametrize("name", REFERENCE_JAX_FREE)
def test_counterpart_imports_without_torch(name, port_without_torch):
    """(a) The port counterpart of a reference module that imports
    without jax imports without torch."""
    port = counterpart(name)
    assert port in port_without_torch["ok"], (
        port_without_torch["failed"].get(port))


def test_torch_bound_modules_fail_on_torch_alone(port_without_torch):
    """What stays torch-bound is the counterpart of the reference's
    jax-bound set (the kernels under ops, serve.models' submodules,
    serve.lm, train, parallel) and the port-only convert and graft: each
    fails on torch itself, and nothing imported torch."""
    free = {counterpart(n) for n in REFERENCE_JAX_FREE}
    free.update(PORT_ONLY_TORCH_FREE)
    assert set(port_without_torch["ok"]) == free
    bound = set(port_without_torch["failed"])
    assert bound == set(modules("client_tpu_torch")) - free
    assert all(err[:2] == ["ModuleNotFoundError", "torch"]
               for err in port_without_torch["failed"].values())
    roots = {n.split(".")[1] for n in bound}
    assert roots == {"ops", "serve", "train", "parallel", "convert",
                     "graft"}
    assert {n for n in bound if n.startswith("client_tpu_torch.serve")} \
        == {n for n in modules("client_tpu_torch")
            if n.startswith(("client_tpu_torch.serve.lm",
                             "client_tpu_torch.serve.models."))}
    assert port_without_torch["loaded"] == []


# -- (b), (c): the server, the clients and perf_analyzer ----------------------

DRIVE = r"""
import base64, importlib, json, os, subprocess, sys, threading
sys.modules[sys.argv[2]] = None
import numpy as np

pkg, root = sys.argv[1], sys.argv[3]
serve = importlib.import_module(pkg + ".serve")
httpclient = importlib.import_module(pkg + ".http")
grpcclient = importlib.import_module(pkg + ".grpc")


def batched_model():
    def fn(inputs, params, ctx):
        x = inputs["X"]
        assert type(x) is np.ndarray, type(x)
        return {"Y": x * 3 + 1}

    return serve.Model(
        "batched_numpy", inputs=[serve.TensorSpec("X", "INT32", [-1, 4])],
        outputs=[serve.TensorSpec("Y", "INT32", [-1, 4])], fn=fn,
        max_batch_size=8, dynamic_batching=True)


rng = np.random.default_rng(25)
a = rng.integers(-1000, 1000, (1, 16), dtype=np.int32)
b = rng.integers(-1000, 1000, (1, 16), dtype=np.int32)
words = np.array([rng.bytes(int(n)) for n in rng.integers(0, 12, 6)],
                 dtype=np.object_)
steps = rng.integers(-50, 50, 4).astype(np.int32)
rows = rng.integers(-100, 100, (8, 1, 4), dtype=np.int32)
out = {"__rows__": base64.b64encode(rows.tobytes()).decode()}


def put(key, arr):
    assert isinstance(arr, np.ndarray), (key, type(arr))
    if arr.dtype == np.object_:
        data = [base64.b64encode(bytes(x)).decode() for x in arr.ravel()]
    else:
        data = base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()
    out[key] = [str(arr.dtype), list(arr.shape), data]


def inputs(mod, spec):
    made = []
    for name, datatype, arr in spec:
        inp = mod.InferInput(name, list(arr.shape), datatype)
        inp.set_data_from_numpy(arr)
        made.append(inp)
    return made


def successes(server, model):
    stats = server.engine.statistics(model)[0]["inference_stats"]
    return stats["success"]["count"], stats["fail"]["count"]


# the reference's batcher takes every host group's result through
# jax.device_get (client_tpu/serve/dynamic_batcher.py:860-862), so only
# the port serves a batched numpy model without its framework
port = pkg == "client_tpu_torch"
with serve.Server(models=[batched_model()] if port else [],
                  grpc_port=0) as server:
    out["__models__"] = sorted(
        m["name"] for m in server.engine.repository_index())
    for proto, mod, url in (("http", httpclient, server.http_address),
                            ("grpc", grpcclient, server.grpc_address)):
        with mod.InferenceServerClient(url) as c:
            r = c.infer("simple", inputs(mod, [("INPUT0", "INT32", a),
                                               ("INPUT1", "INT32", b)]))
            put(proto + " simple OUTPUT0", r.as_numpy("OUTPUT0"))
            put(proto + " simple OUTPUT1", r.as_numpy("OUTPUT1"))
            r = c.infer("identity_bytes",
                        inputs(mod, [("INPUT0", "BYTES", words)]))
            put(proto + " identity_bytes", r.as_numpy("OUTPUT0"))
            for i, v in enumerate(steps):
                r = c.infer(
                    "simple_sequence",
                    inputs(mod, [("INPUT", "INT32", np.array([v], np.int32))]),
                    sequence_id=100 + len(proto), sequence_start=i == 0,
                    sequence_end=i == len(steps) - 1)
                put(f"{proto} simple_sequence {i}", r.as_numpy("OUTPUT"))
        if not port:
            continue
        got = [None] * len(rows)

        def one(k, mod=mod, url=url):
            with mod.InferenceServerClient(url) as c:
                got[k] = c.infer("batched_numpy", inputs(
                    mod, [("X", "INT32", rows[k])])).as_numpy("Y")

        threads = [threading.Thread(target=one, args=(k,))
                   for k in range(len(rows))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        for k, arr in enumerate(got):
            put(f"{proto} batched_numpy {k}", arr)
    with httpclient.InferenceServerClient(server.http_address) as c:
        r = c.infer("repeat_int32", inputs(
            httpclient, [("IN", "INT32", np.array([1], np.int32))]))
        put("http repeat_int32", r.as_numpy("OUT"))
    streamed, done = [], threading.Event()

    def callback(result=None, error=None):
        streamed.append(error if error is not None else result.as_numpy("OUT"))
        if len(streamed) == 5:
            done.set()

    with grpcclient.InferenceServerClient(server.grpc_address) as c:
        c.start_stream(callback=callback)
        c.async_stream_infer("repeat_int32", inputs(
            grpcclient, [("IN", "INT32", np.array([5], np.int32))]))
        done.wait(60)
        c.stop_stream()
    for i, arr in enumerate(streamed):
        put(f"grpc repeat_int32 {i}", arr)
    if len(sys.argv) > 4:
        launcher, tmp = sys.argv[4:6]
        out["__perf__"] = {}
        for proto, url in (("http", server.http_address),
                           ("grpc", server.grpc_address)):
            export = os.path.join(tmp, f"perf_{proto}.json")
            before = successes(server, "simple")
            p = subprocess.run(
                [sys.executable, launcher, "-m", pkg + ".perf", "-m",
                 "simple", "-i", proto, "-u", url, "--concurrency-range",
                 "1:2", "--measurement-interval", "300", "--max-trials",
                 "3", "--json-export", export],
                capture_output=True, text=True, timeout=240, cwd=root,
                env={**os.environ, "PYTHONPATH": root})
            after = successes(server, "simple")
            with open(export) as f:
                doc = json.load(f) if p.returncode == 0 else None
            out["__perf__"][proto] = {
                "rc": p.returncode, "stdout": p.stdout[-2000:],
                "stderr": p.stderr[-2000:], "requests": doc and doc["requests"],
                "errors": doc and [r["error_count"] for r in doc["results"]],
                "served": [after[0] - before[0], after[1] - before[1]]}
out["__loaded__"] = sorted(m for m, v in sys.modules.items()
                           if m.split(".")[0] == sys.argv[2]
                           and v is not None)
print(json.dumps(out))
"""


def drive(package, blocked, *extra):
    out = fresh(DRIVE, package, blocked, str(ROOT), *extra, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The port's side torch-free with its perf runs, the reference's
    jax-free."""
    tmp = tmp_path_factory.mktemp("layering")
    return (drive("client_tpu_torch", "torch", str(TORCH_FREE), str(tmp)),
            drive("client_tpu", "jax"))


def test_torch_free_server_serves_the_builtins(served):
    """(b) ``Server()`` without torch serves the reference's builtin set
    (the reference's ``Server()`` without jax serves the same), and
    neither process loaded its framework."""
    port, ref = served
    builtins = ["classifier", "identity", "identity_bytes", "identity_int32",
                "identity_int8", "repeat_int32", "simple", "simple_ensemble",
                "simple_sequence", "simple_string", "slow_identity"]
    assert ref["__models__"] == builtins
    assert port["__models__"] == sorted(builtins + ["batched_numpy"])
    assert port["__loaded__"] == ref["__loaded__"] == []


@pytest.mark.parametrize("case", [
    "simple", "identity_bytes", "simple_sequence", "repeat_int32"])
@pytest.mark.parametrize("proto", ["http", "grpc"])
def test_torch_free_outputs_equal_the_reference_byte_for_byte(
        served, case, proto):
    """(b) The port's clients against the torch-free server give the
    reference's clients' bytes against its jax-free server: dtype, shape
    and payload of every output."""
    port, ref = served
    keys = sorted(k for k in ref if k.startswith(f"{proto} {case}"))
    assert keys and keys == sorted(
        k for k in port if k.startswith(f"{proto} {case}"))
    for key in keys:
        assert port[key] == ref[key], key
    if case == "repeat_int32" and proto == "grpc":
        assert len(keys) == 5


@pytest.mark.parametrize("proto", ["http", "grpc"])
def test_torch_free_batcher_serves_numpy_groups(served, proto):
    """(b) A dynamically batched numpy model behind the torch-free
    server: 8 concurrent requests, each its rows of ``x * 3 + 1`` as
    int32 (the model asserts numpy inputs; the batcher never needs
    torch for a host model)."""
    port = served[0]
    rows = np.frombuffer(base64.b64decode(port["__rows__"]),
                         np.int32).reshape(8, 1, 4)
    for k, x in enumerate(rows):
        dtype, shape, data = port[f"{proto} batched_numpy {k}"]
        want = x * 3 + 1
        assert [dtype, shape] == [str(want.dtype), list(want.shape)]
        assert base64.b64decode(data) == want.tobytes()


@pytest.mark.parametrize("proto", ["http", "grpc"])
def test_perf_cli_runs_torch_free(served, proto):
    """(c) ``python -m client_tpu_torch.perf -i <proto>`` with torch
    blocked exits 0 at concurrency 1 and 2, no request failed, and its
    count equals the server's successes."""
    run = served[0]["__perf__"][proto]
    assert run["rc"] == 0, run["stderr"]
    assert run["requests"]["failed"] == 0 and run["requests"]["completed"] > 0
    assert run["served"] == [run["requests"]["completed"], 0]
    assert run["errors"] == [0, 0]
    start = [ln for ln in run["stderr"].splitlines()
             if ln.startswith("torch_free: ")]
    assert len(start) == 1
    assert json.loads(start[0][len("torch_free: "):])["torch_loaded"] is False


def test_procpool_workers_run_torch_free(tmp_path):
    """procpool's spawned workers need no torch: a script that blocks
    torch at its top (so each spawned worker, which imports the script
    as its main module, blocks it too) serves the builtins and
    sends wire load from two worker processes, with no error."""
    script = tmp_path / "load.py"
    script.write_text(
        "import sys\n"
        "sys.modules['torch'] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import json\n"
        "from client_tpu_torch.perf.procpool import "
        "run_completion_multiproc\n"
        "from client_tpu_torch.serve import Server\n"
        "if __name__ == '__main__':\n"
        "    with Server(grpc_port=0) as s:\n"
        "        r = run_completion_multiproc(\n"
        "            s.grpc_address, 'simple', processes=2, concurrency=2,\n"
        "            window_s=0.5, warmup_s=0.2, spec={'mode': 'wire'})\n"
        "        stats = s.engine.statistics('simple')[0]\n"
        "    print(json.dumps({'errors': r.error_count,\n"
        "                      'completed': r.completed_requests,\n"
        "                      'requests': list(r.requests),\n"
        "                      'success': stats['inference_stats']"
        "['success']['count']}))\n")
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["errors"] == 0 and got["completed"] > 0
    assert got["requests"] == [got["success"], 0]


# -- (d) the analyser ---------------------------------------------------------

def test_analyser_reports_no_finding_torch_free():
    """(d) ``python -m client_tpu_torch.analysis`` torch-free: exit 0,
    0 findings (as with torch; the grandfathered entries are the
    baseline's)."""
    out = fresh(
        "import sys\n"
        "sys.modules['torch'] = None\n"
        "from client_tpu_torch.analysis.__main__ import main\n"
        "code = main(['client_tpu_torch', '--json', '--no-cache'])\n"
        "assert 'torch' not in [m.split('.')[0] for m, v in "
        "sys.modules.items() if v is not None]\n"
        "sys.exit(code)\n")
    assert out.returncode == 0, out.stderr[-3000:]
    report = json.loads(out.stdout)
    assert report["count"] == 0 and report["findings"] == []


# -- (e) refusals and what stays ----------------------------------------------

REFUSALS = r"""
import json, subprocess, sys
sys.modules["torch"] = None
import numpy as np

from client_tpu_torch import resolve_device
from client_tpu_torch.serve import model_runtime
from client_tpu_torch.serve.builtins import default_models
from client_tpu_torch.serve.models import model_sets
from client_tpu_torch.utils import (
    InferenceServerException, serialize_bf16_tensor, to_wire_bytes)
from client_tpu_torch.utils import cuda_shared_memory as cudashm

said = {}


def refused(key, fn, *errors):
    try:
        fn()
    except errors as e:
        said[key] = str(e)
    else:
        said[key] = None


refused("resolve_device", resolve_device, ModuleNotFoundError)
refused("resolve_device cpu", lambda: resolve_device("cpu"),
        ModuleNotFoundError)
refused("cuda region", lambda: cudashm.create_shared_memory_region(
    "r", 64, device="cpu"), ModuleNotFoundError)
refused("bf16 input", lambda: to_wire_bytes(
    np.ones(4, np.float32), "BF16"), InferenceServerException)
refused("bf16 tensor", lambda: serialize_bf16_tensor(
    np.ones(4, np.float32)), InferenceServerException)
refused("language set", lambda: model_sets("language"), ModuleNotFoundError)
for argv, key in (
        (["-m", "client_tpu_torch.perf", "-m", "simple", "-u",
          "127.0.0.1:1", "--shared-memory", "cuda"], "perf cuda"),
        (["-m", "client_tpu_torch.perf", "-m", "simple", "-u",
          "127.0.0.1:1", "--collect-metrics",
          "--collect-local-gpu-metrics"], "perf gpu metrics"),
        (["-m", "client_tpu_torch.perf", "-m", "simple", "--hermetic",
          "--device", "cpu"], "perf device"),
        (["-m", "client_tpu_torch.serve", "--models", "language",
          "--http-port", "0"], "serve language"),
        (["-m", "client_tpu_torch.profview", "--live"], "profview live")):
    p = subprocess.run([sys.executable, sys.argv[1], *argv],
                       capture_output=True, text=True, timeout=120)
    said[key] = [p.returncode, p.stderr.strip().splitlines()[-2:]]

snap = model_runtime._seq_decode(model_runtime._seq_encode(
    {"acc": np.arange(3, dtype=np.int32), "n": np.int64(4)}))
said["snapshot"] = [type(snap["acc"]).__name__, snap["acc"].tolist(),
                    type(snap["n"]).__name__]
said["builtins"] = sorted(m.name for m in default_models(device="cuda"))
said["loaded"] = sorted(m for m, v in sys.modules.items()
                        if m.split(".")[0] == "torch" and v is not None)
print(json.dumps(said))
"""


@pytest.fixture(scope="module")
def refusals():
    out = fresh(REFUSALS, str(TORCH_FREE), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("key", [
    "resolve_device", "resolve_device cpu", "cuda region", "bf16 input",
    "bf16 tensor", "language set"])
def test_torch_bound_calls_refuse_naming_torch(refusals, key):
    """(e) Without torch, resolve_device (even for the CPU), a CUDA
    region (even a CPU one), BF16 encoding and the torch model sets
    raise a message naming torch."""
    assert refusals[key] is not None, f"{key} did not refuse"
    assert "needs torch, which is not installed" in refusals[key]


@pytest.mark.parametrize("key,rc", [
    ("perf cuda", 1), ("perf gpu metrics", 1), ("perf device", 1),
    ("serve language", 2), ("profview live", 2)])
def test_torch_bound_options_refuse_naming_torch(refusals, key, rc):
    """(e) Without torch the CLIs refuse ``--shared-memory cuda``, the
    local GPU gauges, ``--device``, ``--models language`` and
    ``profview --live`` with a message naming torch, never ignore them."""
    code, tail = refusals[key]
    assert code == rc, tail
    assert any("needs torch, which is not installed" in ln for ln in tail), \
        tail


def test_torch_free_state_stays_numpy(refusals):
    """A numpy sequence snapshot decodes to numpy without torch, the
    builtin set is the numpy models (whatever device is named), and
    nothing loaded torch."""
    assert refusals["snapshot"] == ["ndarray", [0, 1, 2], "int64"]
    assert refusals["builtins"] == [
        "classifier", "identity", "identity_bytes", "identity_int32",
        "identity_int8", "repeat_int32", "simple", "simple_ensemble",
        "simple_sequence", "simple_string", "slow_identity"]
    assert refusals["loaded"] == []


def test_default_models_hides_only_torchs_own_absence(monkeypatch):
    """With torch installed, a broken vision module raises from
    default_models instead of quietly serving the numpy set."""
    from client_tpu_torch.serve import builtins

    monkeypatch.setitem(sys.modules,
                        "client_tpu_torch.serve.models.vision", None)
    with pytest.raises(ModuleNotFoundError) as e:
        builtins.default_models(device="cpu")
    assert e.value.name == "client_tpu_torch.serve.models.vision"


def test_with_torch_and_no_cuda_the_entry_points_still_refuse():
    """With torch and without CUDA, resolve_device, the builtin set's
    vision pipeline and a CUDA region refuse unless device="cpu"; with
    it, they run on the CPU."""
    import torch

    import client_tpu_torch
    from client_tpu_torch.serve.builtins import default_models
    from client_tpu_torch.utils import cuda_shared_memory as cudashm

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    for call in (client_tpu_torch.resolve_device, default_models,
                 lambda: cudashm.create_shared_memory_region("r", 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert client_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    names = [m.name for m in default_models(device="cpu")]
    assert "simple" in names and len(names) > 11
    region = cudashm.create_shared_memory_region("r", 8, device="cpu")
    cudashm.destroy_shared_memory_region(region)


def test_metrics_report_no_gpu_gauges_without_torch_loaded():
    """The ``ctpu_gpu_memory_*`` gauges report only once torch is
    loaded (as the reference reports devices only once jax is): a
    torch-free server's /metrics has none, and scraping loads nothing."""
    out = fresh(
        "import sys, urllib.request\n"
        "sys.modules['torch'] = None\n"
        "from client_tpu_torch.serve import Server\n"
        "with Server() as s:\n"
        "    text = urllib.request.urlopen(\n"
        "        f'http://{s.http_address}/metrics').read().decode()\n"
        "print('ctpu_gpu_memory' in text, 'ctpu_server_busy_ns' in text)\n")
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["False", "True"]


def test_torch_free_tensor_checks_need_no_import():
    """``is_tensor`` reads the torch this process has loaded: a numpy
    array is no tensor, a tensor is one, and neither check imports."""
    import torch

    import client_tpu_torch

    assert client_tpu_torch.is_tensor(torch.zeros(1))
    assert not client_tpu_torch.is_tensor(np.zeros(1))
    assert client_tpu_torch.loaded_torch() is torch
    assert client_tpu_torch.require_torch("a test") is torch
