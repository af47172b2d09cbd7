"""perf_analyzer's ``--async`` in the port (client_tpu_torch.perf's
AsyncConcurrencyManager over client_tpu_torch.grpc.aio) held against the
JAX package's (client_tpu.perf), on the CPU.

- tests/test_perf.py::TestAsyncConcurrencyManager's two cases on the
  port's ``Server(device="cpu", grpc_port=0)``: asyncio slots drive
  ``simple`` and reconfigure to a lower level, and ``python -m
  client_tpu_torch.perf --async`` completes a sweep; crosswise, the
  port's manager drives the JAX server and the JAX manager the port's.
- ``--async`` from CPU CUDA regions (this process's broker resolves
  them; another process cannot open them), in process as
  tests/test_torch_perf.py's CUDA-region legs run: the server's success
  count equals the client's count of the whole run, with and without
  ``--cuda-shm-sync``, and the records carry the fields of the JAX CLI's
  ``--async`` run against the JAX server.
- JAX's ``--async`` refusals, word for word: ``-i http``, ``--hermetic``,
  ``--sequence``, ``--request-rate-range`` and ``--tenants``.
- A slot's transport failure reaches ``check_health`` and is raised,
  never swallowed.

Counts are exact; timed waits are short sleeps no check depends on the
length of.
"""

import json
import subprocess
import sys
import time

import pytest

from client_tpu.perf import load_manager as jload
from client_tpu.perf.__main__ import main as jmain
from client_tpu.perf.client_backend import BackendKind as JaxKind
from client_tpu.perf.client_backend import ClientBackendFactory as JaxFactory
from client_tpu.perf.data_loader import DataLoader as JaxLoader
from client_tpu.perf.infer_data import InferDataManager as JaxDataManager
from client_tpu.serve import Server as JaxServer
from client_tpu_torch.perf import (
    AsyncConcurrencyManager,
    BackendKind,
    ClientBackendFactory,
    DataLoader,
)
from client_tpu_torch.perf.__main__ import main
from client_tpu_torch.perf.infer_data import InferDataManager
from client_tpu_torch.serve import Server
from client_tpu_torch.utils import InferenceServerException as PortError

_COUNT = ["--measurement-mode", "count_windows",
          "--measurement-request-count", "20", "--measurement-interval",
          "300", "--max-trials", "3", "-s", "90"]


@pytest.fixture(scope="module")
def servers():
    with Server(device="cpu", grpc_port=0, http_port=0) as port, \
            JaxServer(grpc_port=0) as ref:
        yield {"torch": port, "jax": ref}


def _manager(package, address):
    """tests/test_perf.py::TestAsyncConcurrencyManager's set-up with
    *package*'s classes: (manager, control backend)."""
    factory, kind, loader_cls, dm_cls, manager_cls = {
        "torch": (ClientBackendFactory, BackendKind.TRITON_GRPC, DataLoader,
                  InferDataManager, AsyncConcurrencyManager),
        "jax": (JaxFactory, JaxKind.TRITON_GRPC, JaxLoader, JaxDataManager,
                jload.AsyncConcurrencyManager)}[package]
    control = factory.create(kind, url=address)
    meta = control.model_metadata("simple")
    inputs_meta = [
        {"name": m["name"], "datatype": m["datatype"],
         "shape": [1 if d == -1 else d for d in m["shape"]]}
        for m in meta["inputs"]
    ]
    outputs_meta = [dict(m) for m in meta["outputs"]]
    loader = loader_cls(inputs_meta, batch_size=1)
    loader.generate_data()
    dm = dm_cls(control, loader, inputs_meta, outputs_meta)
    dm.init()
    manager = manager_cls(url=address, data_loader=loader, data_manager=dm,
                          model_name="simple", max_threads=16)
    return manager, control


@pytest.mark.parametrize("package,kind", [
    ("torch", "torch"), ("torch", "jax"), ("jax", "torch")])
def test_async_slots_drive_requests(servers, package, kind):
    """tests/test_perf.py::TestAsyncConcurrencyManager::
    test_async_slots_drive_requests: 8 slots on one loop, every record
    ok, then level 2 still sends; with the port's manager the run's
    request totals equal the server's success count, exactly."""
    server = servers[kind]
    before = server.engine.statistics("simple")[0]["inference_stats"]
    manager, control = _manager(package, server.grpc_address)
    try:
        manager.change_concurrency_level(8)
        time.sleep(1.0)
        manager.check_health()
        records = manager.swap_timestamps()
        assert len(records) > 8
        assert all(r.ok for r in records)
        # reconfigure to a lower level works (slot teardown + restart)
        manager.change_concurrency_level(2)
        time.sleep(0.4)
        assert manager.get_and_reset_num_sent() > 0
    finally:
        manager.cleanup()
        control.close()
    after = server.engine.statistics("simple")[0]["inference_stats"]
    if package == "torch":
        completed, failed = manager.request_totals()
        assert failed == 0
        assert (after["success"]["count"] - before["success"]["count"]
                == completed > len(records))


def test_cli_async_mode(servers):
    """tests/test_perf.py::TestAsyncConcurrencyManager::test_cli_async_mode
    with ``python -m client_tpu_torch.perf`` against the port's server."""
    proc = subprocess.run(
        [sys.executable, "-m", "client_tpu_torch.perf", "-m", "simple",
         "-u", servers["torch"].grpc_address, "-i", "grpc", "--async",
         "--concurrency-range", "4:4:1",
         "--measurement-interval", "500", "--max-trials", "4"],
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Best: concurrency=" in proc.stdout


@pytest.mark.parametrize("sync", [False, True])
def test_async_from_cuda_regions_counts_every_request(servers, sync,
                                                      tmp_path):
    """``--async --shared-memory cuda --device cpu`` at concurrency 1 and
    4: inputs and outputs in CPU CUDA regions the port's server resolves
    through this process's broker; no failure on either side, the
    server's success count equals the client's count of the run, and the
    regions are gone afterwards.  The records carry the fields of the JAX
    CLI's ``--async`` run over the wire against the JAX server."""
    server = servers["torch"]
    out = tmp_path / "port.json"
    before = server.engine.statistics("simple")[0]["inference_stats"]
    rc = main(["-m", "simple", "-u", server.grpc_address, "--async",
               "--shared-memory", "cuda", "--device", "cpu",
               "--output-shared-memory-size", "64",
               "--concurrency-range", "1:4:3", *_COUNT,
               "--json-export", str(out)]
              + (["--cuda-shm-sync"] if sync else []))
    after = server.engine.statistics("simple")[0]["inference_stats"]
    assert rc == 0
    assert server.engine.shm.cuda_status() == {}
    doc = json.loads(out.read_text())
    assert [r["level_value"] for r in doc["results"]] == [1, 4]
    assert all(r["error_count"] == 0 and r["completed_requests"] > 0
               for r in doc["results"])
    assert after["fail"]["count"] == before["fail"]["count"]
    assert doc["requests"] == {
        "completed": after["success"]["count"] - before["success"]["count"],
        "failed": 0}
    ref = tmp_path / "jax.json"
    assert jmain(["-m", "simple", "-u", servers["jax"].grpc_address,
                  "--async", "--concurrency-range", "1:4:3", *_COUNT,
                  "--json-export", str(ref)]) == 0
    jdoc = json.loads(ref.read_text())
    assert set(doc) == set(jdoc) | {"requests"}
    assert [set(r) for r in doc["results"]] == [
        set(r) for r in jdoc["results"]]


@pytest.mark.parametrize("flags", [
    ["-i", "http"], ["--hermetic"], ["--sequence"],
    ["--request-rate-range", "10"], ["--tenants", "gold:1"],
])
def test_async_refusals_equal_jax(servers, flags):
    """Where the JAX CLI refuses ``--async`` (not a socket gRPC server,
    a sequence workload, a request-rate schedule, a tenant mix), the
    port's refuses with the same message, word for word."""
    messages = []
    for run, kind, extra in ((main, "torch", ["--device", "cpu"]),
                             (jmain, "jax", [])):
        server = servers[kind]
        url = (server.http_address if "http" in flags
               else server.grpc_address)
        with pytest.raises(SystemExit) as e:
            run(["-m", "simple", "-u", url, "--async", *flags, *extra])
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    assert messages[0].startswith("error: --")


def test_a_slot_transport_failure_reaches_check_health(servers,
                                                       monkeypatch):
    """A slot whose client raises something other than a server answer
    (a transport collapse) stops, and ``check_health`` raises that very
    error; an answered failure only counts as a failed request."""
    manager, control = _manager("torch", servers["torch"].grpc_address)
    from client_tpu_torch.grpc import aio

    collapse = ConnectionResetError("the transport collapsed")
    calls = []

    async def infer(self, model_name, inputs, **kwargs):
        calls.append(model_name)
        if len(calls) == 1:
            raise PortError("answered", status="INVALID_ARGUMENT")
        raise collapse

    monkeypatch.setattr(aio.InferenceServerClient, "infer", infer)
    raised = None
    try:
        manager.change_concurrency_level(1)
        deadline = time.monotonic() + 30
        while raised is None and time.monotonic() < deadline:
            try:
                manager.check_health()
            except ConnectionResetError as e:
                raised = e
            time.sleep(0.01)
        assert raised is collapse
        assert manager.request_totals() == (0, 1)
        assert [r.ok for r in manager.swap_timestamps()] == [False]
    finally:
        manager.cleanup()
        control.close()
    assert len(calls) == 2
