"""The port's multi-process load generation (client_tpu_torch.perf.procpool)
held against the JAX package's (client_tpu.perf.procpool), on the CPU.

- tests/test_perf.py::TestProcPool's cases (wire load from 2 spawned
  processes, a worker error reported, region-referencing requests built
  from specs) on both packages; the port's ``requests`` (every request the
  workers sent) equals the port server's success count exactly.
- ``export_region_specs`` gives JAX's specs on the same region layout.
- Region-by-name end to end: the coordinator registers system regions,
  and CUDA regions made on the CPU (which only this process's server
  resolves), the spawned workers reference them by name; no error, the
  count equal to the server's.  The JAX pool does the same with system
  regions against the JAX server.
"""

import json

import numpy as np
import pytest

from client_tpu.perf import DataLoader as JaxLoader
from client_tpu.perf import procpool as jpool
from client_tpu.perf.infer_data import (
    create_infer_data_manager as jax_manager,
)
from client_tpu.perf.client_backend import BackendKind as JaxKind
from client_tpu.perf.client_backend import (
    ClientBackendFactory as JaxFactory,
)
from client_tpu.serve import Server as JaxServer
from client_tpu.utils import InferenceServerException as JaxError
from client_tpu_torch.perf import (
    BackendKind,
    ClientBackendFactory,
    DataLoader,
    ModelParser,
    create_infer_data_manager,
)
from client_tpu_torch.perf import procpool
from client_tpu_torch.serve import Server
from client_tpu_torch.utils import InferenceServerException

META = [{"name": "INPUT0", "datatype": "INT32", "shape": [1, 16]},
        {"name": "INPUT1", "datatype": "INT32", "shape": [1, 16]}]


@pytest.fixture(scope="module")
def port_server():
    with Server(grpc_port=0, device="cpu") as s:
        yield s


@pytest.fixture(scope="module")
def jax_server():
    with JaxServer(grpc_port=0) as s:
        yield s


def _counts(server, model="simple"):
    stats = server.engine.statistics(model)[0]["inference_stats"]
    return stats["success"]["count"], stats["fail"]["count"]


def test_multiproc_wire_load(port_server, jax_server):
    """TestProcPool.test_multiproc_wire_load on both packages."""
    results = []
    for run, server in ((procpool.run_completion_multiproc, port_server),
                        (jpool.run_completion_multiproc, jax_server)):
        before = _counts(server)
        res = run(server.grpc_address, "simple", processes=2, concurrency=4,
                  window_s=1.0, warmup_s=0.2, spec={"mode": "wire"})
        after = _counts(server)
        assert res.processes == 2 and res.concurrency == 4
        assert res.error_count == 0 and res.completed_requests > 0
        assert res.throughput > 0
        assert sorted(res.percentiles_us) == [50, 90, 95, 99]
        assert after[1] == before[1]
        results.append((res, after[0] - before[0]))
    (port, served), (jax, jax_served) = results
    # the port counts every request its workers sent, warm-up included
    assert port.requests == (served, 0)
    assert port.completed_requests <= served
    assert 0 < jax.completed_requests <= jax_served
    assert set(vars(port)) - set(vars(jax)) == {"requests"}


@pytest.mark.parametrize("pool,error", [(procpool, InferenceServerException),
                                        (jpool, JaxError)],
                         ids=["port", "jax"])
def test_multiproc_worker_error_reported(pool, error):
    """TestProcPool.test_multiproc_worker_error_reported."""
    with pytest.raises(error, match="load worker"):
        pool.run_completion_multiproc(
            "127.0.0.1:1", "nope", processes=1, concurrency=1,
            window_s=0.2, warmup_s=0.0, spec={"mode": "wire"},
            start_timeout_s=30)


class _FakeInput:
    def __init__(self, name, shape, datatype):
        self.name, self.shape, self.datatype = name, shape, datatype

    def set_shared_memory(self, region, nbytes, offset=0):
        self.region, self.nbytes = region, nbytes


class _FakeOut:
    def __init__(self, name):
        self.name, self.region = name, None

    def set_shared_memory(self, region, nbytes, offset=0):
        self.region = region


class _FakeBackend:
    infer_input_cls = _FakeInput
    requested_output_cls = _FakeOut


def test_preregistered_shm_specs_equal_jax():
    """TestProcPool.test_preregistered_shm_specs on both packages: the
    same requests from the same specs (no region is created)."""
    specs = ({(0, 0): [("IN", [1, 4], "FP32", "region_in", 16)],
              (0, 1): [("IN", [1, 4], "FP32", "region_in2", 16)]},
             [("OUT", "region_out", 16), ("AUX", "", 0)])
    built = []
    for pool in (procpool, jpool):
        mgr = pool.PreRegisteredShmInferDataManager(_FakeBackend(), *specs)
        mgr.init()
        built.append([
            ([vars(i) for i in mgr.get_infer_data(0, t).inputs],
             [vars(o) for o in mgr.get_infer_data(0, t).outputs])
            for t in (0, 1)])
        loader = pool.ShapeOnlyLoader(1, [2])
        assert loader.num_steps(0) == 2
        assert loader.get_expected_outputs(0, 1) == {}
    assert built[0] == built[1]
    assert built[0][0][0][0]["region"] == "region_in"
    assert built[0][0][1][1]["region"] is None  # plain requested output


class _Layout:
    """A data manager's region layout, as both packages' managers hold it."""

    def __init__(self, regions, out_regions, outputs_meta):
        self._regions = regions
        self._out_regions = out_regions
        self._outputs_meta = outputs_meta


@pytest.mark.parametrize("streams", [1, 3])
def test_export_region_specs_equal_jax(streams, tmp_path):
    """export_region_specs on the same layout and the same loaded data:
    JAX's specs, exactly (an input absent from a step is left out)."""
    data = {"data": [[{"INPUT0": list(range(16)), "INPUT1": [1] * 16}] * 2]
            * streams}
    path = tmp_path / "data.json"
    path.write_text(json.dumps(data))
    layout = _Layout(
        {(s, t, name): (f"r_{s}_{t}_{name}", 64)
         for s in range(streams) for t in range(2)
         for name in ("INPUT0", "INPUT1") if (s, t, name) != (0, 1, "INPUT1")},
        {"OUTPUT0": ("r_out0", 64)},
        [{"name": "OUTPUT0"}, {"name": "OUTPUT1"}])
    specs = []
    for Loader, pool in ((DataLoader, procpool), (JaxLoader, jpool)):
        loader = Loader(META)
        loader.read_data_from_json(str(path))
        specs.append(pool.export_region_specs(layout, META, loader))
    assert specs[0] == specs[1]
    assert specs[0][1] == [("OUTPUT0", "r_out0", 64), ("OUTPUT1", "", 0)]
    assert len(specs[0][0]) == 2 * streams
    assert [t[0] for t in specs[0][0][(0, 1)]] == ["INPUT0"]


def _shm_ref_spec(manager, inputs_meta, loader, pool):
    input_specs, output_specs = pool.export_region_specs(
        manager, inputs_meta, loader)
    return {"mode": "shm_ref", "num_streams": loader.num_streams,
            "steps_per_stream": [loader.num_steps(s)
                                 for s in range(loader.num_streams)],
            "input_specs": input_specs, "output_specs": output_specs}


@pytest.mark.parametrize("shm", ["system", "cuda"])
def test_region_by_name_load(port_server, shm):
    """The coordinator registers the regions (CUDA ones on the CPU: only
    this process's server resolves them); the spawned workers reference
    them by name and never open them."""
    backend = ClientBackendFactory.create(BackendKind.TRITON_GRPC,
                                          url=port_server.grpc_address)
    parser = ModelParser.create(backend, "simple", "", batch_size=1)
    loader = DataLoader(parser.inputs, batch_size=1)
    loader.generate_data()
    manager = create_infer_data_manager(
        backend, loader, parser.inputs, parser.outputs, shared_memory=shm,
        output_shm_byte_size=64, device="cpu")
    manager.init()
    try:
        spec = _shm_ref_spec(manager, parser.inputs, loader, procpool)
        assert ({t[3] for t in spec["input_specs"][(0, 0)]}
                <= set(manager.region_names()))
        before = _counts(port_server)
        res = procpool.run_completion_multiproc(
            port_server.grpc_address, "simple", processes=2, concurrency=4,
            window_s=1.0, warmup_s=0.2, spec=spec)
        after = _counts(port_server)
    finally:
        manager.cleanup()
        backend.close()
    assert res.error_count == 0 and res.completed_requests > 0
    assert res.requests == (after[0] - before[0], 0)
    assert after[1] == before[1]


def test_region_by_name_load_jax(jax_server):
    """The JAX pool's region-by-name load on the JAX server, system
    regions: the reference the port's case above follows."""
    backend = JaxFactory.create(JaxKind.TRITON_GRPC,
                                url=jax_server.grpc_address)
    meta = backend.model_metadata("simple", "")
    inputs = [dict(m, shape=[1, 16]) for m in meta["inputs"]]
    loader = JaxLoader(inputs, batch_size=1)
    loader.generate_data()
    manager = jax_manager(backend, loader, inputs, meta["outputs"],
                          shared_memory="system", output_shm_byte_size=64)
    manager.init()
    try:
        spec = _shm_ref_spec(manager, inputs, loader, jpool)
        before = _counts(jax_server)
        res = jpool.run_completion_multiproc(
            jax_server.grpc_address, "simple", processes=2, concurrency=4,
            window_s=1.0, warmup_s=0.2, spec=spec)
        after = _counts(jax_server)
    finally:
        manager.cleanup()
        backend.close()
    assert res.error_count == 0
    assert 0 < res.completed_requests <= after[0] - before[0]
    assert np.isfinite(res.latency_avg_us)
