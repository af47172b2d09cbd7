"""The port's non-KServe perf backends (client_tpu_torch.perf's
TorchServe, TF-Serving gRPC and TF-Serving REST kinds) and its hermetic
fakes (client_tpu_torch.perf.fake_endpoints) held against the JAX
package's, on the CPU.

- The cases of tests/test_backends.py run with the port's backends, data
  loader, data manager and load manager in place of the JAX ones (the
  module's names are swapped for the test), against the port's fakes and
  the JAX package's.  Each case is the JAX test's own body.
- Crosswise, the JAX backends against the port's fakes: the same
  requests give the same answers through both packages' backends.
- ``_proto/tfserve_pb2.py`` is a byte copy of the JAX package's.
- The two hermetic CLI sweeps, ``python -m client_tpu_torch.perf
  --service-kind torchserve|tfserve --hermetic`` (and ``tfserve_rest``),
  which start only a host fake: they run where CUDA is absent without
  ``--device cpu``.

Every comparison is exact: JSON documents, float32 and float64 arrays.
"""

import filecmp
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import client_tpu.perf.fake_endpoints as jfakes
import test_backends as jb
from client_tpu.perf import client_backend as jbackend
from client_tpu.utils import InferenceServerException as JaxError
from client_tpu_torch.perf import (
    BackendKind,
    ClientBackendFactory,
    ConcurrencyManager,
    DataLoader,
)
from client_tpu_torch.perf import client_backend as backend
from client_tpu_torch.perf import fake_endpoints as fakes
from client_tpu_torch.perf.__main__ import main
from client_tpu_torch.perf.infer_data import InferDataManager
from client_tpu_torch.utils import InferenceServerException as PortError

ROOT = pathlib.Path(__file__).resolve().parent.parent
FAKES = {"torch": fakes, "jax": jfakes}


@pytest.fixture(autouse=True)
def port_backends(monkeypatch):
    """The JAX test bodies build the port's backends and managers and
    catch either package's exception."""
    for name, value in (("ClientBackendFactory", ClientBackendFactory),
                        ("BackendKind", BackendKind),
                        ("ConcurrencyManager", ConcurrencyManager),
                        ("DataLoader", DataLoader),
                        ("InferDataManager", InferDataManager),
                        ("InferenceServerException", (JaxError, PortError))):
        monkeypatch.setattr(jb, name, value)


@pytest.fixture(scope="module", params=["torch", "jax"])
def torchserve(request):
    with FAKES[request.param].fake_torchserve(["resnet"]) as s:
        yield s


@pytest.fixture(scope="module", params=["torch", "jax"])
def tfserving(request):
    with FAKES[request.param].fake_tfserving(["half_plus_two"]) as s:
        yield s


class TestTorchServeBackendPort(jb.TestTorchServeBackend):
    """tests/test_backends.py::TestTorchServeBackend."""


class TestTfServeGrpcBackendPort(jb.TestTfServeGrpcBackend):
    """tests/test_backends.py::TestTfServeGrpcBackend, against both
    packages' gRPC fakes."""

    @pytest.fixture(params=["torch", "jax"])
    def tfs_grpc(self, request):
        with FAKES[request.param].fake_tfserving_grpc(["half_plus_two"]) as s:
            yield s


class TestTfServeBackendPort(jb.TestTfServeBackend):
    """tests/test_backends.py::TestTfServeBackend."""


def test_tfserve_pb2_is_a_byte_copy():
    """One registration in protobuf's default pool serves both packages:
    the port's tfserve_pb2 is the JAX package's, byte for byte."""
    assert filecmp.cmp(ROOT / "client_tpu_torch/_proto/tfserve_pb2.py",
                       ROOT / "client_tpu/_proto/tfserve_pb2.py",
                       shallow=False)


def _answers(mod, kind, url, model, name, arr):
    """Liveness, metadata, config, one prediction and an unknown model's
    error through *mod*'s backend of *kind*."""
    be = mod.ClientBackendFactory.create(kind, url=url,
                                         input_shape=list(arr.shape))
    inp = be.infer_input_cls(name, list(arr.shape), "FP32")
    inp.set_data_from_numpy(arr)
    result = be.infer(model, [inp])
    try:
        be.infer("nope", [inp])
        unknown = None
    except (JaxError, PortError) as e:
        unknown = (e.status(), e.message())
    out = {
        "metadata": be.model_metadata(model),
        "config": be.model_config(model),
        "arrays": {k: v.tolist() for k, v in result._arrays.items()},
        "response": result.get_response(),
        "unknown": unknown,
    }
    if kind == "tfserve":
        out["ready"] = (be.model_ready(model), be.model_ready("nope"))
    else:
        out["live"] = be.server_live()
    be.close()
    return out


@pytest.mark.parametrize("fake_pkg", ["torch", "jax"])
@pytest.mark.parametrize("kind,factory,model,name", [
    ("torchserve", "fake_torchserve", "resnet", "data"),
    ("tfserve", "fake_tfserving_grpc", "half_plus_two", "input"),
    ("tfserve_rest", "fake_tfserving", "half_plus_two", "instances"),
])
def test_both_backends_answer_alike(fake_pkg, kind, factory, model, name):
    """The port's and the JAX package's backends of one kind against one
    fake (the port's or JAX's): the same metadata, config, prediction
    arrays, response document and unknown-model error."""
    arr = np.random.default_rng(11).random((2, 4), dtype=np.float32)
    with getattr(FAKES[fake_pkg], factory)([model]) as fake:
        got = _answers(backend, kind, fake.url, model, name, arr)
        want = _answers(jbackend, kind, fake.url, model, name, arr)
        assert fake.request_count >= 2
    assert got == want
    assert got["unknown"] is not None


def test_rest_transport_errors_are_wrapped():
    """A refused connection is a per-request InferenceServerException
    naming the kind, the method and the URL (the reference's urllib3
    wrapping), with the transport's error as its details."""
    be = ClientBackendFactory.create(BackendKind.TORCHSERVE,
                                     url="127.0.0.1:1", input_shape=[1, 4])
    with pytest.raises(PortError) as e:
        be.server_live()
    assert e.value.message().startswith(
        "torchserve GET http://127.0.0.1:1/ping failed: ")
    assert isinstance(e.value.debug_details(), ConnectionRefusedError)
    be.close()


def _sweep(kind, model, shape):
    proc = subprocess.run(
        [sys.executable, "-m", "client_tpu_torch.perf", "-m", model,
         "--service-kind", kind, "--hermetic",
         "--shape", shape, "--concurrency-range", "1:2:1",
         "--measurement-interval", "400", "--max-trials", "4"],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Best: concurrency=" in proc.stdout


def test_perf_cli_tfserve_grpc_hermetic_sweep():
    """tests/test_backends.py::test_perf_cli_tfserve_grpc_hermetic_sweep
    with the port's CLI."""
    _sweep("tfserve", "half_plus_two", "input:1,8")


def test_perf_cli_torchserve_hermetic_sweep():
    """tests/test_backends.py::test_perf_cli_torchserve_hermetic_sweep
    with the port's CLI."""
    _sweep("torchserve", "resnet", "data:1,8")


@pytest.mark.parametrize("kind,model,shape", [
    ("torchserve", "resnet", "data:1,8"),
    ("tfserve", "half_plus_two", "input:1,8"),
    ("tfserve_rest", "half_plus_two", "instances:1,4"),
])
def test_hermetic_service_kinds_need_no_cuda(monkeypatch, capsys, kind,
                                             model, shape):
    """A hermetic non-KServe run starts only its host fake: on a machine
    without CUDA it runs without --device cpu, counts windows and stops
    its fake (the JAX CLI starts no engine there either)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stopped = []
    real_stop = fakes._FakeService.stop, fakes._FakeTfServingGrpc.stop
    monkeypatch.setattr(fakes._FakeService, "stop",
                        lambda self: (stopped.append(self), real_stop[0](self)))
    monkeypatch.setattr(fakes._FakeTfServingGrpc, "stop",
                        lambda self: (stopped.append(self), real_stop[1](self)))
    rc = main(["-m", model, "--service-kind", kind, "--hermetic",
               "--shape", shape, "--concurrency-range", "2",
               "--measurement-mode", "count_windows",
               "--measurement-request-count", "20",
               "--measurement-interval", "300", "--max-trials", "3",
               "-s", "90"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Best: concurrency=2" in out and ", 0 failed" in out
    assert len(stopped) == 1
