"""The port's builtin model set (client_tpu_torch.serve.builtins) and the
classification extension held against client_tpu's, on the CPU.

The port's ``Server(device="cpu")`` serves the builtin set by default, as
the JAX ``Server()`` does.  The cases of tests/test_http_client.py that
need these models run unchanged against it with the JAX package's own
HTTP client (``client_tpu.http``): the classes below subclass the JAX
test classes, so each case is the JAX test's own body, answered by the
port's server.  The remaining tests send the same requests to both
servers and compare the answers: exact for the numpy models (the same
numpy arithmetic on both sides), and the classification strings letter
for letter.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

import client_tpu.http as httpclient
import test_http_client as jhc
from client_tpu.serve import Server as JaxServer
from client_tpu.serve.builtins import default_models as jax_default_models
from client_tpu.utils import shared_memory as jsysshm
from client_tpu_torch.serve import Server
from client_tpu_torch.serve.builtins import default_models
from client_tpu_torch.serve.model_runtime import SERVER_EXTENSIONS
from client_tpu_torch.serve.models import model_sets


@pytest.fixture(scope="module")
def server():
    with Server(device="cpu") as s:
        yield s


@pytest.fixture(scope="module")
def client(server):
    with httpclient.InferenceServerClient(server.http_address,
                                          concurrency=4) as c:
        yield c


@pytest.fixture(scope="module")
def jax_server():
    with JaxServer() as s:
        yield s


def _post(addr, model, body):
    req = urllib.request.Request(
        f"http://{addr}/v2/models/{model}/infer",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _strip(response):
    return {k: v for k, v in response.items() if k != "id"}


# -- tests/test_http_client.py against the port's server -----------------------


class TestHealthPort(jhc.TestHealth):
    """tests/test_http_client.py::TestHealth (``simple`` ready)."""


class TestInferPort(jhc.TestInfer):
    """tests/test_http_client.py::TestInfer: ``simple``, ``identity``,
    ``identity_bytes`` and ``classifier`` (``test_classification``)."""


class TestAsyncInferPort(jhc.TestAsyncInfer):
    """tests/test_http_client.py::TestAsyncInfer on ``simple``."""


class TestMetadataPort:
    """tests/test_http_client.py::TestMetadata; the server metadata names
    the port and its extensions."""

    test_model_metadata = jhc.TestMetadata.test_model_metadata
    test_model_config = jhc.TestMetadata.test_model_config
    test_unknown_model = jhc.TestMetadata.test_unknown_model

    def test_server_metadata(self, client):
        meta = client.get_server_metadata()
        assert meta["name"] == "client_tpu_torch.serve"
        for ext in ("binary_tensor_data", "classification", "sequence",
                    "cuda_shared_memory"):
            assert ext in meta["extensions"]
        assert meta["extensions"] == SERVER_EXTENSIONS


class TestManagementPort:
    """tests/test_http_client.py::TestManagement's cases on the builtin
    models."""

    test_repository_index = jhc.TestManagement.test_repository_index
    test_load_unload = jhc.TestManagement.test_load_unload
    test_statistics = jhc.TestManagement.test_statistics
    test_all_statistics = jhc.TestManagement.test_all_statistics
    test_load_with_config_override = \
        jhc.TestManagement.test_load_with_config_override


# -- the same requests to both servers ----------------------------------------


def test_builtin_set_is_the_reference_set():
    """model_sets("builtin") and default_models name client_tpu's builtin
    models, with the same specs (the vision pipeline's included)."""
    want = jax_default_models()
    for got in (default_models(device="cpu"),
                model_sets("builtin", device="cpu")):
        assert [m.name for m in got] == [m.name for m in want]
        for g, w in zip(got, want):
            assert g.max_batch_size == w.max_batch_size
            assert g.decoupled == w.decoupled and g.stateful == w.stateful
            assert g.ensemble_steps == w.ensemble_steps
            for x, y in zip(g.inputs + g.outputs, w.inputs + w.outputs,
                            strict=True):
                assert (x.name, x.datatype, x.dims, x.labels) == (
                    y.name, y.datatype, y.dims, y.labels)


def test_server_default_models_follow_the_reference():
    """Server() serves the builtin set beside the models it is given, and
    with_default_models=False only those."""
    from client_tpu_torch.serve.builtins import identity_model

    extra = identity_model("extra", "FP32")
    with Server(models=[extra], device="cpu") as s:
        names = {m["name"] for m in s.engine.repository_index()}
    assert "extra" in names and "simple" in names and "vision_pipeline" \
        in names
    with Server(models=[identity_model("extra", "FP32")],
                with_default_models=False) as s:
        names = {m["name"] for m in s.engine.repository_index()}
    assert names == {"extra"}


def test_simple_ensemble_matches_jax(server, jax_server):
    """simple_ensemble (simple -> identity_int32 twice) answers as the JAX
    server's, and each composing model counts the request."""
    rng = np.random.default_rng(0)
    a, b = (rng.integers(-100, 100, (2, 16)).astype(np.int32)
            for _ in range(2))
    body = {"inputs": [
        {"name": "INPUT0", "shape": [2, 16], "datatype": "INT32",
         "data": a.ravel().tolist()},
        {"name": "INPUT1", "shape": [2, 16], "datatype": "INT32",
         "data": b.ravel().tolist()}]}
    got = _post(server.http_address, "simple_ensemble", body)
    want = _post(jax_server.http_address, "simple_ensemble", body)
    assert got == want
    out = {o["name"]: o["data"] for o in got["outputs"]}
    assert out["OUTPUT0"] == (a + b).ravel().tolist()
    assert out["OUTPUT1"] == (a - b).ravel().tolist()
    stats = {s["name"]: s for s in server.engine.statistics()}
    assert stats["simple"]["inference_count"] >= 2
    assert stats["identity_int32"]["execution_count"] >= 2


@pytest.mark.parametrize("n", [1, 5])
def test_repeat_int32_streams_match_jax(server, jax_server, n):
    """repeat_int32 (decoupled) streams n responses 0..n-1 through
    engine.execute, as the JAX server's does; n=1 over HTTP too."""
    body = {"inputs": [{"name": "IN", "shape": [1], "datatype": "INT32",
                        "data": [n]}]}
    got = [_strip(r[0]) for r in
           server.engine.execute("repeat_int32", "", body, b"")]
    want = [_strip(r[0]) for r in
            jax_server.engine.execute("repeat_int32", "", body, b"")]
    assert got == want
    assert [r["outputs"][0]["data"] for r in got] == [[i] for i in range(n)]
    if n == 1:
        assert _post(server.http_address, "repeat_int32", body) == \
            _post(jax_server.http_address, "repeat_int32", body)


@pytest.mark.parametrize("class_count", [1, 3, 9])
def test_classifier_classification_matches_jax(server, jax_server,
                                               class_count):
    """The classification extension on ``classifier``: the JAX server's
    "score:index:label" strings letter for letter (top-N by
    np.argsort(...)[::-1], N capped at the class count)."""
    x = np.array([[0.1, 3.0, 0.5, 1.0], [2.0, -1.0, 2.5, 0.0]], np.float32)
    body = {"inputs": [{"name": "INPUT0", "shape": [2, 4],
                        "datatype": "FP32", "data": x.ravel().tolist()}],
            "outputs": [{"name": "OUTPUT0",
                         "parameters": {"classification": class_count}}]}
    got = _post(server.http_address, "classifier", body)
    want = _post(jax_server.http_address, "classifier", body)
    assert got == want
    out = got["outputs"][0]
    assert out["datatype"] == "BYTES"
    assert out["shape"] == [2, min(class_count, 4)]
    assert out["data"][0].split(":")[1:] == ["1", "dog"]


def test_classified_output_in_a_system_region_matches_jax(server,
                                                          jax_server):
    """A classified output bound to a system shared-memory region: both
    servers write the same serialized BYTES into it."""
    x = np.array([[0.1, 3.0, 0.5, 1.0]], np.float32)
    answers = {}
    for name, srv in (("torch", server), ("jax", jax_server)):
        key = f"/ctpu_torch_builtins_{name}_{os.getpid()}"
        region = jsysshm.create_shared_memory_region(f"cls_{name}", key, 256)
        try:
            with httpclient.InferenceServerClient(srv.http_address) as c:
                c.register_system_shared_memory(f"cls_{name}", key, 256)
                inp = httpclient.InferInput("INPUT0", [1, 4], "FP32")
                inp.set_data_from_numpy(x)
                out = httpclient.InferRequestedOutput("OUTPUT0",
                                                      class_count=2)
                out.set_shared_memory(f"cls_{name}", 256)
                result = c.infer("classifier", [inp], outputs=[out])
                entry = result.get_output("OUTPUT0")
                size = entry["parameters"]["shared_memory_byte_size"]
                raw = bytes(jsysshm.get_contents_as_numpy(
                    region, np.uint8, [size]))
                answers[name] = (entry["datatype"], entry["shape"], raw)
                c.unregister_system_shared_memory(f"cls_{name}")
        finally:
            jsysshm.destroy_shared_memory_region(region)
    assert answers["torch"] == answers["jax"]
    assert answers["torch"][0] == "BYTES" and answers["torch"][1] == [1, 2]


def test_simple_string_matches_jax(server, jax_server):
    """simple_string (BYTES add/sub on string-encoded integers)."""
    a = [str(i) for i in range(16)]
    b = [str(2 * i - 7) for i in range(16)]
    body = {"inputs": [
        {"name": "INPUT0", "shape": [1, 16], "datatype": "BYTES", "data": a},
        {"name": "INPUT1", "shape": [1, 16], "datatype": "BYTES", "data": b}]}
    got = _post(server.http_address, "simple_string", body)
    assert got == _post(jax_server.http_address, "simple_string", body)
    out = {o["name"]: o["data"] for o in got["outputs"]}
    assert out["OUTPUT0"] == [str(int(x) + int(y)) for x, y in zip(a, b)]


def test_vision_pipeline_builtin_answers():
    """The builtin tiny vision pipeline on the port's server: SCORES of
    shape [N, 16] that sum to 1 a row (a softmax)."""
    with Server(device="cpu") as s:
        img = np.random.default_rng(3).integers(
            0, 256, (2, 32, 32, 3)).astype(np.uint8)
        out = _post(s.http_address, "vision_pipeline", {"inputs": [{
            "name": "IMAGE", "shape": [2, 32, 32, 3], "datatype": "UINT8",
            "data": img.ravel().tolist()}]})["outputs"][0]
    scores = np.array(out["data"], np.float32).reshape(out["shape"])
    assert out["shape"] == [2, 16]
    np.testing.assert_allclose(scores.sum(axis=1), 1.0, rtol=1e-5)


def test_unknown_set_names_builtin():
    with pytest.raises(Exception, match="builtin"):
        model_sets("no_such_set", device="cpu")


def test_http_error_on_missing_builtin_input(server):
    """A request missing an input answers 400, as on the JAX server."""
    body = {"inputs": [{"name": "INPUT0", "shape": [1, 16],
                        "datatype": "INT32", "data": [0] * 16}]}
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server.http_address, "simple", body)
    assert e.value.code == 400
