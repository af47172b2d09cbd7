"""The direct path on the batcher's bucket program, held against the
batched path and the JAX server, on the CPU.

A request that is not batched (a host request with shared-memory outputs,
one with request parameters) reaches the model on the direct path.  The
JAX server's direct path calls the same ``jax.jit`` executable its batcher
calls (client_tpu/serve/models/vision.py); the port's calls the same
``_BucketProgram`` its batcher calls (``ModelBatcher.run_direct``): on the
card a CUDA graph replay, here the forward run through the program's
static buffers.  These tests count that route on a tiny ResNet (the
served ResNet-50 at ``_TINY_STAGES``, image 32) and the CNN: every
forward a direct request causes receives a program's static inputs, and
the batcher's ``direct_runs`` counts each such request once.

Stated tolerances: a direct answer equals the batched answer for the same
image bit for bit (the same bucket program on the same values); against
the JAX server's answer to the same request, from the same weights carried
across with ``convert.params_from_numpy``, within ``FORWARD_BF16_TOL``
(1e-2) of the largest score, as tests/test_torch_vision.py holds the two
forwards.
"""

import os
import threading

import jax
import numpy as np
import pytest

import client_tpu.http as jhttp
from client_tpu.serve import Server as JaxServer
from client_tpu.serve.models import vision as jvision
from client_tpu_torch import convert
from client_tpu_torch.serve import Server
from client_tpu_torch.serve.model_runtime import Model, TensorSpec
from client_tpu_torch.serve.models import vision
from client_tpu_torch.utils import cuda_shared_memory as cudashm
from client_tpu_torch.utils import shared_memory as sysshm

FORWARD_BF16_TOL = 1e-2  # of the largest score (tests/test_torch_vision.py)
IMAGE = 32
MAX_BATCH = 8
IMAGE_BYTES = 3 * IMAGE * IMAGE * 4
SCORE_BYTES = 1000 * 4
MODELS = ("resnet50", "cnn_classifier")


def _images(n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, 1, 3, IMAGE, IMAGE)).astype(np.float32)


def _jax_models():
    """The JAX CNN, and the JAX ResNet-50 servable with tiny-stage
    parameters (its full-depth parameters are never made)."""
    resnet = object.__new__(jvision.ResNet50Classifier)
    resnet.image_size = IMAGE
    resnet.params = jvision._init_resnet_params(
        jax.random.PRNGKey(0), stages=jvision._TINY_STAGES)
    resnet._forward = jax.jit(jvision._resnet_forward)
    orig = jvision.ResNet50Classifier
    jvision.ResNet50Classifier = lambda image_size: resnet
    try:
        jres = jvision.resnet50_model(image_size=IMAGE,
                                      max_batch_size=MAX_BATCH)
    finally:
        jvision.ResNet50Classifier = orig
    jcnn = jvision.cnn_classifier_model(image_size=IMAGE,
                                        max_batch_size=MAX_BATCH)
    return [jres, jcnn]


def _carried(jmodel):
    return convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jmodel.fn.params), "cpu")


class _Spy:
    """``model.fn`` with every call's inputs dict kept, so a test tells a
    forward run through a program's static buffers from an eager one."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = []
        self.lock = threading.Lock()

    def __call__(self, inputs, params, ctx):
        with self.lock:
            self.calls.append(inputs)
        return self.fn(inputs, params, ctx)


@pytest.fixture(scope="module")
def servers():
    """(port server, JAX server, {name: spy}): both serve the tiny ResNet
    and the CNN at image 32 from the same parameters."""
    jmodels = _jax_models()
    ours = [vision.resnet50_model(image_size=IMAGE, max_batch_size=MAX_BATCH,
                                  device="cpu"),
            vision.cnn_classifier_model(image_size=IMAGE,
                                        max_batch_size=MAX_BATCH,
                                        device="cpu")]
    spies = {}
    for model, jmodel in zip(ours, jmodels):
        model.fn.params = _carried(jmodel)
        spies[model.name] = model.fn = _Spy(model.fn)
    with Server(models=ours, http_port=0, with_default_models=False) as s, \
            JaxServer(models=jmodels, with_default_models=False) as js:
        yield s, js, spies


@pytest.fixture()
def clients(servers):
    s, js, _ = servers
    ours = jhttp.InferenceServerClient(s.http_address)
    theirs = jhttp.InferenceServerClient(js.http_address)
    yield ours, theirs
    for c in (ours, theirs):
        c.unregister_system_shared_memory()
        c.close()


def _batcher(server, name):
    return server.engine._batchers[name]


def _eager_calls(server, spy, name, since):
    """The forwards since call *since* that did not run through one of
    the model's programs."""
    static = [p.inputs for p in _batcher(server, name)._programs.values()]
    return [c for c in spy.calls[since:]
            if not any(c is inputs for inputs in static)]


def _input(x, region=None):
    inp = jhttp.InferInput("INPUT0", list(x.shape), "FP32")
    if region is None:
        inp.set_data_from_numpy(x, binary_data=True)
    else:
        inp.set_shared_memory(region, x.nbytes)
    return inp


def _wire(client, name, x, **kw):
    out = jhttp.InferRequestedOutput("OUTPUT0", binary_data=True)
    return client.infer(name, [_input(x)], outputs=[out],
                        **kw).as_numpy("OUTPUT0")


class _Region:
    """A system region for one request's scores, registered on a
    client's server."""

    def __init__(self, client, tag, rows=1):
        self.name = f"direct_{tag}"
        self.key = f"/ctpu_torch_direct_{tag}_{os.getpid()}"
        self.rows = rows
        self.h = sysshm.create_shared_memory_region(
            self.name, self.key, rows * SCORE_BYTES)
        client.register_system_shared_memory(self.name, self.key,
                                             rows * SCORE_BYTES)

    def infer(self, client, name, x, **kw):
        out = jhttp.InferRequestedOutput("OUTPUT0")
        out.set_shared_memory(self.name, self.rows * SCORE_BYTES)
        client.infer(name, [_input(x)], outputs=[out], **kw)
        return sysshm.get_contents_as_numpy(self.h, np.float32,
                                            [self.rows, 1000])

    def close(self):
        sysshm.destroy_shared_memory_region(self.h)


def _close_to_scale(got, want):
    err = np.abs(got - want).max()
    assert err <= FORWARD_BF16_TOL * np.abs(want).max(), (
        err, np.abs(want).max())


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("rows", [1, 3])
def test_shm_output_request_runs_the_bucket_program(servers, clients, name,
                                                    rows):
    """A host request with a system-shm output (the reference's direct
    path) runs through the program: one ``direct_runs`` a request and no
    eager forward.  Its scores equal the batched answer's bit for bit
    and the JAX server's within the stated tolerance."""
    s, _, spies = servers
    ours, theirs = clients
    x = _images(1, seed=rows)[0].repeat(rows, axis=0)
    x[1:] *= 0.5
    batched = _wire(ours, name, x)
    batcher = _batcher(s, name)
    runs = batcher.graph_stats()["direct_runs"]
    since = len(spies[name].calls)
    region = _Region(ours, f"{name}_{rows}", rows)
    jregion = _Region(theirs, f"jax_{name}_{rows}", rows)
    try:
        got = region.infer(ours, name, x)
        want = jregion.infer(theirs, name, x)
    finally:
        region.close()
        jregion.close()
    assert batcher.graph_stats()["direct_runs"] == runs + 1
    assert len(spies[name].calls) == since + 1  # the program's one run
    assert _eager_calls(s, spies[name], name, since) == []
    np.testing.assert_array_equal(got, batched)
    _close_to_scale(got, want)


@pytest.mark.parametrize("name", MODELS)
def test_request_with_parameter_runs_the_bucket_program(servers, clients,
                                                        name):
    """A request parameter keeps the request off the batcher (the
    reference's rule) and reaches the same outputs through the program;
    the JAX server's within the stated tolerance."""
    s, _, spies = servers
    ours, theirs = clients
    x = _images(1, seed=7)[0]
    batched = _wire(ours, name, x)
    runs = _batcher(s, name).graph_stats()["direct_runs"]
    since = len(spies[name].calls)
    got = _wire(ours, name, x, parameters={"tag": "direct"})
    assert _batcher(s, name).graph_stats()["direct_runs"] == runs + 1
    assert _eager_calls(s, spies[name], name, since) == []
    np.testing.assert_array_equal(got, batched)
    _close_to_scale(got, _wire(theirs, name, x, parameters={"tag": "direct"}))


@pytest.mark.parametrize("name", MODELS)
def test_cuda_region_input_with_parameter_runs_the_bucket_program(
        servers, clients, name):
    """A request whose input lies in a CUDA-shm region (here made with
    ``device="cpu"``: a tensor, as a card's region is) and that carries a
    parameter takes the program's device route: one ``direct_runs``, no
    eager forward, scores bit-equal to the batched answer for the same
    image and the JAX server's within the stated tolerance."""
    s, _, spies = servers
    ours, theirs = clients
    x = _images(1, seed=11)[0]
    batched = _wire(ours, name, x)
    tag = f"direct_cuda_in_{name}"
    h = cudashm.create_shared_memory_region(tag, IMAGE_BYTES, device="cpu")
    runs = _batcher(s, name).graph_stats()["direct_runs"]
    since = len(spies[name].calls)
    try:
        cudashm.set_shared_memory_region(h, [x])
        ours.register_cuda_shared_memory(tag, cudashm.get_raw_handle(h), 0,
                                         IMAGE_BYTES)
        out = jhttp.InferRequestedOutput("OUTPUT0", binary_data=True)
        got = ours.infer(name, [_input(x, tag)], outputs=[out],
                         parameters={"tag": "direct"}).as_numpy("OUTPUT0")
    finally:
        ours.unregister_cuda_shared_memory(tag)
        cudashm.destroy_shared_memory_region(h)
    assert _batcher(s, name).graph_stats()["direct_runs"] == runs + 1
    assert len(spies[name].calls) == since + 1  # the program's one run
    assert _eager_calls(s, spies[name], name, since) == []
    np.testing.assert_array_equal(got, batched)
    _close_to_scale(got, _wire(theirs, name, x))


def _classes(result):
    """[(score, index, label)] of a classified output's one row."""
    out = []
    for entry in result.as_numpy("OUTPUT0").reshape(-1):
        score, index, label = entry.decode().split(":")
        out.append((float(score), int(index), label))
    return out


@pytest.mark.parametrize("name", MODELS)
def test_classified_output_on_the_direct_path(servers, clients, name):
    """An output's ``classification`` parameter on a direct request: the
    same classes as the batched request's, in order with equal scores, and
    the JAX server's top class with its score within the tolerance."""
    s, _, spies = servers
    ours, theirs = clients
    x = _images(1, seed=11)[0]

    def classified(client, **kw):
        out = jhttp.InferRequestedOutput("OUTPUT0", class_count=3)
        return _classes(client.infer(name, [_input(x)], outputs=[out], **kw))

    batched = classified(ours)
    runs = _batcher(s, name).graph_stats()["direct_runs"]
    since = len(spies[name].calls)
    got = classified(ours, parameters={"tag": "direct"})
    assert _batcher(s, name).graph_stats()["direct_runs"] == runs + 1
    assert _eager_calls(s, spies[name], name, since) == []
    assert got == batched
    want = classified(theirs, parameters={"tag": "direct"})
    scores = _wire(ours, name, x)
    assert got[0][1] == want[0][1]
    assert abs(got[0][0] - want[0][0]) <= (
        FORWARD_BF16_TOL * np.abs(scores).max())


def test_rows_beyond_the_largest_bucket_call_fn(servers, clients):
    """A request with more rows than ``max_batch_size`` fits no bucket:
    it calls the model's forward on its own arrays, as before, and
    agrees with the batched rows."""
    s, _, spies = servers
    ours, _ = clients
    x = np.concatenate([_images(1, seed=20 + i)[0]
                        for i in range(MAX_BATCH + 1)])
    runs = _batcher(s, "cnn_classifier").graph_stats()["direct_runs"]
    since = len(spies["cnn_classifier"].calls)
    got = _wire(ours, "cnn_classifier", x)
    assert _batcher(s, "cnn_classifier").graph_stats()["direct_runs"] == runs
    assert len(_eager_calls(s, spies["cnn_classifier"], "cnn_classifier",
                            since)) == 1
    row = _wire(ours, "cnn_classifier", x[:1])
    np.testing.assert_allclose(got[:1], row, atol=1e-2 * np.abs(row).max())


def test_model_with_response_parameters_keeps_fn():
    """A model that sets per-response parameters is not fused, so its
    direct request calls ``fn`` and its parameters reach the response,
    and no bucket program is built for it."""
    calls = []

    def fn(inputs, params, ctx):
        calls.append(params)
        return {"OUT": np.asarray(inputs["IN"]) * 2,
                "__parameters__": {"scale": 2}}

    model = Model("echo2", [TensorSpec("IN", "FP32", [-1, 4])],
                  [TensorSpec("OUT", "FP32", [-1, 4])], fn,
                  max_batch_size=8, dynamic_batching=True)
    with Server(models=[model], http_port=0, with_default_models=False,
                device="cpu") as s:
        c = jhttp.InferenceServerClient(s.http_address)
        x = np.arange(8, dtype=np.float32).reshape(2, 4)
        inp = jhttp.InferInput("IN", [2, 4], "FP32")
        inp.set_data_from_numpy(x)
        res = c.infer("echo2", [inp], parameters={"tag": "direct"})
        c.close()
        np.testing.assert_array_equal(res.as_numpy("OUT"), x * 2)
        assert res.get_response()["parameters"] == {"scale": 2}
        assert calls[-1]["tag"] == "direct"
        batcher = s.engine._batchers.get("echo2")
        assert batcher is None or batcher._programs == {}


@pytest.mark.parametrize("name", MODELS)
def test_direct_and_batched_requests_at_once(servers, name):
    """Two threads, one sending direct requests (system-shm outputs) and
    one batched requests, each of its own images, at once: every answer
    equals that image's answer sent alone (the program's lock keeps one
    owner of the static buffers at a time)."""
    s, _, _ = servers
    images = _images(6, seed=30)
    alone = {}
    c = jhttp.InferenceServerClient(s.http_address)
    for i, x in enumerate(images):
        alone[i] = _wire(c, name, x)
    c.close()
    errors, got = [], {}

    def direct():
        cl = jhttp.InferenceServerClient(s.http_address)
        region = _Region(cl, f"threads_{name}")
        try:
            for _ in range(4):
                for i in range(0, 6, 2):
                    got[("d", i, _)] = region.infer(cl, name, images[i])
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)
        finally:
            region.close()
            cl.unregister_system_shared_memory()
            cl.close()

    def batched():
        cl = jhttp.InferenceServerClient(s.http_address)
        try:
            for _ in range(4):
                for i in range(1, 6, 2):
                    got[("b", i, _)] = _wire(cl, name, images[i])
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(e)
        finally:
            cl.close()

    runs = _batcher(s, name).graph_stats()["direct_runs"]
    threads = [threading.Thread(target=direct),
               threading.Thread(target=batched)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(got) == 24
    for (_, i, _), scores in got.items():
        np.testing.assert_array_equal(scores, alone[i])
    assert _batcher(s, name).graph_stats()["direct_runs"] == runs + 12
