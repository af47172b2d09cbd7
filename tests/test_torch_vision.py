"""The port's vision models (client_tpu_torch.serve.models.vision) held
against client_tpu.serve.models.vision on the CPU.

Inputs are made from a seed with numpy; the JAX parameters are carried
across with ``convert.params_from_numpy`` (bfloat16 bit for bit, or cast
to float32 first).  Stated tolerances:

- ``_conv``, the max-pool, one bottleneck, the preprocess: float32
  everywhere, sums in another order: 1e-5 (1e-4 for the bottleneck's
  three convs and the skip);
- ``_resnet_forward`` at ``_TINY_STAGES`` and ``_cnn_forward`` with the
  parameters carried as float32: both sides round the image to bf16 once
  (as the forwards do) and compute every conv in float32; the ResNet head
  rounds the pooled features to bf16 on both sides too: 1e-5 of the
  largest score (1.1e-7 and 5.2e-7 measured);
- the same with the bfloat16 parameters, every activation rounded to
  bf16 after each op: 1e-2 of the largest score, about 2.5 bf16 ulps
  (2**-8 each) at the scale of the largest score.  Both CPU backends
  agreed bit for bit when this was written; another order of the sums
  may flip an ulp somewhere and carry it through the later convs.

``jax.lax.conv_general_dilated`` refuses operands of two dtypes, so with
float32 parameters the JAX forward runs with its ``_conv`` promoting both
operands to float32 (monkeypatched for the test): what the port's
``_conv`` does.  Every other op is the JAX package's own.
"""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import jax
import jax.numpy as jnp

from client_tpu.serve.models import vision as jvision
from client_tpu_torch import convert
from client_tpu_torch.serve.models import vision

F32_TOL = 1e-5
BLOCK_TOL = 1e-4
FORWARD_F32_TOL = 1e-5   # of the largest score
FORWARD_BF16_TOL = 1e-2  # of the largest score


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(arr):
    return torch.from_numpy(np.array(arr, copy=True))


def _np(x):
    x = x.float() if isinstance(x, torch.Tensor) else x
    return np.asarray(x, dtype=np.float32)


def _jax_tree(tree, dtype=None):
    """JAX params as numpy (optionally cast)."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a if dtype is None else a.astype(dtype)), tree)


@pytest.fixture
def promoting_jax_conv(monkeypatch):
    """JAX ``_conv`` with both operands promoted to their common type."""
    orig = jvision._conv

    def conv(x, w, stride=1):
        dt = jnp.promote_types(x.dtype, w.dtype)
        return orig(x.astype(dt), w.astype(dt), stride)

    monkeypatch.setattr(jvision, "_conv", conv)


# -- the layers ----------------------------------------------------------------


@pytest.mark.parametrize("size,k,stride", [
    (8, 3, 1), (9, 3, 1), (8, 3, 2), (9, 3, 2), (14, 7, 2), (15, 7, 2),
    (8, 1, 2), (9, 1, 1),
])
def test_conv_same_padding_matches_jax(size, k, stride):
    """``_conv`` against JAX ``_conv`` (XLA "SAME", asymmetric at stride
    2), float32, to 1e-5."""
    rng = _rng(size * 10 + k + stride)
    x = rng.standard_normal((2, 3, size, size)).astype(np.float32)
    w = rng.standard_normal((4, 3, k, k)).astype(np.float32) * 0.3
    want = np.asarray(jvision._conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = vision._conv(_t(x), _t(w), stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("size", [8, 9, 16, 112])
def test_max_pool_matches_reduce_window(size):
    """``_max_pool`` against the reference's ``reduce_window`` (3x3/2,
    SAME, -inf init): equal."""
    x = _rng(size).standard_normal((2, 4, size, size)).astype(np.float32)
    want = np.asarray(jax.lax.reduce_window(
        jnp.asarray(x), -jnp.inf, jax.lax.max,
        window_dimensions=(1, 1, 3, 3), window_strides=(1, 1, 2, 2),
        padding="SAME"))
    got = vision._max_pool(_t(x))
    np.testing.assert_array_equal(_np(got), want)


def test_same_pads_of_the_resnet_shapes():
    """The asymmetric cases: the stem 7x7/2 at 224, the 3x3/2 convs at 56,
    28 and 14, the max-pool at 112."""
    assert vision._same_pads(224, 7, 2) == (2, 3)
    for size in (56, 28, 14, 112):
        assert vision._same_pads(size, 3, 2) == (0, 1)
    assert vision._same_pads(56, 3, 1) == (1, 1)
    assert vision._same_pads(56, 1, 2) == (0, 0)


@pytest.mark.parametrize("proj,stride", [(False, 1), (True, 1), (True, 2)])
def test_bottleneck_matches_jax(proj, stride):
    """One ``_bottleneck`` (with and without ``proj``) against JAX's,
    float32, to 1e-4."""
    rng = _rng(7 + stride)
    cin, mid = (8, 4) if proj else (16, 4)
    out = mid * 4
    block = {
        "w1": rng.standard_normal((mid, cin, 1, 1)) * 0.3,
        "s1": rng.uniform(0.5, 1.5, (mid, 1, 1)),
        "w2": rng.standard_normal((mid, mid, 3, 3)) * 0.2,
        "s2": rng.uniform(0.5, 1.5, (mid, 1, 1)),
        "w3": rng.standard_normal((out, mid, 1, 1)) * 0.3,
        "s3": rng.uniform(0.5, 1.5, (out, 1, 1)),
    }
    if proj:
        block["proj"] = rng.standard_normal((out, cin, 1, 1)) * 0.3
    block = {k: v.astype(np.float32) for k, v in block.items()}
    x = rng.standard_normal((2, cin, 9, 9)).astype(np.float32)
    want = np.asarray(jvision._bottleneck(
        {k: jnp.asarray(v) for k, v in block.items()}, jnp.asarray(x),
        stride))
    got = vision._bottleneck(convert.params_from_numpy(block, "cpu"), _t(x),
                             stride)
    np.testing.assert_allclose(_np(got), want, atol=BLOCK_TOL,
                               rtol=BLOCK_TOL)


def test_preprocess_matches_jax():
    """``_preprocess_forward`` (uint8 NHWC -> normalized float32 NCHW)
    against JAX's, to 1e-5."""
    img = _rng(3).integers(0, 256, (3, 5, 7, 3), dtype=np.uint8)
    want = np.asarray(jvision._preprocess_forward(jnp.asarray(img)))
    got = vision._preprocess_forward(_t(img))
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(_np(got), want, atol=F32_TOL, rtol=F32_TOL)


# -- whole forwards -------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_resnet():
    params = jvision._init_resnet_params(
        jax.random.PRNGKey(0), num_classes=16, stages=jvision._TINY_STAGES)
    x = _rng(11).standard_normal((3, 3, 32, 32)).astype(np.float32)
    return params, x


def _tiny_strides():
    return tuple(s for _, _, s in vision._TINY_STAGES)


def _close_to_scale(got, want, tol):
    err = np.abs(_np(got) - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def test_resnet_forward_f32_params_matches_jax(tiny_resnet,
                                               promoting_jax_conv):
    """``_resnet_forward`` at ``_TINY_STAGES``, image 32, parameters
    carried as float32: 1e-5 of the largest score."""
    jparams, x = tiny_resnet
    p32 = _jax_tree(jparams, jnp.float32)
    want = np.asarray(jvision._resnet_forward(
        jax.tree_util.tree_map(jnp.asarray, p32), jnp.asarray(x),
        stage_strides=_tiny_strides()))
    got = vision._resnet_forward(convert.params_from_numpy(p32, "cpu"),
                                 _t(x), stage_strides=_tiny_strides())
    assert got.dtype == torch.float32 and got.shape == (3, 16)
    _close_to_scale(got, want, FORWARD_F32_TOL)


def test_resnet_forward_bf16_params_matches_jax(tiny_resnet):
    """The same with the bfloat16 parameters: 1e-2 of the largest score."""
    jparams, x = tiny_resnet
    want = np.asarray(jvision._resnet_forward(
        jparams, jnp.asarray(x), stage_strides=_tiny_strides()))
    got = vision._resnet_forward(
        convert.params_from_numpy(_jax_tree(jparams), "cpu"), _t(x),
        stage_strides=_tiny_strides())
    assert got.dtype == torch.float32
    _close_to_scale(got, want, FORWARD_BF16_TOL)


@pytest.fixture(scope="module")
def cnn():
    params = jvision._init_cnn_params(jax.random.PRNGKey(1))
    x = _rng(12).standard_normal((2, 3, 33, 33)).astype(np.float32)
    return params, x


def test_cnn_forward_f32_params_matches_jax(cnn, promoting_jax_conv):
    """``_cnn_forward`` at image 33 (odd: SAME pads every stride-2 conv),
    parameters carried as float32: 1e-5 of the largest score."""
    jparams, x = cnn
    p32 = _jax_tree(jparams, jnp.float32)
    want = np.asarray(jvision._cnn_forward(
        jax.tree_util.tree_map(jnp.asarray, p32), jnp.asarray(x)))
    got = vision._cnn_forward(convert.params_from_numpy(p32, "cpu"), _t(x))
    assert got.shape == (2, 1000)
    _close_to_scale(got, want, FORWARD_F32_TOL)


def test_cnn_forward_bf16_params_matches_jax(cnn):
    """The same with the bfloat16 parameters: 1e-2 of the largest score."""
    jparams, x = cnn
    want = np.asarray(jvision._cnn_forward(jparams, jnp.asarray(x)))
    got = vision._cnn_forward(
        convert.params_from_numpy(_jax_tree(jparams), "cpu"), _t(x))
    _close_to_scale(got, want, FORWARD_BF16_TOL)


# -- FLOPs, parameters, servables ----------------------------------------------


@pytest.mark.parametrize("image_size", [32, 64, 224, 225])
def test_flop_counters_equal_jax(image_size):
    assert (vision.cnn_flops_per_image(image_size)
            == jvision.cnn_flops_per_image(image_size))
    assert (vision.resnet50_flops_per_image(image_size)
            == jvision.resnet50_flops_per_image(image_size))
    assert (vision.resnet50_flops_per_image(
                image_size, num_classes=16, stages=vision._TINY_STAGES)
            == jvision.resnet50_flops_per_image(
                image_size, num_classes=16, stages=jvision._TINY_STAGES))


def _counted_flops(forward, params, image_size):
    meta = vision._place(params, torch.device("meta"))
    x = torch.zeros((1, 3, image_size, image_size), device="meta")
    with FlopCounterMode(display=False) as counter:
        forward(meta, x)
    return counter.get_total_flops()


def test_resnet50_flops_match_flop_counter():
    """The analytic count against torch's own count of the port's forward
    (on the meta device), as test_vision.py holds the JAX count against
    XLA's cost analysis: equal."""
    params = vision._init_resnet_params(torch.Generator().manual_seed(0))
    assert (_counted_flops(vision._resnet_forward, params, 64)
            == vision.resnet50_flops_per_image(64))
    cnn_params = vision._init_cnn_params(torch.Generator().manual_seed(0))
    assert (_counted_flops(vision._cnn_forward, cnn_params, 64)
            == vision.cnn_flops_per_image(64))


def test_resnet50_params_and_flops():
    # torchvision resnet50: 4.09 GMACs (= ~8.2e9 FLOPs at 2*MAC), 25.56M
    flops = vision.resnet50_flops_per_image()
    assert 8.0e9 < flops < 8.4e9
    params = vision._init_resnet_params(torch.Generator().manual_seed(0))
    leaves = jax.tree_util.tree_leaves(
        params, is_leaf=lambda t: isinstance(t, torch.Tensor))
    n = sum(t.numel() for t in leaves)
    jn = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(
        jax.eval_shape(lambda: jvision._init_resnet_params(
            jax.random.PRNGKey(0)))))
    assert n == jn and 25.0e6 < n < 26.0e6
    assert all(t.dtype == torch.bfloat16 for t in leaves)


def test_servables_match_the_reference_specs(monkeypatch):
    """``cnn_classifier_model`` and ``resnet50_model`` carry the
    reference's tensor specs, labels and batching fields (platform and
    backend name torch).  The JAX runners are not built: only their
    Models' fields are read."""
    monkeypatch.setattr(jvision, "CnnClassifier", lambda image_size: None)
    monkeypatch.setattr(jvision, "ResNet50Classifier",
                        lambda image_size: None)
    fields = ("max_batch_size", "dynamic_batching", "batch_device_inputs",
              "fused_batching", "max_fused_arity", "flops_per_item")
    for ours, theirs in (
            (vision.cnn_classifier_model(image_size=32, device="cpu"),
             jvision.cnn_classifier_model(image_size=32)),
            (vision.resnet50_model(image_size=32, device="cpu"),
             jvision.resnet50_model(image_size=32))):
        for f in fields:
            assert getattr(ours, f) == getattr(theirs, f), f
        for a, b in zip(ours.inputs + ours.outputs,
                        theirs.inputs + theirs.outputs):
            assert (a.name, a.datatype, a.dims, a.labels) == (
                b.name, b.datatype, b.dims, b.labels)
        assert ours.platform == ours.backend == "torch"
        cfg = ours.config()
        assert int(cfg["parameters"]["flops_per_item"]["string_value"]) == (
            ours.flops_per_item)
        assert cfg["dynamic_batching"] == theirs.config()["dynamic_batching"]


def test_pipeline_servables_match_the_reference_specs():
    ours = vision.vision_pipeline_models(device="cpu")
    theirs = jvision.vision_pipeline_models()
    for a, b in zip(ours, theirs):
        assert a.name == b.name
        assert a.ensemble_steps == b.ensemble_steps
        for f in ("max_batch_size", "dynamic_batching",
                  "batch_device_inputs", "fused_batching"):
            assert getattr(a, f) == getattr(b, f), (a.name, f)
        for x, y in zip(a.inputs + a.outputs, b.inputs + b.outputs):
            assert (x.name, x.datatype, x.dims, x.labels) == (
                y.name, y.datatype, y.dims, y.labels)


def test_classifier_runs_on_the_cpu_when_asked():
    m = vision.cnn_classifier_model(image_size=32, device="cpu")
    x = _rng(5).standard_normal((2, 3, 32, 32)).astype(np.float32)
    out = m.fn({"INPUT0": x}, {}, None)["OUTPUT0"]
    assert out.shape == (2, 1000) and out.dtype == torch.float32
    assert torch.isfinite(out).all()


def test_cnn_served_over_http_through_the_batcher():
    """The CNN (image 32) behind Server on the CPU: concurrent batch-1
    binary requests go through the dynamic batcher's bucket programs and
    each answer equals the eager forward of its image within 1e-2 of the
    largest score (bf16, at another batch size)."""
    import json
    import threading
    import urllib.request

    from client_tpu_torch.serve import Server
    from client_tpu_torch.utils import to_wire_bytes

    model = vision.cnn_classifier_model(image_size=32, max_batch_size=8,
                                        warmup=True, device="cpu")
    images = _rng(9).standard_normal((6, 1, 3, 32, 32)).astype(np.float32)
    want = [model.fn({"INPUT0": x}, {}, None)["OUTPUT0"].numpy()
            for x in images]
    got = [None] * len(images)
    with Server(models=[model], http_port=0,
                with_default_models=False) as server:
        def run(i):
            raw = to_wire_bytes(images[i], "FP32")
            header = json.dumps({
                "inputs": [{"name": "INPUT0", "shape": [1, 3, 32, 32],
                            "datatype": "FP32",
                            "parameters": {"binary_data_size": len(raw)}}],
                "outputs": [{"name": "OUTPUT0",
                             "parameters": {"binary_data": True}}],
            }).encode()
            req = urllib.request.Request(
                f"http://{server.http_address}/v2/models/cnn_classifier/"
                "infer", data=header + raw,
                headers={"Inference-Header-Content-Length": str(len(header))})
            with urllib.request.urlopen(req, timeout=60) as resp:
                body = resp.read()
                n = int(resp.headers["Inference-Header-Content-Length"])
            got[i] = np.frombuffer(body[n:], dtype=np.float32).reshape(1, -1)

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(images))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = server.engine.statistics("cnn_classifier")[0]
    for g, w in zip(got, want):
        _close_to_scale(g, w, FORWARD_BF16_TOL)
    assert stats["inference_count"] == len(images)
    assert 1 <= stats["execution_count"] <= len(images)


def test_cnn_classification_matches_the_jax_server(cnn, promoting_jax_conv):
    """The classification extension on ``cnn_classifier`` (the fault the
    port had: it answered the FP32 scores): the same ``classification: 3``
    request to both servers, the JAX CNN's parameters carried as float32
    into both, returns BYTES [1, 3] with the same top-3 indices and labels
    and scores within 1e-4 relative."""
    import json
    import urllib.request

    from client_tpu.serve import Server as JaxServer
    from client_tpu_torch.serve import Server

    jparams, _ = cnn
    p32 = _jax_tree(jparams, jnp.float32)
    jmodel = jvision.cnn_classifier_model(image_size=32, max_batch_size=8)
    jmodel.fn.params = jax.tree_util.tree_map(jnp.asarray, p32)
    model = vision.cnn_classifier_model(image_size=32, max_batch_size=8,
                                        device="cpu")
    model.fn.params = convert.params_from_numpy(p32, "cpu")
    x = _rng(21).standard_normal((1, 3, 32, 32)).astype(np.float32)
    body = json.dumps({
        "inputs": [{"name": "INPUT0", "shape": [1, 3, 32, 32],
                    "datatype": "FP32", "data": x.ravel().tolist()}],
        "outputs": [{"name": "OUTPUT0",
                     "parameters": {"classification": 3}}]}).encode()
    answers = {}
    with JaxServer(models=[jmodel], with_default_models=False) as js, \
            Server(models=[model], with_default_models=False) as ts:
        for name, srv in (("jax", js), ("torch", ts)):
            req = urllib.request.Request(
                f"http://{srv.http_address}/v2/models/cnn_classifier/infer",
                data=body, headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                answers[name] = json.loads(resp.read())["outputs"][0]
    for out in answers.values():
        assert out["datatype"] == "BYTES" and out["shape"] == [1, 3]
    got = [s.split(":") for s in answers["torch"]["data"]]
    want = [s.split(":") for s in answers["jax"]["data"]]
    assert [g[1:] for g in got] == [w[1:] for w in want]
    assert got[0][2] == f"class_{got[0][1]}"
    np.testing.assert_allclose([float(g[0]) for g in got],
                               [float(w[0]) for w in want], rtol=1e-4)
