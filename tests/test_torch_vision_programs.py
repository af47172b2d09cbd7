"""The vision pipeline's step programs (client_tpu_torch/serve/models/
vision.py, ``_StepPrograms``) against their plain functions and against
the JAX runners' jitted ``_pre``, ``_features`` and ``_head``
(client_tpu/serve/models/vision.py), at the tiny pipeline (32 px,
``_TINY_STAGES``, 16 classes) on weights carried from the JAX runners.

On the CPU a step's program runs its body eagerly on its static buffers;
the card's counterpart (the CUDA graphs) is in tests/test_torch_cuda.py.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.serve.models import vision as jvision
from client_tpu_torch import convert
from client_tpu_torch.serve.dynamic_batcher import _buckets_up_to
from client_tpu_torch.serve.model_runtime import InferenceEngine
from client_tpu_torch.serve.models import vision

IMAGE = 32
STEPS = ("preprocess", "backbone", "postprocess")
# the pipeline tests' tolerance for bf16 activations (test_torch_pipeline)
SCORES_ATOL = 1e-2
PIXELS_ATOL = 1e-6  # the float32 preprocess


@pytest.fixture(scope="module")
def runners():
    """The JAX runners and the port's on the JAX runners' bf16 weights."""
    theirs = jvision.vision_pipeline_models()[1].fn.__self__
    ours = vision.vision_pipeline_models(device="cpu")[1].fn.__self__
    ours.params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, theirs._ensure()), "cpu")
    return theirs, ours


def _images(rows, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (rows, IMAGE, IMAGE, 3), dtype=np.uint8)


def _step_input(ours, step, rows, seed):
    """A seeded input of ``step`` at ``rows``: images, or the pixels or
    features the plain functions make of them."""
    x = torch.from_numpy(_images(rows, seed))
    if step == "preprocess":
        return x
    x = vision._preprocess_forward(x)
    if step == "backbone":
        return x
    return _plain(ours, "backbone", x)


def _plain(ours, step, x):
    """The eager composition a step's program must equal bit for bit."""
    if step == "preprocess":
        return vision._preprocess_forward(x)
    if step == "backbone":
        return vision._resnet_features(ours.params, x,
                                       stage_strides=ours.strides).float()
    return torch.softmax(vision._resnet_head(ours.params, x), dim=-1)


def _run(ours, step, x):
    name = {"preprocess": "IMAGE", "backbone": "PIXELS",
            "postprocess": "FEATURES"}[step]
    out = getattr(ours, step)({name: x}, {}, None)
    return next(iter(out.values()))


@pytest.mark.parametrize("rows", [1, 3, 5])
@pytest.mark.parametrize("step", STEPS)
def test_step_program_equals_its_plain_function(runners, step, rows):
    """Each step through its program against its plain function
    (``_preprocess_forward``, ``_resnet_features`` then the float32
    cast, ``_resnet_head`` then the softmax): bit for bit."""
    _, ours = runners
    x = _step_input(ours, step, rows, seed=rows)
    got = _run(ours, step, x)
    assert torch.equal(got, _plain(ours, step, x))


@pytest.mark.parametrize("step", STEPS)
def test_step_matches_the_jax_jit(runners, step):
    """Each step against the JAX runners' jitted step on the same seeded
    numpy input: ``_pre`` within 1e-6 (float32), ``_features`` (cast to
    float32) and ``_head`` then the softmax within the pipeline's 1e-2
    (bf16 activations)."""
    theirs, ours = runners
    img = _images(3, seed=7)
    pixels = np.asarray(theirs._pre(jnp.asarray(img)))
    feats = np.asarray(theirs._features(theirs._ensure(),
                                        jnp.asarray(pixels)).astype(
                                            jnp.float32))
    if step == "preprocess":
        want, x, atol = pixels, img, PIXELS_ATOL
    elif step == "backbone":
        want, x, atol = feats, pixels, SCORES_ATOL
    else:
        want = np.asarray(jax.nn.softmax(
            theirs._head(theirs._ensure(), jnp.asarray(feats)), axis=-1))
        x, atol = feats, SCORES_ATOL
    got = _run(ours, step, x).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("step", STEPS)
def test_returned_tensor_survives_the_next_call(runners, step):
    """A step returns a copy of its static output: a second call at the
    same shape with other inputs leaves the first result as it was
    (reference: the plain function on the first input)."""
    _, ours = runners
    x1 = _step_input(ours, step, 3, seed=11)
    x2 = _step_input(ours, step, 3, seed=12)
    first = _run(ours, step, x1)
    kept = first.clone()
    second = _run(ours, step, x2)
    assert torch.equal(first, kept)
    assert torch.equal(first, _plain(ours, step, x1))
    assert not torch.equal(first, second)


def _threads_get_their_own_rows(ours, step, rows):
    """Four threads calling ``step`` at once, thread i at ``rows[i]``
    with its own input, five times each: whether each got the plain
    function of its own input every time."""
    inputs = [_step_input(ours, step, r, seed=20 + i)
              for i, r in enumerate(rows)]
    want = [_plain(ours, step, x) for x in inputs]
    results, errors = [None] * 4, []
    start = threading.Barrier(4)

    def worker(i):
        try:
            start.wait(timeout=30)
            for _ in range(5):
                got = _run(ours, step, inputs[i])
                if not torch.equal(got, want[i]):
                    results[i] = False
                    return
            results[i] = True
        except Exception as e:  # noqa: BLE001 - asserted by the caller
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors
    return results


@pytest.mark.parametrize("step", STEPS)
def test_threads_at_one_shape_get_their_own_rows(runners, step):
    """Four threads calling a step at one shape, each with its own input,
    each get the plain function of their own input (the step's lock
    gives its static buffers one owner at a time)."""
    _, ours = runners
    assert _threads_get_their_own_rows(ours, step, [2] * 4) == [True] * 4


@pytest.mark.parametrize("step", STEPS)
def test_threads_at_two_shapes_get_their_own_rows(runners, step):
    """Threads at rows 1 and 3 calling a step at once each get the plain
    function of their own input: the two shapes' programs share the
    step's graph pool, so a call holds the step's lock from its copy in
    to its copy out, not its shape's alone."""
    _, ours = runners
    assert _threads_get_their_own_rows(ours, step, [1, 3, 1, 3]) == [
        True] * 4


def test_one_program_per_distinct_shape():
    """Each step holds one program per distinct input shape and dtype, as
    ``jax.jit`` holds one executable per signature: rows 1, 3, 1, 3, 5
    make three; a float64 input at a held row count makes one more."""
    ours = vision.vision_pipeline_models(device="cpu")[1].fn.__self__
    for rows in (1, 3, 1, 3, 5):
        x = torch.from_numpy(_images(rows, seed=rows))
        for step in STEPS:
            feats, x = x, _run(ours, step, x)
    for step, progs in ours.programs().items():
        assert sorted(s[0][1][0] for s in progs.shapes()) == [1, 3, 5], step
        assert progs.stats()["eager_runs"] == 5
        assert progs.stats()["graphs"] == 0  # no capture on the CPU
    _run(ours, "postprocess", feats.double())
    assert len(ours.programs()["postprocess"].shapes()) == 4


def test_backbone_warmup_holds_one_program_per_bucket():
    """``warmup=True`` runs the backbone once per padded bucket at load
    (``ModelBatcher.warmup``): its programs are then one per bucket,
    ``len(_buckets_up_to(max_batch_size))``, and pipeline requests of 1
    and 3 images (buckets 1 and 3) add none."""
    models = vision.vision_pipeline_models(device="cpu", warmup=True,
                                           max_batch_size=16)
    ours = models[1].fn.__self__
    engine = InferenceEngine(models)
    try:
        buckets = _buckets_up_to(16)
        shapes = ours.programs()["backbone"].shapes()
        assert sorted(s[0][1][0] for s in shapes) == buckets
        assert all(s[0][1][1:] == (3, IMAGE, IMAGE) for s in shapes)
        for rows in (1, 3):
            img = _images(rows, seed=rows)
            raw = img.tobytes()
            request = {"inputs": [{"name": "IMAGE", "datatype": "UINT8",
                                   "shape": list(img.shape),
                                   "parameters": {"binary_data_size":
                                                  len(raw)}}],
                       "outputs": [{"name": "SCORES",
                                    "parameters": {"binary_data": True}}]}
            _, blobs = engine.execute("vision_pipeline", "", request, raw)
            got = np.frombuffer(blobs[0], np.float32).reshape(rows, 16)
            want = _plain(ours, "postprocess", _plain(
                ours, "backbone", vision._preprocess_forward(
                    torch.from_numpy(img))))
            np.testing.assert_allclose(got, want.numpy(), atol=1e-5,
                                       rtol=0)
        assert len(ours.programs()["backbone"].shapes()) == len(buckets)
    finally:
        engine.close()
