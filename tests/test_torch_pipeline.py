"""The port's ensemble DAG scheduler (client_tpu_torch.serve.pipeline)
held against client_tpu.serve.pipeline: the add-time validation and runner
cases of tests/test_ensemble_pipeline.py on the port's engine, the device
residency cases with torch-backed models, and the tiny vision pipeline
against the JAX pipeline on the same weights.

Stated tolerance of the vision pipeline: its SCORES are softmax
probabilities computed in bf16 from the carried bf16 weights on both
sides; they agree within 1e-2 absolute (a softmax moves a probability by
at most half the largest change of a logit, and the logits agree within
1e-2 of the largest, as tests/test_torch_vision.py holds them).
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax

from client_tpu.serve.model_runtime import InferenceEngine as JaxEngine
from client_tpu.serve.models import vision as jvision
from client_tpu_torch import convert
from client_tpu_torch.serve.model_runtime import (
    InferenceEngine,
    Model,
    TensorSpec,
)
from client_tpu_torch.serve.models import vision
from client_tpu_torch.serve.pipeline import (
    ENSEMBLE_RESERVED_PARAMS,
    build_dag,
    step_params,
)
from client_tpu_torch.utils import InferenceServerException

SCORES_ATOL = 1e-2


def _identity(name, dtype="INT32", sleep_s=0.0, record=None, fail=False,
              on_call=None, **model_kwargs):
    """A configurable one-in/one-out python model for DAG shapes."""

    def fn(inputs, params, ctx):
        if record is not None:
            record.append((name, dict(params or {}), time.monotonic()))
        if on_call is not None:
            on_call()
        if sleep_s:
            time.sleep(sleep_s)
        if fail:
            raise InferenceServerException(f"{name} exploded", status="500")
        return {"OUT": inputs["IN"]}

    return Model(
        name,
        inputs=[TensorSpec("IN", dtype, [-1])],
        outputs=[TensorSpec("OUT", dtype, [-1])],
        fn=fn,
        **model_kwargs,
    )


def _ensemble(name, steps, in_dtype="INT32", out_names=("OUT",),
              out_dtype=None, in_names=("IN",)):
    return Model(
        name,
        inputs=[TensorSpec(n, in_dtype, [-1]) for n in in_names],
        outputs=[TensorSpec(n, out_dtype or in_dtype, [-1])
                 for n in out_names],
        fn=None,
        platform="ensemble",
        ensemble_steps=steps,
    )


def _step(model, inp, out):
    return {"model_name": model, "input_map": inp, "output_map": out}


def _request(arrays, params=None):
    request = {
        "id": "t",
        "inputs": [
            {"name": n, "shape": list(a.shape), "datatype": dt,
             "data": a.flatten().tolist()}
            for n, dt, a in arrays
        ],
    }
    if params:
        request["parameters"] = dict(params)
    return request


def _infer(engine, name, arrays, params=None):
    response, _ = engine.execute(name, "", _request(arrays, params), b"")
    return {o["name"]: np.array(o["data"]).reshape(o["shape"])
            for o in response["outputs"]}


def _inference_stats(engine, name):
    return engine.statistics(name)[0]["inference_stats"]


# -- load-time validation ----------------------------------------------------


def _two(dtype_a="INT32", dtype_b="INT32"):
    return [_identity("a", dtype=dtype_a), _identity("b", dtype=dtype_b)]


def _wide_narrow():
    wide = Model("wide", inputs=[TensorSpec("IN", "INT32", [-1, 8])],
                 outputs=[TensorSpec("OUT", "INT32", [-1, 8])],
                 fn=lambda i, p, c: {"OUT": i["IN"]})
    narrow = Model("narrow", inputs=[TensorSpec("IN", "INT32", [-1, 4])],
                   outputs=[TensorSpec("OUT", "INT32", [-1, 4])],
                   fn=lambda i, p, c: {"OUT": i["IN"]})
    ens = Model(
        "e", inputs=[TensorSpec("IN", "INT32", [-1, 8])],
        outputs=[TensorSpec("OUT", "INT32", [-1, 4])], fn=None,
        platform="ensemble",
        ensemble_steps=[_step("wide", {"IN": "IN"}, {"OUT": "mid"}),
                        _step("narrow", {"IN": "mid"}, {"OUT": "OUT"})])
    return [wide, narrow], ens


REJECTIONS = {
    "unknown_composing_model": lambda: (
        [_identity("a")],
        _ensemble("e", [_step("ghost", {"IN": "IN"}, {"OUT": "OUT"})]),
        "unknown composing model 'ghost'"),
    "cycle": lambda: (
        _two(),
        _ensemble("e", [_step("a", {"IN": "t2"}, {"OUT": "t1"}),
                        _step("b", {"IN": "t1"}, {"OUT": "t2"}),
                        _step("a", {"IN": "IN"}, {"OUT": "OUT"})]),
        "dependency cycle"),
    "dangling_tensor": lambda: (
        [_identity("a")],
        _ensemble("e", [_step("a", {"IN": "nowhere"}, {"OUT": "OUT"})]),
        "dangling tensor"),
    "unmapped_composing_input": lambda: (
        [_identity("a")],
        _ensemble("e", [_step("a", {}, {"OUT": "OUT"})]),
        "unmapped"),
    "dtype_mismatch": lambda: (
        _two("INT32", "FP32"),
        _ensemble("e", [_step("a", {"IN": "IN"}, {"OUT": "mid"}),
                        _step("b", {"IN": "mid"}, {"OUT": "OUT"})],
                  out_dtype="FP32"),
        "expects FP32 but tensor 'mid' carries INT32"),
    "shape_conflict": lambda: (*_wide_narrow(), "conflict with tensor 'mid'"),
    "duplicate_producer": lambda: (
        [_identity("a")],
        _ensemble("e", [_step("a", {"IN": "IN"}, {"OUT": "OUT"}),
                        _step("a", {"IN": "IN"}, {"OUT": "OUT"})]),
        "produced by both step 0 and step 1"),
    "unproduced_output": lambda: (
        [_identity("a")],
        _ensemble("e", [_step("a", {"IN": "IN"}, {"OUT": "mid"})]),
        "output tensor 'OUT' is not produced"),
    "self_reference": lambda: (
        [_identity("a")],
        _ensemble("e", [_step("e", {"IN": "IN"}, {"OUT": "OUT"})]),
        "refers to the ensemble itself"),
    "self_cycle": lambda: (
        [_identity("a")],
        _ensemble("e", [_step("a", {"IN": "t"}, {"OUT": "t"}),
                        _step("a", {"IN": "IN"}, {"OUT": "OUT"})]),
        "reads its own output tensor 't'"),
    "decoupled_composing_model": lambda: (
        [_identity("dec", decoupled=True)],
        _ensemble("e", [_step("dec", {"IN": "IN"}, {"OUT": "OUT"})]),
        "decoupled"),
}


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_invalid_ensemble_rejected_at_add(case):
    """Each structural fault is a 400 at ``add_model`` with the reference's
    message, never a surprise at infer time."""
    models, ensemble, match = REJECTIONS[case]()
    engine = InferenceEngine(models)
    try:
        with pytest.raises(InferenceServerException, match=match) as ei:
            engine.add_model(ensemble)
        assert ei.value.status() == "400"
        assert not engine.model_ready("e")
    finally:
        engine.close()


def test_load_revalidates_against_current_repository():
    engine = InferenceEngine([_identity("a", dtype="INT32")])
    try:
        engine.add_model(_ensemble(
            "e", [_step("a", {"IN": "IN"}, {"OUT": "OUT"})]))
        engine.add_model(_identity("a", dtype="FP32"))  # swap in place
        with pytest.raises(InferenceServerException) as ei:
            engine.load_model("e")
        assert ei.value.status() == "400"
        assert "expects FP32 but tensor 'IN' carries INT32" in str(ei.value)
    finally:
        engine.close()


def test_incompatible_swap_unloads_dependent_ensemble():
    engine = InferenceEngine([_identity("a", dtype="INT32")])
    try:
        engine.add_model(_ensemble(
            "e", [_step("a", {"IN": "IN"}, {"OUT": "OUT"})]))
        assert engine.model_ready("e")
        engine.add_model(_identity("a", dtype="FP32"))  # breaking swap
        assert not engine.model_ready("e")
        with pytest.raises(InferenceServerException) as ei:
            _infer(engine, "e", [("IN", "INT32", np.arange(4, dtype=np.int32))])
        assert ei.value.status() == "400"
        with pytest.raises(InferenceServerException, match="expects FP32"):
            engine.load_model("e")
    finally:
        engine.close()


def test_compatible_swap_keeps_dependent_ensemble_ready():
    engine = InferenceEngine([_identity("a", dtype="INT32")])
    try:
        engine.add_model(_ensemble(
            "e", [_step("a", {"IN": "IN"}, {"OUT": "OUT"})]))
        engine.add_model(_identity("a", dtype="INT32"))  # same specs
        assert engine.model_ready("e")
        x = np.arange(4, dtype=np.int32)
        np.testing.assert_array_equal(
            _infer(engine, "e", [("IN", "INT32", x)])["OUT"], x)
    finally:
        engine.close()


def test_valid_dag_computes_deps():
    a, b = _two()
    ens = _ensemble("e", [_step("a", {"IN": "IN"}, {"OUT": "mid"}),
                          _step("b", {"IN": "mid"}, {"OUT": "OUT"})])
    dag = build_dag(ens, {"a": a, "b": b}.get)
    assert dag.is_chain
    assert dag.steps[1].deps == {0}
    assert dag.steps[0].consumers == {1}


def test_parallel_branches_not_a_chain():
    ens = _ensemble("e", [_step("a", {"IN": "IN"}, {"OUT": "OUT"}),
                          _step("a", {"IN": "IN"}, {"OUT": "OUT1"})],
                    out_names=("OUT", "OUT1"))
    assert not build_dag(ens, {"a": _identity("a")}.get).is_chain


# -- execution ---------------------------------------------------------------


def test_parallel_branches_overlap():
    """Two independent 0.15 s branches overlap in wall clock."""
    engine = InferenceEngine([_identity("slow_a", sleep_s=0.15),
                              _identity("slow_b", sleep_s=0.15)])
    try:
        engine.add_model(_ensemble("fork", [
            _step("slow_a", {"IN": "IN"}, {"OUT": "OUT"}),
            _step("slow_b", {"IN": "IN"}, {"OUT": "OUT1"}),
        ], out_names=("OUT", "OUT1")))
        x = np.arange(8, dtype=np.int32)
        t0 = time.monotonic()
        out = _infer(engine, "fork", [("IN", "INT32", x)])
        wall = time.monotonic() - t0
        assert wall < 0.26, f"branches ran serially ({wall:.3f}s)"
        np.testing.assert_array_equal(out["OUT1"], x)
    finally:
        engine.close()


def test_nested_ensemble_recurses():
    engine = InferenceEngine([_identity("leaf")])
    try:
        engine.add_model(_ensemble(
            "inner", [_step("leaf", {"IN": "IN"}, {"OUT": "OUT"})]))
        engine.add_model(_ensemble("outer", [
            _step("inner", {"IN": "IN"}, {"OUT": "mid"}),
            _step("leaf", {"IN": "mid"}, {"OUT": "OUT"}),
        ]))
        x = np.arange(6, dtype=np.int32)
        np.testing.assert_array_equal(
            _infer(engine, "outer", [("IN", "INT32", x)])["OUT"], x)
        assert _inference_stats(engine, "inner")["success"]["count"] == 1
        assert _inference_stats(engine, "leaf")["success"]["count"] == 2
    finally:
        engine.close()


def test_request_params_thread_to_composing_models():
    seen = []
    engine = InferenceEngine([_identity("a", record=seen)])
    try:
        engine.add_model(_ensemble(
            "e", [_step("a", {"IN": "IN"}, {"OUT": "OUT"})]))
        _infer(engine, "e", [("IN", "INT32", np.arange(4, dtype=np.int32))],
               params={"temperature": 0.5, "timeout": 10, "priority": 3})
        (_, params, _), = seen
        assert params.get("temperature") == 0.5
        assert not (set(params) & ENSEMBLE_RESERVED_PARAMS)
    finally:
        engine.close()


def test_step_params_strips_only_reserved_keys():
    assert step_params({"sequence_id": 9, "timeout": 1, "seed": 7}) == {
        "seed": 7}
    assert step_params(None) == {}


def test_mid_dag_failure_cancels_rest_and_names_step():
    ran = []
    engine = InferenceEngine([
        _identity("ok", record=ran),
        _identity("boom", fail=True),
        _identity("never", record=ran),
    ])
    try:
        engine.add_model(_ensemble("chain", [
            _step("ok", {"IN": "IN"}, {"OUT": "t1"}),
            _step("boom", {"IN": "t1"}, {"OUT": "t2"}),
            _step("never", {"IN": "t2"}, {"OUT": "OUT"}),
        ]))
        with pytest.raises(InferenceServerException) as ei:
            _infer(engine, "chain",
                   [("IN", "INT32", np.arange(4, dtype=np.int32))])
        msg = str(ei.value)
        assert "step 1" in msg and "'boom'" in msg
        assert ei.value.status() == "500"
        assert [n for n, _, _ in ran] == ["ok"], "step after failure ran"
        assert engine.metrics.get(
            "ctpu_ensemble_cancelled_steps_total", {"model": "chain"}) == 1
        assert _inference_stats(engine, "never")["success"]["count"] == 0
        assert _inference_stats(engine, "boom")["fail"]["count"] == 1
        assert _inference_stats(engine, "chain")["fail"]["count"] == 1
    finally:
        engine.close()


def test_parallel_branch_failure_does_not_hang():
    engine = InferenceEngine([_identity("slow", sleep_s=0.2),
                              _identity("boom", fail=True)])
    try:
        engine.add_model(_ensemble("fork", [
            _step("slow", {"IN": "IN"}, {"OUT": "OUT"}),
            _step("boom", {"IN": "IN"}, {"OUT": "OUT1"}),
        ], out_names=("OUT", "OUT1")))
        t0 = time.monotonic()
        with pytest.raises(InferenceServerException, match="'boom'"):
            _infer(engine, "fork",
                   [("IN", "INT32", np.arange(4, dtype=np.int32))])
        assert time.monotonic() - t0 < 2.0
    finally:
        engine.close()


def test_missing_composing_output_is_500_naming_step():
    broken = Model("half", inputs=[TensorSpec("IN", "INT32", [-1])],
                   outputs=[TensorSpec("OUT", "INT32", [-1])],
                   fn=lambda i, p, c: {})
    engine = InferenceEngine([broken])
    try:
        engine.add_model(_ensemble(
            "e", [_step("half", {"IN": "IN"}, {"OUT": "OUT"})]))
        with pytest.raises(InferenceServerException) as ei:
            _infer(engine, "e", [("IN", "INT32",
                                  np.arange(2, dtype=np.int32))])
        assert ei.value.status() == "500"
        assert "produced no output 'OUT'" in str(ei.value)
    finally:
        engine.close()


def test_composing_model_unloaded_mid_flight_clean_4xx():
    engine = InferenceEngine([_identity("b")])
    gate = threading.Event()

    def unload_b():
        engine.unload_model("b")
        gate.set()

    engine.add_model(_identity("a", on_call=unload_b))
    try:
        engine.add_model(_ensemble("chain", [
            _step("a", {"IN": "IN"}, {"OUT": "mid"}),
            _step("b", {"IN": "mid"}, {"OUT": "OUT"}),
        ]))
        t0 = time.monotonic()
        with pytest.raises(InferenceServerException) as ei:
            _infer(engine, "chain", [("IN", "INT32",
                                      np.arange(2, dtype=np.int32))])
        assert gate.is_set()
        assert time.monotonic() - t0 < 2.0, "unload mid-flight hung"
        assert ei.value.status() == "400"
        assert "step 1" in str(ei.value) and "'b'" in str(ei.value)
    finally:
        engine.close()


# -- statistics / metrics reconciliation -------------------------------------


def test_composing_durations_sum_to_ensemble_compute_infer():
    engine = InferenceEngine(_two())
    try:
        engine.add_model(_ensemble("e", [
            _step("a", {"IN": "IN"}, {"OUT": "mid"}),
            _step("b", {"IN": "mid"}, {"OUT": "OUT"}),
        ]))
        for _ in range(3):
            _infer(engine, "e", [("IN", "INT32", np.arange(8, dtype=np.int32))])
        ens = _inference_stats(engine, "e")
        total = sum(_inference_stats(engine, n)["success"]["ns"]
                    for n in ("a", "b"))
        assert ens["success"]["count"] == 3
        assert ens["compute_infer"]["ns"] == total
    finally:
        engine.close()


def test_step_stats_have_real_phase_split():
    engine = InferenceEngine([_identity("a")])
    try:
        engine.add_model(_ensemble(
            "e", [_step("a", {"IN": "IN"}, {"OUT": "OUT"})]))
        _infer(engine, "e", [("IN", "INT32", np.arange(64, dtype=np.int32))])
        sub = _inference_stats(engine, "a")
        assert sub["compute_input"]["ns"] > 0
        assert sub["compute_infer"]["ns"] > 0
        assert sub["success"]["ns"] >= (
            sub["compute_input"]["ns"] + sub["compute_infer"]["ns"])
    finally:
        engine.close()


def test_ensemble_metric_series():
    engine = InferenceEngine(_two())
    try:
        engine.add_model(_ensemble("e", [
            _step("a", {"IN": "IN"}, {"OUT": "mid"}),
            _step("b", {"IN": "mid"}, {"OUT": "OUT"}),
        ]))
        _infer(engine, "e", [("IN", "INT32", np.arange(4, dtype=np.int32))])
        m = engine.metrics
        assert m.get("ctpu_ensemble_requests_total", {"model": "e"}) == 1
        for n in ("a", "b"):
            assert m.get("ctpu_ensemble_steps_total",
                         {"model": "e", "composing_model": n}) == 1
    finally:
        engine.close()


def test_batched_composing_model_records_queue_stats():
    engine = InferenceEngine([
        _identity("batched", max_batch_size=8, dynamic_batching=True),
    ])
    try:
        engine.add_model(Model(
            "e", inputs=[TensorSpec("IN", "INT32", [-1, 4])],
            outputs=[TensorSpec("OUT", "INT32", [-1, 4])], fn=None,
            platform="ensemble",
            ensemble_steps=[_step("batched", {"IN": "IN"}, {"OUT": "OUT"})],
        ))
        x = np.arange(4, dtype=np.int32).reshape(1, 4)
        np.testing.assert_array_equal(
            _infer(engine, "e", [("IN", "INT32", x)])["OUT"], x)
        sub = engine.statistics("batched")[0]
        assert sub["inference_stats"]["success"]["count"] == 1
        assert sub["inference_stats"]["queue"]["count"] >= 1
        assert sub["execution_count"] == 1
    finally:
        engine.close()


# -- device residency ----------------------------------------------------------


def _torch_model(name, fn):
    return Model(name, inputs=[TensorSpec("IN", "FP32", [-1])],
                 outputs=[TensorSpec("OUT", "FP32", [-1])], fn=fn,
                 platform="torch", backend="torch", device="cpu")


def test_torch_consumer_receives_device_tensor():
    """Between two torch-backed steps the intermediate is handed over as
    the producer's tensor, the very object (no host hop)."""
    made, received = [], []

    def producer_fn(inputs, params, ctx):
        out = torch.as_tensor(np.asarray(inputs["IN"])) * 2
        made.append(out)
        return {"OUT": out}

    def consumer_fn(inputs, params, ctx):
        received.append(inputs["IN"])
        assert isinstance(inputs["IN"], torch.Tensor)
        return {"OUT": inputs["IN"] + 1}

    engine = InferenceEngine([_torch_model("producer", producer_fn),
                              _torch_model("consumer", consumer_fn)])
    try:
        engine.add_model(_ensemble("e", [
            _step("producer", {"IN": "IN"}, {"OUT": "mid"}),
            _step("consumer", {"IN": "mid"}, {"OUT": "OUT"}),
        ], in_dtype="FP32"))
        x = np.arange(4, dtype=np.float32)
        out = _infer(engine, "e", [("IN", "FP32", x)])
        np.testing.assert_allclose(out["OUT"], x * 2 + 1)
        assert received[0] is made[0]
        assert engine.metrics.get(
            "ctpu_ensemble_device_handoffs_total", {"model": "e"}) == 1
        assert not engine.metrics.get(
            "ctpu_ensemble_host_hops_total", {"model": "e"})
    finally:
        engine.close()


def test_python_consumer_gets_host_array_and_hop_is_counted():
    def consumer_fn(inputs, params, ctx):
        assert isinstance(inputs["IN"], np.ndarray)
        return {"OUT": inputs["IN"]}

    producer = _torch_model(
        "producer",
        lambda i, p, c: {"OUT": torch.as_tensor(np.asarray(i["IN"]))})
    consumer = Model("pyconsumer", inputs=[TensorSpec("IN", "FP32", [-1])],
                     outputs=[TensorSpec("OUT", "FP32", [-1])],
                     fn=consumer_fn)
    engine = InferenceEngine([producer, consumer])
    try:
        engine.add_model(_ensemble("e", [
            _step("producer", {"IN": "IN"}, {"OUT": "mid"}),
            _step("pyconsumer", {"IN": "mid"}, {"OUT": "OUT"}),
        ], in_dtype="FP32"))
        _infer(engine, "e", [("IN", "FP32", np.arange(4, dtype=np.float32))])
        assert engine.metrics.get(
            "ctpu_ensemble_host_hops_total", {"model": "e"}) == 1
    finally:
        engine.close()


# -- the tiny vision pipeline against the JAX one -----------------------------


@pytest.fixture(scope="module")
def vision_engines():
    """The JAX and the port's tiny vision pipelines on the same weights
    (the JAX runners' bf16 parameters carried across)."""
    theirs = jvision.vision_pipeline_models()
    jparams = theirs[1].fn.__self__._ensure()
    ours = vision.vision_pipeline_models(device="cpu")
    ours[1].fn.__self__.params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    jengine, engine = JaxEngine(theirs), InferenceEngine(ours)
    yield jengine, engine
    jengine.close()
    engine.close()


def test_vision_pipeline_matches_jax_with_zero_host_hops(vision_engines):
    """preprocess -> backbone -> postprocess, every intermediate a tensor
    handed over as is: SCORES within 1e-2 of the JAX pipeline's, 0 host
    hops, 2 device handoffs, and composing statistics that reconcile."""
    jengine, engine = vision_engines
    img = np.random.default_rng(0).integers(0, 255, (2, 32, 32, 3),
                                            dtype=np.uint8)
    arrays = [("IMAGE", "UINT8", img)]
    want = _infer(jengine, "vision_pipeline", arrays)["SCORES"]
    got = _infer(engine, "vision_pipeline", arrays)["SCORES"]
    assert got.shape == want.shape == (2, 16)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(got, want, atol=SCORES_ATOL, rtol=0)
    assert (got.argmax(1) == want.argmax(1)).all()
    m = engine.metrics
    assert not m.get("ctpu_ensemble_host_hops_total",
                     {"model": "vision_pipeline"})
    assert m.get("ctpu_ensemble_device_handoffs_total",
                 {"model": "vision_pipeline"}) == 2
    ens = _inference_stats(engine, "vision_pipeline")
    total = sum(_inference_stats(engine, n)["success"]["ns"]
                for n in ("vision_preprocess", "vision_backbone",
                          "vision_postprocess"))
    assert ens["compute_infer"]["ns"] == total


def test_vision_pipeline_equals_its_steps_in_turn(vision_engines):
    """Concurrent pipeline requests (the backbone step batched across
    them on the device path) equal the three composing models called in
    turn on each image, within 1e-5: the backbone runs at another batch
    size there, where the library may sum in another order."""
    _, engine = vision_engines
    models = {n: engine.get_model(n) for n in (
        "vision_preprocess", "vision_backbone", "vision_postprocess")}
    images = [np.random.default_rng(10 + i).integers(
        0, 255, (1, 32, 32, 3), dtype=np.uint8) for i in range(4)]
    got = [None] * 4
    barrier = threading.Barrier(4)

    def run(i):
        barrier.wait()
        got[i] = _infer(engine, "vision_pipeline",
                        [("IMAGE", "UINT8", images[i])])["SCORES"]

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, img in enumerate(images):
        pixels = models["vision_preprocess"].fn({"IMAGE": img}, {}, None)
        feats = models["vision_backbone"].fn(pixels, {}, None)
        scores = models["vision_postprocess"].fn(feats, {}, None)["SCORES"]
        np.testing.assert_allclose(got[i], scores.numpy(), atol=1e-5,
                                   rtol=0)
