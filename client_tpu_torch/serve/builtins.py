"""Built-in models for the port's in-process server.

A copy of client_tpu/serve/builtins.py: the model zoo the reference's
examples assume on a Triton server (the "simple" add/sub model family,
identity, sequence and decoupled models), numpy models that run on the
host, plus the hermetic tiny vision pipeline, whose torch models run on
the server's device.  The torch models live in
client_tpu_torch.serve.models; ``model_sets("builtin")`` serves this set.
"""

import time

import numpy as np

from client_tpu_torch.serve.model_runtime import Model, TensorSpec


def simple_model():
    """INT32 add/sub: OUTPUT0 = INPUT0 + INPUT1, OUTPUT1 = INPUT0 - INPUT1.

    Shape parity with the Triton qa 'simple' model ([1,16], batchable).
    """

    def fn(inputs, params, ctx):
        a, b = inputs["INPUT0"], inputs["INPUT1"]
        return {"OUTPUT0": a + b, "OUTPUT1": a - b}

    return Model(
        "simple",
        inputs=[
            TensorSpec("INPUT0", "INT32", [-1, 16]),
            TensorSpec("INPUT1", "INT32", [-1, 16]),
        ],
        outputs=[
            TensorSpec("OUTPUT0", "INT32", [-1, 16]),
            TensorSpec("OUTPUT1", "INT32", [-1, 16]),
        ],
        fn=fn,
        max_batch_size=8,
    )


def simple_string_model():
    """BYTES add/sub on string-encoded integers (parity: simple_string examples)."""

    def fn(inputs, params, ctx):
        a = np.array([int(x) for x in inputs["INPUT0"].flatten()])
        b = np.array([int(x) for x in inputs["INPUT1"].flatten()])
        shape = inputs["INPUT0"].shape
        enc = lambda arr: np.array(
            [str(int(v)).encode() for v in arr], dtype=np.object_
        ).reshape(shape)
        return {"OUTPUT0": enc(a + b), "OUTPUT1": enc(a - b)}

    return Model(
        "simple_string",
        inputs=[
            TensorSpec("INPUT0", "BYTES", [-1, 16]),
            TensorSpec("INPUT1", "BYTES", [-1, 16]),
        ],
        outputs=[
            TensorSpec("OUTPUT0", "BYTES", [-1, 16]),
            TensorSpec("OUTPUT1", "BYTES", [-1, 16]),
        ],
        fn=fn,
        max_batch_size=8,
    )


def identity_model(name="identity", datatype="FP32"):
    """Echo INPUT0 -> OUTPUT0 unchanged (any shape)."""

    def fn(inputs, params, ctx):
        return {"OUTPUT0": inputs["INPUT0"]}

    return Model(
        name,
        inputs=[TensorSpec("INPUT0", datatype, [-1])],
        outputs=[TensorSpec("OUTPUT0", datatype, [-1])],
        fn=fn,
    )


def slow_identity_model(delay_s=0.05):
    """Identity with a fixed server-side delay — the timeout-behavior test
    model (the reference ships delay models for the same purpose)."""

    def fn(inputs, params, ctx):
        time.sleep(delay_s)
        return {"OUTPUT0": inputs["INPUT0"]}

    return Model(
        "slow_identity",
        inputs=[TensorSpec("INPUT0", "INT32", [-1])],
        outputs=[TensorSpec("OUTPUT0", "INT32", [-1])],
        fn=fn,
    )


def sequence_model():
    """Stateful accumulator (parity: the simple_sequence examples' model).

    Per sequence: OUTPUT = running sum of INPUT values; on sequence_start the
    accumulator resets to the input value.
    """

    def fn(inputs, params, ctx):
        value = inputs["INPUT"]
        if ctx is None:
            return {"OUTPUT": value}
        if params.get("sequence_start") or "acc" not in ctx.state:
            ctx.state["acc"] = np.zeros_like(value)
        ctx.state["acc"] = ctx.state["acc"] + value
        return {"OUTPUT": ctx.state["acc"].copy()}

    return Model(
        "simple_sequence",
        inputs=[TensorSpec("INPUT", "INT32", [1])],
        outputs=[TensorSpec("OUTPUT", "INT32", [1])],
        fn=fn,
        stateful=True,
    )


def decoupled_model():
    """Decoupled streamer: for input [n, delay?] yields n responses 0..n-1.

    Mirrors the shape of Triton's repeat/decoupled sample models used for LLM
    token streaming tests.
    """

    def fn(inputs, params, ctx):
        n = int(np.asarray(inputs["IN"]).flatten()[0])
        for i in range(n):
            yield {"OUT": np.array([i], dtype=np.int32)}

    return Model(
        "repeat_int32",
        inputs=[TensorSpec("IN", "INT32", [1])],
        outputs=[TensorSpec("OUT", "INT32", [1])],
        fn=fn,
        decoupled=True,
    )


def classification_model():
    """Softmax-ish scores with labels, for the classification extension."""
    labels = ["cat", "dog", "bird", "fish"]

    def fn(inputs, params, ctx):
        x = inputs["INPUT0"].astype(np.float32)
        e = np.exp(x - x.max(axis=-1, keepdims=True))
        return {"OUTPUT0": e / e.sum(axis=-1, keepdims=True)}

    return Model(
        "classifier",
        inputs=[TensorSpec("INPUT0", "FP32", [-1, 4])],
        outputs=[TensorSpec("OUTPUT0", "FP32", [-1, 4], labels=labels)],
        fn=fn,
    )


def ensemble_model():
    """Config-driven ensemble chaining simple -> identity_int32 (the
    reference's ensemble_add_sub pattern: ensemble_scheduling steps with
    input_map/output_map, composing models keep their own statistics)."""
    return Model(
        "simple_ensemble",
        inputs=[
            TensorSpec("INPUT0", "INT32", [-1, 16]),
            TensorSpec("INPUT1", "INT32", [-1, 16]),
        ],
        outputs=[
            TensorSpec("OUTPUT0", "INT32", [-1, 16]),
            TensorSpec("OUTPUT1", "INT32", [-1, 16]),
        ],
        fn=None,  # the engine's ensemble scheduler runs the steps
        platform="ensemble",
        ensemble_steps=[
            {
                "model_name": "simple",
                "input_map": {"INPUT0": "INPUT0", "INPUT1": "INPUT1"},
                "output_map": {"OUTPUT0": "sum", "OUTPUT1": "diff"},
            },
            {
                "model_name": "identity_int32",
                "input_map": {"INPUT0": "sum"},
                "output_map": {"OUTPUT0": "OUTPUT0"},
            },
            {
                "model_name": "identity_int32",
                "input_map": {"INPUT0": "diff"},
                "output_map": {"OUTPUT0": "OUTPUT1"},
            },
        ],
    )


def default_models(device=None):
    """The builtin set: the numpy models above, and the tiny vision
    pipeline (preprocess -> resnet backbone -> postprocess) on *device*
    (``cuda`` unless the caller says otherwise), built when the set is."""
    from client_tpu_torch.serve.models.vision import vision_pipeline_models

    return [
        simple_model(),
        simple_string_model(),
        identity_model(),
        identity_model("identity_bytes", "BYTES"),
        identity_model("identity_int32", "INT32"),
        identity_model("identity_int8", "INT8"),
        slow_identity_model(),
        sequence_model(),
        decoupled_model(),
        classification_model(),
        ensemble_model(),
        *vision_pipeline_models(device=device),
    ]
