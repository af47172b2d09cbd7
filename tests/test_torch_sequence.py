"""Sequences in the port's runtime (``SequenceContext``, ``Model(stateful=)``
and the engine's sequence table) held against client_tpu's, on the CPU.

The stateful model is the builtin ``simple_sequence`` accumulator (a copy
of client_tpu/serve/builtins.py's), served by the port's ``Server`` and
driven by the JAX package's HTTP client; the same steps go to the JAX
server and the answers must be equal, exactly (integer sums), with
``sequence_durable`` and ``sequence_step`` on servers with no fleet tier
too (local durability, idempotent step replay, the 409s).  The
replicated half is held in tests/test_torch_fleet.py.
"""

import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import client_tpu.http as httpclient
import test_http_client as jhc
from client_tpu.serve import Server as JaxServer
from client_tpu_torch.serve import Server
from client_tpu_torch.serve.builtins import sequence_model
from client_tpu_torch.serve.frontdoor import ResponseCache
from client_tpu_torch.serve.model_runtime import (
    InferenceEngine,
    Model,
    SequenceContext,
    TensorSpec,
)


@pytest.fixture(scope="module")
def server():
    with Server(device="cpu") as s:
        yield s


@pytest.fixture(scope="module")
def client(server):
    with httpclient.InferenceServerClient(server.http_address,
                                          concurrency=4) as c:
        yield c


def _step(addr, value, params):
    body = {"inputs": [{"name": "INPUT", "shape": [1], "datatype": "INT32",
                        "data": [int(value)]}],
            "parameters": params}
    req = urllib.request.Request(
        f"http://{addr}/v2/models/simple_sequence/infer",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())["outputs"][0]["data"][0]


class TestSequenceHttpPort(jhc.TestSequenceHttp):
    """tests/test_http_client.py::TestSequenceHttp::
    test_stateful_accumulation against the port's server."""


def test_interleaved_sequences_match_jax(server):
    """Three interleaved sequences with starts, ends and a restart: the
    port's answers equal the JAX server's step for step."""
    rng = np.random.default_rng(0)
    plan = []
    for i in range(30):
        seq = int(rng.integers(1, 4))
        plan.append((int(rng.integers(-50, 50)), seq,
                     {"sequence_id": seq,
                      "sequence_start": bool(i < 3 or rng.random() < 0.1),
                      "sequence_end": bool(rng.random() < 0.1)}))
    with JaxServer() as jax_server:
        got = [_step(server.http_address, v, p) for v, _, p in plan]
        want = [_step(jax_server.http_address, v, p) for v, _, p in plan]
    assert got == want


def test_context_counts_steps_and_keeps_the_last_response():
    """A sequence's context: step counts its executed requests and
    last_response keeps the last rendering without the request id; the
    context leaves the table on sequence_end."""
    engine = InferenceEngine([sequence_model()])
    try:
        body = {"id": "r1", "inputs": [{"name": "INPUT", "shape": [1],
                                        "datatype": "INT32", "data": [4]}],
                "parameters": {"sequence_id": 9, "sequence_start": True}}
        engine.execute("simple_sequence", "", body, b"")
        ctx = engine._sequences[9]
        assert isinstance(ctx, SequenceContext)
        assert ctx.step == 1 and ctx.state["acc"].tolist() == [4]
        body["parameters"] = {"sequence_id": 9}
        body["id"] = "r2"
        response, _ = engine.execute("simple_sequence", "", body, b"")
        assert response["id"] == "r2"
        step, kept, blobs = ctx.last_response
        assert step == 2 and "id" not in kept and blobs == []
        assert kept["outputs"][0]["data"] == [8]
        body["parameters"] = {"sequence_id": 9, "sequence_end": True}
        response, _ = engine.execute("simple_sequence", "", body, b"")
        assert response["outputs"][0]["data"] == [12]
        assert 9 not in engine._sequences and ctx.step == 3
    finally:
        engine.close()


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_idle_sequences_are_reaped(pkg):
    """A sequence idle past max_sequence_idle_s is dropped at the next
    sequence request (a client that never sent sequence_end leaks no
    state); continuing it afterwards starts from a fresh context, in the
    port as in client_tpu."""
    srv = (Server(device="cpu") if pkg == "torch" else JaxServer()).start()
    try:
        srv.engine.max_sequence_idle_s = 0.2
        addr = srv.http_address
        assert _step(addr, 10, {"sequence_id": 5,
                                "sequence_start": True}) == 10
        assert _step(addr, 1, {"sequence_id": 5}) == 11
        time.sleep(0.5)
        assert _step(addr, 7, {"sequence_id": 6,
                               "sequence_start": True}) == 7
        assert 5 not in srv.engine._sequences
        assert 6 in srv.engine._sequences
        # the reaped sequence continues from nothing
        assert _step(addr, 3, {"sequence_id": 5}) == 3
    finally:
        srv.stop()


def _answer(addr, value, params):
    """(HTTP status, the step's sum or the error's status word)."""
    try:
        return 200, _step(addr, value, params)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())["error"].split("]")[0]


@pytest.mark.parametrize("param", ["sequence_durable", "sequence_step"])
def test_durable_and_step_parameters_answer_as_jax(server, param):
    """sequence_durable and sequence_step on servers with no fleet tier:
    the port answers every request as the JAX server does
    (client_tpu/serve/model_runtime.py _sequence_context,
    _sequence_replay): durable state kept locally, a duplicate declared
    step replayed from the retained answer without re-applying, a step
    that skips ahead or one no longer retained refused with a 409."""
    if param == "sequence_durable":
        plan = [(2, {"sequence_id": 77, "sequence_start": True,
                     "sequence_durable": True}),
                (5, {"sequence_id": 77, "sequence_durable": True}),
                (1, {"sequence_id": 78, "sequence_durable": True}),
                (3, {"sequence_id": 77, "sequence_end": True}),
                (4, {"sequence_id": 77, "sequence_durable": True})]
    else:
        plan = [(2, {"sequence_id": 79, "sequence_start": True,
                     "sequence_step": 1}),
                (5, {"sequence_id": 79, "sequence_step": 2}),
                (5, {"sequence_id": 79, "sequence_step": 2}),
                (9, {"sequence_id": 79, "sequence_step": 4}),
                (9, {"sequence_id": 79, "sequence_step": 1}),
                (1, {"sequence_id": 79, "sequence_step": 3,
                     "sequence_end": True}),
                (7, {"sequence_id": 80, "sequence_step": 2})]
    with JaxServer() as jax_server:
        got = [_answer(server.http_address, v, p) for v, p in plan]
        want = [_answer(jax_server.http_address, v, p) for v, p in plan]
    assert got == want
    if param == "sequence_step":
        assert [code for code, _ in got] == [200, 200, 200, 409, 409,
                                             200, 409]
        assert got[2] == got[1]  # the replayed step, not applied twice
        assert got[5] == (200, 8)


def test_stateful_config_and_extension(client):
    """simple_sequence's config carries sequence_batching, as the JAX
    server's does, and the server advertises the sequence extension."""
    cfg = client.get_model_config("simple_sequence")
    assert cfg["sequence_batching"] == {
        "max_sequence_idle_microseconds": 60000000}
    assert "sequence" in client.get_server_metadata()["extensions"]


def test_sequence_requests_bypass_the_front_door_and_the_batcher():
    """A stateful model is never answered from the response cache (each
    identical step executes and accumulates), and a sequence request to a
    dynamically batched model takes the direct path with its context."""
    seen = []

    def fn(inputs, params, ctx):
        seen.append(ctx)
        return {"OUT": np.asarray(inputs["IN"])}

    batched = Model("batched_seq", inputs=[TensorSpec("IN", "INT32", [-1])],
                    outputs=[TensorSpec("OUT", "INT32", [-1])], fn=fn,
                    max_batch_size=8, dynamic_batching=True)
    with Server(models=[sequence_model(), batched],
                with_default_models=False, response_cache=ResponseCache(),
                coalescing=True) as s:
        addr = s.http_address
        answers = [_step(addr, 3, {"sequence_id": 1}) for _ in range(3)]
        assert answers == [3, 6, 9]
        body = {"inputs": [{"name": "IN", "shape": [1, 1],
                            "datatype": "INT32", "data": [1]}],
                "parameters": {"sequence_id": 2}}
        s.engine.execute("batched_seq", "", body, b"")
        assert isinstance(seen[-1], SequenceContext)
        assert seen[-1].sequence_id == 2
        assert "batched_seq" not in s.engine._batchers
        stats = {m["name"]: m for m in s.engine.statistics()}
        assert stats["simple_sequence"]["execution_count"] == 3


@pytest.mark.parametrize("param", ["sequence_durable", "sequence_step"])
def test_decoupled_model_refuses_durable_and_step_as_jax(param):
    """A decoupled stateful model refuses sequence_durable and
    sequence_step with the JAX runtime's 400: the commit path exists on
    the unary direct path only (client_tpu/serve/model_runtime.py
    _execute_admitted)."""
    from client_tpu.serve import model_runtime as jrt

    def stream(inputs, params, ctx):
        yield {"OUT": np.zeros((1,), np.int32)}

    request = {"inputs": [{"name": "IN", "shape": [1], "datatype": "INT32",
                           "data": [1]}],
               "parameters": {"sequence_id": 5, "sequence_start": True,
                              param: True if param == "sequence_durable"
                              else 1}}
    answers = []
    for model_cls, spec, engine_cls in (
            (jrt.Model, jrt.TensorSpec, jrt.InferenceEngine),
            (Model, TensorSpec, InferenceEngine)):
        model = model_cls("dec", [spec("IN", "INT32", [1])],
                          [spec("OUT", "INT32", [1])], stream,
                          decoupled=True, stateful=True)
        engine = engine_cls([model])
        try:
            with pytest.raises(Exception) as e:
                engine.execute("dec", "", request, b"")
            answers.append((e.value.status(), e.value.message()))
        finally:
            engine.close()
    assert answers[0] == answers[1]
    assert answers[1][0] == "400"
