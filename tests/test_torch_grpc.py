"""The port's gRPC frontend (client_tpu_torch.serve.grpc_server) held
against client_tpu's, on the CPU.

- The cases of tests/test_grpc_client.py run unchanged against the port's
  ``Server(device="cpu", grpc_port=0)`` with the JAX package's own gRPC
  client (``client_tpu.grpc``): the classes below subclass the JAX test
  classes, so each case is the JAX test's own body, answered by the
  port's server.  The cases that build their own JAX server get mirrors.
- The flagship: three concurrent gRPC streams of the port's float32
  ``lm_streaming_batched`` give exactly the JAX serial runner's tokens on
  the same weights, and a stream the client stops gives its KV blocks
  back, as the JAX server does under the same stop.
- The same requests to both servers' gRPC frontends give equal protos.
- The engine takes the gRPC frontend's list of per-tensor buffers as the
  JAX engine does.

Every comparison is exact: integers, bytes, protos, float32 greedy tokens.
"""

import dataclasses
import os
import queue
import subprocess
import sys
import threading
import time
import urllib.request

import grpc
import jax
import numpy as np
import pytest

import client_tpu.grpc as grpcclient
import client_tpu.http as httpclient
import test_grpc_client as jg
import test_observability as jobs
from client_tpu._grpc_service import build_stubs
from client_tpu._proto import inference_pb2 as pb
from client_tpu.serve import Server as JaxServer
from client_tpu.serve.models import language as jlanguage
from client_tpu.serve.models import transformer as jtfm
from client_tpu.tracing import ClientTracer, read_trace_file
from client_tpu.utils import InferenceServerException
from client_tpu.utils import shared_memory as sysshm
from client_tpu_torch import convert
from client_tpu_torch._proto import inference_pb2 as port_pb
from client_tpu_torch.serve import Server
from client_tpu_torch.serve.builtins import default_models
from client_tpu_torch.serve.frontdoor import TenantQoS
from client_tpu_torch.serve.model_runtime import SERVER_EXTENSIONS
from client_tpu_torch.serve.models import language
from client_tpu_torch.serve.models import transformer as tfm
from client_tpu_torch.utils import (
    InferenceServerException as PortInferenceServerException,
)


@pytest.fixture(scope="module")
def server():
    with Server(device="cpu", grpc_port=0) as s:
        yield s


@pytest.fixture()
def client(server):
    with grpcclient.InferenceServerClient(server.grpc_address) as c:
        yield c


@pytest.fixture(scope="module")
def jax_server():
    with JaxServer(grpc_port=0) as s:
        yield s


def _stubs(address):
    channel = grpc.insecure_channel(address)
    return channel, build_stubs(channel)


def test_protos_are_the_reference_classes():
    """The port's generated modules are byte copies of the JAX package's:
    both register the same files in protobuf's default pool, so the two
    packages share one set of message classes."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("inference_pb2.py", "model_config_pb2.py"):
        with open(os.path.join(here, "client_tpu", "_proto", name), "rb") as a, \
                open(os.path.join(here, "client_tpu_torch", "_proto", name),
                     "rb") as b:
            assert a.read() == b.read()
    assert port_pb.ModelInferRequest is pb.ModelInferRequest
    assert port_pb.ModelStreamInferResponse is pb.ModelStreamInferResponse


# -- (a) tests/test_grpc_client.py against the port's server ------------------


class TestHealthMetadataPort(jg.TestHealthMetadata):
    """tests/test_grpc_client.py::TestHealthMetadata; the server metadata
    names the port and its extensions (cuda_shared_memory where the
    reference names tpu_shared_memory)."""

    def test_server_metadata(self, client):
        meta = client.get_server_metadata()
        assert meta.name == "client_tpu_torch.serve"
        meta_json = client.get_server_metadata(as_json=True)
        assert "cuda_shared_memory" in meta_json["extensions"]
        assert list(meta.extensions) == SERVER_EXTENSIONS


class TestInferPort(jg.TestInfer):
    """tests/test_grpc_client.py::TestInfer on the builtin models."""


class TestAsyncInferPort(jg.TestAsyncInfer):
    """tests/test_grpc_client.py::TestAsyncInfer on ``simple``."""


class TestStreamingPort(jg.TestStreaming):
    """tests/test_grpc_client.py::TestStreaming: two sequences on one
    stream, a decoupled stream, a stream error, a second stream refused."""


class TestManagementPort:
    """tests/test_grpc_client.py::TestManagement's cases but
    ``test_cuda_shm_rejected`` (the port serves CUDA regions; its mirror
    is ``TestSharedMemoryVerbs``)."""

    test_repository = jg.TestManagement.test_repository
    test_load_with_config = jg.TestManagement.test_load_with_config
    test_statistics = jg.TestManagement.test_statistics
    test_trace_settings = jg.TestManagement.test_trace_settings
    test_log_settings = jg.TestManagement.test_log_settings


# -- (b) mirrors of the JAX tests that build their own server -----------------


class TestTenantPropagationPort:
    """tests/test_grpc_client.py::TestTenantPropagation against the port's
    server and its TenantQoS."""

    def test_tenant_kwarg_stamps_unary_and_stream(self):
        qos = TenantQoS()
        with Server(device="cpu", grpc_port=0, qos=qos) as server:
            with grpcclient.InferenceServerClient(
                server.grpc_address, tenant="acme"
            ) as client:
                assert client.is_server_ready()
                inputs, i0, i1 = jg._simple_inputs()
                result = client.infer("simple", inputs)
                np.testing.assert_array_equal(
                    result.as_numpy("OUTPUT0"), i0 + i1
                )
            snapshot = qos.snapshot()
            assert "acme" in snapshot
            assert snapshot["acme"]["requests"] >= 1

    def test_explicit_header_wins_over_tenant_kwarg(self):
        qos = TenantQoS()
        with Server(device="cpu", grpc_port=0, qos=qos) as server:
            with grpcclient.InferenceServerClient(
                server.grpc_address, tenant="acme"
            ) as client:
                inputs, _, _ = jg._simple_inputs()
                client.infer(
                    "simple", inputs, headers={"x-tenant-id": "override"}
                )
            snapshot = qos.snapshot()
            assert "override" in snapshot and "acme" not in snapshot

    def test_aio_tenant_kwarg(self):
        import asyncio

        import client_tpu.grpc.aio as aiogrpc

        qos = TenantQoS()
        with Server(device="cpu", grpc_port=0, qos=qos) as server:

            async def run():
                async with aiogrpc.InferenceServerClient(
                    server.grpc_address, tenant="aio-acme"
                ) as client:
                    inputs, _, _ = jg._simple_inputs()
                    await client.infer("simple", inputs)

            asyncio.run(run())
            assert "aio-acme" in qos.snapshot()


class TestSharedMemoryVerbs:
    """The mirror of tests/test_grpc_client.py::TestManagement::
    test_cuda_shm_rejected: the port serves CUDA regions and refuses TPU
    ones, as its HTTP frontend does."""

    def test_tpu_shm_rejected(self, client):
        with pytest.raises(InferenceServerException,
                           match=r"use CudaSharedMemoryRegister") as e:
            client.register_tpu_shared_memory("r", b"\x00" * 8, 0, 64)
        assert e.value.status() == "INVALID_ARGUMENT"
        assert "TPU shared memory is not supported" in e.value.message()
        status = client.get_tpu_shared_memory_status()
        assert len(status.regions) == 0
        client.unregister_tpu_shared_memory("r")  # a no-op

    def test_bogus_cuda_handle_answers_as_http(self, server, client):
        """A CUDA register with a handle this CPU server cannot open gets
        the same refusal over gRPC (INVALID_ARGUMENT) as over HTTP (400),
        word for word, and registers nothing."""
        with pytest.raises(InferenceServerException) as g:
            client.register_cuda_shared_memory("r", b"\x00" * 8, 0, 64)
        with httpclient.InferenceServerClient(server.http_address) as hc:
            with pytest.raises(InferenceServerException) as h:
                hc.register_cuda_shared_memory("r", b"\x00" * 8, 0, 64)
        assert g.value.status() == "INVALID_ARGUMENT"
        assert h.value.status() == "400"
        assert g.value.message() == h.value.message()
        assert len(client.get_cuda_shared_memory_status().regions) == 0

    def test_cuda_status_and_unregister(self, server, client):
        """CudaSharedMemoryStatus answers the engine's cuda_status();
        unregister removes the region (a CPU region of this process,
        resolved by the in-process broker)."""
        from client_tpu_torch.utils import cuda_shared_memory as cudashm

        region = cudashm.create_shared_memory_region("grpc_r", 64,
                                                     device="cpu")
        try:
            client.register_cuda_shared_memory(
                "grpc_r", cudashm.get_raw_handle(region), 0, 64)
            status = client.get_cuda_shared_memory_status()
            got = status.regions["grpc_r"]
            assert (got.name, got.device_id, got.byte_size) == (
                "grpc_r", 0, 64)
            assert server.engine.shm.cuda_status() == {
                "grpc_r": {"name": "grpc_r", "device_id": 0,
                           "byte_size": 64}}
            client.unregister_cuda_shared_memory("grpc_r")
            assert len(client.get_cuda_shared_memory_status().regions) == 0
        finally:
            client.unregister_cuda_shared_memory()
            cudashm.destroy_shared_memory_region(region)


# -- (c) the flagship: lm_streaming_batched over gRPC -------------------------

_LM_JCFG = jtfm.TransformerConfig(
    vocab_size=258, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq=64, dtype="float32",
)
# shorter than one KV block (16): no prompt leaves a full block in the
# prefix cache, so a released stream leaves the pool empty
_PROMPTS = ("hello, grpc", "abc", "stream me")
_TOKENS = 6
_STOP_MAX = 48
_STOP_AFTER = 2
# tokens a stopped stream may make past the stop: the port's server
# cancels the engine handle as the RPC ends (StreamCancel, from
# context.add_callback; 4-5 made here, 3 under six busy processes); the
# JAX handler leaves that to grpcio dropping it and keeps the stream's
# own bound
_MADE_MAX = {"torch": _STOP_AFTER + 8, "jax": _STOP_MAX - 1}


@pytest.fixture(scope="module")
def lm():
    """The JAX weights from a seed, the JAX serial runner's tokens for
    each prompt, and both packages' lm_streaming_batched behind a gRPC
    server (the port's in float32 on the CPU, the weights carried over)."""
    jparams = jtfm.init_params(jax.random.PRNGKey(0), _LM_JCFG)
    jrunner = jlanguage._LmRunner(cfg=_LM_JCFG, params=jparams)
    prompts = [jlanguage.encode_text(p).tolist() for p in _PROMPTS]
    want = [list(jrunner.stream(np.asarray(p, np.int32), _TOKENS))
            for p in prompts]
    runner = language._LmRunner(
        cfg=tfm.TransformerConfig(**dataclasses.asdict(_LM_JCFG)),
        params=convert.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), "cpu"),
        device="cpu")
    model = language.lm_streaming_batched_model(
        runner=runner, max_slots=4, lane_counts=(4,))
    jmodel = jlanguage.lm_streaming_batched_model(
        runner=jrunner, max_slots=4, lane_counts=(4,))
    with Server(models=[model], grpc_port=0,
                with_default_models=False) as port, \
            JaxServer(models=[jmodel], grpc_port=0,
                      with_default_models=False) as ref:
        yield {"prompts": prompts, "want": want,
               "torch": (port, model.closer.__self__),
               "jax": (ref, jmodel.closer.__self__)}


def _lm_stream(address, prompt, n, stop_after=None, headers=None):
    """One client's stream (tests/test_continuous.py::
    test_grpc_batched_model_concurrent's run_stream); with *stop_after*
    the client cancels the stream after that many tokens.  *headers* ride
    the stream's metadata."""
    results = queue.Queue()
    client = grpcclient.InferenceServerClient(address)
    client.start_stream(
        callback=lambda result, error: results.put((result, error)),
        headers=headers,
    )
    t_in = grpcclient.InferInput("TOKENS", [len(prompt)], "INT32")
    t_in.set_data_from_numpy(np.asarray(prompt, dtype=np.int32))
    m_in = grpcclient.InferInput("MAX_TOKENS", [1], "INT32")
    m_in.set_data_from_numpy(np.array([n], dtype=np.int32))
    client.async_stream_infer(
        "lm_streaming_batched", [t_in, m_in],
        enable_empty_final_response=True,
    )
    toks = []
    final = False
    while True:
        r, e = results.get(timeout=120)
        assert e is None, e
        if r.get_response().parameters["triton_final_response"].bool_param:
            final = True
            break
        toks.append(int(r.as_numpy("TOKEN")[0]))
        if stop_after is not None and len(toks) == stop_after:
            client.stop_stream(cancel_requests=True)
            break
    client.stop_stream()
    client.close()
    return toks, final


def test_grpc_batched_model_concurrent_equals_jax_serial(lm):
    """Mirrors tests/test_continuous.py::test_grpc_batched_model_concurrent:
    three concurrent streams on the port's engine, each exactly the JAX
    serial runner's greedy tokens, each closed by a final response."""
    server, sched = lm["torch"]
    got = [None] * len(lm["prompts"])
    threads = [
        threading.Thread(
            target=lambda i=i, p=p: got.__setitem__(
                i, _lm_stream(server.grpc_address, p, _TOKENS)))
        for i, p in enumerate(lm["prompts"])
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert got == [(w, True) for w in lm["want"]]
    assert all(len(w) == _TOKENS for w in lm["want"])


def _wait_released(sched, timeout=30):
    deadline = time.monotonic() + timeout
    while sched.kv.used_blocks and time.monotonic() < deadline:
        time.sleep(0.01)
    return sched.kv.used_blocks


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_stopped_stream_gives_its_blocks_back(lm, pkg):
    """A client that stops its stream after two tokens ends the engine's
    stream early: the handle is cancelled and its KV blocks return, on
    the port as on the JAX server.  The port's server cancels the engine
    handle as soon as the RPC ends, so the engine makes at most a few
    tokens past the stop."""
    server, sched = lm[pkg]
    before = server.engine.metrics.get("ctpu_lm_tokens_total") or 0
    toks, final = _lm_stream(server.grpc_address, lm["prompts"][0],
                             _STOP_MAX, stop_after=_STOP_AFTER)
    assert toks == lm["want"][0][:_STOP_AFTER] and not final
    assert _wait_released(sched) == 0
    made = server.engine.metrics.get("ctpu_lm_tokens_total") - before
    assert _STOP_AFTER <= made <= _MADE_MAX[pkg]


# -- (d) the same requests to both servers ------------------------------------


def test_metadata_and_config_of_every_builtin_equal_jax(server, jax_server):
    """ModelMetadata and ModelConfig of every builtin model: equal protos
    from both servers (every config the port serves parses), but that the
    tiny vision pipeline's three models name their platform and backend
    "torch" where the reference's name "jax"."""
    names = [m.name for m in default_models(device="cpu")]
    assert len(names) > 10
    answers = {}
    for label, s in (("torch", server), ("jax", jax_server)):
        channel, stubs = _stubs(s.grpc_address)
        with channel:
            answers[label] = [
                (stubs["ModelMetadata"](pb.ModelMetadataRequest(name=n)),
                 stubs["ModelConfig"](pb.ModelConfigRequest(name=n)))
                for n in names]
    renamed = []
    for name, (meta, config), (jmeta, jconfig) in zip(
            names, answers["torch"], answers["jax"]):
        if meta.platform == "torch":
            assert (jmeta.platform, jconfig.config.platform,
                    jconfig.config.backend) == ("jax",) * 3
            assert (config.config.platform, config.config.backend) == (
                "torch", "torch")
            renamed.append(name)
            meta.platform = "jax"
            config.config.platform = config.config.backend = "jax"
        assert (meta, config) == (jmeta, jconfig), name
    assert renamed == ["vision_preprocess", "vision_backbone",
                       "vision_postprocess"]


def test_system_shm_infer_equals_jax(server, jax_server):
    """Mirrors tests/test_shared_memory.py::TestSystemShm::
    test_infer_via_system_shm on both servers: the same response proto,
    the same bytes in the output region, the same region status."""
    i0 = np.arange(16, dtype=np.int32).reshape(1, 16)
    i1 = np.full((1, 16), 3, dtype=np.int32)
    byte_size = i0.nbytes + i1.nbytes
    answers = {}
    for label, s in (("torch", server), ("jax", jax_server)):
        key = f"/grpc_{label}_{os.getpid()}"
        h_in = sysshm.create_shared_memory_region("input_sys", key + "_in",
                                                  byte_size)
        h_out = sysshm.create_shared_memory_region("output_sys",
                                                   key + "_out", byte_size)
        with grpcclient.InferenceServerClient(s.grpc_address) as client:
            try:
                sysshm.set_shared_memory_region(h_in, [i0, i1])
                client.register_system_shared_memory("input_sys",
                                                     key + "_in", byte_size)
                client.register_system_shared_memory("output_sys",
                                                     key + "_out", byte_size)
                status = client.get_system_shared_memory_status()
                inputs = [grpcclient.InferInput("INPUT0", [1, 16], "INT32"),
                          grpcclient.InferInput("INPUT1", [1, 16], "INT32")]
                inputs[0].set_shared_memory("input_sys", i0.nbytes)
                inputs[1].set_shared_memory("input_sys", i1.nbytes,
                                            offset=i0.nbytes)
                outputs = [grpcclient.InferRequestedOutput("OUTPUT0"),
                           grpcclient.InferRequestedOutput("OUTPUT1")]
                outputs[0].set_shared_memory("output_sys", i0.nbytes)
                outputs[1].set_shared_memory("output_sys", i1.nbytes,
                                             offset=i0.nbytes)
                result = client.infer("simple", inputs, outputs=outputs,
                                      request_id="shm1")
                region = sysshm.get_contents_as_numpy(
                    h_out, np.int32, [2, 16])
                answers[label] = (
                    result.get_response(), region.tobytes(),
                    sorted((r.name, r.offset, r.byte_size)
                           for r in status.regions.values()))
            finally:
                client.unregister_system_shared_memory()
                sysshm.destroy_shared_memory_region(h_in)
                sysshm.destroy_shared_memory_region(h_out)
    assert answers["torch"] == answers["jax"]
    np.testing.assert_array_equal(
        np.frombuffer(answers["torch"][1], np.int32).reshape(2, 16),
        np.concatenate([i0 + i1, i0 - i1]))


def _stream_answers(address, requests):
    channel, stubs = _stubs(address)
    with channel:
        return list(stubs["ModelStreamInfer"](iter(requests), timeout=60))


def _simple_request(model="simple", rid="r1"):
    request = pb.ModelInferRequest(model_name=model, id=rid)
    for name in ("INPUT0", "INPUT1"):
        t = request.inputs.add()
        t.name, t.datatype = name, "INT32"
        t.shape.extend([1, 16])
        request.raw_input_contents.append(
            np.arange(16, dtype=np.int32).tobytes())
    return request


def test_stream_error_equals_jax(server, jax_server):
    """A stream request to an unknown model, then a good one: the same
    error_message (with its "[<status>] " prefix and the request id) and
    the same answer after it, from both servers."""
    requests = [_simple_request("nope", "bad1"), _simple_request("simple")]
    got = _stream_answers(server.grpc_address, requests)
    want = _stream_answers(jax_server.grpc_address, requests)
    assert got == want
    assert got[0].error_message.startswith("[400] ")
    assert got[0].infer_response.id == "bad1"
    assert not got[1].error_message


def test_decoupled_model_infer_equals_jax(server, jax_server):
    """ModelInfer on a decoupled model: INVALID_ARGUMENT, "use
    ModelStreamInfer", word for word as the JAX server, and the refused
    request's admission slot is released."""
    request = pb.ModelInferRequest(model_name="repeat_int32")
    t = request.inputs.add()
    t.name, t.datatype = "IN", "INT32"
    t.shape.append(1)
    request.raw_input_contents.append(np.array([3], np.int32).tobytes())
    answers = []
    for s in (server, jax_server):
        channel, stubs = _stubs(s.grpc_address)
        with channel:
            with pytest.raises(grpc.RpcError) as e:
                stubs["ModelInfer"](request, timeout=60)
        answers.append((e.value.code(), e.value.details()))
    assert answers[0] == answers[1]
    assert answers[0][0] == grpc.StatusCode.INVALID_ARGUMENT
    assert "use ModelStreamInfer" in answers[0][1]
    assert server.engine.inflight_count() == 0


# -- (e) tracing and the wire profiler ----------------------------------------


def test_grpc_infer_joins_client_and_server_spans(tmp_path):
    """Mirrors tests/test_observability.py::TestEndToEndTracing::
    test_grpc_infer_joins_client_and_server_spans on the port's server;
    the request is profiled as one "grpc" wire tick."""
    trace_file = str(tmp_path / "trace.jsonl")
    tracing = jobs.TestEndToEndTracing()
    with Server(device="cpu", http_port=0, grpc_port=0) as s:
        tracing._enable(s, trace_file)
        tracer = ClientTracer(trace_file=trace_file)
        with grpcclient.InferenceServerClient(
            s.grpc_address, tracer=tracer
        ) as c:
            jobs._grpc_infer_simple(c)
        with urllib.request.urlopen(
                f"http://{s.http_address}/v2/debug/prof?window=0",
                timeout=60) as resp:
            import json

            engines = {e["engine"]: e
                       for e in json.loads(resp.read())["engines"]}
    records = read_trace_file(trace_file)
    assert len(records) == 2
    tracing._assert_joined(records)
    server = next(r for r in records if r["source"] == "server")
    assert server["protocol"] == "grpc"
    assert server["model_name"] == "simple"
    assert engines["wire"]["kinds"] == {"grpc": 1}


def test_stream_span_ends_at_its_compute_end(lm, tmp_path):
    """A traced stream on the port's server: RESPONSE_SENT is stamped when
    the last response went out, so the server span ends at the model's
    COMPUTE_END and the slot bookkeeping after it lies outside the span.
    The port's traceview (the reference's attribution) then misses the
    client's duration by the span's head alone, REQUEST_START to
    QUEUE_START (queue ends where compute starts)."""
    from client_tpu_torch import traceview
    from client_tpu_torch.tracing import ClientTracer as PortTracer
    from client_tpu_torch.tracing import client_span

    port = lm["torch"][0]
    server_file = str(tmp_path / "server.jsonl")
    client_file = str(tmp_path / "client.jsonl")
    port.engine.update_trace_settings({
        "trace_level": ["TIMESTAMPS"], "trace_rate": "1",
        "trace_count": "-1", "trace_file": server_file})
    tracer = PortTracer(trace_file=client_file, trace_rate=1)
    try:
        with client_span(tracer, "lm_streaming_batched") as trace:
            toks, final = _lm_stream(
                port.grpc_address, lm["prompts"][0], _TOKENS,
                headers={"traceparent": trace.traceparent()})
    finally:
        port.engine.update_trace_settings({"trace_level": ["OFF"],
                                           "trace_file": ""})
    assert final and toks == lm["want"][0]
    traces = traceview.join_traces(
        traceview.load_records([client_file, server_file]))
    joined = [spans for spans in traces.values()
              if any(r.get("source") == "client" for r in spans)]
    assert len(joined) == 1
    spans = joined[0]
    server = [r for r in spans if r.get("source") == "server"
              and not str(r.get("model_name")).startswith("__")]
    assert len(server) == 1
    stamps = {e["name"]: e["ns"] for e in server[0]["timestamps"]}
    names = [e["name"] for e in server[0]["timestamps"]]
    assert names[0] == "REQUEST_START" and names[-1] == "RESPONSE_SENT"
    assert stamps["QUEUE_END"] == stamps["COMPUTE_START"]
    assert stamps["RESPONSE_SENT"] <= stamps["COMPUTE_END"]
    assert stamps["COMPUTE_END"] == max(stamps.values())
    cp = traceview.critical_path(spans)
    head_ms = (stamps["QUEUE_START"] - stamps["REQUEST_START"]) / 1e6
    assert cp["total_ms"] - (cp["queue_ms"] + cp["compute_ms"]
                             + cp["wire_ms"]) == pytest.approx(
                                 head_ms, abs=1e-6)


# -- (f) the engine takes a list of per-tensor buffers -------------------------


def _buffers_request(model):
    if model == "simple":
        a = np.arange(16, dtype=np.int32).reshape(1, 16)
        b = np.full((1, 16), 5, dtype=np.int32)
        parts = [a.tobytes(), b.tobytes()]
        inputs = [{"name": n, "datatype": "INT32", "shape": [1, 16],
                   "parameters": {"binary_data_size": len(p)}}
                  for n, p in zip(("INPUT0", "INPUT1"), parts)]
    else:
        from client_tpu.utils import serialize_byte_tensor

        raw = serialize_byte_tensor(
            np.array([b"per", b"tensor"], dtype=np.object_)).tobytes()
        parts = [raw]
        inputs = [{"name": "INPUT0", "datatype": "BYTES", "shape": [2],
                   "parameters": {"binary_data_size": len(raw)}}]
    return {"id": "parts", "inputs": inputs,
            "parameters": {"binary_data_output": True}}, parts


def _execute(engine, model, request, parts):
    try:
        response, blobs = engine.execute(model, "", request, parts)
        return response, [bytes(b) for b in blobs]
    except (InferenceServerException, PortInferenceServerException) as e:
        return e.status(), e.message()


@pytest.mark.parametrize("model", ["simple", "identity_bytes"])
def test_execute_takes_per_tensor_buffers(server, jax_server, model):
    """InferenceEngine.execute with the binary section as a list of
    per-tensor buffers (the gRPC frontend's form): the JAX runtime's
    answer; a short part and a missing part get its 400."""
    request, parts = _buffers_request(model)
    got = _execute(server.engine, model, request, parts)
    assert got == _execute(jax_server.engine, model, request, parts)
    assert isinstance(got[0], dict) and got[0]["id"] == "parts"
    for bad in ([parts[0][:-1]] + parts[1:], parts[:-1]):
        got = _execute(server.engine, model, request, bad)
        assert got == _execute(jax_server.engine, model, request, bad)
        assert got[0] == "400" and "binary section underrun" in got[1]


# -- perf_analyzer over gRPC --------------------------------------------------


def test_perf_analyzer_grpc_async_against_the_port(server):
    """Mirrors tests/test_perf.py::TestAsyncConcurrencyManager::
    test_cli_async_mode: the JAX
    package's perf_analyzer drives the port's server over gRPC."""
    proc = subprocess.run(
        [sys.executable, "-m", "client_tpu.perf", "-m", "simple",
         "-u", server.grpc_address, "-i", "grpc", "--async",
         "--concurrency-range", "4:4:1",
         "--measurement-interval", "500", "--max-trials", "4"],
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Best: concurrency=" in proc.stdout
