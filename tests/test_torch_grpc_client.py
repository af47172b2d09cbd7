"""The port's gRPC client (client_tpu_torch.grpc) held against the JAX
package's (client_tpu.grpc), on the CPU.

- The cases of tests/test_grpc_client.py run with the port's client in
  place of the JAX one (the module's ``grpcclient`` is swapped for the
  test), against both servers: the port's ``Server(device="cpu",
  grpc_port=0)`` and the JAX ``Server(grpc_port=0)``.  Each case is the
  JAX test's own body.
- The same calls through both clients give the same answers: metadata
  and config of every builtin model, ``simple``, the system shared-memory
  verbs and a ``ModelStreamInfer`` stream, on both servers.
- Request building, the result wrapper, ``InferInput`` (a torch tensor
  in place of a ``jax.Array``), the retry policy and the client tracer
  against the JAX package's.

Every comparison is exact: protos, integers, bytes, float32 values.
"""

import queue
import threading

import numpy as np
import pytest
import torch

import client_tpu.grpc as jgrpc
import test_grpc_client as jg
import test_observability as jobs
from client_tpu import resilience as jresilience
from client_tpu import tracing as jtracing
from client_tpu._grpc_infer import build_infer_request as jbuild
from client_tpu.serve import Server as JaxServer
from client_tpu.utils import InferenceServerException as JaxError
from client_tpu.utils import shared_memory as jsysshm
from client_tpu_torch import grpc as pgrpc
from client_tpu_torch import resilience, tracing
from client_tpu_torch._grpc_infer import InferResult, build_infer_request
from client_tpu_torch.serve import Server
from client_tpu_torch.serve.builtins import default_models
from client_tpu_torch.utils import InferenceServerException as PortError
from client_tpu_torch.utils import cuda_shared_memory as cudashm


@pytest.fixture(scope="module")
def servers():
    with Server(device="cpu", grpc_port=0, http_port=0) as port, \
            JaxServer(grpc_port=0) as ref:
        yield {"torch": port, "jax": ref}


@pytest.fixture(params=["torch", "jax"])
def client(request, servers, monkeypatch):
    """The port's client on one of the two servers; the JAX test bodies
    build their inputs with the port's types and catch either package's
    exception."""
    monkeypatch.setattr(jg, "grpcclient", pgrpc)
    monkeypatch.setattr(jg, "InferenceServerException", (JaxError, PortError))
    with pgrpc.InferenceServerClient(
            servers[request.param].grpc_address) as c:
        c.server_kind = request.param
        yield c


# -- (a) tests/test_grpc_client.py with the port's client ---------------------


class TestHealthMetadataPortClient(jg.TestHealthMetadata):
    """tests/test_grpc_client.py::TestHealthMetadata; the server metadata
    names the server the client reached."""

    def test_server_metadata(self, client):
        meta = client.get_server_metadata(as_json=True)
        if client.server_kind == "jax":
            assert meta["name"] == "client_tpu.serve"
            assert "tpu_shared_memory" in meta["extensions"]
        else:
            assert meta["name"] == "client_tpu_torch.serve"
            assert "cuda_shared_memory" in meta["extensions"]


class TestInferPortClient(jg.TestInfer):
    """tests/test_grpc_client.py::TestInfer on the builtin models."""


class TestAsyncInferPortClient(jg.TestAsyncInfer):
    """tests/test_grpc_client.py::TestAsyncInfer on ``simple``."""


class TestStreamingPortClient(jg.TestStreaming):
    """tests/test_grpc_client.py::TestStreaming: two sequences on one
    stream, a decoupled stream, a stream error, a second stream refused."""


class TestManagementPortClient(jg.TestManagement):
    """tests/test_grpc_client.py::TestManagement: repository, statistics,
    trace and log settings, and a CUDA register with an 8-byte handle,
    which both servers refuse."""


class TestTenantPropagationPortClient:
    """tests/test_grpc_client.py::TestTenantPropagation's sync cases with
    the port's client against the JAX server (the aio case waits for the
    port's grpc.aio client)."""

    test_tenant_kwarg_stamps_unary_and_stream = (
        jg.TestTenantPropagation.test_tenant_kwarg_stamps_unary_and_stream)
    test_explicit_header_wins_over_tenant_kwarg = (
        jg.TestTenantPropagation.test_explicit_header_wins_over_tenant_kwarg)

    @pytest.fixture(autouse=True)
    def _port_client(self, monkeypatch):
        monkeypatch.setattr(jg, "grpcclient", pgrpc)


# -- (b) the same calls through both clients -----------------------------------


def _both(address):
    return (pgrpc.InferenceServerClient(address),
            jgrpc.InferenceServerClient(address))


@pytest.mark.parametrize("server", ["torch", "jax"])
def test_metadata_and_config_of_every_builtin_equal_jax_client(servers,
                                                               server):
    names = [m.name for m in default_models(device="cpu")]
    port, ref = _both(servers[server].grpc_address)
    with port, ref:
        assert (port.get_server_metadata(as_json=True)
                == ref.get_server_metadata(as_json=True))
        for name in names:
            assert (port.get_model_metadata(name, as_json=True)
                    == ref.get_model_metadata(name, as_json=True)), name
            assert (port.get_model_config(name, as_json=True)
                    == ref.get_model_config(name, as_json=True)), name
            assert port.is_model_ready(name) == ref.is_model_ready(name)


def _simple(mod, values=(0, 2)):
    inputs = [mod.InferInput("INPUT0", [1, 16], "INT32"),
              mod.InferInput("INPUT1", [1, 16], "INT32")]
    inputs[0].set_data_from_numpy(
        np.arange(16, dtype=np.int32).reshape(1, 16) + values[0])
    inputs[1].set_data_from_numpy(np.full((1, 16), values[1], np.int32))
    return inputs


@pytest.mark.parametrize("server", ["torch", "jax"])
def test_simple_infer_equals_jax_client(servers, server):
    """``simple`` through both clients: equal responses and outputs."""
    port, ref = _both(servers[server].grpc_address)
    with port, ref:
        for values in ((0, 2), (-7, 100)):
            a = port.infer("simple", _simple(pgrpc, values), request_id="r")
            b = ref.infer("simple", _simple(jgrpc, values), request_id="r")
            assert a.get_response() == b.get_response()
            for name in ("OUTPUT0", "OUTPUT1"):
                np.testing.assert_array_equal(a.as_numpy(name),
                                              b.as_numpy(name))
            assert (a.get_response(as_json=True)
                    == b.get_response(as_json=True))


@pytest.mark.parametrize("server", ["torch", "jax"])
def test_system_shm_verbs_equal_jax_client(servers, server):
    """Register, status, infer from and into system regions, unregister:
    each step's answer through the port's client equals the JAX client's
    (the port's own system-shm module makes the regions)."""
    from client_tpu_torch.utils import shared_memory as psysshm

    port, ref = _both(servers[server].grpc_address)
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    b = np.full((1, 16), 3, dtype=np.int32)
    answers = {}
    with port, ref:
        for label, c, shm, mod in (("torch", port, psysshm, pgrpc),
                                   ("jax", ref, jsysshm, jgrpc)):
            # one key for both clients, in turn: the status answers name it
            key = f"/ctt_grpc_{server}"
            h_in = shm.create_shared_memory_region("in", key + "i", 128)
            h_out = shm.create_shared_memory_region("out", key + "o", 128)
            try:
                shm.set_shared_memory_region(h_in, [a, b])
                c.register_system_shared_memory("in", key + "i", 128)
                c.register_system_shared_memory("out", key + "o", 128)
                status = c.get_system_shared_memory_status(as_json=True)
                inputs = [mod.InferInput("INPUT0", [1, 16], "INT32"),
                          mod.InferInput("INPUT1", [1, 16], "INT32")]
                inputs[0].set_shared_memory("in", 64)
                inputs[1].set_shared_memory("in", 64, offset=64)
                outputs = [mod.InferRequestedOutput("OUTPUT0"),
                           mod.InferRequestedOutput("OUTPUT1")]
                outputs[0].set_shared_memory("out", 64)
                outputs[1].set_shared_memory("out", 64, offset=64)
                result = c.infer("simple", inputs, outputs=outputs)
                got = (shm.get_contents_as_numpy(h_out, np.int32, [1, 16]),
                       shm.get_contents_as_numpy(h_out, np.int32, [1, 16],
                                                 offset=64))
                c.unregister_system_shared_memory("in")
                after = c.get_system_shared_memory_status(as_json=True)
                answers[label] = (status, result.get_response(as_json=True),
                                  [g.tolist() for g in got], after)
            finally:
                c.unregister_system_shared_memory()
                shm.destroy_shared_memory_region(h_in)
                shm.destroy_shared_memory_region(h_out)
    assert answers["torch"] == answers["jax"]
    assert answers["torch"][2] == [(a + b).tolist(), (a - b).tolist()]


def _stream(mod, address, n):
    results = queue.Queue()
    with mod.InferenceServerClient(address) as c:
        c.start_stream(callback=lambda result, error: results.put(
            (result, error)))
        inp = mod.InferInput("IN", [1], "INT32")
        inp.set_data_from_numpy(np.array([n], dtype=np.int32))
        c.async_stream_infer("repeat_int32", [inp], request_id="s",
                             enable_empty_final_response=True)
        got = []
        while True:
            result, error = results.get(timeout=30)
            assert error is None, error
            response = result.get_response(as_json=True)
            got.append(response)
            if response["parameters"].get(
                    "triton_final_response", {}).get("bool_param"):
                break
        c.stop_stream()
    return got


@pytest.mark.parametrize("server", ["torch", "jax"])
def test_model_stream_infer_equals_jax_client(servers, server):
    """A decoupled ``repeat_int32`` stream with an empty final response:
    every response through the port's client equals the JAX client's."""
    address = servers[server].grpc_address
    got = _stream(pgrpc, address, 4)
    assert got == _stream(jgrpc, address, 4)
    assert len(got) == 5


def test_cuda_shm_infer_equals_wire_on_the_port(servers):
    """``register_cuda_shared_memory`` with a CPU region's handle (the
    in-process broker resolves it): ``simple`` from and into the regions
    equals the wire answer bit for bit; status lists, unregister drops."""
    server = servers["torch"]
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    b = np.full((1, 16), 9, dtype=np.int32)
    h_in = cudashm.create_shared_memory_region("cin", 128, device="cpu")
    h_out = cudashm.create_shared_memory_region("cout", 128, device="cpu")
    try:
        cudashm.set_shared_memory_region(h_in, [a, b])
        with pgrpc.InferenceServerClient(server.grpc_address) as c:
            c.register_cuda_shared_memory(
                "cin", cudashm.get_raw_handle(h_in), 0, 128)
            c.register_cuda_shared_memory(
                "cout", cudashm.get_raw_handle(h_out), 0, 128)
            regions = c.get_cuda_shared_memory_status(as_json=True)["regions"]
            assert sorted(regions) == ["cin", "cout"]
            inputs = [pgrpc.InferInput("INPUT0", [1, 16], "INT32"),
                      pgrpc.InferInput("INPUT1", [1, 16], "INT32")]
            inputs[0].set_shared_memory("cin", 64)
            inputs[1].set_shared_memory("cin", 64, offset=64)
            outputs = [pgrpc.InferRequestedOutput("OUTPUT0"),
                       pgrpc.InferRequestedOutput("OUTPUT1")]
            outputs[0].set_shared_memory("cout", 64)
            outputs[1].set_shared_memory("cout", 64, offset=64)
            c.infer("simple", inputs, outputs=outputs)
            wire = c.infer("simple", _simple(pgrpc, (0, 9)))
            for name, offset in (("OUTPUT0", 0), ("OUTPUT1", 64)):
                np.testing.assert_array_equal(
                    cudashm.get_contents_as_numpy(h_out, np.int32, [1, 16],
                                                  offset=offset),
                    wire.as_numpy(name))
            c.unregister_cuda_shared_memory("cin")
            regions = c.get_cuda_shared_memory_status(as_json=True)["regions"]
            assert sorted(regions) == ["cout"]
            c.unregister_cuda_shared_memory()
    finally:
        cudashm.destroy_shared_memory_region(h_in)
        cudashm.destroy_shared_memory_region(h_out)


def test_concurrent_clients_on_both_servers(servers):
    """Eight threads, each its own port client, four on each server: every
    answer right."""
    errors = []

    def run(server, k):
        try:
            with pgrpc.InferenceServerClient(
                    servers[server].grpc_address) as c:
                for i in range(5):
                    r = c.infer("simple", _simple(pgrpc, (k, i)))
                    want = (np.arange(16, dtype=np.int32).reshape(1, 16)
                            + k + i)
                    np.testing.assert_array_equal(r.as_numpy("OUTPUT0"), want)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(s, k))
               for s in ("torch", "jax") for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


# -- (c) request building, results, value types ---------------------------------


def _io(mod, case):
    if case == "binary":
        inp = mod.InferInput("INPUT0", [2, 3], "FP32")
        inp.set_data_from_numpy(np.arange(6, dtype=np.float32).reshape(2, 3))
        return [inp], [mod.InferRequestedOutput("OUTPUT0")]
    if case == "bytes":
        inp = mod.InferInput("INPUT0", [2], "BYTES")
        inp.set_data_from_numpy(np.array([b"a", b"bc"], dtype=np.object_))
        return [inp], [mod.InferRequestedOutput("OUTPUT0", class_count=3)]
    if case == "json":
        inp = mod.InferInput("INPUT0", [3], "INT64")
        inp.set_data_from_numpy(np.array([1, -2, 3], np.int64),
                                binary_data=False)
        return [inp], None
    inp = mod.InferInput("INPUT0", [4], "INT32")
    inp.set_shared_memory("region", 16, offset=32)
    out = mod.InferRequestedOutput("OUTPUT0")
    out.set_shared_memory("outregion", 8, offset=4)
    return [inp], [out]


@pytest.mark.parametrize("case", ["binary", "bytes", "json", "shm"])
@pytest.mark.parametrize("kw", [
    {},
    {"request_id": "x", "model_version": "2", "priority": 3, "timeout": 7},
    {"sequence_id": 12, "sequence_start": True, "sequence_end": False},
    {"sequence_id": "seq-a", "sequence_end": True},
    {"parameters": {"flag": True, "n": 5, "f": 0.5, "s": "v"}},
])
def test_build_infer_request_equals_jax(case, kw):
    """build_infer_request: the JAX package's proto, field for field."""
    inputs, outputs = _io(pgrpc, case)
    jinputs, joutputs = _io(jgrpc, case)
    got = build_infer_request("m", inputs, outputs=outputs, **kw)
    assert got == jbuild("m", jinputs, outputs=joutputs, **kw)


def test_build_infer_request_refusals_equal_jax():
    """Reserved and unsupported parameters refused with JAX's messages."""
    for kw in ({"parameters": {"sequence_id": 1}},
               {"parameters": {"bad": [1]}}):
        with pytest.raises(PortError) as p:
            build_infer_request("m", _io(pgrpc, "binary")[0], **kw)
        with pytest.raises(JaxError) as j:
            jbuild("m", _io(jgrpc, "binary")[0], **kw)
        assert p.value.message() == j.value.message()
    with pytest.raises(PortError, match="has no data"):
        build_infer_request("m", [pgrpc.InferInput("X", [1], "INT32")])


def test_infer_result_as_numpy_equals_jax():
    """Raw contents and typed contents, decoded by the port's InferResult
    as by the JAX package's; a shared-memory output takes no raw slot."""
    from client_tpu._grpc_infer import InferResult as JaxResult
    from client_tpu_torch._proto import inference_pb2 as pb

    response = pb.ModelInferResponse(model_name="m", id="r")
    raw = response.outputs.add(name="RAW", datatype="FP32", shape=[2, 2])
    del raw
    response.raw_output_contents.append(
        np.arange(4, dtype=np.float32).tobytes())
    shm = response.outputs.add(name="SHM", datatype="INT32", shape=[1])
    shm.parameters["shared_memory_region"].string_param = "r"
    typed = response.outputs.add(name="TYPED", datatype="INT64", shape=[3])
    typed.contents.int64_contents.extend([5, -6, 7])
    text = response.outputs.add(name="TEXT", datatype="BYTES", shape=[2])
    text.contents.bytes_contents.extend([b"x", b"yz"])
    got, want = InferResult(response), JaxResult(response)
    for name in ("RAW", "TYPED", "TEXT", "NONE"):
        a, b = got.as_numpy(name), want.as_numpy(name)
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype and a.tolist() == b.tolist()
    assert got.get_output("TEXT", as_json=True) == want.get_output(
        "TEXT", as_json=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.int8,
                                   torch.bool])
def test_set_data_from_array_takes_a_tensor(dtype):
    """A torch tensor (any device; here the CPU) gives the JAX input's
    bytes and parameters for the same values."""
    t = (torch.arange(12).reshape(3, 4) % 3).to(dtype)
    datatype = {torch.float32: "FP32", torch.int32: "INT32",
                torch.int8: "INT8", torch.bool: "BOOL"}[dtype]
    got = pgrpc.InferInput("X", [3, 4], datatype).set_data_from_array(t)
    want = jgrpc.InferInput("X", [3, 4], datatype).set_data_from_numpy(
        t.numpy())
    assert got.raw_data() == want.raw_data()
    assert got.parameters() == want.parameters()
    with pytest.raises(PortError, match="does not match"):
        pgrpc.InferInput("X", [3, 4], "FP64").set_data_from_array(t)


def test_set_data_from_array_keeps_bf16_bits():
    """A bfloat16 tensor travels as BF16 bit for bit: the bytes of the
    same values as the JAX package's ml_dtypes bfloat16 array."""
    import ml_dtypes

    values = np.array([[1.5, -2.25, 3e-3], [7e4, 0.0, -1e-8]], np.float32)
    t = torch.from_numpy(values).to(torch.bfloat16)
    got = pgrpc.InferInput("X", [2, 3], "BF16").set_data_from_array(t)
    want = jgrpc.InferInput("X", [2, 3], "BF16").set_data_from_numpy(
        values.astype(ml_dtypes.bfloat16))
    assert got.raw_data() == want.raw_data()
    assert got.parameters() == want.parameters()
    with pytest.raises(PortError, match="binary_data=True"):
        pgrpc.InferInput("X", [2, 3], "BF16").set_data_from_array(
            t, binary_data=False)


# -- (d) the retry policy and the client tracer --------------------------------


def _flaky(failures, exc_cls, status):
    calls = []

    def fn(timeout):
        calls.append(timeout)
        if len(calls) <= failures:
            raise exc_cls("shed", status=status)
        return "ok"

    return fn, calls


@pytest.mark.parametrize("failures,status", [
    (0, "UNAVAILABLE"), (2, "UNAVAILABLE"), (3, "503"), (5, "UNAVAILABLE"),
    (1, "INVALID_ARGUMENT"),
])
def test_call_with_retry_equals_jax(failures, status):
    """The same attempts and the same outcome as the JAX package's
    ``call_with_retry`` (no jitter, a 1 ms backoff)."""
    outcomes = []
    for mod, exc_cls in ((resilience, PortError), (jresilience, JaxError)):
        policy = mod.RetryPolicy(max_attempts=4, initial_backoff_s=0.001,
                                 jitter=False)
        fn, calls = _flaky(failures, exc_cls, status)
        try:
            result = mod.call_with_retry(fn, policy)
        except exc_cls as e:
            result = ("raised", e.status())
        outcomes.append((result, calls))
    assert outcomes[0] == outcomes[1]


def test_backoff_and_deadline_equal_jax():
    """backoff_delays, RetryPolicy.backoff_s and delay_for (a Retry-After
    hint capped at max_backoff_s), combine_timeouts and Deadline, as in
    client_tpu.resilience."""
    import random

    got = resilience.backoff_delays(rng=random.Random(3))
    want = jresilience.backoff_delays(rng=random.Random(3))
    assert [next(got) for _ in range(8)] == [next(want) for _ in range(8)]
    policy = resilience.RetryPolicy(jitter=False, max_backoff_s=0.5)
    jpolicy = jresilience.RetryPolicy(jitter=False, max_backoff_s=0.5)
    assert ([policy.backoff_s(k) for k in range(6)]
            == [jpolicy.backoff_s(k) for k in range(6)])
    hinted = PortError("shed", status="503")
    hinted.retry_after_s = 9.0
    assert policy.delay_for(hinted, 0) == 0.5
    assert resilience.combine_timeouts(None, 2) == 2
    assert resilience.combine_timeouts(3, 2) == 2
    deadline = resilience.Deadline(60)
    assert 0 < deadline.attempt_timeout(cap=1.5) <= 1.5
    with pytest.raises(ValueError):
        resilience.Deadline(0)


def test_retry_policy_on_the_client_survives_a_shed(servers, monkeypatch):
    """A client with a RetryPolicy: the first two ModelInfer attempts are
    shed (UNAVAILABLE), the third answers."""
    server = servers["torch"]
    policy = resilience.RetryPolicy(max_attempts=3, initial_backoff_s=0.001,
                                    jitter=False)
    with pgrpc.InferenceServerClient(server.grpc_address,
                                     retry_policy=policy) as c:
        real = c._call_once
        seen = []

        def shed_twice(name, *args, **kwargs):
            if name == "ModelInfer":
                seen.append(name)
                if len(seen) <= 2:
                    raise PortError("shed", status="UNAVAILABLE")
            return real(name, *args, **kwargs)

        monkeypatch.setattr(c, "_call_once", shed_twice)
        r = c.infer("simple", _simple(pgrpc))
        assert len(seen) == 3
        np.testing.assert_array_equal(
            r.as_numpy("OUTPUT0"),
            np.arange(16, dtype=np.int32).reshape(1, 16) + 2)


def test_grpc_client_tracer_joins_the_server_span(tmp_path):
    """Mirrors tests/test_observability.py::TestEndToEndTracing::
    test_grpc_infer_joins_client_and_server_spans with the port's client
    and tracer on the port's server; the trace file reads back alike
    through both packages' readers."""
    trace_file = str(tmp_path / "trace.jsonl")
    jtracing_case = jobs.TestEndToEndTracing()
    with Server(device="cpu", http_port=0, grpc_port=0) as s:
        jtracing_case._enable(s, trace_file)
        tracer = tracing.ClientTracer(trace_file=trace_file)
        with pgrpc.InferenceServerClient(s.grpc_address,
                                         tracer=tracer) as c:
            c.infer("simple", _simple(pgrpc))
    records = tracing.read_trace_file(trace_file)
    assert records == jtracing.read_trace_file(trace_file)
    assert len(records) == 2
    jtracing_case._assert_joined(records)
    client = next(r for r in records if r["source"] == "client")
    assert tracer.traces[0].attempts() == 1
    assert client["model_name"] == "simple"


def test_client_tracer_sampling_equals_jax():
    """``trace_rate`` and context keys sample the same requests."""
    got, want = tracing.ClientTracer(trace_rate=3), jtracing.ClientTracer(
        trace_rate=3)
    for i in range(12):
        key = None if i % 4 else f"seq{i // 8}"
        a, b = got.sample("m", context_key=key), want.sample(
            "m", context_key=key)
        assert (a is None) == (b is None), i
