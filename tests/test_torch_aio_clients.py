"""The port's asyncio clients (client_tpu_torch.grpc.aio and
client_tpu_torch.http.aio) held against the JAX package's
(client_tpu.grpc.aio, client_tpu.http.aio), on the CPU.

- The cases of tests/test_aio_clients.py (TestHttpAio, TestGrpcAio,
  TestHttpAioParity, TestGrpcAioParity) run with the port's modules in
  place of the JAX ones (the JAX test bodies' ``import
  client_tpu.{grpc,http}.aio`` reaches the port's module for the test),
  against both servers: the port's ``Server(device="cpu", grpc_port=0,
  http_port=0)`` and the JAX ``Server(grpc_port=0)``.  Each case is the
  JAX test's own body, but where the server's name or its device
  shared-memory verbs differ: the TPU verb case becomes the CUDA verbs on
  CPU regions against the port's server (the in-process broker resolves
  them).
- tests/test_http_client.py's and tests/test_grpc_client.py's
  ``test_aio_tenant_kwarg`` with the port's aio clients.
- The same calls through both packages' aio clients give the same
  answers, on both servers.
- ``acall_with_retry`` against the JAX one: the same policy with a
  seeded rng and a coroutine that fails N times give the same attempts,
  delays and observer calls; both aio clients retry a shed call.

Every comparison is exact: protos, JSON answers, integers, float32.
"""

import asyncio
import random
import sys

import numpy as np
import pytest

import client_tpu.grpc as jgrpc
import client_tpu.grpc.aio as jgrpc_aio
import client_tpu.http as jhttp
import client_tpu.http.aio as jhttp_aio
import test_aio_clients as ja
import test_grpc_client as jg
import test_http_client as jhc
from client_tpu import resilience as jresilience
from client_tpu.serve import Server as JaxServer
from client_tpu.utils import InferenceServerException as JaxError
from client_tpu_torch import grpc as pgrpc
from client_tpu_torch import http as phttp
from client_tpu_torch import resilience
from client_tpu_torch.grpc import aio as pgrpc_aio
from client_tpu_torch.http import aio as phttp_aio
from client_tpu_torch.serve import Server
from client_tpu_torch.utils import InferenceServerException as PortError
from client_tpu_torch.utils import cuda_shared_memory as cudashm


@pytest.fixture(scope="module")
def servers():
    with Server(device="cpu", grpc_port=0, http_port=0) as port, \
            JaxServer(grpc_port=0) as ref:
        yield {"torch": port, "jax": ref}


@pytest.fixture
def port_aio(monkeypatch):
    """The JAX test bodies import the port's aio modules, build their
    inputs with the port's types and catch either package's exception."""
    for pkg, name, mod in ((jgrpc, "client_tpu.grpc.aio", pgrpc_aio),
                           (jhttp, "client_tpu.http.aio", phttp_aio)):
        monkeypatch.setattr(pkg, "aio", mod)
        monkeypatch.setitem(sys.modules, name, mod)
    monkeypatch.setattr(ja, "InferenceServerException", (JaxError, PortError))
    monkeypatch.setattr(jhc, "httpclient", phttp)
    monkeypatch.setattr(jg, "grpcclient", pgrpc)


@pytest.fixture(params=["torch", "jax"])
def server(request, servers, port_aio):
    s = servers[request.param]
    s.server_kind = request.param
    return s


def _server_name(server):
    return {"torch": "client_tpu_torch.serve",
            "jax": "client_tpu.serve"}[server.server_kind]


# -- (a) tests/test_aio_clients.py with the port's aio clients ----------------


class TestHttpAioPortClient(ja.TestHttpAio):
    """tests/test_aio_clients.py::TestHttpAio; the server metadata names
    the server the client reached."""

    def test_full_flow(self, server):
        async def flow():
            async with phttp_aio.InferenceServerClient(
                    server.http_address) as c:
                assert await c.is_server_live()
                assert await c.is_server_ready()
                assert await c.is_model_ready("simple")
                meta = await c.get_server_metadata()
                assert meta["name"] == _server_name(server)
                inputs, i0, i1 = ja._simple_inputs(phttp_aio)
                result = await c.infer("simple", inputs)
                np.testing.assert_array_equal(result.as_numpy("OUTPUT0"),
                                              i0 + i1)
                stats = await c.get_inference_statistics("simple")
                assert stats["model_stats"][0]["inference_count"] >= 1
                index = await c.get_model_repository_index()
                assert any(m["name"] == "simple" for m in index)

        ja._run(flow())


class TestGrpcAioPortClient(ja.TestGrpcAio):
    """tests/test_aio_clients.py::TestGrpcAio; the server metadata names
    the server the client reached."""

    def test_full_flow(self, server):
        async def flow():
            async with pgrpc_aio.InferenceServerClient(
                    server.grpc_address) as c:
                assert await c.is_server_live()
                assert await c.is_model_ready("simple")
                meta = await c.get_server_metadata()
                assert meta.name == _server_name(server)
                inputs, i0, i1 = ja._simple_inputs(pgrpc_aio)
                result = await c.infer("simple", inputs)
                np.testing.assert_array_equal(result.as_numpy("OUTPUT0"),
                                              i0 + i1)
                cfg = await c.get_model_config("simple")
                assert cfg.config.max_batch_size == 8
                stats = await c.get_inference_statistics("simple")
                assert stats.model_stats[0].inference_count >= 1

        ja._run(flow())


class TestHttpAioParityPortClient(ja.TestHttpAioParity):
    """tests/test_aio_clients.py::TestHttpAioParity."""


class TestGrpcAioParityPortClient(ja.TestGrpcAioParity):
    """tests/test_aio_clients.py::TestGrpcAioParity; the TPU verb case is
    the CUDA verbs below."""

    test_tpu_shm_verbs = None  # the port's server has no TPU regions


def _cuda_region(name, size=64):
    return cudashm.create_shared_memory_region(name, size, device="cpu")


def test_grpc_aio_cuda_shm_verbs(servers):
    """TestGrpcAioParity::test_tpu_shm_verbs with the CUDA verbs: a CPU
    region registered by its handle on the port's server, listed by
    status, dropped by unregister."""
    handle = _cuda_region("aio_cuda")
    try:
        async def flow():
            async with pgrpc_aio.InferenceServerClient(
                    servers["torch"].grpc_address) as c:
                await c.register_cuda_shared_memory(
                    "aio_cuda", cudashm.get_raw_handle(handle), 0, 64)
                status = await c.get_cuda_shared_memory_status(as_json=True)
                assert status["regions"]["aio_cuda"]["byte_size"] == "64"
                one = await c.get_cuda_shared_memory_status("aio_cuda")
                assert list(one.regions) == ["aio_cuda"]
                await c.unregister_cuda_shared_memory("aio_cuda")
                status = await c.get_cuda_shared_memory_status(as_json=True)
                assert "aio_cuda" not in status.get("regions", {})

        ja._run(flow())
    finally:
        cudashm.destroy_shared_memory_region(handle)


def test_http_aio_cuda_shm_verbs_serve_simple(servers):
    """The HTTP aio client's CUDA verbs on the port's server: ``simple``
    from and into CPU regions equals the wire answer bit for bit, and the
    status, then unregister, agree with the sync client's."""
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    b = np.full((1, 16), 9, dtype=np.int32)
    h_in, h_out = _cuda_region("aio_cin", 128), _cuda_region("aio_cout", 128)
    address = servers["torch"].http_address
    try:
        cudashm.set_shared_memory_region(h_in, [a, b])

        async def flow():
            async with phttp_aio.InferenceServerClient(address) as c:
                for name, h in (("aio_cin", h_in), ("aio_cout", h_out)):
                    await c.register_cuda_shared_memory(
                        name, cudashm.get_raw_handle(h), 0, 128)
                status = await c.get_cuda_shared_memory_status()
                inputs = [phttp_aio.InferInput("INPUT0", [1, 16], "INT32"),
                          phttp_aio.InferInput("INPUT1", [1, 16], "INT32")]
                inputs[0].set_shared_memory("aio_cin", 64)
                inputs[1].set_shared_memory("aio_cin", 64, offset=64)
                outputs = [phttp_aio.InferRequestedOutput("OUTPUT0"),
                           phttp_aio.InferRequestedOutput("OUTPUT1")]
                outputs[0].set_shared_memory("aio_cout", 64)
                outputs[1].set_shared_memory("aio_cout", 64, offset=64)
                await c.infer("simple", inputs, outputs=outputs)
                wire_in = [phttp_aio.InferInput("INPUT0", [1, 16], "INT32"),
                           phttp_aio.InferInput("INPUT1", [1, 16], "INT32")]
                wire_in[0].set_data_from_numpy(a)
                wire_in[1].set_data_from_numpy(b)
                wire = await c.infer("simple", wire_in)
                await c.unregister_cuda_shared_memory("aio_cin")
                after_one = await c.get_cuda_shared_memory_status()
                await c.unregister_cuda_shared_memory()
                return status, wire, after_one, (
                    await c.get_cuda_shared_memory_status())

        status, wire, after_one, after_all = ja._run(flow())
        assert sorted(r["name"] for r in status) == ["aio_cin", "aio_cout"]
        with phttp.InferenceServerClient(address) as sync:
            assert [r["name"] for r in after_one] == ["aio_cout"]
            assert after_all == sync.get_cuda_shared_memory_status() == []
        for name, offset in (("OUTPUT0", 0), ("OUTPUT1", 64)):
            np.testing.assert_array_equal(
                cudashm.get_contents_as_numpy(h_out, np.int32, [1, 16],
                                              offset=offset),
                wire.as_numpy(name))
    finally:
        cudashm.destroy_shared_memory_region(h_in)
        cudashm.destroy_shared_memory_region(h_out)


class TestTenantPropagationAioPortClient:
    """``test_aio_tenant_kwarg`` of tests/test_http_client.py and
    tests/test_grpc_client.py with the port's aio clients, against the
    JAX server."""

    test_http_aio_tenant_kwarg = jhc.TestTenantPropagation.test_aio_tenant_kwarg
    test_grpc_aio_tenant_kwarg = jg.TestTenantPropagation.test_aio_tenant_kwarg

    @pytest.fixture(autouse=True)
    def _port_clients(self, port_aio):
        pass


def test_aio_tenant_kwarg_on_the_port_server():
    """The same two cases against the port's server with its TenantQoS:
    the tenant= kwarg reaches the server from both aio clients."""
    from client_tpu_torch.serve.frontdoor import TenantQoS

    qos = TenantQoS()
    with Server(device="cpu", grpc_port=0, http_port=0, qos=qos) as server:
        async def run():
            async with phttp_aio.InferenceServerClient(
                    server.http_address, tenant="aio-http") as c:
                await c.infer("simple", ja._simple_inputs(phttp_aio)[0])
            async with pgrpc_aio.InferenceServerClient(
                    server.grpc_address, tenant="aio-grpc") as c:
                await c.infer("simple", ja._simple_inputs(pgrpc_aio)[0])

        asyncio.run(run())
    snapshot = qos.snapshot()
    assert snapshot["aio-http"]["requests"] >= 1
    assert snapshot["aio-grpc"]["requests"] >= 1


# -- (b) the same calls through both packages' aio clients --------------------


async def _grpc_calls(mod, address):
    async with mod.InferenceServerClient(address) as c:
        inputs, _, _ = ja._simple_inputs(mod)
        result = await c.infer("simple", inputs)

        async def requests():
            for v in (1, 2, 3):
                inp = mod.InferInput("INPUT", [1], "INT32")
                inp.set_data_from_numpy(np.array([v], dtype=np.int32))
                yield {"model_name": "simple_sequence", "inputs": [inp],
                       "sequence_id": 4242,
                       "sequence_start": v == 1, "sequence_end": v == 3}

        streamed = []
        async for r, error in c.stream_infer(requests()):
            assert error is None
            streamed.append(r.as_numpy("OUTPUT").tolist())
            if len(streamed) == 3:
                break
        try:
            await c.infer("nope", inputs)
            unknown = None
        except (JaxError, PortError) as e:
            unknown = e.status()
        return {
            "live": await c.is_server_live(),
            "ready": await c.is_model_ready("simple"),
            "not_ready": await c.is_model_ready("nope"),
            "metadata": await c.get_model_metadata("simple", as_json=True),
            "config": await c.get_model_config("identity", as_json=True),
            "trace": await c.get_trace_settings(as_json=True),
            "outputs": {n: result.as_numpy(n).tolist()
                        for n in ("OUTPUT0", "OUTPUT1")},
            "streamed": streamed,
            "unknown_model": unknown,
        }


async def _http_calls(mod, address):
    async with mod.InferenceServerClient(address) as c:
        inputs, _, _ = ja._simple_inputs(mod)
        binary = await c.infer("simple", inputs)
        gzipped = await c.infer("simple", inputs,
                                request_compression_algorithm="gzip",
                                response_compression_algorithm="gzip")
        as_json = [mod.InferInput("INPUT0", [1, 16], "INT32"),
                   mod.InferInput("INPUT1", [1, 16], "INT32")]
        as_json[0].set_data_from_numpy(np.arange(16, dtype=np.int32)
                                       .reshape(1, 16), binary_data=False)
        as_json[1].set_data_from_numpy(np.full((1, 16), 3, np.int32),
                                       binary_data=False)
        json_result = await c.infer("simple", as_json)
        try:
            await c.infer("nope", inputs)
            unknown = None
        except (JaxError, PortError) as e:
            unknown = (e.status(), e.message())
        return {
            "live": await c.is_server_live(),
            "ready": await c.is_model_ready("simple"),
            "not_ready": await c.is_model_ready("nope"),
            "metadata": await c.get_model_metadata("simple"),
            "config": await c.get_model_config("identity"),
            "trace": await c.get_trace_settings(),
            "outputs": [r.as_numpy(n).tolist()
                        for r in (binary, gzipped, json_result)
                        for n in ("OUTPUT0", "OUTPUT1")],
            "unknown_model": unknown,
            "system_regions": await c.get_system_shared_memory_status(),
        }


@pytest.mark.parametrize("kind", ["torch", "jax"])
@pytest.mark.parametrize("protocol", ["grpc", "http"])
def test_both_aio_clients_answer_alike(servers, kind, protocol):
    """Health, metadata, config, trace settings, ``simple`` (binary,
    JSON and gzip over HTTP), a ``simple_sequence`` stream over gRPC and
    an unknown model's error: the port's aio client gets exactly what the
    JAX package's gets from the same server."""
    server = servers[kind]
    if protocol == "grpc":
        calls, address = _grpc_calls, server.grpc_address
        mods = (pgrpc_aio, jgrpc_aio)
    else:
        calls, address = _http_calls, server.http_address
        mods = (phttp_aio, jhttp_aio)
    port, ref = (ja._run(calls(mod, address)) for mod in mods)
    assert port == ref
    if protocol == "grpc":
        assert port["streamed"] == [[1], [3], [6]]
        assert port["unknown_model"] == "INVALID_ARGUMENT"


# -- (c) the asyncio retry ----------------------------------------------------


class _Observer:
    def __init__(self):
        self.calls = []

    def on_backoff(self, attempt, delay_s, exc):
        self.calls.append(("backoff", attempt, delay_s, exc.status()))

    def on_giveup(self, attempt, exc):
        self.calls.append(("giveup", attempt, exc.status()))

    def on_success(self, attempt):
        self.calls.append(("success", attempt))


@pytest.mark.parametrize("failures,status", [
    (0, "UNAVAILABLE"), (2, "UNAVAILABLE"), (3, "503"), (5, "UNAVAILABLE"),
    (1, "INVALID_ARGUMENT"),
])
def test_acall_with_retry_equals_jax(failures, status):
    """The same attempts, jittered delays (a seeded rng) and observer
    calls, and the same outcome, as client_tpu.resilience's
    ``acall_with_retry``."""
    outcomes = []
    for mod, exc_cls in ((resilience, PortError), (jresilience, JaxError)):
        observer = _Observer()
        policy = mod.RetryPolicy(max_attempts=4, initial_backoff_s=0.002,
                                 rng=random.Random(17), observer=observer)
        calls = []

        async def fn(timeout):
            calls.append(timeout)
            await asyncio.sleep(0)
            if len(calls) <= failures:
                raise exc_cls("shed", status=status)
            return "ok"

        try:
            result = ja._run(mod.acall_with_retry(fn, policy))
        except exc_cls as e:
            result = ("raised", e.status())
        outcomes.append((result, calls, observer.calls))
    assert outcomes[0] == outcomes[1]
    attempts = 1 if status == "INVALID_ARGUMENT" else min(failures + 1, 4)
    assert len(outcomes[0][1]) == attempts


@pytest.mark.parametrize("protocol", ["grpc", "http"])
def test_aio_retry_policy_survives_a_shed(servers, monkeypatch, protocol):
    """An aio client with a RetryPolicy on the port's server: the first two
    ``infer`` attempts are shed (UNAVAILABLE, 503), the third answers."""
    server = servers["torch"]
    policy = resilience.RetryPolicy(max_attempts=3, initial_backoff_s=0.001,
                                    jitter=False)
    mod, address, shed = {
        "grpc": (pgrpc_aio, server.grpc_address, "UNAVAILABLE"),
        "http": (phttp_aio, server.http_address, "503")}[protocol]
    seen = []

    async def flow():
        async with mod.InferenceServerClient(address,
                                             retry_policy=policy) as c:
            real = c._attempt_once

            async def shed_twice(*args, **kwargs):
                seen.append(args[0])
                if len(seen) <= 2:
                    raise PortError("shed", status=shed)
                return await real(*args, **kwargs)

            monkeypatch.setattr(c, "_attempt_once", shed_twice)
            inputs, i0, i1 = ja._simple_inputs(mod)
            result = await c.infer("simple", inputs)
            np.testing.assert_array_equal(result.as_numpy("OUTPUT0"), i0 + i1)

    ja._run(flow())
    assert len(seen) == 3
