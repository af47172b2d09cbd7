"""The port's HTTP client (client_tpu_torch.http) held against the JAX
package's (client_tpu.http), on the CPU.

- The cases of tests/test_http_client.py run with the port's client in
  place of the JAX one (the module's ``httpclient`` is swapped for the
  test), against both servers: the port's ``Server(device="cpu")`` and
  the JAX ``Server()``.  Each case is the JAX test's own body.
- The same calls through both clients give the same answers: metadata
  and config of every builtin model, ``simple`` in JSON and binary,
  compressed requests and responses, the system shared-memory verbs, the
  retry policy and the client tracer, on both servers.
- The transport the port rebuilt on ``http.client`` where the reference
  has urllib3: a server that closes an idle keep-alive connection does
  not fail the next call; a request whose connection drops before its
  answer raises once and is never resent; ``network_timeout`` and a
  per-call ``client_timeout_s`` bound a read; the pool's connections are
  reused.

Every comparison is exact: JSON answers, integers, bytes, float32 values.
"""

import http.server
import socket
import threading
import time

import numpy as np
import pytest

import client_tpu.http as jhttp
import client_tpu.serve.builtins as jbuiltins
import test_http_client as jhc
import test_observability as jobs
from client_tpu import tracing as jtracing
from client_tpu.serve import Server as JaxServer
from client_tpu.utils import InferenceServerException as JaxError
from client_tpu.utils import shared_memory as jsysshm
from client_tpu_torch import http as phttp
from client_tpu_torch import resilience, tracing
from client_tpu_torch.serve import Server
from client_tpu_torch.serve import builtins as pbuiltins
from client_tpu_torch.serve.builtins import default_models
from client_tpu_torch.utils import InferenceServerException as PortError
from client_tpu_torch.utils import shared_memory as psysshm


@pytest.fixture(scope="module")
def servers():
    with Server(device="cpu") as port, JaxServer() as ref:
        yield {"torch": port, "jax": ref}


@pytest.fixture(params=["torch", "jax"])
def server(request, servers, monkeypatch):
    """One of the two servers; the JAX test bodies build their inputs
    with the port's types, catch either package's exception, and add the
    server's own package's ``identity_model``."""
    monkeypatch.setattr(jhc, "httpclient", phttp)
    monkeypatch.setattr(jhc, "InferenceServerException", (JaxError, PortError))
    if request.param == "torch":
        monkeypatch.setattr(jbuiltins, "identity_model",
                            pbuiltins.identity_model)
    s = servers[request.param]
    s.server_kind = request.param
    return s


@pytest.fixture()
def client(server):
    with phttp.InferenceServerClient(server.http_address,
                                     concurrency=4) as c:
        c.server_kind = server.server_kind
        yield c


# -- (a) tests/test_http_client.py with the port's client ---------------------


class TestHealthPortClient(jhc.TestHealth):
    """tests/test_http_client.py::TestHealth."""


class TestMetadataPortClient(jhc.TestMetadata):
    """tests/test_http_client.py::TestMetadata; the server metadata names
    the server the client reached."""

    def test_server_metadata(self, client):
        meta = client.get_server_metadata()
        if client.server_kind == "jax":
            assert meta["name"] == "client_tpu.serve"
            assert "tpu_shared_memory" in meta["extensions"]
        else:
            assert meta["name"] == "client_tpu_torch.serve"
            assert "cuda_shared_memory" in meta["extensions"]


class TestInferPortClient(jhc.TestInfer):
    """tests/test_http_client.py::TestInfer on the builtin models."""


class TestAsyncInferPortClient(jhc.TestAsyncInfer):
    """tests/test_http_client.py::TestAsyncInfer on ``simple``."""


class TestPipeliningPortClient(jhc.TestPipelining):
    """tests/test_http_client.py::TestPipelining: the port's static
    request builder and response parser around a raw POST."""


class TestManagementPortClient(jhc.TestManagement):
    """tests/test_http_client.py::TestManagement: repository, statistics,
    trace and log settings, a CUDA register with a 16-byte handle both
    servers refuse (the pooled connection survives it), a percent-encoded
    model name."""


class TestSequenceHttpPortClient(jhc.TestSequenceHttp):
    """tests/test_http_client.py::TestSequenceHttp."""


class TestTenantPropagationPortClient:
    """tests/test_http_client.py::TestTenantPropagation's sync cases with
    the port's client against the JAX server (the aio case waits for an
    asyncio client in the port)."""

    test_tenant_kwarg_stamps_every_verb = (
        jhc.TestTenantPropagation.test_tenant_kwarg_stamps_every_verb)
    test_explicit_header_wins_over_tenant_kwarg = (
        jhc.TestTenantPropagation.test_explicit_header_wins_over_tenant_kwarg)

    @pytest.fixture(autouse=True)
    def _port_client(self, monkeypatch):
        monkeypatch.setattr(jhc, "httpclient", phttp)


# -- (b) the same calls through both clients -----------------------------------


def _both(address):
    return (phttp.InferenceServerClient(address),
            jhttp.InferenceServerClient(address))


@pytest.mark.parametrize("server_kind", ["torch", "jax"])
def test_metadata_and_config_of_every_builtin_equal_jax_client(servers,
                                                               server_kind):
    names = [m.name for m in default_models(device="cpu")]
    port, ref = _both(servers[server_kind].http_address)
    with port, ref:
        assert port.get_server_metadata() == ref.get_server_metadata()
        for name in names:
            assert (port.get_model_metadata(name)
                    == ref.get_model_metadata(name)), name
            assert (port.get_model_config(name)
                    == ref.get_model_config(name)), name
            assert port.is_model_ready(name) == ref.is_model_ready(name)
        assert port.is_server_live() and port.is_server_ready()
        assert port.server_state() == ref.server_state()


def _simple_io(mod, values=(0, 2), binary=True):
    inputs = [mod.InferInput("INPUT0", [1, 16], "INT32"),
              mod.InferInput("INPUT1", [1, 16], "INT32")]
    inputs[0].set_data_from_numpy(
        np.arange(16, dtype=np.int32).reshape(1, 16) + values[0],
        binary_data=binary)
    inputs[1].set_data_from_numpy(np.full((1, 16), values[1], np.int32),
                                  binary_data=binary)
    outputs = [mod.InferRequestedOutput("OUTPUT0", binary_data=binary),
               mod.InferRequestedOutput("OUTPUT1", binary_data=binary)]
    return inputs, outputs


def _simple(c, mod, values=(0, 2), binary=True, **kw):
    """``simple`` through client *c* of package *mod*."""
    inputs, outputs = _simple_io(mod, values, binary)
    return c.infer("simple", inputs, outputs=outputs, **kw)


@pytest.mark.parametrize("server_kind", ["torch", "jax"])
@pytest.mark.parametrize("binary", [True, False], ids=["binary", "json"])
def test_simple_infer_equals_jax_client(servers, server_kind, binary):
    """``simple`` in binary and in JSON through both clients: equal
    responses and outputs."""
    port, ref = _both(servers[server_kind].http_address)
    with port, ref:
        for values in ((0, 2), (-7, 100)):
            a = _simple(port, phttp, values, binary, request_id="r")
            b = _simple(ref, jhttp, values, binary, request_id="r")
            assert a.get_response() == b.get_response()
            for name in ("OUTPUT0", "OUTPUT1"):
                np.testing.assert_array_equal(a.as_numpy(name),
                                              b.as_numpy(name))


@pytest.mark.parametrize("server_kind", ["torch", "jax"])
@pytest.mark.parametrize("algorithm", ["gzip", "deflate"])
def test_compressed_request_and_response_equal_jax_client(servers,
                                                          server_kind,
                                                          algorithm):
    """A compressed request, and a response asked for compressed: the
    same answer through both clients, and the same bytes as uncompressed."""
    port, ref = _both(servers[server_kind].http_address)
    with port, ref:
        kw = {"request_compression_algorithm": algorithm,
              "response_compression_algorithm": algorithm}
        a = _simple(port, phttp, (3, 4), **kw)
        b = _simple(ref, jhttp, (3, 4), **kw)
        plain = _simple(port, phttp, (3, 4))
        assert a.get_response() == b.get_response() == plain.get_response()
        for name in ("OUTPUT0", "OUTPUT1"):
            np.testing.assert_array_equal(a.as_numpy(name), b.as_numpy(name))
            np.testing.assert_array_equal(a.as_numpy(name),
                                          plain.as_numpy(name))


@pytest.mark.parametrize("server_kind", ["torch", "jax"])
def test_system_shm_verbs_equal_jax_client(servers, server_kind):
    """Register, status, infer from and into system regions, unregister:
    each step's answer through the port's client equals the JAX client's
    (the port's own system-shm module makes the regions)."""
    port, ref = _both(servers[server_kind].http_address)
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    b = np.full((1, 16), 3, dtype=np.int32)
    answers = {}
    with port, ref:
        for label, c, shm, mod in (("torch", port, psysshm, phttp),
                                   ("jax", ref, jsysshm, jhttp)):
            # one key for both clients, in turn: the status answers name it
            key = f"/ctt_http_{server_kind}"
            h_in = shm.create_shared_memory_region("in", key + "i", 128)
            h_out = shm.create_shared_memory_region("out", key + "o", 128)
            try:
                shm.set_shared_memory_region(h_in, [a, b])
                c.register_system_shared_memory("in", key + "i", 128)
                c.register_system_shared_memory("out", key + "o", 128)
                status = c.get_system_shared_memory_status()
                one = c.get_system_shared_memory_status("in")
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
                after = c.get_system_shared_memory_status()
                answers[label] = (status, one, result.get_response(),
                                  [g.tolist() for g in got], after)
            finally:
                c.unregister_system_shared_memory()
                shm.destroy_shared_memory_region(h_in)
                shm.destroy_shared_memory_region(h_out)
    assert answers["torch"] == answers["jax"]
    assert answers["torch"][3] == [(a + b).tolist(), (a - b).tolist()]


def test_cuda_shm_verbs_on_the_port(servers):
    """``register_cuda_shared_memory`` with a CPU region's handle (the
    in-process broker resolves it): ``simple`` from and into the regions
    equals the wire answer bit for bit; status lists, unregister drops."""
    from client_tpu_torch.utils import cuda_shared_memory as cudashm

    server = servers["torch"]
    a = np.arange(16, dtype=np.int32).reshape(1, 16)
    b = np.full((1, 16), 9, dtype=np.int32)
    h_in = cudashm.create_shared_memory_region("hcin", 128, device="cpu")
    h_out = cudashm.create_shared_memory_region("hcout", 128, device="cpu")
    try:
        cudashm.set_shared_memory_region(h_in, [a, b])
        with phttp.InferenceServerClient(server.http_address) as c:
            c.register_cuda_shared_memory(
                "hcin", cudashm.get_raw_handle(h_in), 0, 128)
            c.register_cuda_shared_memory(
                "hcout", cudashm.get_raw_handle(h_out), 0, 128)
            names = sorted(r["name"] for r in
                           c.get_cuda_shared_memory_status())
            assert names == ["hcin", "hcout"]
            inputs = [phttp.InferInput("INPUT0", [1, 16], "INT32"),
                      phttp.InferInput("INPUT1", [1, 16], "INT32")]
            inputs[0].set_shared_memory("hcin", 64)
            inputs[1].set_shared_memory("hcin", 64, offset=64)
            outputs = [phttp.InferRequestedOutput("OUTPUT0"),
                       phttp.InferRequestedOutput("OUTPUT1")]
            outputs[0].set_shared_memory("hcout", 64)
            outputs[1].set_shared_memory("hcout", 64, offset=64)
            c.infer("simple", inputs, outputs=outputs)
            wire = _simple(c, phttp, (0, 9))
            for name, offset in (("OUTPUT0", 0), ("OUTPUT1", 64)):
                np.testing.assert_array_equal(
                    cudashm.get_contents_as_numpy(h_out, np.int32, [1, 16],
                                                  offset=offset),
                    wire.as_numpy(name))
            c.unregister_cuda_shared_memory("hcin")
            names = [r["name"] for r in c.get_cuda_shared_memory_status()]
            assert names == ["hcout"]
            c.unregister_cuda_shared_memory()
            assert c.get_cuda_shared_memory_status() == []
    finally:
        cudashm.destroy_shared_memory_region(h_in)
        cudashm.destroy_shared_memory_region(h_out)


def test_the_client_has_no_tpu_verbs():
    """The port's server refuses the TPU shared-memory verbs, so the
    port's client has none (as its gRPC client)."""
    names = {n for n in dir(phttp.InferenceServerClient) if "tpu" in n}
    assert names == set()
    assert {n for n in dir(jhttp.InferenceServerClient) if "tpu" in n} == {
        "get_tpu_shared_memory_status", "register_tpu_shared_memory",
        "unregister_tpu_shared_memory"}


def test_retry_policy_on_the_client_survives_a_shed(servers, monkeypatch):
    """A client with a RetryPolicy: the first two infer attempts answer
    503 with a Retry-After hint, the third answers; each client, the
    port's and the JAX one, makes the same three attempts."""
    attempts = []
    for mod, res in ((phttp, resilience), (jhttp, None)):
        from client_tpu import resilience as jres

        res = res or jres
        policy = res.RetryPolicy(max_attempts=3, initial_backoff_s=0.001,
                                 max_backoff_s=0.002, jitter=False)
        with mod.InferenceServerClient(servers["torch"].http_address,
                                       retry_policy=policy) as c:
            real = c._request_once
            seen = []

            class _Shed:
                status = 503
                headers = {"Retry-After": "0.001"}
                data = b'{"error": "shed"}'

            def shed_twice(method, uri, *args, _real=real, _seen=seen,
                           **kwargs):
                if uri.endswith("/infer"):
                    _seen.append(uri)
                    if len(_seen) <= 2:
                        return _Shed()
                return _real(method, uri, *args, **kwargs)

            monkeypatch.setattr(c, "_request_once", shed_twice)
            r = _simple(c, mod)
            np.testing.assert_array_equal(
                r.as_numpy("OUTPUT0"),
                np.arange(16, dtype=np.int32).reshape(1, 16) + 2)
            attempts.append(len(seen))
    assert attempts == [3, 3]


def test_http_client_tracer_joins_the_server_span(tmp_path):
    """Mirrors tests/test_observability.py::TestEndToEndTracing::
    test_http_infer_joins_client_and_server_spans with the port's client
    and tracer on the port's server; the trace file reads back alike
    through both packages' readers."""
    trace_file = str(tmp_path / "trace.jsonl")
    case = jobs.TestEndToEndTracing()
    with Server(device="cpu", http_port=0) as s:
        case._enable(s, trace_file)
        tracer = tracing.ClientTracer(trace_file=trace_file)
        with phttp.InferenceServerClient(s.http_address,
                                         tracer=tracer) as c:
            _simple(c, phttp)
    records = tracing.read_trace_file(trace_file)
    assert records == jtracing.read_trace_file(trace_file)
    assert len(records) == 2
    case._assert_joined(records)
    assert tracer.traces[0].attempts() == 1
    client = next(r for r in records if r["source"] == "client")
    assert client["model_name"] == "simple"


# -- (c) the transport rebuilt on http.client ---------------------------------


class _Toy:
    """A raw HTTP/1.1 server on loopback for transport cases: answers
    ``GET /v2/health/live`` with 200 and, per mode, closes the
    connection after answering with no ``Connection: close`` (an idle
    keep-alive timeout), drops it before answering, or answers late.
    Counts connections and requests."""

    def __init__(self, mode="keep", delay_s=0.0):
        toy = self
        self.connections = 0
        self.requests = 0
        self.closed = threading.Event()

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def setup(self):
                super().setup()
                toy.connections += 1

            def do_GET(self):  # noqa: N802 -- the stdlib's name
                toy.requests += 1
                if mode == "drop":
                    self.close_connection = True
                    return
                if delay_s:
                    time.sleep(delay_s)
                body = b"{}"
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                if mode == "idle_close":
                    self.close_connection = True

            def finish(self):
                super().finish()
                toy.closed.set()

            def log_message(self, *args):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                     Handler)
        self.httpd.daemon_threads = True
        # a client that timed out leaves the late answer a broken pipe
        self.httpd.handle_error = lambda request, address: None
        self.address = "127.0.0.1:%d" % self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_idle_keepalive_closed_by_the_server_does_not_fail_the_next_call():
    """The server closes each connection after its answer, as an idle
    keep-alive timeout does: every next call notices the pooled
    connection is gone and opens a new one; none fails."""
    toy = _Toy("idle_close")
    try:
        with phttp.InferenceServerClient(toy.address) as c:
            for i in range(4):
                toy.closed.clear()
                r = c._request_once("GET", "v2/health/live")
                assert r.status == 200
                assert toy.closed.wait(5)  # the server closed it, idle
                time.sleep(0.05)  # its FIN reaches the client's socket
        assert toy.requests == 4 and toy.connections == 4
    finally:
        toy.close()


def test_keepalive_connection_is_reused():
    """A server that keeps connections: three calls from one thread ride
    one connection."""
    toy = _Toy("keep")
    try:
        with phttp.InferenceServerClient(toy.address) as c:
            for _ in range(3):
                assert c.is_server_live()
        assert toy.requests == 3 and toy.connections == 1
    finally:
        toy.close()


def test_a_dropped_request_raises_once_and_is_never_resent():
    """The server reads the request and closes without an answer: the
    call raises a connection-level error, and the server saw it once (the
    reference's ``retries=False``)."""
    toy = _Toy("drop")
    try:
        with phttp.InferenceServerClient(toy.address) as c:
            with pytest.raises(PortError) as err:
                c._request_once("GET", "v2/health/live")
            assert resilience.is_connection_level(err.value)
            assert not c.is_server_live()
        assert toy.requests == 2
    finally:
        toy.close()


@pytest.mark.parametrize("how", ["network_timeout", "client_timeout_s"])
def test_a_late_answer_times_out(how):
    """``network_timeout`` bounds a read, and so does a call's
    ``client_timeout_s``: a server that answers after 2 s makes the call
    raise a connection-level timeout well before that."""
    toy = _Toy("keep", delay_s=2.0)
    try:
        kw = {"network_timeout": 0.3} if how == "network_timeout" else {}
        with phttp.InferenceServerClient(toy.address, **kw) as c:
            t0 = time.monotonic()
            with pytest.raises(PortError) as err:
                c._request_once("GET", "v2/health/live",
                                timeout_s=(0.3 if how == "client_timeout_s"
                                           else None))
            assert time.monotonic() - t0 < 1.5
            assert resilience.is_connection_level(err.value)
        assert toy.requests == 1
    finally:
        toy.close()


def test_an_unreachable_server_is_connection_level():
    """A refused connect: health verbs answer False and UNREACHABLE, an
    infer raises a connection-level error, as with the JAX client."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    address = "127.0.0.1:%d" % sock.getsockname()[1]
    sock.close()
    port, ref = _both(address)
    with port, ref:
        assert port.is_server_live() is ref.is_server_live() is False
        assert port.server_state() == ref.server_state() == "UNREACHABLE"
        with pytest.raises(PortError) as err:
            _simple(port, phttp)
        assert resilience.is_connection_level(err.value)
