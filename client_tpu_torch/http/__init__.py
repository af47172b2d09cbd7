"""Synchronous HTTP/REST client for KServe-v2 servers (Triton-compatible).

Counterpart of client_tpu/http/__init__.py, on the port's own codec,
value types, retry policies and tracer: the full management surface, the
binary tensor-data extension, request/response compression, the system
and CUDA shared-memory verbs (``register_cuda_shared_memory`` with a
region's 64-byte IPC handle, client_tpu_torch.utils.cuda_shared_memory),
``async_infer``, and the static ``generate_request_body`` /
``parse_response_body`` pair for request pipelining.  Where the reference
adds the TPU shared-memory verbs, the port's client has none: the port's
server refuses them.

The transport is the standard library's ``http.client`` (the reference's
is urllib3): a thread-safe pool of keep-alive connections sized by
``concurrency``, and ``async_infer`` on a thread pool of the same size.
What urllib3 did for the reference is done here by hand:

- an idle pooled connection the server has closed is found before it is
  reused (its socket polls readable: EOF or stray bytes) and replaced by
  a new one; a request is sent once and never resent (the reference's
  ``retries=False``), so one that fails on the wire raises, and a retry
  policy decides;
- ``connection_timeout`` bounds the connect, ``network_timeout`` each
  socket read; a per-attempt budget (see :meth:`_request_once`) bounds
  the attempt;
- response bodies keep their content encoding, so ``Content-Encoding``
  reaches ``InferResult.from_response_body``; header lookups ignore case;
- ``ssl``, ``ssl_context`` and ``insecure`` build the
  ``http.client.HTTPSConnection``'s ``ssl.SSLContext``.
"""

import base64
import http.client
import json
import select
import ssl as _ssl
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from urllib.parse import quote, urlencode

from client_tpu_torch import _codec
from client_tpu_torch import resilience as _resilience
from client_tpu_torch import tracing as _tracing
from client_tpu_torch._infer_types import (  # noqa: F401  (re-exported API)
    InferInput,
    InferRequestedOutput,
    _np_from_json_data,
)
from client_tpu_torch.utils import (
    SERVER_NOT_READY,
    SERVER_READY,
    SERVER_UNREACHABLE,
    InferenceServerException,
    from_wire_bytes,
    raise_error,
    stamp_tenant as _stamp_tenant,
)

__all__ = [
    "InferenceServerClient",
    "InferInput",
    "InferRequestedOutput",
    "InferResult",
    "InferAsyncRequest",
]

_READ_CHUNK = 1 << 16


def _get_error_from_response(response_body, status, headers=None):
    try:
        msg = json.loads(response_body.decode("utf-8", errors="replace")).get(
            "error", response_body.decode("utf-8", errors="replace")
        )
    except Exception:
        msg = response_body.decode("utf-8", errors="replace")
    exc = InferenceServerException(msg=msg, status=str(status))
    retry_after = (headers or {}).get("Retry-After")
    if retry_after is not None:
        try:
            exc.retry_after_s = float(retry_after)
        except ValueError:
            pass  # HTTP-date form: ignore, the backoff schedule applies
    return exc


class _Response:
    """One answered request: ``status``, ``headers`` (an
    ``http.client.HTTPMessage``: lookups ignore case) and the raw body
    ``data``, still in its content encoding."""

    __slots__ = ("status", "headers", "data")

    def __init__(self, status, headers, data):
        self.status = status
        self.headers = headers
        self.data = data


def _dropped(sock):
    """Whether the server closed an idle keep-alive connection: its
    socket is readable while no request is outstanding (EOF, or bytes no
    request asked for)."""
    poller = select.poll()
    poller.register(sock, select.POLLIN)
    return bool(poller.poll(0))


class _ConnectionPool:
    """Keep-alive connections to one server, shared by threads: ``get``
    takes an idle one or opens a new one, ``put`` keeps up to ``maxsize``
    idle (the reference's urllib3 pool, non-blocking: more than
    ``maxsize`` may be open at once; the surplus closes when returned)."""

    def __init__(self, host, https, ssl_context, connect_timeout,
                 read_timeout, maxsize):
        self._host = host
        self._https = https
        self._ssl_context = ssl_context
        self.connect_timeout = connect_timeout
        self.read_timeout = read_timeout
        self._maxsize = max(1, maxsize)
        self._idle = []
        self._lock = threading.Lock()

    def _new(self):
        if self._https:
            return http.client.HTTPSConnection(
                self._host, timeout=self.connect_timeout,
                context=self._ssl_context)
        return http.client.HTTPConnection(self._host,
                                          timeout=self.connect_timeout)

    def get(self):
        while True:
            with self._lock:
                conn = self._idle.pop() if self._idle else None
            if conn is None:
                return self._new()
            if conn.sock is not None and not _dropped(conn.sock):
                return conn
            conn.close()  # closed by the server while idle: never reused

    def put(self, conn):
        with self._lock:
            if len(self._idle) < self._maxsize:
                self._idle.append(conn)
                return
        conn.close()

    def clear(self):
        with self._lock:
            idle, self._idle = self._idle, []
        for conn in idle:
            conn.close()


class InferAsyncRequest:
    """Handle returned by ``async_infer``; ``get_result()`` blocks for the result.

    Parity: tritonclient.http InferAsyncRequest (reference http/__init__.py:1683).
    """

    def __init__(self, future, verbose=False):
        self._future = future
        self._verbose = verbose

    def get_result(self, block=True, timeout=None):
        if not block and not self._future.done():
            raise_error("inference is not yet completed")
        try:
            return self._future.result(timeout=timeout)
        except InferenceServerException:
            raise
        except Exception as e:  # transport-level failure
            raise InferenceServerException(msg=str(e), debug_details=e) from e

    def cancel(self):
        return self._future.cancel()


class InferResult:
    """Parsed inference response: JSON header + sliced binary output section.

    Parity: reference http/__init__.py:2045-2168.
    """

    def __init__(self, response_header, binary_section, verbose=False):
        self._result = response_header
        self._verbose = verbose
        self._output_name_to_buffer = {}
        offset = 0
        for output in self._result.get("outputs", []):
            params = output.get("parameters", {})
            bin_size = params.get("binary_data_size")
            if bin_size is not None:
                self._output_name_to_buffer[output["name"]] = binary_section[
                    offset : offset + bin_size
                ]
                offset += bin_size

    @classmethod
    def from_response_body(
        cls, response_body, verbose=False, header_length=None, content_encoding=None
    ):
        body = _codec.decompress(bytes(response_body), content_encoding)
        header, binary = _codec.parse_infer_response_body(body, header_length)
        return cls(header, binary, verbose)

    def get_response(self):
        """The response header as a dict (JSON form of ModelInferResponse)."""
        return self._result

    def get_output(self, name):
        """The output's JSON metadata dict, or None if absent."""
        for output in self._result.get("outputs", []):
            if output["name"] == name:
                return output
        return None

    def as_numpy(self, name):
        """Output tensor as a numpy array (None if not present or in shm)."""
        output = self.get_output(name)
        if output is None:
            return None
        shape = output["shape"]
        datatype = output["datatype"]
        if name in self._output_name_to_buffer:
            return from_wire_bytes(
                self._output_name_to_buffer[name], datatype, shape
            )
        if "data" in output:
            return _np_from_json_data(output["data"], datatype, shape)
        return None


class InferenceServerClient:
    """Blocking HTTP client for every KServe-v2 endpoint.

    Parity: reference http/__init__.py:142-1510 (``concurrency`` sizes
    both the connection pool and the async_infer worker pool).
    """

    def __init__(
        self,
        url,
        verbose=False,
        concurrency=1,
        connection_timeout=60.0,
        network_timeout=60.0,
        ssl=False,
        ssl_context=None,
        insecure=False,
        retry_policy=None,
        tracer=None,
        tenant=None,
    ):
        if "://" in url:
            scheme, _, rest = url.partition("://")
            if scheme not in ("http", "https"):
                raise_error(f"unsupported scheme '{scheme}' in url")
            url = rest
            ssl = ssl or scheme == "https"
        scheme = "https" if ssl else "http"
        self._endpoint = url  # host:port identity (trace attempt spans)
        host, _, prefix = url.partition("/")
        self._origin = f"{scheme}://{host}"
        self._prefix = "/" + (prefix.strip("/") + "/" if prefix else "")
        self._verbose = verbose
        self._concurrency = concurrency
        context = None
        if ssl:
            context = ssl_context or _ssl.create_default_context()
            if insecure:
                context.check_hostname = False
                context.verify_mode = _ssl.CERT_NONE
        self._pool = _ConnectionPool(host, ssl, context, connection_timeout,
                                     network_timeout, concurrency)
        # Opt-in resilience: a client_tpu_torch.resilience.RetryPolicy
        # routes every request through retry/backoff/deadline/circuit-
        # breaker.  None (the default) keeps the single-attempt behavior.
        self._retry_policy = retry_policy
        # Opt-in tracing: a client_tpu_torch.tracing.ClientTracer samples
        # infer calls, records client spans, and propagates a W3C
        # traceparent so the server's trace joins under the same trace id.
        self._tracer = tracer
        # Tenant identity: stamped as the x-tenant-id header on EVERY verb
        # (an explicitly passed header still wins).
        self._tenant = None if tenant is None else str(tenant)
        self._executor = None  # lazily created for async_infer

    # -- lifecycle ----------------------------------------------------------

    def close(self):
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
        self._pool.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- low-level request helpers -----------------------------------------

    def _request(self, method, uri, headers=None, query_params=None, body=None,
                 trace=None, client_timeout_s=None):
        if self._retry_policy is None:
            return self._attempt_once(
                method, uri, headers, query_params, body, client_timeout_s,
                trace,
            )

        def attempt(timeout_s):
            response = self._attempt_once(
                method, uri, headers, query_params, body,
                _resilience.combine_timeouts(timeout_s, client_timeout_s),
                trace,
            )
            # Overload statuses become exceptions so the retry loop sees
            # them (with the server's Retry-After hint attached); retries
            # exhausted -> the same exception _raise_if_error would build.
            if str(response.status) in self._retry_policy.retryable_statuses:
                raise _get_error_from_response(
                    response.data, response.status, response.headers
                )
            return response

        return _resilience.call_with_retry(attempt, self._retry_policy)

    def _attempt_once(self, method, uri, headers, query_params, body,
                      timeout_s, trace):
        """One transport attempt in a trace attempt span — retries show as
        repeated ATTEMPT_START/ATTEMPT_END pairs."""
        with _tracing.attempt_span(trace, endpoint=self._endpoint):
            return self._request_once(
                method, uri, headers, query_params, body, timeout_s
            )

    def _request_once(
        self, method, uri, headers=None, query_params=None, body=None, timeout_s=None
    ):
        """Send one request on a pooled connection and read its whole
        answer; any transport failure raises InferenceServerException with
        the error as its ``debug_details``, and the connection is closed.

        ``timeout_s`` (a retry policy's deadline-derived budget, or the
        caller's ``client_timeout_s``) bounds the attempt: the connect, the
        send and every read of the answer each wait at most the time left
        until the attempt's deadline (and at most ``connection_timeout`` /
        ``network_timeout``), and an attempt past its deadline raises.  A
        read inside ``http.client``'s header parsing is one socket wait set
        before it, so a server that trickles the status line and headers
        byte by byte can stretch that phase; the body is read in chunks,
        each against the time left."""
        headers = _stamp_tenant(headers, self._tenant)
        path = self._prefix + uri
        if query_params:
            path += "?" + urlencode(query_params, doseq=True)
        if self._verbose:
            print(f"{method} {self._origin}{path}, headers {headers}")
        deadline = (None if timeout_s is None
                    else time.monotonic() + max(timeout_s, 1e-3))
        pool = self._pool

        def wait(cap):
            if deadline is None:
                return cap
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError("timed out")
            return left if cap is None else min(cap, left)

        conn = pool.get()
        try:
            if conn.sock is None:
                conn.timeout = wait(pool.connect_timeout)
                conn.connect()
            conn.sock.settimeout(wait(pool.read_timeout))
            conn.request(method, path, body=body, headers={
                k: str(v) for k, v in (headers or {}).items()})
            conn.sock.settimeout(wait(pool.read_timeout))
            resp = conn.getresponse()
            chunks = []
            while True:
                if conn.sock is not None:
                    conn.sock.settimeout(wait(pool.read_timeout))
                chunk = resp.read(_READ_CHUNK)
                if not chunk:
                    break
                chunks.append(chunk)
            if resp.length:
                # EOF before the Content-Length's bytes (the server died
                # mid-answer): http.client's read(amt) returns short
                # where urllib3 raises, so raise as it does
                raise http.client.IncompleteRead(b"".join(chunks),
                                                 resp.length)
            response = _Response(resp.status, resp.headers, b"".join(chunks))
        except Exception as e:
            conn.close()
            raise InferenceServerException(msg=str(e), debug_details=e) from e
        if resp.will_close or conn.sock is None:
            conn.close()
        else:
            pool.put(conn)
        if self._verbose:
            print(response.status)
        return response

    def _get(self, uri, headers=None, query_params=None):
        return self._request("GET", uri, headers, query_params)

    def _post(self, uri, body=b"", headers=None, query_params=None):
        return self._request("POST", uri, headers, query_params, body=body)

    @staticmethod
    def _raise_if_error(response):
        if response.status != 200:
            raise _get_error_from_response(response.data, response.status)

    @staticmethod
    def _json_or_raise(response):
        InferenceServerClient._raise_if_error(response)
        content = _codec.decompress(
            response.data, response.headers.get("Content-Encoding")
        )
        return json.loads(content.decode("utf-8")) if content else {}

    # -- health -------------------------------------------------------------
    # Health verbs answer False on transport/connection errors instead of
    # raising (tritonclient reference semantics): an unreachable server IS
    # not-live/not-ready, and health probes must be safe to poll.  They
    # bypass the retry policy — a draining server's 503 readiness answer
    # is the answer, not a failure to retry through.

    def _probe(self, uri, headers, query_params):
        try:
            r = self._request_once("GET", uri, headers, query_params)
        except InferenceServerException:
            return False
        return r.status == 200

    def is_server_live(self, headers=None, query_params=None):
        return self._probe("v2/health/live", headers, query_params)

    def is_server_ready(self, headers=None, query_params=None):
        return self._probe("v2/health/ready", headers, query_params)

    def server_state(self, headers=None, query_params=None, timeout_s=None):
        """READY / NOT_READY / UNREACHABLE (client_tpu_torch.utils
        constants).

        ``is_server_ready()`` collapses "answered not-ready" (draining) and
        "never answered" (dead) into False; this keeps them apart so a
        replica set can let a draining server finish its in-flight work
        while routing a dead one straight to its circuit breaker.
        ``timeout_s`` bounds the probe (background probers must not hang
        on a black-holed endpoint)."""
        try:
            r = self._request_once("GET", "v2/health/ready", headers,
                                   query_params, timeout_s=timeout_s)
        except InferenceServerException:
            return SERVER_UNREACHABLE
        return SERVER_READY if r.status == 200 else SERVER_NOT_READY

    def is_model_ready(self, model_name, model_version="", headers=None, query_params=None):
        uri = f"v2/models/{quote(model_name, safe='')}"
        if model_version:
            uri += f"/versions/{model_version}"
        return self._probe(uri + "/ready", headers, query_params)

    # -- metadata / config ---------------------------------------------------

    def get_server_metadata(self, headers=None, query_params=None):
        return self._json_or_raise(self._get("v2", headers, query_params))

    def get_model_metadata(
        self, model_name, model_version="", headers=None, query_params=None
    ):
        uri = f"v2/models/{quote(model_name, safe='')}"
        if model_version:
            uri += f"/versions/{model_version}"
        return self._json_or_raise(self._get(uri, headers, query_params))

    def get_model_config(
        self, model_name, model_version="", headers=None, query_params=None
    ):
        uri = f"v2/models/{quote(model_name, safe='')}"
        if model_version:
            uri += f"/versions/{model_version}"
        return self._json_or_raise(self._get(uri + "/config", headers, query_params))

    # -- repository ----------------------------------------------------------

    def get_model_repository_index(self, headers=None, query_params=None):
        return self._json_or_raise(
            self._post("v2/repository/index", b"", headers, query_params)
        )

    def load_model(
        self, model_name, headers=None, query_params=None, config=None, files=None
    ):
        body = {}
        if config is not None:
            body.setdefault("parameters", {})["config"] = (
                config if isinstance(config, str) else json.dumps(config)
            )
        if files:
            for path, content in files.items():
                body.setdefault("parameters", {})[path] = base64.b64encode(
                    content
                ).decode("utf-8")
        r = self._post(
            f"v2/repository/models/{quote(model_name, safe='')}/load",
            json.dumps(body).encode("utf-8") if body else b"",
            headers,
            query_params,
        )
        self._raise_if_error(r)

    def unload_model(
        self, model_name, headers=None, query_params=None, unload_dependents=False
    ):
        body = {"parameters": {"unload_dependents": unload_dependents}}
        r = self._post(
            f"v2/repository/models/{quote(model_name, safe='')}/unload",
            json.dumps(body).encode("utf-8"),
            headers,
            query_params,
        )
        self._raise_if_error(r)

    # -- statistics / trace / log -------------------------------------------

    def get_inference_statistics(
        self, model_name="", model_version="", headers=None, query_params=None
    ):
        if model_name:
            uri = f"v2/models/{quote(model_name, safe='')}"
            if model_version:
                uri += f"/versions/{model_version}"
            uri += "/stats"
        else:
            uri = "v2/models/stats"
        return self._json_or_raise(self._get(uri, headers, query_params))

    def update_trace_settings(
        self, model_name="", settings=None, headers=None, query_params=None
    ):
        uri = (
            f"v2/models/{quote(model_name, safe='')}/trace/setting"
            if model_name
            else "v2/trace/setting"
        )
        r = self._post(
            uri, json.dumps(settings or {}).encode("utf-8"), headers, query_params
        )
        return self._json_or_raise(r)

    def get_trace_settings(self, model_name="", headers=None, query_params=None):
        uri = (
            f"v2/models/{quote(model_name, safe='')}/trace/setting"
            if model_name
            else "v2/trace/setting"
        )
        return self._json_or_raise(self._get(uri, headers, query_params))

    def update_log_settings(self, settings, headers=None, query_params=None):
        r = self._post(
            "v2/logging", json.dumps(settings).encode("utf-8"), headers, query_params
        )
        return self._json_or_raise(r)

    def get_log_settings(self, headers=None, query_params=None):
        return self._json_or_raise(self._get("v2/logging", headers, query_params))

    # -- shared memory -------------------------------------------------------

    def _shm_status(self, kind, region_name, headers, query_params):
        uri = f"v2/{kind}"
        if region_name:
            uri += f"/region/{quote(region_name, safe='')}"
        uri += "/status"
        return self._json_or_raise(self._get(uri, headers, query_params))

    def get_system_shared_memory_status(
        self, region_name="", headers=None, query_params=None
    ):
        return self._shm_status("systemsharedmemory", region_name, headers, query_params)

    def register_system_shared_memory(
        self, name, key, byte_size, offset=0, headers=None, query_params=None
    ):
        body = json.dumps(
            {"key": key, "offset": offset, "byte_size": byte_size}
        ).encode("utf-8")
        r = self._post(
            f"v2/systemsharedmemory/region/{quote(name, safe='')}/register",
            body,
            headers,
            query_params,
        )
        self._raise_if_error(r)

    def unregister_system_shared_memory(
        self, name="", headers=None, query_params=None
    ):
        uri = "v2/systemsharedmemory"
        if name:
            uri += f"/region/{quote(name, safe='')}"
        uri += "/unregister"
        self._raise_if_error(self._post(uri, b"", headers, query_params))

    def get_cuda_shared_memory_status(
        self, region_name="", headers=None, query_params=None
    ):
        return self._shm_status("cudasharedmemory", region_name, headers, query_params)

    def register_cuda_shared_memory(
        self, name, raw_handle, device_id, byte_size, headers=None, query_params=None
    ):
        """Register a CUDA region by its raw IPC handle (what
        ``client_tpu_torch.utils.cuda_shared_memory.get_raw_handle``
        gives)."""
        body = json.dumps(
            {
                "raw_handle": {"b64": base64.b64encode(raw_handle).decode("utf-8")},
                "device_id": device_id,
                "byte_size": byte_size,
            }
        ).encode("utf-8")
        r = self._post(
            f"v2/cudasharedmemory/region/{quote(name, safe='')}/register",
            body,
            headers,
            query_params,
        )
        self._raise_if_error(r)

    def unregister_cuda_shared_memory(self, name="", headers=None, query_params=None):
        uri = "v2/cudasharedmemory"
        if name:
            uri += f"/region/{quote(name, safe='')}"
        uri += "/unregister"
        self._raise_if_error(self._post(uri, b"", headers, query_params))

    # -- inference -----------------------------------------------------------

    @staticmethod
    def generate_request_body(
        inputs,
        outputs=None,
        request_id="",
        sequence_id=0,
        sequence_start=False,
        sequence_end=False,
        priority=0,
        timeout=None,
        parameters=None,
    ):
        """Build (body, json_size) without sending — the pipelining entry point
        (parity: reference http/__init__.py:1255)."""
        return _codec.build_infer_request_body(
            inputs,
            outputs,
            request_id,
            sequence_id,
            sequence_start,
            sequence_end,
            priority,
            timeout,
            parameters,
        )

    @staticmethod
    def parse_response_body(
        response_body, verbose=False, header_length=None, content_encoding=None
    ):
        """Parse a raw response body into InferResult (parity: reference
        http/__init__.py:1336)."""
        return InferResult.from_response_body(
            response_body, verbose, header_length, content_encoding
        )

    def infer(
        self,
        model_name,
        inputs,
        model_version="",
        outputs=None,
        request_id="",
        sequence_id=0,
        sequence_start=False,
        sequence_end=False,
        priority=0,
        timeout=None,
        headers=None,
        query_params=None,
        request_compression_algorithm=None,
        response_compression_algorithm=None,
        parameters=None,
        client_timeout_s=None,
    ):
        """Run one synchronous inference; returns InferResult.

        ``client_timeout_s`` bounds this request's transport time on the
        client side (the gRPC clients' ``client_timeout`` analog; distinct
        from ``timeout``, the KServe server-side budget in microseconds).
        With a retry policy it caps each attempt alongside the policy's
        deadline-derived budget."""
        with _tracing.client_span(self._tracer, model_name) as trace:
            body, json_size = _codec.build_infer_request_body(
                inputs,
                outputs,
                request_id,
                sequence_id,
                sequence_start,
                sequence_end,
                priority,
                timeout,
                parameters,
            )
            request_headers = dict(headers) if headers else {}
            if json_size is not None:
                request_headers["Inference-Header-Content-Length"] = str(json_size)
            body = _codec.compress(body, request_compression_algorithm)
            if request_compression_algorithm:
                request_headers["Content-Encoding"] = request_compression_algorithm
            if response_compression_algorithm:
                request_headers["Accept-Encoding"] = response_compression_algorithm
            if trace is not None:
                trace.event("CLIENT_SERIALIZE_END")
                request_headers["traceparent"] = trace.traceparent()

            uri = f"v2/models/{quote(model_name, safe='')}"
            if model_version:
                uri += f"/versions/{model_version}"
            uri += "/infer"
            response = self._request(
                "POST", uri, request_headers, query_params, body, trace=trace,
                client_timeout_s=client_timeout_s,
            )
            self._raise_if_error(response)
            header_length = response.headers.get(
                "Inference-Header-Content-Length"
            )
            return InferResult.from_response_body(
                response.data,
                self._verbose,
                int(header_length) if header_length is not None else None,
                response.headers.get("Content-Encoding"),
            )

    def async_infer(self, model_name, inputs, **kwargs):
        """Submit inference on the worker pool; returns InferAsyncRequest.

        Parity: reference http/__init__.py:1512 (gevent greenlet -> thread pool).
        """
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=max(1, self._concurrency),
                thread_name_prefix="client_tpu_torch-http",
            )
        future = self._executor.submit(self.infer, model_name, inputs, **kwargs)
        return InferAsyncRequest(future, self._verbose)
