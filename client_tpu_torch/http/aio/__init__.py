"""asyncio HTTP client — mirror of client_tpu_torch.http over aiohttp.

Counterpart of client_tpu/http/aio/__init__.py (capability parity with
``tritonclient.http.aio``, reference
src/python/library/tritonclient/http/aio/__init__.py:64-786), on the
port's own codec, value types, retry policies and tracer, with the sync
client's response and error parsing (client_tpu_torch/http).  The
transport is aiohttp, as in the reference: the H100 machine has it
(3.13.5), so this client is not rebuilt on the standard library as the
sync one is.  Where the reference has the TPU shared-memory verbs, this
client has the CUDA ones, with the sync client's signatures.
"""

import asyncio
import base64
import json
from urllib.parse import quote

import aiohttp

from client_tpu_torch import _codec
from client_tpu_torch import resilience as _resilience
from client_tpu_torch import tracing as _tracing
from client_tpu_torch._infer_types import (  # noqa: F401
    InferInput,
    InferRequestedOutput,
)
from client_tpu_torch.http import (  # same response/error parsing as sync
    InferResult,
    _get_error_from_response,
    _stamp_tenant,
)
from client_tpu_torch.utils import (
    SERVER_NOT_READY,
    SERVER_READY,
    SERVER_UNREACHABLE,
    InferenceServerException,
    raise_error,
)

__all__ = [
    "InferenceServerClient",
    "InferInput",
    "InferRequestedOutput",
    "InferResult",
]


class InferenceServerClient:
    """asyncio client for every KServe-v2 HTTP endpoint."""

    def __init__(
        self,
        url,
        verbose=False,
        conn_limit=100,
        conn_timeout=60.0,
        ssl=False,
        ssl_context=None,
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
        self._base_url = f"{'https' if ssl else 'http'}://{url}"
        self._endpoint = url  # host:port identity (trace attempt spans)
        self._verbose = verbose
        connector = aiohttp.TCPConnector(limit=conn_limit, ssl=ssl_context if ssl else False)
        self._session = aiohttp.ClientSession(
            connector=connector,
            timeout=aiohttp.ClientTimeout(total=conn_timeout),
            auto_decompress=False,
        )
        # Opt-in resilience (client_tpu_torch.resilience.RetryPolicy); None keeps
        # the original single-attempt behavior.
        self._retry_policy = retry_policy
        # Opt-in tracing (client_tpu_torch.tracing.ClientTracer): client spans +
        # traceparent propagation, same semantics as the sync client.
        self._tracer = tracer
        # Tenant identity stamped on every verb (sync-client semantics).
        self._tenant = None if tenant is None else str(tenant)

    async def close(self):
        await self._session.close()

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.close()

    async def _get(self, uri, headers=None, query_params=None):
        return await self._request("GET", uri, headers, query_params)

    async def _post(self, uri, body=b"", headers=None, query_params=None):
        return await self._request("POST", uri, headers, query_params, body)

    async def _request(self, method, uri, headers=None, query_params=None,
                       body=b"", trace=None, client_timeout_s=None):
        if self._retry_policy is None:
            return await self._attempt_once(
                method, uri, headers, query_params, body, client_timeout_s,
                trace,
            )

        async def attempt(timeout_s):
            response = await self._attempt_once(
                method, uri, headers, query_params, body,
                _resilience.combine_timeouts(timeout_s, client_timeout_s),
                trace,
            )
            # Overload statuses become exceptions for the retry loop (with
            # the Retry-After hint); the body read happens inside the
            # attempt so a mid-body truncation is retried too (aiohttp
            # caches it, later read() calls return the same bytes).
            if str(response.status) in self._retry_policy.retryable_statuses:
                raise await self._error_from_response(response)
            await response.read()
            return response

        return await _resilience.acall_with_retry(attempt, self._retry_policy)

    async def _attempt_once(self, method, uri, headers, query_params, body,
                            timeout_s, trace):
        """One transport attempt in a trace attempt span — retries show as
        repeated ATTEMPT_START/ATTEMPT_END pairs."""
        with _tracing.attempt_span(trace, endpoint=self._endpoint):
            return await self._request_once(
                method, uri, headers, query_params, body, timeout_s
            )

    async def _request_once(
        self, method, uri, headers=None, query_params=None, body=b"", timeout_s=None
    ):
        headers = _stamp_tenant(headers, self._tenant)
        if self._verbose:
            print(f"{method} {self._base_url}/{uri}")
        kwargs = {}
        if timeout_s is not None:  # deadline-derived per-attempt timeout
            kwargs["timeout"] = aiohttp.ClientTimeout(total=max(timeout_s, 1e-3))
        if method == "GET":
            return await self._session.get(
                f"{self._base_url}/{uri}", headers=headers, params=query_params,
                **kwargs,
            )
        return await self._session.post(
            f"{self._base_url}/{uri}", data=body, headers=headers,
            params=query_params, **kwargs,
        )

    @staticmethod
    async def _error_from_response(response):
        body = await response.read()
        # same error extraction + Retry-After parsing as the sync client
        return _get_error_from_response(body, response.status, response.headers)

    @classmethod
    async def _raise_if_error(cls, response):
        if response.status != 200:
            raise await cls._error_from_response(response)

    @staticmethod
    async def _json_or_raise(response):
        await InferenceServerClient._raise_if_error(response)
        body = _codec.decompress(
            await response.read(), response.headers.get("Content-Encoding")
        )
        return json.loads(body.decode("utf-8")) if body else {}

    # -- health --------------------------------------------------------------
    # Health verbs answer False on transport/connection errors instead of
    # raising (tritonclient reference semantics): health probes must be
    # safe to poll against a down server.  They bypass the retry policy —
    # a draining server's 503 readiness answer is the answer.

    _HEALTH_ERRORS = (
        InferenceServerException,
        aiohttp.ClientError,
        asyncio.TimeoutError,
        OSError,
    )

    async def _probe(self, uri, headers, query_params):
        try:
            r = await self._request_once("GET", uri, headers, query_params)
        except self._HEALTH_ERRORS:
            return False
        return r.status == 200

    async def is_server_live(self, headers=None, query_params=None):
        return await self._probe("v2/health/live", headers, query_params)

    async def is_server_ready(self, headers=None, query_params=None):
        return await self._probe("v2/health/ready", headers, query_params)

    async def server_state(self, headers=None, query_params=None,
                           timeout_s=None):
        """READY / NOT_READY / UNREACHABLE (client_tpu_torch.utils constants) —
        distinguishes a draining server (answered not-ready) from a dead
        one (never answered); same contract as the sync client.
        ``timeout_s`` bounds the probe."""
        try:
            r = await self._request_once(
                "GET", "v2/health/ready", headers, query_params,
                timeout_s=timeout_s,
            )
        except self._HEALTH_ERRORS:
            return SERVER_UNREACHABLE
        return SERVER_READY if r.status == 200 else SERVER_NOT_READY

    async def is_model_ready(
        self, model_name, model_version="", headers=None, query_params=None
    ):
        uri = f"v2/models/{quote(model_name, safe='')}"
        if model_version:
            uri += f"/versions/{model_version}"
        return await self._probe(uri + "/ready", headers, query_params)

    # -- metadata / config / repository --------------------------------------

    async def get_server_metadata(self, headers=None, query_params=None):
        return await self._json_or_raise(await self._get("v2", headers, query_params))

    async def get_model_metadata(
        self, model_name, model_version="", headers=None, query_params=None
    ):
        uri = f"v2/models/{quote(model_name, safe='')}"
        if model_version:
            uri += f"/versions/{model_version}"
        return await self._json_or_raise(await self._get(uri, headers, query_params))

    async def get_model_config(
        self, model_name, model_version="", headers=None, query_params=None
    ):
        uri = f"v2/models/{quote(model_name, safe='')}"
        if model_version:
            uri += f"/versions/{model_version}"
        return await self._json_or_raise(
            await self._get(uri + "/config", headers, query_params)
        )

    async def get_model_repository_index(self, headers=None, query_params=None):
        return await self._json_or_raise(
            await self._post("v2/repository/index", b"", headers, query_params)
        )

    async def load_model(
        self, model_name, headers=None, query_params=None, config=None, files=None
    ):
        body = {}
        if config is not None:
            body.setdefault("parameters", {})["config"] = (
                config if isinstance(config, str) else json.dumps(config)
            )
        for path, content in (files or {}).items():
            body.setdefault("parameters", {})[path] = base64.b64encode(content).decode()
        r = await self._post(
            f"v2/repository/models/{quote(model_name, safe='')}/load",
            json.dumps(body).encode() if body else b"",
            headers,
            query_params,
        )
        await self._raise_if_error(r)

    async def unload_model(
        self, model_name, headers=None, query_params=None, unload_dependents=False
    ):
        r = await self._post(
            f"v2/repository/models/{quote(model_name, safe='')}/unload",
            json.dumps({"parameters": {"unload_dependents": unload_dependents}}).encode(),
            headers,
            query_params,
        )
        await self._raise_if_error(r)

    # -- statistics ----------------------------------------------------------

    async def get_inference_statistics(
        self, model_name="", model_version="", headers=None, query_params=None
    ):
        if model_name:
            uri = f"v2/models/{quote(model_name, safe='')}"
            if model_version:
                uri += f"/versions/{model_version}"
            uri += "/stats"
        else:
            uri = "v2/models/stats"
        return await self._json_or_raise(await self._get(uri, headers, query_params))

    # -- trace / log settings (parity with the sync client) ------------------

    async def update_trace_settings(
        self, model_name="", settings=None, headers=None, query_params=None
    ):
        uri = (
            f"v2/models/{quote(model_name, safe='')}/trace/setting"
            if model_name
            else "v2/trace/setting"
        )
        r = await self._post(
            uri, json.dumps(settings or {}).encode("utf-8"), headers,
            query_params,
        )
        return await self._json_or_raise(r)

    async def get_trace_settings(
        self, model_name="", headers=None, query_params=None
    ):
        uri = (
            f"v2/models/{quote(model_name, safe='')}/trace/setting"
            if model_name
            else "v2/trace/setting"
        )
        return await self._json_or_raise(
            await self._get(uri, headers, query_params)
        )

    async def update_log_settings(
        self, settings, headers=None, query_params=None
    ):
        r = await self._post(
            "v2/logging", json.dumps(settings).encode("utf-8"), headers,
            query_params,
        )
        return await self._json_or_raise(r)

    async def get_log_settings(self, headers=None, query_params=None):
        return await self._json_or_raise(
            await self._get("v2/logging", headers, query_params)
        )

    # -- pipelining statics (reference http/__init__.py:1255/1336; the bodies
    #    are transport-independent, shared with the sync client) -------------

    @staticmethod
    def generate_request_body(
        inputs, outputs=None, request_id="", sequence_id=0,
        sequence_start=False, sequence_end=False, priority=0, timeout=None,
        parameters=None,
    ):
        """Build (body, json_size) without sending."""
        return _codec.build_infer_request_body(
            inputs, outputs, request_id, sequence_id, sequence_start,
            sequence_end, priority, timeout, parameters,
        )

    @staticmethod
    def parse_response_body(
        response_body, verbose=False, header_length=None,
        content_encoding=None,
    ):
        """Parse a raw response body into InferResult."""
        return InferResult.from_response_body(
            response_body, verbose, header_length, content_encoding
        )

    # -- shared memory -------------------------------------------------------

    async def get_system_shared_memory_status(
        self, region_name="", headers=None, query_params=None
    ):
        uri = "v2/systemsharedmemory"
        if region_name:
            uri += f"/region/{quote(region_name, safe='')}"
        return await self._json_or_raise(
            await self._get(uri + "/status", headers, query_params)
        )

    async def register_system_shared_memory(
        self, name, key, byte_size, offset=0, headers=None, query_params=None
    ):
        r = await self._post(
            f"v2/systemsharedmemory/region/{quote(name, safe='')}/register",
            json.dumps({"key": key, "offset": offset, "byte_size": byte_size}).encode(),
            headers,
            query_params,
        )
        await self._raise_if_error(r)

    async def unregister_system_shared_memory(
        self, name="", headers=None, query_params=None
    ):
        uri = "v2/systemsharedmemory"
        if name:
            uri += f"/region/{quote(name, safe='')}"
        r = await self._post(uri + "/unregister", b"", headers, query_params)
        await self._raise_if_error(r)

    async def get_cuda_shared_memory_status(
        self, region_name="", headers=None, query_params=None
    ):
        uri = "v2/cudasharedmemory"
        if region_name:
            uri += f"/region/{quote(region_name, safe='')}"
        return await self._json_or_raise(
            await self._get(uri + "/status", headers, query_params)
        )

    async def register_cuda_shared_memory(
        self, name, raw_handle, device_id, byte_size, headers=None, query_params=None
    ):
        """Register a CUDA region by its raw IPC handle (what
        ``client_tpu_torch.utils.cuda_shared_memory.get_raw_handle``
        gives)."""
        r = await self._post(
            f"v2/cudasharedmemory/region/{quote(name, safe='')}/register",
            json.dumps(
                {
                    "raw_handle": {"b64": base64.b64encode(raw_handle).decode()},
                    "device_id": device_id,
                    "byte_size": byte_size,
                }
            ).encode(),
            headers,
            query_params,
        )
        await self._raise_if_error(r)

    async def unregister_cuda_shared_memory(
        self, name="", headers=None, query_params=None
    ):
        uri = "v2/cudasharedmemory"
        if name:
            uri += f"/region/{quote(name, safe='')}"
        r = await self._post(uri + "/unregister", b"", headers, query_params)
        await self._raise_if_error(r)

    # -- inference -----------------------------------------------------------

    async def infer(
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
            response = await self._request(
                "POST", uri, request_headers, query_params, body, trace=trace,
                client_timeout_s=client_timeout_s,
            )
            await self._raise_if_error(response)
            data = await response.read()
            header_length = response.headers.get(
                "Inference-Header-Content-Length"
            )
            return InferResult.from_response_body(
                data,
                self._verbose,
                int(header_length) if header_length is not None else None,
                response.headers.get("Content-Encoding"),
            )
