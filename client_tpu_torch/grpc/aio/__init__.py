"""asyncio gRPC client — mirror of client_tpu_torch.grpc over ``grpc.aio``.

Counterpart of client_tpu/grpc/aio/__init__.py, on the port's own protos,
method table, value types, retry policies and tracer (capability parity
with ``tritonclient.grpc.aio``, reference
src/python/library/tritonclient/grpc/aio/__init__.py:34-772): every RPC
as a coroutine, plus ``stream_infer``, which maps an async iterator of
requests onto the bidirectional ModelStreamInfer stream and yields
(result, error) tuples.  Where the reference has the TpuSharedMemory*
verbs, this client has the CUDA ones, with the sync client's signatures
(``register_cuda_shared_memory`` with a region's 64-byte IPC handle).
"""

import grpc

from client_tpu_torch import resilience as _resilience
from client_tpu_torch import tracing as _tracing
from client_tpu_torch._grpc_infer import (  # noqa: F401
    InferResult,
    build_infer_request,
)
from client_tpu_torch._grpc_service import build_stubs
from client_tpu_torch._infer_types import (  # noqa: F401
    InferInput,
    InferRequestedOutput,
)
from client_tpu_torch._proto import inference_pb2 as pb
from client_tpu_torch.grpc import (
    KeepAliveOptions,  # noqa: F401
    _attempt_timeout,
    _channel_options,
    _grpc_compression,
    _metadata,
    _stamp_tenant,
    raise_error_grpc,
)
from client_tpu_torch.utils import (
    SERVER_NOT_READY,
    SERVER_READY,
    SERVER_UNREACHABLE,
    InferenceServerException,
)

__all__ = [
    "InferenceServerClient",
    "InferInput",
    "InferRequestedOutput",
    "InferResult",
    "KeepAliveOptions",
]


class InferenceServerClient:
    """asyncio client for every GRPCInferenceService RPC."""

    def __init__(
        self,
        url,
        verbose=False,
        ssl=False,
        root_certificates=None,
        private_key=None,
        certificate_chain=None,
        creds=None,
        keepalive_options=None,
        channel_args=None,
        retry_policy=None,
        tracer=None,
        tenant=None,
    ):
        options = _channel_options(keepalive_options, channel_args)
        if creds is not None:
            self._channel = grpc.aio.secure_channel(url, creds, options=options)
        elif ssl:
            rc = pk = cc = None
            if root_certificates:
                with open(root_certificates, "rb") as f:
                    rc = f.read()
            if private_key:
                with open(private_key, "rb") as f:
                    pk = f.read()
            if certificate_chain:
                with open(certificate_chain, "rb") as f:
                    cc = f.read()
            credentials = grpc.ssl_channel_credentials(rc, pk, cc)
            self._channel = grpc.aio.secure_channel(url, credentials, options=options)
        else:
            self._channel = grpc.aio.insecure_channel(url, options=options)
        self._stubs = build_stubs(self._channel)
        self._endpoint = url  # host:port identity (trace attempt spans)
        self._verbose = verbose
        # Opt-in resilience for unary RPCs; None keeps single-attempt
        # behavior.  stream_infer is never retried (replay would re-send
        # every request the iterator already produced).
        self._retry_policy = retry_policy
        # Opt-in tracing (client_tpu_torch.tracing.ClientTracer): client spans +
        # traceparent propagation over gRPC metadata.
        self._tracer = tracer
        # Tenant identity stamped on every verb (sync-client semantics).
        self._tenant = None if tenant is None else str(tenant)

    async def close(self):
        await self._channel.close()

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.close()

    async def _call(self, name, request, headers=None, client_timeout=None,
                    trace=None, **kw):
        if self._retry_policy is None:
            return await self._attempt_once(
                name, request, headers, client_timeout, trace, **kw
            )

        async def attempt(timeout_s):
            timeout = _attempt_timeout(client_timeout, timeout_s)
            return await self._attempt_once(
                name, request, headers, timeout, trace, **kw
            )

        return await _resilience.acall_with_retry(attempt, self._retry_policy)

    async def _attempt_once(self, name, request, headers, client_timeout,
                            trace, **kw):
        """One RPC attempt in a trace attempt span — retries show as
        repeated ATTEMPT_START/ATTEMPT_END pairs."""
        with _tracing.attempt_span(trace, endpoint=self._endpoint):
            return await self._call_once(
                name, request, headers, client_timeout, **kw
            )

    async def _call_once(self, name, request, headers=None, client_timeout=None, **kw):
        headers = _stamp_tenant(headers, self._tenant)
        if self._verbose:
            print(f"{name}, metadata {headers}\n{request}")
        try:
            response = await self._stubs[name](
                request, metadata=_metadata(headers), timeout=client_timeout, **kw
            )
            if self._verbose:
                print(response)
            return response
        except grpc.RpcError as e:
            raise_error_grpc(e)

    @staticmethod
    def _maybe_json(response, as_json):
        if not as_json:
            return response
        from google.protobuf import json_format

        return json_format.MessageToDict(response, preserving_proto_field_name=True)

    # -- health --------------------------------------------------------------
    # Health verbs answer False on transport errors instead of raising
    # (tritonclient reference semantics): probes must be safe to poll
    # against a down server.  They bypass the retry policy (_call_once) —
    # an unavailable answer IS the probe result, not a failure to retry.

    async def is_server_live(self, headers=None, client_timeout=None):
        try:
            r = await self._call_once(
                "ServerLive", pb.ServerLiveRequest(), headers, client_timeout
            )
        except InferenceServerException:
            return False
        return r.live

    async def is_server_ready(self, headers=None, client_timeout=None):
        try:
            r = await self._call_once(
                "ServerReady", pb.ServerReadyRequest(), headers, client_timeout
            )
        except InferenceServerException:
            return False
        return r.ready

    async def server_state(self, headers=None, client_timeout=None):
        """READY / NOT_READY / UNREACHABLE (client_tpu_torch.utils constants) —
        a draining server answers ready=False (NOT_READY), a dead one
        fails the RPC (UNREACHABLE); same contract as the sync client."""
        try:
            r = await self._call_once(
                "ServerReady", pb.ServerReadyRequest(), headers, client_timeout
            )
        except InferenceServerException:
            return SERVER_UNREACHABLE
        return SERVER_READY if r.ready else SERVER_NOT_READY

    async def is_model_ready(
        self, model_name, model_version="", headers=None, client_timeout=None
    ):
        try:
            r = await self._call_once(
                "ModelReady",
                pb.ModelReadyRequest(name=model_name, version=model_version),
                headers,
                client_timeout,
            )
        except InferenceServerException:
            return False
        return r.ready

    # -- metadata / config / repository --------------------------------------

    async def get_server_metadata(self, headers=None, as_json=False, client_timeout=None):
        r = await self._call(
            "ServerMetadata", pb.ServerMetadataRequest(), headers, client_timeout
        )
        return self._maybe_json(r, as_json)

    async def get_model_metadata(
        self, model_name, model_version="", headers=None, as_json=False,
        client_timeout=None,
    ):
        r = await self._call(
            "ModelMetadata",
            pb.ModelMetadataRequest(name=model_name, version=model_version),
            headers,
            client_timeout,
        )
        return self._maybe_json(r, as_json)

    async def get_model_config(
        self, model_name, model_version="", headers=None, as_json=False,
        client_timeout=None,
    ):
        r = await self._call(
            "ModelConfig",
            pb.ModelConfigRequest(name=model_name, version=model_version),
            headers,
            client_timeout,
        )
        return self._maybe_json(r, as_json)

    async def get_model_repository_index(
        self, headers=None, as_json=False, client_timeout=None
    ):
        r = await self._call(
            "RepositoryIndex", pb.RepositoryIndexRequest(), headers, client_timeout
        )
        return self._maybe_json(r, as_json)

    async def load_model(
        self, model_name, headers=None, config=None, files=None, client_timeout=None
    ):
        import json as _json

        request = pb.RepositoryModelLoadRequest(model_name=model_name)
        if config is not None:
            request.parameters["config"].string_param = (
                config if isinstance(config, str) else _json.dumps(config)
            )
        for path, content in (files or {}).items():
            request.parameters[path].bytes_param = content
        await self._call("RepositoryModelLoad", request, headers, client_timeout)

    async def unload_model(
        self, model_name, headers=None, unload_dependents=False, client_timeout=None
    ):
        request = pb.RepositoryModelUnloadRequest(model_name=model_name)
        request.parameters["unload_dependents"].bool_param = unload_dependents
        await self._call("RepositoryModelUnload", request, headers, client_timeout)

    # -- statistics ----------------------------------------------------------

    async def get_inference_statistics(
        self, model_name="", model_version="", headers=None, as_json=False,
        client_timeout=None,
    ):
        r = await self._call(
            "ModelStatistics",
            pb.ModelStatisticsRequest(name=model_name, version=model_version),
            headers,
            client_timeout,
        )
        return self._maybe_json(r, as_json)

    # -- trace / log settings (parity with the sync client; reference
    #    grpc/aio/__init__.py update_trace_settings..get_log_settings) -------

    async def update_trace_settings(
        self, model_name="", settings=None, headers=None, as_json=False,
        client_timeout=None,
    ):
        from client_tpu_torch.grpc import build_trace_setting_request

        request = build_trace_setting_request(model_name, settings)
        r = await self._call("TraceSetting", request, headers, client_timeout)
        return self._maybe_json(r, as_json)

    async def get_trace_settings(
        self, model_name="", headers=None, as_json=False, client_timeout=None
    ):
        r = await self._call(
            "TraceSetting",
            pb.TraceSettingRequest(model_name=model_name),
            headers,
            client_timeout,
        )
        return self._maybe_json(r, as_json)

    async def update_log_settings(
        self, settings, headers=None, as_json=False, client_timeout=None
    ):
        from client_tpu_torch.grpc import build_log_settings_request

        request = build_log_settings_request(settings)
        r = await self._call("LogSettings", request, headers, client_timeout)
        return self._maybe_json(r, as_json)

    async def get_log_settings(
        self, headers=None, as_json=False, client_timeout=None
    ):
        r = await self._call(
            "LogSettings", pb.LogSettingsRequest(), headers, client_timeout
        )
        return self._maybe_json(r, as_json)

    # -- shared memory -------------------------------------------------------

    async def get_system_shared_memory_status(
        self, region_name="", headers=None, as_json=False, client_timeout=None
    ):
        r = await self._call(
            "SystemSharedMemoryStatus",
            pb.SystemSharedMemoryStatusRequest(name=region_name),
            headers,
            client_timeout,
        )
        return self._maybe_json(r, as_json)

    async def register_system_shared_memory(
        self, name, key, byte_size, offset=0, headers=None, client_timeout=None
    ):
        await self._call(
            "SystemSharedMemoryRegister",
            pb.SystemSharedMemoryRegisterRequest(
                name=name, key=key, offset=offset, byte_size=byte_size
            ),
            headers,
            client_timeout,
        )

    async def unregister_system_shared_memory(
        self, name="", headers=None, client_timeout=None
    ):
        await self._call(
            "SystemSharedMemoryUnregister",
            pb.SystemSharedMemoryUnregisterRequest(name=name),
            headers,
            client_timeout,
        )

    async def get_cuda_shared_memory_status(
        self, region_name="", headers=None, as_json=False, client_timeout=None
    ):
        r = await self._call(
            "CudaSharedMemoryStatus",
            pb.CudaSharedMemoryStatusRequest(name=region_name),
            headers,
            client_timeout,
        )
        return self._maybe_json(r, as_json)

    async def register_cuda_shared_memory(
        self, name, raw_handle, device_id, byte_size, headers=None, client_timeout=None
    ):
        await self._call(
            "CudaSharedMemoryRegister",
            pb.CudaSharedMemoryRegisterRequest(
                name=name,
                raw_handle=raw_handle,
                device_id=device_id,
                byte_size=byte_size,
            ),
            headers,
            client_timeout,
        )

    async def unregister_cuda_shared_memory(
        self, name="", headers=None, client_timeout=None
    ):
        await self._call(
            "CudaSharedMemoryUnregister",
            pb.CudaSharedMemoryUnregisterRequest(name=name),
            headers,
            client_timeout,
        )

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
        client_timeout=None,
        headers=None,
        compression_algorithm=None,
        parameters=None,
    ):
        with _tracing.client_span(self._tracer, model_name) as trace:
            request = build_infer_request(
                model_name,
                inputs,
                model_version,
                outputs,
                request_id,
                sequence_id,
                sequence_start,
                sequence_end,
                priority,
                timeout,
                parameters,
            )
            if trace is not None:
                trace.event("CLIENT_SERIALIZE_END")
                headers = dict(headers or {})
                headers["traceparent"] = trace.traceparent()
            response = await self._call(
                "ModelInfer",
                request,
                headers,
                client_timeout,
                trace=trace,
                compression=_grpc_compression(compression_algorithm),
            )
            return InferResult(response)

    def stream_infer(
        self,
        inputs_iterator,
        stream_timeout=None,
        headers=None,
        compression_algorithm=None,
    ):
        """Map an async iterator of request kwargs dicts onto the bidi stream.

        Yields (InferResult, error) tuples (parity: reference aio
        stream_infer).  Each item from *inputs_iterator* is a dict of
        ``infer``-style kwargs.  Closing the generator before the stream
        ends (``aclose``, a cancelled task) cancels the call.
        """

        async def _requests():
            async for kwargs in inputs_iterator:
                yield build_infer_request(
                    kwargs["model_name"],
                    kwargs["inputs"],
                    kwargs.get("model_version", ""),
                    kwargs.get("outputs"),
                    kwargs.get("request_id", ""),
                    kwargs.get("sequence_id", 0),
                    kwargs.get("sequence_start", False),
                    kwargs.get("sequence_end", False),
                    kwargs.get("priority", 0),
                    kwargs.get("timeout"),
                    kwargs.get("parameters"),
                )

        async def _responses():
            stream = None
            try:
                stream = self._stubs["ModelStreamInfer"](
                    _requests(),
                    metadata=_metadata(_stamp_tenant(headers, self._tenant)),
                    timeout=stream_timeout,
                    compression=_grpc_compression(compression_algorithm),
                )
                async for response in stream:
                    error = (
                        InferenceServerException(response.error_message)
                        if response.error_message
                        else None
                    )
                    yield InferResult(response.infer_response), error
            except grpc.RpcError as e:
                raise_error_grpc(e)
            finally:
                # a consumer that stops iterating (or is cancelled) ends the
                # call at once: the server closes the request's generator
                if stream is not None and not stream.done():
                    stream.cancel()

        return _responses()
