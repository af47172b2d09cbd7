"""Synchronous gRPC client for KServe-v2 servers (Triton-compatible).

Counterpart of client_tpu/grpc/__init__.py, copied onto the port's own
protos, method table, value types, retry policies and tracer: every
GRPCInferenceService RPC including bidirectional streaming inference
(``start_stream`` / ``async_stream_infer`` over an ``_InferStream``), SSL
and keepalive channel configuration, per-call metadata/timeout/
compression, and the CUDA shared-memory verbs
(``register_cuda_shared_memory`` with a region's 64-byte IPC handle,
client_tpu_torch.utils.cuda_shared_memory).  Where the reference adds the
TpuSharedMemory* extension verbs, the port's client has none: the port's
server refuses them.  Stubs are built over grpc's generic channel API
from client_tpu_torch._grpc_service (no grpcio-tools codegen).
"""

import queue
import re
import threading

import grpc

from client_tpu_torch import resilience as _resilience
from client_tpu_torch import tracing as _tracing
from client_tpu_torch._grpc_infer import (  # noqa: F401  (re-exported API)
    InferResult,
    build_infer_request,
    set_infer_parameter,
)
from client_tpu_torch._grpc_service import build_stubs
from client_tpu_torch._infer_types import (  # noqa: F401
    InferInput,
    InferRequestedOutput,
)
from client_tpu_torch._proto import inference_pb2 as pb
from client_tpu_torch._proto import model_config_pb2  # noqa: F401
from client_tpu_torch.utils import (
    SERVER_NOT_READY,
    SERVER_READY,
    SERVER_UNREACHABLE,
    InferenceServerException,
    raise_error,
    stamp_tenant as _stamp_tenant,
)

__all__ = [
    "InferenceServerClient",
    "InferInput",
    "InferRequestedOutput",
    "InferResult",
    "KeepAliveOptions",
]

# Never limit message size client-side (parity: reference common.h:54,
# MAX_GRPC_MESSAGE_SIZE = INT32_MAX).
MAX_GRPC_MESSAGE_SIZE = 2**31 - 1

# INT32_MAX sentinel the reference uses for "not set" keepalive values.
INT32_MAX = 2**31 - 1


class KeepAliveOptions:
    """gRPC keepalive channel arguments (parity: reference grpc/__init__.py:139)."""

    def __init__(
        self,
        keepalive_time_ms=INT32_MAX,
        keepalive_timeout_ms=20000,
        keepalive_permit_without_calls=False,
        http2_max_pings_without_data=2,
    ):
        self.keepalive_time_ms = keepalive_time_ms
        self.keepalive_timeout_ms = keepalive_timeout_ms
        self.keepalive_permit_without_calls = keepalive_permit_without_calls
        self.http2_max_pings_without_data = http2_max_pings_without_data


def raise_error_grpc(rpc_error):
    exc = InferenceServerException(
        msg=rpc_error.details(),
        status=str(rpc_error.code().name),
        debug_details=rpc_error,
    )
    # server backoff hint (the gRPC spelling of HTTP Retry-After): QoS and
    # overload sheds attach it as trailing metadata; the retry policy's
    # delay_for() honors exc.retry_after_s
    try:
        for key, value in rpc_error.trailing_metadata() or ():
            if key == "retry-after":
                exc.retry_after_s = float(value)
                break
    except Exception:
        pass  # a malformed hint must never mask the real error
    raise exc from None


def build_trace_setting_request(model_name, settings):
    """TraceSettingRequest from a plain dict (a pure function of
    ``settings``)."""
    request = pb.TraceSettingRequest(model_name=model_name)
    for key, value in (settings or {}).items():
        if value is None:
            request.settings[key]  # present-but-empty clears the setting
        elif isinstance(value, (list, tuple)):
            request.settings[key].value.extend(str(v) for v in value)
        else:
            request.settings[key].value.append(str(value))
    return request


def build_log_settings_request(settings):
    """LogSettingsRequest from a plain dict."""
    request = pb.LogSettingsRequest()
    for key, value in settings.items():
        if value is None:
            request.settings[key]
        elif isinstance(value, bool):  # before int: bool is an int subclass
            request.settings[key].bool_param = value
        elif isinstance(value, int):
            request.settings[key].uint32_param = value
        else:
            request.settings[key].string_param = str(value)
    return request


def _stream_error(error_message):
    """ModelStreamInferResponse.error_message -> exception.  The server
    encodes any status code as a leading "[<status>] " prefix (the wire type
    has no status field); strip it back out."""
    m = re.match(r"\[([A-Za-z0-9_]+)\] (.*)", error_message, re.DOTALL)
    if m:
        return InferenceServerException(m.group(2), status=m.group(1))
    return InferenceServerException(error_message)


def _channel_options(keepalive_options=None, channel_args=None):
    options = [
        ("grpc.max_send_message_length", MAX_GRPC_MESSAGE_SIZE),
        ("grpc.max_receive_message_length", MAX_GRPC_MESSAGE_SIZE),
        ("grpc.primary_user_agent", "client_tpu_torch"),
    ]
    ka = keepalive_options or KeepAliveOptions()
    options += [
        ("grpc.keepalive_time_ms", ka.keepalive_time_ms),
        ("grpc.keepalive_timeout_ms", ka.keepalive_timeout_ms),
        (
            "grpc.keepalive_permit_without_calls",
            int(ka.keepalive_permit_without_calls),
        ),
        ("grpc.http2.max_pings_without_data", ka.http2_max_pings_without_data),
    ]
    if channel_args:
        options += list(channel_args)
    return options


def _metadata(headers):
    return tuple((k.lower(), str(v)) for k, v in (headers or {}).items())


def _attempt_timeout(client_timeout, deadline_remaining_s):
    """Per-attempt RPC timeout: the caller's client_timeout capped by the
    retry deadline's remaining budget (shared by the sync and aio clients)."""
    if deadline_remaining_s is None:
        return client_timeout
    if client_timeout is None:
        return max(deadline_remaining_s, 1e-3)
    return max(min(client_timeout, deadline_remaining_s), 1e-3)


class _InferStream:
    """One bidirectional ModelStreamInfer stream.

    Requests are pushed into a queue consumed by a generator the RPC reads;
    responses are pulled by a handler thread that invokes the user callback
    (parity: reference _InferStream/_RequestIterator grpc/__init__.py:2155-2305).
    """

    _CLOSE = object()

    def __init__(self, callback, stubs, metadata, stream_timeout, compression):
        self._callback = callback
        self._request_queue = queue.SimpleQueue()
        self._active = True
        self._closed = False
        self._lock = threading.Lock()
        self._response_iterator = stubs["ModelStreamInfer"](
            iter(self._request_queue.get, self._CLOSE),
            metadata=metadata,
            timeout=stream_timeout,
            compression=compression,
        )
        self._handler = threading.Thread(
            target=self._process_responses,
            name="client_tpu_torch-grpc-stream",
            daemon=True,
        )
        self._handler.start()

    def send(self, request):
        with self._lock:
            if not self._active:
                raise_error("stream is closed")
            self._request_queue.put(request)

    def cancel(self):
        """Cancel the RPC and leave the stream open: safe from the
        stream's own callback, where ``close`` (which joins the thread
        that runs the callback) is not."""
        self._response_iterator.cancel()

    def close(self, cancel_requests=False):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._active = False
        if cancel_requests:
            self._response_iterator.cancel()
        # ends the request iterator grpc's request thread reads, also when
        # the response side has already ended (the server closed the
        # stream, an error, cancel_stream): the reference returns early
        # then and leaves that thread blocked on the queue for good
        self._request_queue.put(self._CLOSE)
        self._handler.join(timeout=30)

    def _process_responses(self):
        try:
            for response in self._response_iterator:
                error = (
                    _stream_error(response.error_message)
                    if response.error_message
                    else None
                )
                result = InferResult(response.infer_response)
                self._callback(result=result, error=error)
        except grpc.RpcError as e:
            if e.code() not in (grpc.StatusCode.CANCELLED,):
                self._callback(
                    result=None,
                    error=InferenceServerException(
                        msg=e.details(), status=str(e.code().name), debug_details=e
                    ),
                )
        with self._lock:
            self._active = False


class InferenceServerClient:
    """Blocking gRPC client for every GRPCInferenceService RPC.

    Parity: reference grpc/__init__.py:181-1782.
    """

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
            self._channel = grpc.secure_channel(url, creds, options=options)
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
            self._channel = grpc.secure_channel(url, credentials, options=options)
        else:
            self._channel = grpc.insecure_channel(url, options=options)
        self._stubs = build_stubs(self._channel)
        self._endpoint = url  # host:port identity (trace attempt spans)
        self._verbose = verbose
        self._stream = None
        # Opt-in resilience for unary RPCs (resilience.RetryPolicy);
        # None keeps the original single-attempt behavior.  Streaming RPCs
        # are never retried (replay would re-send every queued request).
        self._retry_policy = retry_policy
        # Opt-in tracing (tracing.ClientTracer): client spans +
        # traceparent propagation over gRPC metadata.
        self._tracer = tracer
        # Tenant identity stamped as x-tenant-id metadata on EVERY verb,
        # unary and streaming (an explicitly passed header wins).
        self._tenant = None if tenant is None else str(tenant)

    # -- lifecycle -----------------------------------------------------------

    def close(self):
        self.stop_stream()
        self._channel.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _call(self, name, request, headers=None, client_timeout=None,
              trace=None, **kwargs):
        if self._retry_policy is None:
            return self._attempt_once(
                name, request, headers, client_timeout, trace, **kwargs
            )

        def attempt(timeout_s):
            timeout = _attempt_timeout(client_timeout, timeout_s)
            return self._attempt_once(
                name, request, headers, timeout, trace, **kwargs
            )

        return _resilience.call_with_retry(attempt, self._retry_policy)

    def _attempt_once(self, name, request, headers, client_timeout, trace,
                      **kwargs):
        """One RPC attempt in a trace attempt span — retries show as
        repeated ATTEMPT_START/ATTEMPT_END pairs."""
        with _tracing.attempt_span(trace, endpoint=self._endpoint):
            return self._call_once(
                name, request, headers, client_timeout, **kwargs
            )

    def _call_once(self, name, request, headers=None, client_timeout=None, **kwargs):
        headers = _stamp_tenant(headers, self._tenant)
        if self._verbose:
            print(f"{name}, metadata {headers}\n{request}")
        try:
            response = self._stubs[name](
                request,
                metadata=_metadata(headers),
                timeout=client_timeout,
                **kwargs,
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

    def is_server_live(self, headers=None, client_timeout=None):
        try:
            return self._call_once(
                "ServerLive", pb.ServerLiveRequest(), headers, client_timeout
            ).live
        except InferenceServerException:
            return False

    def is_server_ready(self, headers=None, client_timeout=None):
        try:
            return self._call_once(
                "ServerReady", pb.ServerReadyRequest(), headers, client_timeout
            ).ready
        except InferenceServerException:
            return False

    def server_state(self, headers=None, client_timeout=None):
        """READY / NOT_READY / UNREACHABLE (client_tpu_torch.utils constants).

        A draining server ANSWERS the ServerReady RPC with ready=False
        (NOT_READY); a dead one fails the RPC itself (UNREACHABLE) — the
        distinction a replica set routes on."""
        try:
            r = self._call_once(
                "ServerReady", pb.ServerReadyRequest(), headers, client_timeout
            )
        except InferenceServerException:
            return SERVER_UNREACHABLE
        return SERVER_READY if r.ready else SERVER_NOT_READY

    def is_model_ready(
        self, model_name, model_version="", headers=None, client_timeout=None
    ):
        request = pb.ModelReadyRequest(name=model_name, version=model_version)
        try:
            return self._call_once(
                "ModelReady", request, headers, client_timeout
            ).ready
        except InferenceServerException:
            return False

    # -- metadata / config ---------------------------------------------------

    def get_server_metadata(self, headers=None, as_json=False, client_timeout=None):
        response = self._call(
            "ServerMetadata", pb.ServerMetadataRequest(), headers, client_timeout
        )
        return self._maybe_json(response, as_json)

    def get_model_metadata(
        self,
        model_name,
        model_version="",
        headers=None,
        as_json=False,
        client_timeout=None,
    ):
        request = pb.ModelMetadataRequest(name=model_name, version=model_version)
        return self._maybe_json(
            self._call("ModelMetadata", request, headers, client_timeout), as_json
        )

    def get_model_config(
        self,
        model_name,
        model_version="",
        headers=None,
        as_json=False,
        client_timeout=None,
    ):
        request = pb.ModelConfigRequest(name=model_name, version=model_version)
        return self._maybe_json(
            self._call("ModelConfig", request, headers, client_timeout), as_json
        )

    # -- repository ----------------------------------------------------------

    def get_model_repository_index(
        self, headers=None, as_json=False, client_timeout=None
    ):
        return self._maybe_json(
            self._call(
                "RepositoryIndex", pb.RepositoryIndexRequest(), headers, client_timeout
            ),
            as_json,
        )

    def load_model(
        self,
        model_name,
        headers=None,
        config=None,
        files=None,
        client_timeout=None,
    ):
        request = pb.RepositoryModelLoadRequest(model_name=model_name)
        if config is not None:
            request.parameters["config"].string_param = (
                config if isinstance(config, str) else __import__("json").dumps(config)
            )
        for path, content in (files or {}).items():
            request.parameters[path].bytes_param = content
        self._call("RepositoryModelLoad", request, headers, client_timeout)

    def unload_model(
        self, model_name, headers=None, unload_dependents=False, client_timeout=None
    ):
        request = pb.RepositoryModelUnloadRequest(model_name=model_name)
        request.parameters["unload_dependents"].bool_param = unload_dependents
        self._call("RepositoryModelUnload", request, headers, client_timeout)

    # -- statistics / trace / log --------------------------------------------

    def get_inference_statistics(
        self,
        model_name="",
        model_version="",
        headers=None,
        as_json=False,
        client_timeout=None,
    ):
        request = pb.ModelStatisticsRequest(name=model_name, version=model_version)
        return self._maybe_json(
            self._call("ModelStatistics", request, headers, client_timeout), as_json
        )

    def update_trace_settings(
        self,
        model_name="",
        settings=None,
        headers=None,
        as_json=False,
        client_timeout=None,
    ):
        request = build_trace_setting_request(model_name, settings)
        return self._maybe_json(
            self._call("TraceSetting", request, headers, client_timeout), as_json
        )

    def get_trace_settings(
        self, model_name="", headers=None, as_json=False, client_timeout=None
    ):
        request = pb.TraceSettingRequest(model_name=model_name)
        return self._maybe_json(
            self._call("TraceSetting", request, headers, client_timeout), as_json
        )

    def update_log_settings(
        self, settings, headers=None, as_json=False, client_timeout=None
    ):
        request = build_log_settings_request(settings)
        return self._maybe_json(
            self._call("LogSettings", request, headers, client_timeout), as_json
        )

    def get_log_settings(self, headers=None, as_json=False, client_timeout=None):
        return self._maybe_json(
            self._call("LogSettings", pb.LogSettingsRequest(), headers, client_timeout),
            as_json,
        )

    # -- shared memory -------------------------------------------------------

    def get_system_shared_memory_status(
        self, region_name="", headers=None, as_json=False, client_timeout=None
    ):
        request = pb.SystemSharedMemoryStatusRequest(name=region_name)
        return self._maybe_json(
            self._call("SystemSharedMemoryStatus", request, headers, client_timeout),
            as_json,
        )

    def register_system_shared_memory(
        self, name, key, byte_size, offset=0, headers=None, client_timeout=None
    ):
        request = pb.SystemSharedMemoryRegisterRequest(
            name=name, key=key, offset=offset, byte_size=byte_size
        )
        self._call("SystemSharedMemoryRegister", request, headers, client_timeout)

    def unregister_system_shared_memory(
        self, name="", headers=None, client_timeout=None
    ):
        request = pb.SystemSharedMemoryUnregisterRequest(name=name)
        self._call("SystemSharedMemoryUnregister", request, headers, client_timeout)

    def get_cuda_shared_memory_status(
        self, region_name="", headers=None, as_json=False, client_timeout=None
    ):
        request = pb.CudaSharedMemoryStatusRequest(name=region_name)
        return self._maybe_json(
            self._call("CudaSharedMemoryStatus", request, headers, client_timeout),
            as_json,
        )

    def register_cuda_shared_memory(
        self, name, raw_handle, device_id, byte_size, headers=None, client_timeout=None
    ):
        request = pb.CudaSharedMemoryRegisterRequest(
            name=name,
            raw_handle=raw_handle,
            device_id=device_id,
            byte_size=byte_size,
        )
        self._call("CudaSharedMemoryRegister", request, headers, client_timeout)

    def unregister_cuda_shared_memory(self, name="", headers=None, client_timeout=None):
        request = pb.CudaSharedMemoryUnregisterRequest(name=name)
        self._call("CudaSharedMemoryUnregister", request, headers, client_timeout)

    # -- inference -----------------------------------------------------------

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
            response = self._call(
                "ModelInfer",
                request,
                headers,
                client_timeout,
                trace=trace,
                compression=_grpc_compression(compression_algorithm),
            )
            return InferResult(response)

    def async_infer(
        self,
        model_name,
        inputs,
        callback,
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
        """Fire-and-callback inference: ``callback(result, error)`` runs on the
        gRPC completion thread (parity: reference grpc/__init__.py:1471)."""
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
        try:
            future = self._stubs["ModelInfer"].future(
                request,
                metadata=_metadata(_stamp_tenant(headers, self._tenant)),
                timeout=client_timeout,
                compression=_grpc_compression(compression_algorithm),
            )
        except grpc.RpcError as e:
            raise_error_grpc(e)

        def _done(f):
            try:
                callback(result=InferResult(f.result()), error=None)
            except grpc.RpcError as e:
                callback(
                    result=None,
                    error=InferenceServerException(
                        msg=e.details(), status=str(e.code().name), debug_details=e
                    ),
                )

        future.add_done_callback(_done)
        return future

    # -- streaming -----------------------------------------------------------

    def start_stream(
        self,
        callback,
        stream_timeout=None,
        headers=None,
        compression_algorithm=None,
    ):
        """Open the bidirectional inference stream; ``callback(result, error)``
        fires per response (parity: reference grpc/__init__.py:1615)."""
        if self._stream is not None:
            raise_error("cannot start another stream with one already active")
        self._stream = _InferStream(
            callback,
            self._stubs,
            _metadata(_stamp_tenant(headers, self._tenant)),
            stream_timeout,
            _grpc_compression(compression_algorithm),
        )

    def stop_stream(self, cancel_requests=False):
        if self._stream is not None:
            self._stream.close(cancel_requests)
            self._stream = None

    def cancel_stream(self):
        """Cancel the active stream's RPC at once, from any thread,
        the stream's callback included: the server sees the cancel and
        the callback receives nothing more.  It does not close the
        stream: ``stop_stream()`` does that afterwards, from a thread
        other than the callback's.  A port addition: the reference
        cancels only through ``stop_stream(cancel_requests=True)``, so a
        callback that has read enough must first wake another thread."""
        stream = self._stream
        if stream is not None:
            stream.cancel()

    def async_stream_infer(
        self,
        model_name,
        inputs,
        model_version="",
        outputs=None,
        request_id="",
        sequence_id=0,
        sequence_start=False,
        sequence_end=False,
        enable_empty_final_response=False,
        priority=0,
        timeout=None,
        parameters=None,
    ):
        """Enqueue one request on the active stream (parity: reference
        grpc/__init__.py:1681)."""
        if self._stream is None:
            raise_error("stream not available, call start_stream() first")
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
        if enable_empty_final_response:
            request.parameters["triton_enable_empty_final_response"].bool_param = True
        self._stream.send(request)


def _grpc_compression(algorithm):
    if algorithm is None:
        return None
    name = str(algorithm).lower()
    if name == "deflate":
        return grpc.Compression.Deflate
    if name == "gzip":
        return grpc.Compression.Gzip
    if name in ("none", ""):
        return grpc.Compression.NoCompression
    raise_error(f"unsupported compression algorithm '{algorithm}' (gzip/deflate/none)")
