"""KServe-v2 gRPC frontend for the in-process inference engine.

Counterpart of client_tpu/serve/grpc_server.py.  Registers generic method
handlers from the client_tpu_torch._grpc_service table (no grpcio-tools)
and bridges protobuf requests to the engine's JSON-dict execution form,
including bidirectional ModelStreamInfer with decoupled (N-response)
models: the transport the LM token streams take.  The shared-memory verbs
mirror the HTTP frontend's: system and CUDA regions are served, a TPU
region is refused.  The handlers compute nothing on the device; the models
behind the engine run where they were built.
"""

import json
import time
from concurrent import futures

import grpc
from google.protobuf import json_format

from client_tpu_torch._grpc_infer import _CONTENTS_FIELD
from client_tpu_torch._grpc_service import METHODS, SERVICE
from client_tpu_torch._infer_types import _np_from_json_data
from client_tpu_torch._proto import inference_pb2 as pb
from client_tpu_torch._proto import model_config_pb2 as mc
from client_tpu_torch.serve import model_runtime
from client_tpu_torch.utils import (
    TENANT_HEADER,
    InferenceServerException,
    to_wire_bytes,
)

_STATUS_MAP = {
    "400": grpc.StatusCode.INVALID_ARGUMENT,
    "404": grpc.StatusCode.NOT_FOUND,
    # retryable overload/drain shedding: UNAVAILABLE is the status gRPC
    # clients retry on
    "429": grpc.StatusCode.RESOURCE_EXHAUSTED,
    "503": grpc.StatusCode.UNAVAILABLE,
    "500": grpc.StatusCode.INTERNAL,
    "501": grpc.StatusCode.UNIMPLEMENTED,
}


def _abort(context, exc):
    code = grpc.StatusCode.INVALID_ARGUMENT
    if isinstance(exc, InferenceServerException) and exc.status():
        code = _STATUS_MAP.get(exc.status(), grpc.StatusCode.UNKNOWN)
    msg = exc.message() if isinstance(exc, InferenceServerException) else str(exc)
    # QoS/overload sheds carry a backoff hint in trailing metadata (the
    # gRPC spelling of the HTTP Retry-After header)
    hint = getattr(exc, "retry_after_s", None)
    if hint:
        context.set_trailing_metadata((("retry-after", f"{float(hint):.3f}"),))
    context.abort(code, msg)


def _tenant_of(context):
    """Tenant identity from the request metadata (serve/frontdoor.py)."""
    for key, value in context.invocation_metadata() or ():
        if key == TENANT_HEADER:
            return value
    return ""


def _param_value(param):
    which = param.WhichOneof("parameter_choice")
    return getattr(param, which) if which else None


def _request_to_dict(request):
    """ModelInferRequest proto -> (engine request dict, binary buffers).

    The binary section is handed to the engine as the *list* of per-tensor
    proto buffers, untouched: the engine decodes each as a zero-copy
    read-only view of the proto-owned bytes, so wire tensors are not copied
    between the transport and the model.
    """
    req = {"id": request.id}
    params = {k: _param_value(v) for k, v in request.parameters.items()}
    req["parameters"] = params

    raw_cursor = 0
    binary_parts = []
    inputs = []
    for tensor in request.inputs:
        entry = {
            "name": tensor.name,
            "datatype": tensor.datatype,
            "shape": list(tensor.shape),
        }
        tparams = {k: _param_value(v) for k, v in tensor.parameters.items()}
        if "shared_memory_region" in tparams:
            entry["parameters"] = tparams
        elif tensor.HasField("contents"):
            # typed repeated-field contents: normalised to wire bytes so the
            # engine has a single decode path
            arr = _contents_to_array(tensor)
            raw = to_wire_bytes(arr, tensor.datatype)
            entry["parameters"] = {"binary_data_size": len(raw)}
            binary_parts.append(raw)
        else:
            if raw_cursor >= len(request.raw_input_contents):
                raise InferenceServerException(
                    f"input '{tensor.name}' has no data", status="400"
                )
            raw = request.raw_input_contents[raw_cursor]
            raw_cursor += 1
            entry["parameters"] = {"binary_data_size": len(raw)}
            binary_parts.append(raw)
        inputs.append(entry)
    req["inputs"] = inputs

    if request.outputs:
        outputs = []
        for out in request.outputs:
            oparams = {k: _param_value(v) for k, v in out.parameters.items()}
            if "shared_memory_region" not in oparams:
                oparams["binary_data"] = True
            oparams.pop("binary_data_size", None)
            outputs.append({"name": out.name, "parameters": oparams})
        req["outputs"] = outputs
    else:
        params["binary_data_output"] = True
    return req, binary_parts


def _contents_to_array(tensor):
    field = _CONTENTS_FIELD.get(tensor.datatype)
    if field is None:
        raise InferenceServerException(
            f"unsupported datatype {tensor.datatype}", status="400"
        )
    values = list(getattr(tensor.contents, field))
    return _np_from_json_data(values, tensor.datatype, list(tensor.shape))


def _set_infer_param(proto_params, key, value):
    """Python value -> InferParameter oneof (bool checked before int:
    bool is an int subclass)."""
    if isinstance(value, bool):
        proto_params[key].bool_param = value
    elif isinstance(value, int):
        proto_params[key].int64_param = value
    else:
        proto_params[key].string_param = str(value)


def _dict_to_response(model_name, model_version, response_json, blobs):
    """Engine response dict + blobs -> ModelInferResponse proto."""
    response = pb.ModelInferResponse(
        model_name=response_json.get("model_name", model_name),
        model_version=response_json.get("model_version", model_version),
        id=response_json.get("id", ""),
    )
    # response-level parameters (decoupled final markers etc.)
    for key, value in (response_json.get("parameters", {}) or {}).items():
        _set_infer_param(response.parameters, key, value)
    # raw_output_contents align positionally with the non-shm outputs, so
    # binary blobs and JSON-data fallbacks interleave in output order
    raws = []
    blob_cursor = 0
    for entry in response_json.get("outputs", []):
        out = response.outputs.add()
        out.name = entry["name"]
        out.datatype = entry["datatype"]
        out.shape.extend(entry["shape"])
        eparams = entry.get("parameters", {}) or {}
        for key, value in eparams.items():
            if key == "binary_data_size":
                continue
            _set_infer_param(out.parameters, key, value)
        if "binary_data_size" in eparams:
            raws.append(blobs[blob_cursor])
            blob_cursor += 1
        elif "data" in entry:
            arr = _np_from_json_data(
                entry["data"], entry["datatype"], entry["shape"]
            )
            raws.append(to_wire_bytes(arr, entry["datatype"]))
    response.raw_output_contents.extend(raws)
    return response


class _Handlers:
    def __init__(self, engine, verbose=False):
        self.engine = engine
        self.verbose = verbose

    # health ---------------------------------------------------------------

    def ServerLive(self, request, context):
        return pb.ServerLiveResponse(live=True)

    def ServerReady(self, request, context):
        # drain() flips readiness false so load balancers stop routing here
        return pb.ServerReadyResponse(ready=self.engine.ready())

    def ModelReady(self, request, context):
        return pb.ModelReadyResponse(
            ready=self.engine.model_ready(request.name, request.version)
        )

    # metadata -------------------------------------------------------------

    def ServerMetadata(self, request, context):
        return pb.ServerMetadataResponse(
            name=model_runtime.SERVER_NAME,
            version=model_runtime.SERVER_VERSION,
            extensions=model_runtime.SERVER_EXTENSIONS,
        )

    def ModelMetadata(self, request, context):
        try:
            model = self.engine.get_model(request.name, request.version)
        except InferenceServerException as e:
            _abort(context, e)
        meta = model.metadata()
        response = pb.ModelMetadataResponse(
            name=meta["name"], versions=meta["versions"], platform=meta["platform"]
        )
        for t in meta["inputs"]:
            tm = response.inputs.add()
            tm.name, tm.datatype = t["name"], t["datatype"]
            tm.shape.extend(t["shape"])
        for t in meta["outputs"]:
            tm = response.outputs.add()
            tm.name, tm.datatype = t["name"], t["datatype"]
            tm.shape.extend(t["shape"])
        return response

    def ModelConfig(self, request, context):
        try:
            model = self.engine.get_model(request.name, request.version)
        except InferenceServerException as e:
            _abort(context, e)
        config = json_format.ParseDict(
            model.config(), mc.ModelConfig(), ignore_unknown_fields=True
        )
        return pb.ModelConfigResponse(config=config)

    # repository -----------------------------------------------------------

    def RepositoryIndex(self, request, context):
        response = pb.RepositoryIndexResponse()
        for entry in self.engine.repository_index(request.ready):
            m = response.models.add()
            m.name, m.version = entry["name"], entry["version"]
            m.state, m.reason = entry["state"], entry["reason"]
        return response

    def RepositoryModelLoad(self, request, context):
        config = None
        files = {}
        for key, param in request.parameters.items():
            if key == "config":
                config = json.loads(param.string_param)
            elif param.WhichOneof("parameter_choice") == "bytes_param":
                files[key] = param.bytes_param
        try:
            self.engine.load_model(
                request.model_name, config_override=config, files=files or None
            )
        except InferenceServerException as e:
            _abort(context, e)
        return pb.RepositoryModelLoadResponse()

    def RepositoryModelUnload(self, request, context):
        try:
            self.engine.unload_model(request.model_name)
        except InferenceServerException as e:
            _abort(context, e)
        return pb.RepositoryModelUnloadResponse()

    # statistics / trace / log ---------------------------------------------

    def ModelStatistics(self, request, context):
        try:
            stats = self.engine.statistics(request.name, request.version)
        except InferenceServerException as e:
            _abort(context, e)
        response = pb.ModelStatisticsResponse()
        for entry in stats:
            response.model_stats.append(
                json_format.ParseDict(entry, pb.ModelStatistics())
            )
        return response

    def TraceSetting(self, request, context):
        settings = self.engine.trace_settings
        if request.settings:
            updates = {}
            for key, value in request.settings.items():
                values = list(value.value)
                if not values:
                    continue
                updates[key] = values if key == "trace_level" else values[0]
            try:
                # the HTTP verb's normalisation point, so settings
                # round-trip identically over both protocols
                settings = self.engine.update_trace_settings(updates)
            except InferenceServerException as e:
                _abort(context, e)
        response = pb.TraceSettingResponse()
        for key, value in settings.items():
            values = value if isinstance(value, list) else [str(value)]
            response.settings[key].value.extend(values)
        return response

    def LogSettings(self, request, context):
        settings = self.engine.log_settings
        if request.settings:
            for key, value in request.settings.items():
                which = value.WhichOneof("parameter_choice")
                if which:
                    settings[key] = getattr(value, which)
        response = pb.LogSettingsResponse()
        for key, value in settings.items():
            if isinstance(value, bool):
                response.settings[key].bool_param = value
            elif isinstance(value, int):
                response.settings[key].uint32_param = value
            else:
                response.settings[key].string_param = str(value)
        return response

    # shared memory --------------------------------------------------------
    # system and CUDA regions are served; a TPU region is refused (the
    # mirror image of the reference, as the HTTP verbs are)

    def SystemSharedMemoryStatus(self, request, context):
        try:
            regions = self.engine.shm.system_status(request.name or None)
        except InferenceServerException as e:
            _abort(context, e)
        response = pb.SystemSharedMemoryStatusResponse()
        for name, r in regions.items():
            response.regions[name].name = name
            response.regions[name].key = r["key"]
            response.regions[name].offset = r["offset"]
            response.regions[name].byte_size = r["byte_size"]
        return response

    def SystemSharedMemoryRegister(self, request, context):
        try:
            self.engine.shm.register_system(
                request.name, request.key, request.offset, request.byte_size
            )
        except InferenceServerException as e:
            _abort(context, e)
        return pb.SystemSharedMemoryRegisterResponse()

    def SystemSharedMemoryUnregister(self, request, context):
        self.engine.shm.unregister_system(request.name or None)
        return pb.SystemSharedMemoryUnregisterResponse()

    def CudaSharedMemoryStatus(self, request, context):
        try:
            regions = self.engine.shm.cuda_status(request.name or None)
        except InferenceServerException as e:
            _abort(context, e)
        response = pb.CudaSharedMemoryStatusResponse()
        for name, r in regions.items():
            response.regions[name].name = name
            response.regions[name].device_id = r["device_id"]
            response.regions[name].byte_size = r["byte_size"]
        return response

    def CudaSharedMemoryRegister(self, request, context):
        try:
            self.engine.shm.register_cuda(
                request.name, request.raw_handle, request.device_id,
                request.byte_size,
            )
        except InferenceServerException as e:
            _abort(context, e)
        return pb.CudaSharedMemoryRegisterResponse()

    def CudaSharedMemoryUnregister(self, request, context):
        self.engine.shm.unregister_cuda(request.name or None)
        return pb.CudaSharedMemoryUnregisterResponse()

    def TpuSharedMemoryStatus(self, request, context):
        return pb.TpuSharedMemoryStatusResponse()

    def TpuSharedMemoryRegister(self, request, context):
        context.abort(
            grpc.StatusCode.INVALID_ARGUMENT,
            "TPU shared memory is not supported by this server "
            "(use CudaSharedMemoryRegister)",
        )

    def TpuSharedMemoryUnregister(self, request, context):
        return pb.TpuSharedMemoryUnregisterResponse()

    # inference ------------------------------------------------------------

    def _sample_trace(self, request, context):
        """A RequestTrace for this RPC (or None), joined to the client's
        trace id through the traceparent metadata entry when present."""
        traceparent = None
        for key, value in context.invocation_metadata() or ():
            if key == "traceparent":
                traceparent = value
                break
        return self.engine.tracer.sample(
            traceparent, model_name=request.model_name,
            model_version=request.model_version, protocol="grpc",
        )

    def ModelInfer(self, request, context):
        trace = self._sample_trace(request, context)
        # wire-path profiling (serve/prof.py): proto-decode / execute-
        # wait / proto-encode splits committed as one "grpc" tick
        ptick = self.engine.wire_prof.start_tick("grpc")
        try:
            t_mark = time.perf_counter()
            req, binary = _request_to_dict(request)
            ptick.add("deserialize", time.perf_counter() - t_mark)
            t_mark = time.perf_counter()
            if trace is not None:
                # as the HTTP frontend does: the span starts where the
                # decoded request reaches the engine, the decode being
                # the wire's (traceview's "wire" holds serialization)
                trace.event("REQUEST_START")
            result = self.engine.execute(
                request.model_name, request.model_version, req, binary,
                trace=trace, tenant=_tenant_of(context),
            )
            ptick.add("wait", time.perf_counter() - t_mark)
            if not isinstance(result, tuple):  # list/generator = decoupled
                if hasattr(result, "close"):
                    result.close()  # releases its admission and tenant slots
                raise InferenceServerException(
                    f"model '{request.model_name}' is decoupled; use "
                    "ModelStreamInfer",
                    status="400",
                )
            response_json, blobs = result
            t_mark = time.perf_counter()
            response = _dict_to_response(
                request.model_name, request.model_version, response_json, blobs
            )
            ptick.add("serialize", time.perf_counter() - t_mark)
            if trace is not None:
                trace.event("RESPONSE_SENT")
            return response
        except InferenceServerException as e:
            if trace is not None:
                trace.error = str(e)
            _abort(context, e)
        finally:
            self.engine.wire_prof.finish(ptick)
            if trace is not None:
                self.engine.tracer.complete(trace)

    def ModelStreamInfer(self, request_iterator, context):
        tenant = _tenant_of(context)  # one identity per stream connection
        # the RPC's end (a client's cancel among them) cancels the engine
        # handles of the models streaming on it from grpc's own thread,
        # before this handler's next send would fail
        ended = model_runtime.StreamCancel()
        context.add_callback(ended.fire)
        for request in request_iterator:
            trace = self._sample_trace(request, context)
            try:
                req, binary = _request_to_dict(request)
                if trace is not None:
                    trace.event("REQUEST_START")  # as in ModelInfer
                result = self.engine.execute(
                    request.model_name, request.model_version, req, binary,
                    trace=trace, tenant=tenant,
                )
                # a decoupled result streams lazily (generator): each
                # response reaches the wire as the model produces it
                responses = [result] if isinstance(result, tuple) else result
                sent_ns = None
                try:
                    with ended.bound():
                        for response_json, blobs in responses:
                            yield pb.ModelStreamInferResponse(
                                infer_response=_dict_to_response(
                                    request.model_name,
                                    request.model_version,
                                    response_json,
                                    blobs,
                                )
                            )
                            # grpc resumes this generator once it has
                            # sent the response
                            if trace is not None:
                                sent_ns = time.time_ns()
                finally:
                    # a stream the client stops closes the model's
                    # generator here and now, which cancels its engine
                    # handle and frees its KV blocks
                    if hasattr(responses, "close"):
                        responses.close()
                if trace is not None:
                    # stamped when the last response went out, before the
                    # model's generator recorded COMPUTE_END and released
                    # its slots: that bookkeeping is no part of the span
                    trace.event("RESPONSE_SENT", sent_ns)
            except InferenceServerException as e:
                # ModelStreamInferResponse carries only a message string, so
                # the status rides as a "[<status>] " prefix (str(e) form);
                # the client strips it back into InferenceServerException
                if trace is not None:
                    trace.error = str(e)
                err = pb.ModelStreamInferResponse(error_message=str(e))
                err.infer_response.id = request.id
                yield err
            except Exception as e:  # pragma: no cover - defensive
                if trace is not None:
                    trace.error = str(e)
                yield pb.ModelStreamInferResponse(error_message=str(e))
            finally:
                if trace is not None:
                    self.engine.tracer.complete(trace)


class GrpcFrontend:
    """grpc.server bound to an InferenceEngine through generic method
    handlers."""

    def __init__(self, engine, host="127.0.0.1", port=0, verbose=False,
                 max_workers=96):
        self._server = grpc.server(
            futures.ThreadPoolExecutor(
                max_workers=max_workers,
                thread_name_prefix="client_tpu_torch-grpc",
            ),
            options=[
                ("grpc.max_send_message_length", 2**31 - 1),
                ("grpc.max_receive_message_length", 2**31 - 1),
            ],
        )
        handlers_obj = _Handlers(engine, verbose)
        method_handlers = {}
        for name, (req_cls, resp_cls, cstream, sstream) in METHODS.items():
            fn = getattr(handlers_obj, name)
            kwargs = {
                "request_deserializer": req_cls.FromString,
                "response_serializer": resp_cls.SerializeToString,
            }
            if cstream and sstream:
                handler = grpc.stream_stream_rpc_method_handler(fn, **kwargs)
            elif sstream:
                handler = grpc.unary_stream_rpc_method_handler(fn, **kwargs)
            elif cstream:
                handler = grpc.stream_unary_rpc_method_handler(fn, **kwargs)
            else:
                handler = grpc.unary_unary_rpc_method_handler(fn, **kwargs)
            method_handlers[name] = handler
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE, method_handlers),)
        )
        self._port = self._server.add_insecure_port(f"{host}:{port}")
        self._host = host

    @property
    def address(self):
        return f"{self._host}:{self._port}"

    def start(self):
        self._server.start()
        return self

    def stop(self):
        self._server.stop(grace=2)
