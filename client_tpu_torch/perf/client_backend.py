"""Pluggable client-backend layer for the perf harness.

Re-design of the reference's client_backend abstraction (reference
src/c++/perf_analyzer/client_backend/client_backend.h:134-139
BackendKind, :250-307 factory, :335-455 unified API): one interface over the
transport variants so the load engine never touches protocol details.

The port's copy of client_tpu/perf/client_backend.py.  Backends:

- ``triton_grpc`` — the port's KServe-v2 gRPC client
  (client_tpu_torch/grpc) over the network (any Triton-compatible server);
  CUDA regions register by their 64-byte IPC handle.
- ``triton_http`` — the port's KServe-v2 HTTP client
  (client_tpu_torch/http, on ``http.client``), the same surface as the
  gRPC backend; system and CUDA regions register through its verbs.
- ``inprocess`` — the port's in-process InferenceEngine, no sockets (the
  analog of the reference's TRITON_C_API dlopen backend).  Its CUDA
  regions are this process's own, so the engine's registry resolves them
  through the process-local broker (utils/cuda_shared_memory), never over
  IPC.
- ``torchserve``, ``tfserve`` (gRPC PredictionService) and
  ``tfserve_rest`` — the non-KServe protocol families (reference
  client_backend.h:134-139), against a real service or the hermetic
  fakes of perf/fake_endpoints.py.  The REST kinds send over the port's
  HTTP client's ``http.client`` transport where the reference's use
  urllib3, with the same transport-error wrapping; the gRPC kind speaks
  the port's byte copy of the TF-Serving protos.
- ``mock`` — deterministic fake with injectable latency/error schedules
  (reference mock_client_backend.h:405-583), used by the unit tests.
"""

import json
import ssl
import threading
import time

import numpy as np

from client_tpu_torch._infer_types import (
    InferInput,
    InferRequestedOutput,
    _np_from_json_data,
)
from client_tpu_torch.serve.prof import PhaseProfiler
from client_tpu_torch.utils import InferenceServerException, from_wire_bytes

# Client-side wire accounting (serve/prof.py): every backend commits a
# tick per request — build/serialize, wait (the whole server round
# trip), deserialize — so the perf harness can attribute its own side
# of the link.
CLIENT_PROF = PhaseProfiler(name="perf_client")


class BackendKind:
    TRITON_GRPC = "triton_grpc"
    TRITON_HTTP = "triton_http"
    INPROCESS = "inprocess"
    MOCK = "mock"
    # non-KServe protocol families (reference client_backend.h:134-139 lists
    # TENSORFLOW_SERVING and TORCHSERVE next to the Triton kinds)
    TORCHSERVE = "torchserve"
    # TFSERVE speaks gRPC PredictionService (the reference's
    # tfserve_grpc_client.cc shape); the REST variant stays available for
    # endpoints with only the HTTP surface enabled
    TFSERVE = "tfserve"
    TFSERVE_REST = "tfserve_rest"


class ClientBackend:
    """Unified synchronous inference + management surface.

    Latency-critical path is ``infer``; management calls mirror the
    clients.  All methods raise InferenceServerException on failure.
    """

    kind = None
    # Replica identity for per-endpoint reporting: the url this backend
    # instance is bound to.
    endpoint = ""
    infer_input_cls = InferInput
    requested_output_cls = InferRequestedOutput

    def model_metadata(self, model_name, model_version=""):
        raise NotImplementedError

    def model_config(self, model_name, model_version=""):
        raise NotImplementedError

    def infer(self, model_name, inputs, outputs=None, request_id="",
              sequence_id=0, sequence_start=False, sequence_end=False,
              model_version="", priority=0, timeout_us=None, headers=None):
        """Blocking infer; returns the client's InferResult-like object."""
        raise NotImplementedError

    def statistics(self, model_name="", model_version=""):
        return {}

    def metrics(self):
        """Server utilization metrics snapshot (GPU memory when exposed)."""
        return {}

    def update_trace_settings(self, model_name="", settings=None):
        """Push trace settings to the server (KServe trace extension)."""
        raise InferenceServerException(
            f"trace settings not supported by the '{self.kind}' backend"
        )

    def register_system_shared_memory(self, name, key, byte_size):
        raise NotImplementedError

    def register_cuda_shared_memory(self, name, raw_handle, device_id,
                                    byte_size):
        raise NotImplementedError

    def unregister_shared_memory(self, names):
        """Unregister the regions ``names``, of either kind."""

    def close(self):
        pass


class ClientBackendFactory:
    """Create backends by kind+url (client_backend.h:250-307 analog)."""

    @staticmethod
    def create(kind, url=None, engine=None, verbose=False, ssl_options=None,
               **kwargs):
        if kind == BackendKind.TRITON_GRPC:
            return _GrpcBackend(url, verbose, ssl_options=ssl_options)
        if kind == BackendKind.TRITON_HTTP:
            return _HttpBackend(url, verbose, ssl_options=ssl_options)
        if kind == BackendKind.INPROCESS:
            if engine is None:
                raise InferenceServerException(
                    "inprocess backend requires an InferenceEngine"
                )
            return _InprocessBackend(engine)
        if kind == BackendKind.MOCK:
            return MockClientBackend(**kwargs)
        if kind == BackendKind.TORCHSERVE:
            return _TorchServeBackend(url, **kwargs)
        if kind == BackendKind.TFSERVE:
            return _TfServeGrpcBackend(url, **kwargs)
        if kind == BackendKind.TFSERVE_REST:
            return _TfServeBackend(url, **kwargs)
        raise InferenceServerException(f"unknown backend kind '{kind}'")


class _GrpcBackend(ClientBackend):
    kind = BackendKind.TRITON_GRPC

    def __init__(self, url, verbose=False, ssl_options=None):
        import client_tpu_torch.grpc as grpcclient

        opts = ssl_options or {}
        self.endpoint = url
        self._client = grpcclient.InferenceServerClient(
            url,
            verbose=verbose,
            ssl=opts.get("use_ssl", False),
            root_certificates=opts.get("root_certificates"),
            private_key=opts.get("private_key"),
            certificate_chain=opts.get("certificate_chain"),
        )

    def model_metadata(self, model_name, model_version=""):
        return self._client.get_model_metadata(
            model_name, model_version, as_json=True
        )

    def model_config(self, model_name, model_version=""):
        cfg = self._client.get_model_config(model_name, model_version, as_json=True)
        return cfg.get("config", cfg)

    def infer(self, model_name, inputs, outputs=None, request_id="",
              sequence_id=0, sequence_start=False, sequence_end=False,
              model_version="", priority=0, timeout_us=None, headers=None):
        with CLIENT_PROF.start_tick("grpc_client") as ptick:
            with ptick.phase("wait"):  # serialize+rtt+parse live in the lib
                return self._client.infer(
                    model_name,
                    inputs,
                    model_version=model_version,
                    outputs=outputs,
                    request_id=request_id,
                    sequence_id=sequence_id,
                    sequence_start=sequence_start,
                    sequence_end=sequence_end,
                    priority=priority,
                    client_timeout=(timeout_us / 1e6) if timeout_us else None,
                    headers=headers,
                )

    def statistics(self, model_name="", model_version=""):
        return self._client.get_inference_statistics(
            model_name, model_version, as_json=True
        )

    def update_trace_settings(self, model_name="", settings=None):
        return self._client.update_trace_settings(
            model_name=model_name, settings=settings or {}, as_json=True
        )

    def register_system_shared_memory(self, name, key, byte_size):
        self._client.register_system_shared_memory(name, key, byte_size)

    def register_cuda_shared_memory(self, name, raw_handle, device_id,
                                    byte_size):
        self._client.register_cuda_shared_memory(
            name, raw_handle, device_id, byte_size
        )

    def unregister_shared_memory(self, names):
        for name in names:
            self._client.unregister_system_shared_memory(name)
            self._client.unregister_cuda_shared_memory(name)

    def close(self):
        self._client.close()


class _HttpBackend(_GrpcBackend):
    kind = BackendKind.TRITON_HTTP

    def __init__(self, url, verbose=False, ssl_options=None):
        import client_tpu_torch.http as httpclient

        opts = ssl_options or {}
        ctx = None
        if opts.get("use_ssl") and (
            opts.get("ca_certificates_file")
            or opts.get("client_certificate_file")
        ):
            ctx = ssl.create_default_context(
                cafile=opts.get("ca_certificates_file")
            )
            if opts.get("client_certificate_file"):
                ctx.load_cert_chain(
                    opts["client_certificate_file"],
                    keyfile=opts.get("private_key_file"),
                )
            if not opts.get("verify_peer", True):
                # check_hostname must go before CERT_NONE, or ssl raises
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
        self.endpoint = url
        # without a context, insecure=True makes the client's own default
        # context non-verifying (verify_peer=0 with no CA)
        self._client = httpclient.InferenceServerClient(
            url,
            verbose=verbose,
            ssl=opts.get("use_ssl", False),
            ssl_context=ctx,
            insecure=not opts.get("verify_peer", True),
        )

    # the HTTP client returns parsed JSON natively (no as_json kwarg); its
    # `timeout` is the KServe per-request server-side timeout in MICROSECONDS
    # (request parameter), not a client deadline like gRPC's client_timeout
    def model_metadata(self, model_name, model_version=""):
        return self._client.get_model_metadata(model_name, model_version)

    def model_config(self, model_name, model_version=""):
        cfg = self._client.get_model_config(model_name, model_version)
        return cfg.get("config", cfg)

    def infer(self, model_name, inputs, outputs=None, request_id="",
              sequence_id=0, sequence_start=False, sequence_end=False,
              model_version="", priority=0, timeout_us=None, headers=None):
        with CLIENT_PROF.start_tick("http_client") as ptick:
            with ptick.phase("wait"):  # serialize+rtt+parse live in the lib
                return self._client.infer(
                    model_name,
                    inputs,
                    model_version=model_version,
                    outputs=outputs,
                    request_id=request_id,
                    sequence_id=sequence_id,
                    sequence_start=sequence_start,
                    sequence_end=sequence_end,
                    priority=priority,
                    timeout=int(timeout_us) if timeout_us else None,
                    headers=headers,
                )

    def statistics(self, model_name="", model_version=""):
        return self._client.get_inference_statistics(model_name, model_version)

    def update_trace_settings(self, model_name="", settings=None):
        return self._client.update_trace_settings(
            model_name=model_name, settings=settings or {}
        )


class _EngineResult:
    """InferResult-like view over the engine's (response, blobs) tuple so the
    load path (validation, stats) treats all backends uniformly."""

    def __init__(self, response, blobs):
        self._response = response
        self._arrays = {}
        blob_idx = 0
        for out in response.get("outputs", []):
            params = out.get("parameters", {}) or {}
            if "binary_data_size" in params:
                self._arrays[out["name"]] = from_wire_bytes(
                    blobs[blob_idx], out["datatype"], out["shape"]
                )
                blob_idx += 1
            elif "data" in out:
                self._arrays[out["name"]] = _np_from_json_data(
                    out["data"], out["datatype"], out["shape"]
                )
            # shm outputs carry no payload; read them from the region

    def as_numpy(self, name):
        return self._arrays.get(name)

    def get_response(self):
        return self._response


class _InprocessBackend(ClientBackend):
    """Run requests straight into an InferenceEngine — no sockets.

    The analog of the reference's in-process C-API backend
    (triton_c_api/triton_loader.h:84+): benchmark the model/runtime without
    network or serialization overhead.  A decoupled model's responses come
    back as a list, one view a response, once the model has produced them
    all.
    """

    kind = BackendKind.INPROCESS

    def __init__(self, engine):
        self._engine = engine

    def update_trace_settings(self, model_name="", settings=None):
        # same normalization point the socket frontends use, so the
        # hermetic path round-trips the identical schema
        return dict(self._engine.update_trace_settings(settings or {}))

    def model_metadata(self, model_name, model_version=""):
        return self._engine.get_model(model_name, model_version).metadata()

    def model_config(self, model_name, model_version=""):
        return self._engine.get_model(model_name, model_version).config()

    def infer(self, model_name, inputs, outputs=None, request_id="",
              sequence_id=0, sequence_start=False, sequence_end=False,
              model_version="", priority=0, timeout_us=None, headers=None):
        ptick = CLIENT_PROF.start_tick("inprocess")
        t_mark = time.perf_counter()
        request = {"id": request_id, "inputs": []}
        if sequence_id:
            request["parameters"] = {
                "sequence_id": sequence_id,
                "sequence_start": bool(sequence_start),
                "sequence_end": bool(sequence_end),
            }
        binary = b""
        for inp in inputs:
            entry = {
                "name": inp.name(),
                "shape": inp.shape(),
                "datatype": inp.datatype(),
            }
            params = dict(inp.parameters())
            if inp.raw_data() is not None:
                binary += inp.raw_data()
            elif inp.nonbinary_data() is not None:
                entry["data"] = inp.nonbinary_data()
            if params:
                entry["parameters"] = params
            request["inputs"].append(entry)
        if outputs:
            request["outputs"] = [
                {"name": o.name(), "parameters": dict(o.parameters())}
                for o in outputs
            ]
        tenant = (headers or {}).get("x-tenant-id", "")
        try:
            ptick.add("serialize", time.perf_counter() - t_mark)
            t_mark = time.perf_counter()
            result = self._engine.execute(
                model_name, model_version, request, binary, tenant=tenant
            )
            ptick.add("wait", time.perf_counter() - t_mark)
            if not isinstance(result, tuple):  # decoupled (generator/list)
                return [_EngineResult(r, b) for r, b in result]
            response, blobs = result
            t_mark = time.perf_counter()
            view = _EngineResult(response, blobs)
            ptick.add("deserialize", time.perf_counter() - t_mark)
            return view
        finally:
            CLIENT_PROF.finish(ptick)

    def statistics(self, model_name="", model_version=""):
        return self._engine.statistics(model_name, model_version)

    def register_system_shared_memory(self, name, key, byte_size):
        self._engine.shm.register_system(name, key, 0, byte_size)

    def register_cuda_shared_memory(self, name, raw_handle, device_id,
                                    byte_size):
        self._engine.shm.register_cuda(name, raw_handle, device_id, byte_size)

    def unregister_shared_memory(self, names):
        for name in names:
            self._engine.shm.unregister_system(name)
            self._engine.shm.unregister_cuda(name)


class _RestResult:
    """InferResult-like view over a non-KServe JSON prediction response."""

    def __init__(self, arrays, response):
        self._arrays = arrays
        self._response = response

    def as_numpy(self, name):
        return self._arrays.get(name)

    def get_response(self):
        return self._response


class _TorchServeBackend(ClientBackend):
    """TorchServe inference-API backend (reference
    torchserve_http_client.cc:47-225): health via GET /ping, inference via
    POST /predictions/{model} with the input payload as the request body.

    TorchServe has no tensor-metadata endpoint, so (like the reference,
    which requires --input-data for this service kind) the input shape is
    declared at construction: ``input_shape``/``input_datatype`` kwargs, or
    the DataLoader's ``--shape`` override downstream.
    """

    kind = BackendKind.TORCHSERVE

    def __init__(self, url, verbose=False, input_shape=None,
                 input_datatype="FP32", timeout_s=60.0):
        from client_tpu_torch.http import InferenceServerClient

        if "://" not in url:
            url = "http://" + url
        self._base = url.rstrip("/")
        # the HTTP client's pool of keep-alive connections (8 idle at
        # most); the reference's urllib3 total timeout becomes a bound on
        # the connect and on each read
        self._http = InferenceServerClient(
            self._base, verbose=verbose, concurrency=8,
            connection_timeout=timeout_s, network_timeout=timeout_s,
        )
        self._shape = list(input_shape or [-1])
        self._datatype = input_datatype

    def _request(self, method, path, body=None, headers=None):
        """One request on the HTTP client's transport, with transport
        errors wrapped — a transient connection reset must surface as a
        per-window error count, not kill the sweep via the worker-fatal
        path (mirrors http/__init__.py).  The answer has the ``status``
        and raw ``data`` of any status."""
        try:
            return self._http._request_once(
                method, path.lstrip("/"), headers, None, body
            )
        except InferenceServerException as e:
            cause = e.debug_details()
            raise InferenceServerException(
                f"{self.kind} {method} {self._base}{path} failed: {cause}",
                debug_details=cause,
            ) from e

    @staticmethod
    def _json(r, what):
        try:
            return json.loads(r.data)
        except Exception as e:
            raise InferenceServerException(
                f"{what} returned non-JSON body: {r.data[:200]!r}",
                debug_details=e,
            ) from e

    def _get(self, path):
        r = self._request("GET", path)
        if r.status != 200:
            raise InferenceServerException(
                f"torchserve GET {path} -> {r.status}: {r.data[:200]!r}",
                status=str(r.status),
            )
        return self._json(r, f"GET {path}")

    def server_live(self):
        return self._get("/ping").get("status") == "Healthy"

    def model_metadata(self, model_name, model_version=""):
        # surface the declared tensor interface in KServe-metadata shape so
        # DataLoader / InferDataManager work unchanged
        return {
            "name": model_name,
            "versions": ["1.0"],
            "platform": "pytorch_torchserve",
            "inputs": [{"name": "data", "datatype": self._datatype,
                        "shape": self._shape}],
            "outputs": [{"name": "predictions", "datatype": "FP64",
                         "shape": [-1]}],
        }

    def model_config(self, model_name, model_version=""):
        models = self._get(f"/models/{model_name}")
        return {"name": model_name, "torchserve": models}

    def infer(self, model_name, inputs, outputs=None, request_id="",
              sequence_id=0, sequence_start=False, sequence_end=False,
              model_version="", priority=0, timeout_us=None, headers=None):
        if not inputs:
            raise InferenceServerException("torchserve infer needs one input")
        body = bytes(inputs[0].raw_data() or b"")
        r = self._request(
            "POST", f"/predictions/{model_name}", body=body,
            headers={"Content-Type": "application/octet-stream"},
        )
        if r.status != 200:
            raise InferenceServerException(
                f"torchserve predict -> {r.status}: {r.data[:200]!r}",
                status=str(r.status),
            )
        # A 200 is a successful inference whatever the body shape: numeric
        # predictions become a validatable tensor; anything else (TorchServe
        # classification dicts, text/plain custom handlers) stays reachable
        # via get_response() as parsed JSON or raw bytes.
        try:
            doc = json.loads(r.data)
        except Exception:
            return _RestResult({}, r.data)
        try:
            arrays = {
                "predictions": np.asarray(doc, dtype=np.float64).reshape(-1)
            }
        except (TypeError, ValueError):
            arrays = {}
        return _RestResult(arrays, doc)

    def close(self):
        self._http.close()


class _TfServeGrpcBackend(ClientBackend):
    """TensorFlow-Serving backend over gRPC PredictionService — the
    reference's service shape (tensorflow_serving/tfserve_grpc_client.cc:
    PredictRequest with a TensorProto inputs map, ModelService status for
    liveness).  Wire messages come from the self-contained
    proto/tfserve.proto mirror (field numbers match upstream tensorflow, so
    this talks to a real TF-Serving endpoint)."""

    kind = BackendKind.TFSERVE

    _DTYPES = {
        "FP32": ("DT_FLOAT", np.float32),
        "FP64": ("DT_DOUBLE", np.float64),
        "INT32": ("DT_INT32", np.int32),
        "INT64": ("DT_INT64", np.int64),
        "INT16": ("DT_INT16", np.int16),
        "INT8": ("DT_INT8", np.int8),
        "UINT8": ("DT_UINT8", np.uint8),
        "UINT32": ("DT_UINT32", np.uint32),
        "UINT64": ("DT_UINT64", np.uint64),
        "BOOL": ("DT_BOOL", np.bool_),
    }

    def __init__(self, url, verbose=False, signature_name="serving_default",
                 input_name="input", output_name="output", input_shape=None,
                 input_datatype="FP32", **_):
        import grpc

        from client_tpu_torch._proto import tfserve_pb2 as tfs

        self._tfs = tfs
        self._signature = signature_name
        self._input_name = input_name
        self._output_name = output_name
        self._shape = input_shape or [-1, 4]
        self._datatype = input_datatype
        self._channel = grpc.insecure_channel(url)
        service = "/tensorflow.serving.PredictionService/"
        self._predict = self._channel.unary_unary(
            service + "Predict",
            request_serializer=tfs.PredictRequest.SerializeToString,
            response_deserializer=tfs.PredictResponse.FromString,
        )
        self._metadata_rpc = self._channel.unary_unary(
            service + "GetModelMetadata",
            request_serializer=tfs.GetModelMetadataRequest.SerializeToString,
            response_deserializer=tfs.GetModelMetadataResponse.FromString,
        )
        self._status = self._channel.unary_unary(
            "/tensorflow.serving.ModelService/GetModelStatus",
            request_serializer=tfs.GetModelStatusRequest.SerializeToString,
            response_deserializer=tfs.GetModelStatusResponse.FromString,
        )

    def server_live(self):
        return True  # liveness is per-model (GetModelStatus) below

    def model_ready(self, model_name, model_version=""):
        import grpc

        request = self._tfs.GetModelStatusRequest()
        request.model_spec.name = model_name
        try:
            response = self._status(request)
        except grpc.RpcError as e:
            raise InferenceServerException(
                f"GetModelStatus failed: {e.details()}"
            ) from e
        return any(
            s.state == self._tfs.ModelVersionStatus.AVAILABLE
            for s in response.model_version_status
        )

    def model_metadata(self, model_name, model_version=""):
        import grpc

        request = self._tfs.GetModelMetadataRequest()
        request.model_spec.name = model_name
        request.metadata_field.append("signature_def")
        version = "1"
        try:
            response = self._metadata_rpc(request)
            if response.model_spec.version.value:
                version = str(response.model_spec.version.value)
        except grpc.RpcError:
            pass  # metadata verb optional on some deployments
        return {
            "name": model_name,
            "versions": [version],
            "platform": "tensorflow_serving",
            "inputs": [{"name": self._input_name,
                        "datatype": self._datatype, "shape": self._shape}],
            "outputs": [{"name": self._output_name, "datatype": "FP32",
                         "shape": [-1]}],
        }

    def model_config(self, model_name, model_version=""):
        return {"name": model_name, "platform": "tensorflow_serving"}

    def _to_tensor(self, tensor, inp):
        datatype = inp.datatype()
        if datatype == "BYTES":
            arr = from_wire_bytes(inp.raw_data() or b"", "BYTES", inp.shape())
            tensor.dtype = self._tfs.DT_STRING
            for v in arr.flatten():
                tensor.string_val.append(
                    v if isinstance(v, bytes) else str(v).encode()
                )
        else:
            entry = self._DTYPES.get(datatype)
            if entry is None:
                raise InferenceServerException(
                    f"tfserve backend cannot map datatype {datatype}"
                )
            tensor.dtype = getattr(self._tfs, entry[0])
            tensor.tensor_content = inp.raw_data() or b""
        for d in inp.shape():
            tensor.tensor_shape.dim.add().size = int(d)

    def _from_tensor(self, tensor):
        shape = [d.size for d in tensor.tensor_shape.dim]
        for wire, (dt_name, np_dtype) in self._DTYPES.items():
            if tensor.dtype == getattr(self._tfs, dt_name):
                if tensor.tensor_content:
                    arr = np.frombuffer(tensor.tensor_content, dtype=np_dtype)
                else:
                    # upstream's repeated-field conventions: int_val also
                    # carries the narrow integer dtypes
                    field = {
                        "DT_FLOAT": tensor.float_val,
                        "DT_DOUBLE": tensor.double_val,
                        "DT_INT32": tensor.int_val,
                        "DT_INT16": tensor.int_val,
                        "DT_INT8": tensor.int_val,
                        "DT_UINT8": tensor.int_val,
                        "DT_INT64": tensor.int64_val,
                        "DT_UINT32": tensor.uint32_val,
                        "DT_UINT64": tensor.uint64_val,
                        "DT_BOOL": tensor.bool_val,
                    }[dt_name]
                    arr = np.asarray(list(field), dtype=np_dtype)
                return arr.reshape(shape) if shape else arr
        if tensor.dtype == self._tfs.DT_STRING:
            arr = np.array(list(tensor.string_val), dtype=np.object_)
            return arr.reshape(shape) if shape else arr
        raise InferenceServerException(
            f"tfserve response carried unsupported dtype {tensor.dtype}"
        )

    def infer(self, model_name, inputs, outputs=None, request_id="",
              sequence_id=0, sequence_start=False, sequence_end=False,
              model_version="", priority=0, timeout_us=None, headers=None):
        import grpc

        if not inputs:
            raise InferenceServerException("tfserve infer needs inputs")
        request = self._tfs.PredictRequest()
        request.model_spec.name = model_name
        request.model_spec.signature_name = self._signature
        if model_version:
            request.model_spec.version.value = int(model_version)
        for inp in inputs:
            self._to_tensor(request.inputs[inp.name()], inp)
        for out in outputs or []:
            request.output_filter.append(out.name())
        timeout_s = (timeout_us / 1e6) if timeout_us else None
        try:
            response = self._predict(request, timeout=timeout_s)
        except grpc.RpcError as e:
            raise InferenceServerException(
                f"tfserve Predict failed: {e.details()}",
                status=str(e.code().name),
            ) from e
        arrays = {
            name: self._from_tensor(tensor)
            for name, tensor in response.outputs.items()
        }
        return _RestResult(arrays, {"model_spec": response.model_spec.name})

    def statistics(self, model_name="", model_version=""):
        raise NotImplementedError("tensorflow serving exposes no statistics")

    def close(self):
        self._channel.close()


class _TfServeBackend(_TorchServeBackend):
    """TensorFlow-Serving backend over its REST predict API — for
    deployments with only the HTTP surface enabled (the gRPC
    PredictionService backend above is the reference's shape)."""

    kind = BackendKind.TFSERVE_REST

    def server_live(self):
        return True  # liveness is per-model below

    def model_metadata(self, model_name, model_version=""):
        md = self._get(f"/v1/models/{model_name}/metadata")
        meta = {
            "name": model_name,
            "versions": [md.get("model_spec", {}).get("version", "1")],
            "platform": "tensorflow_serving",
            "inputs": [{"name": "instances", "datatype": self._datatype,
                        "shape": self._shape}],
            "outputs": [{"name": "predictions", "datatype": "FP64",
                         "shape": [-1]}],
        }
        return meta

    def model_config(self, model_name, model_version=""):
        return {"name": model_name,
                "tfserving": self._get(f"/v1/models/{model_name}")}

    def infer(self, model_name, inputs, outputs=None, request_id="",
              sequence_id=0, sequence_start=False, sequence_end=False,
              model_version="", priority=0, timeout_us=None, headers=None):
        if not inputs:
            raise InferenceServerException("tfserve infer needs one input")
        inp = inputs[0]
        arr = from_wire_bytes(
            inp.raw_data() or b"", inp.datatype(), inp.shape()
        )
        doc = {"instances": arr.reshape(arr.shape[0], -1).tolist()
               if arr.ndim > 1 else [arr.tolist()]}
        r = self._request(
            "POST", f"/v1/models/{model_name}:predict",
            body=json.dumps(doc).encode(),
            headers={"Content-Type": "application/json"},
        )
        if r.status != 200:
            raise InferenceServerException(
                f"tfserve predict -> {r.status}: {r.data[:200]!r}",
                status=str(r.status),
            )
        out = self._json(r, "predict")
        try:  # columnar ("outputs") or non-numeric responses: raw doc only
            arrays = {
                "predictions": np.asarray(out["predictions"], np.float64)
            }
        except (KeyError, TypeError, ValueError):
            arrays = {}
        return _RestResult(arrays, out)


class MockStats:
    """Request accounting shared by mock backend instances
    (mock_client_backend.h:125-300 analog)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.num_infer_calls = 0
        self.request_timestamps = []
        self.sequence_ids = []

    def record(self, sequence_id):
        with self.lock:
            self.num_infer_calls += 1
            self.request_timestamps.append(time.monotonic_ns())
            if sequence_id:
                self.sequence_ids.append(sequence_id)


class MockClientBackend(ClientBackend):
    """Deterministic fake backend with injectable latency/error schedules."""

    kind = BackendKind.MOCK

    def __init__(self, latency_s=0.0, error_schedule=None, stats=None,
                 metadata=None):
        self.latency_s = latency_s
        self._errors = list(error_schedule or [])  # bool per request: True=fail
        self.stats = stats or MockStats()
        self._metadata = metadata or {
            "name": "mock",
            "versions": ["1"],
            "platform": "mock",
            "inputs": [{"name": "INPUT0", "datatype": "FP32", "shape": [-1, 4]}],
            "outputs": [{"name": "OUTPUT0", "datatype": "FP32", "shape": [-1, 4]}],
        }

    def model_metadata(self, model_name, model_version=""):
        return dict(self._metadata, name=model_name)

    def model_config(self, model_name, model_version=""):
        return {"name": model_name, "max_batch_size": 8}

    def infer(self, model_name, inputs, outputs=None, request_id="",
              sequence_id=0, sequence_start=False, sequence_end=False,
              model_version="", priority=0, timeout_us=None, headers=None):
        self.stats.record(sequence_id)
        if self.latency_s:
            time.sleep(self.latency_s)
        with self.stats.lock:
            fail = self._errors.pop(0) if self._errors else False
        if fail:
            raise InferenceServerException("mock: injected failure")
        return None
