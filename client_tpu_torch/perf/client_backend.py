"""Pluggable client-backend layer for the perf harness.

Re-design of the reference's client_backend abstraction (reference
src/c++/perf_analyzer/client_backend/client_backend.h:134-139
BackendKind, :250-307 factory, :335-455 unified API): one interface over the
transport variants so the load engine never touches protocol details.

The port's copy of client_tpu/perf/client_backend.py, less the HTTP and
non-KServe backends (the reference's HTTP client needs urllib3; the
TorchServe and TF-Serving kinds wait with it).  Backends:

- ``triton_grpc`` — the port's KServe-v2 gRPC client
  (client_tpu_torch/grpc) over the network (any Triton-compatible server);
  CUDA regions register by their 64-byte IPC handle.
- ``inprocess`` — the port's in-process InferenceEngine, no sockets (the
  analog of the reference's TRITON_C_API dlopen backend).  Its CUDA
  regions are this process's own, so the engine's registry resolves them
  through the process-local broker (utils/cuda_shared_memory), never over
  IPC.
- ``mock`` — deterministic fake with injectable latency/error schedules
  (reference mock_client_backend.h:405-583), used by the unit tests.
"""

import threading
import time

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
    INPROCESS = "inprocess"
    MOCK = "mock"


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
    def create(kind, url=None, engine=None, verbose=False, **kwargs):
        if kind == BackendKind.TRITON_GRPC:
            return _GrpcBackend(url, verbose)
        if kind == BackendKind.INPROCESS:
            if engine is None:
                raise InferenceServerException(
                    "inprocess backend requires an InferenceEngine"
                )
            return _InprocessBackend(engine)
        if kind == BackendKind.MOCK:
            return MockClientBackend(**kwargs)
        raise InferenceServerException(f"unknown backend kind '{kind}'")


class _GrpcBackend(ClientBackend):
    kind = BackendKind.TRITON_GRPC

    def __init__(self, url, verbose=False):
        import client_tpu_torch.grpc as grpcclient

        self.endpoint = url
        self._client = grpcclient.InferenceServerClient(url, verbose=verbose)

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
