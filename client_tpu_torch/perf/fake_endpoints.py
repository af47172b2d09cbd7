"""In-process fake TorchServe / TensorFlow-Serving endpoints.

Counterpart of client_tpu/perf/fake_endpoints.py; its gRPC fake speaks
the port's byte copy of the TF-Serving protos
(client_tpu_torch/_proto/tfserve_pb2.py).  The perf harness's
pluggable-backend layer (client_backend.py) promises that the load engine
works over non-KServe protocol families, the way the reference ships
TorchServe and TF-Serving client backends (reference
src/c++/perf_analyzer/client_backend/torchserve/torchserve_http_client.cc,
tensorflow_serving/tfserve_grpc_client.cc).  These stdlib-only fakes give
the harness (and its tests) hermetic servers speaking each service's actual
REST dialect:

- TorchServe inference API: ``GET /ping``, ``POST /predictions/{model}``
  (opaque request body -> JSON prediction).
- TF-Serving REST API: ``GET /v1/models/{m}``, ``GET /v1/models/{m}/metadata``,
  ``POST /v1/models/{m}:predict`` ({"instances": ...} -> {"predictions": ...}).

Both run a deterministic model (sum over the payload) so client-side
validation has ground truth.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


class _Quiet(BaseHTTPRequestHandler):
    def log_message(self, fmt, *args):  # no stderr chatter under load
        pass

    def _reply(self, code, payload, content_type="application/json"):
        body = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _body(self):
        n = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(n) if n else b""


class _TorchServeHandler(_Quiet):
    """TorchServe inference-API surface (the subset the reference backend
    drives: ping + predictions; plus the management models listing)."""

    def do_GET(self):
        if self.path == "/ping":
            self._reply(200, {"status": "Healthy"})
        elif self.path.startswith("/models"):
            name = self.path.rsplit("/", 1)[-1]
            if name in self.server.models or name == "models":
                self._reply(
                    200,
                    [{"modelName": m, "modelVersion": "1.0"}
                     for m in self.server.models],
                )
            else:
                self._reply(404, {"code": 404, "message": f"Model not found: {name}"})
        else:
            self._reply(404, {"code": 404, "message": "unknown path"})

    def do_POST(self):
        if not self.path.startswith("/predictions/"):
            return self._reply(404, {"code": 404, "message": "unknown path"})
        name = self.path[len("/predictions/"):].split("/")[0]
        if name not in self.server.models:
            return self._reply(
                404, {"code": 404, "message": f"Model not found: {name}"}
            )
        raw = self._body()
        with self.server.stats_lock:
            self.server.request_count += 1
        # deterministic "model": sum of payload interpreted as f32 when
        # aligned, else byte sum — clients can validate either way
        if len(raw) % 4 == 0 and raw:
            value = float(np.frombuffer(raw, np.float32).sum())
        else:
            value = float(np.frombuffer(raw, np.uint8).sum())
        self._reply(200, [round(value, 4)])


class _TfServingHandler(_Quiet):
    """TF-Serving REST predict surface."""

    def do_GET(self):
        parts = self.path.strip("/").split("/")
        if len(parts) >= 2 and parts[0] == "v1" and parts[1] == "models":
            name = parts[2].split(":")[0] if len(parts) > 2 else ""
            if name not in self.server.models:
                return self._reply(
                    404, {"error": f"Model {name} not found"}
                )
            if len(parts) > 3 and parts[3] == "metadata":
                return self._reply(200, {
                    "model_spec": {"name": name, "version": "1"},
                    "metadata": {"signature_def": {"signature_def": {
                        "serving_default": {
                            "inputs": {"input": {"dtype": "DT_FLOAT"}},
                            "outputs": {"output": {"dtype": "DT_FLOAT"}},
                        }}}},
                })
            return self._reply(200, {"model_version_status": [
                {"version": "1", "state": "AVAILABLE",
                 "status": {"error_code": "OK", "error_message": ""}}]})
        self._reply(404, {"error": "unknown path"})

    def do_POST(self):
        parts = self.path.strip("/").split("/")
        if (len(parts) != 3 or parts[0] != "v1" or parts[1] != "models"
                or not parts[2].endswith(":predict")):
            return self._reply(404, {"error": "unknown path"})
        name = parts[2][: -len(":predict")]
        if name not in self.server.models:
            return self._reply(404, {"error": f"Model {name} not found"})
        try:
            doc = json.loads(self._body())
            instances = doc["instances"]
        except Exception:
            return self._reply(400, {"error": "malformed predict request"})
        with self.server.stats_lock:
            self.server.request_count += 1
        predictions = [
            [float(np.asarray(inst, dtype=np.float64).sum())]
            for inst in instances
        ]
        self._reply(200, {"predictions": predictions})


class _FakeService:
    def __init__(self, handler, models):
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        self.httpd.models = set(models)
        self.httpd.stats_lock = threading.Lock()
        self.httpd.request_count = 0
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )

    def start(self):
        self._thread.start()
        return self

    @property
    def url(self):
        host, port = self.httpd.server_address[:2]
        return f"{host}:{port}"

    @property
    def request_count(self):
        with self.httpd.stats_lock:
            return self.httpd.request_count

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def fake_torchserve(models=("resnet",)):
    return _FakeService(_TorchServeHandler, models)


def fake_tfserving(models=("half_plus_two",)):
    return _FakeService(_TfServingHandler, models)


class _FakeTfServingGrpc:
    """Hermetic gRPC PredictionService (the real protocol surface the
    TFSERVE backend speaks): Predict sums each row of the first input into
    an ``output`` DT_FLOAT tensor; GetModelStatus reports AVAILABLE."""

    def __init__(self, models):
        self.models = set(models)
        self.request_count = 0
        self.stats_lock = threading.Lock()
        self._server = None
        self._port = 0

    def start(self):
        from concurrent import futures

        import grpc

        from client_tpu_torch._proto import tfserve_pb2 as tfs

        outer = self

        def Predict(request, context):
            if request.model_spec.name not in outer.models:
                context.abort(
                    grpc.StatusCode.NOT_FOUND,
                    f"Servable not found: {request.model_spec.name}",
                )
            with outer.stats_lock:
                outer.request_count += 1
            response = tfs.PredictResponse()
            response.model_spec.name = request.model_spec.name
            out = response.outputs["output"]
            out.dtype = tfs.DT_FLOAT
            for name, tensor in sorted(request.inputs.items()):
                shape = [d.size for d in tensor.tensor_shape.dim]
                if tensor.tensor_content:
                    arr = np.frombuffer(
                        tensor.tensor_content, dtype=np.float32
                    )
                elif tensor.float_val:
                    arr = np.asarray(list(tensor.float_val), np.float32)
                else:
                    arr = np.zeros(0, np.float32)
                rows = int(shape[0]) if shape else 1
                sums = arr.reshape(rows, -1).sum(axis=1) if arr.size else (
                    np.zeros(rows, np.float32)
                )
                out.tensor_content = np.asarray(
                    sums, np.float32
                ).tobytes()
                out.tensor_shape.dim.add().size = rows
                out.tensor_shape.dim.add().size = 1
                break  # first input only (half_plus_two-style single-input)
            return response

        def GetModelStatus(request, context):
            response = tfs.GetModelStatusResponse()
            if request.model_spec.name in outer.models:
                s = response.model_version_status.add()
                s.version = 1
                s.state = tfs.ModelVersionStatus.AVAILABLE
            return response

        def GetModelMetadata(request, context):
            response = tfs.GetModelMetadataResponse()
            response.model_spec.name = request.model_spec.name
            response.model_spec.version.value = 1
            return response

        handlers = {
            "Predict": grpc.unary_unary_rpc_method_handler(
                Predict,
                request_deserializer=tfs.PredictRequest.FromString,
                response_serializer=tfs.PredictResponse.SerializeToString,
            ),
            "GetModelMetadata": grpc.unary_unary_rpc_method_handler(
                GetModelMetadata,
                request_deserializer=(
                    tfs.GetModelMetadataRequest.FromString
                ),
                response_serializer=(
                    tfs.GetModelMetadataResponse.SerializeToString
                ),
            ),
        }
        model_handlers = {
            "GetModelStatus": grpc.unary_unary_rpc_method_handler(
                GetModelStatus,
                request_deserializer=tfs.GetModelStatusRequest.FromString,
                response_serializer=(
                    tfs.GetModelStatusResponse.SerializeToString
                ),
            ),
        }
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        self._server.add_generic_rpc_handlers((
            grpc.method_handlers_generic_handler(
                "tensorflow.serving.PredictionService", handlers
            ),
            grpc.method_handlers_generic_handler(
                "tensorflow.serving.ModelService", model_handlers
            ),
        ))
        self._port = self._server.add_insecure_port("127.0.0.1:0")
        self._server.start()
        return self

    @property
    def url(self):
        return f"127.0.0.1:{self._port}"

    def stop(self):
        if self._server is not None:
            self._server.stop(grace=1)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def fake_tfserving_grpc(models=("half_plus_two",)):
    return _FakeTfServingGrpc(models)
