"""KServe-v2 HTTP/REST frontend for the in-process inference engine.

Counterpart of client_tpu/serve/http_server.py on the stdlib
``ThreadingHTTPServer``: health, server and model metadata, model config
and readiness, infer (binary tensor extension + compression), and the
shared-memory verbs: system and CUDA regions (``tpusharedmemory``
register answers 400, as the JAX server answers for CUDA).  Other
endpoints (repository control, statistics, trace/log settings) answer 404
until a later slice of the port.
"""

import base64
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import unquote

from client_tpu_torch import _codec
from client_tpu_torch.serve import model_runtime
from client_tpu_torch.utils import InferenceServerException

_MODEL_URI = re.compile(
    r"^/v2/models/(?P<model>[^/]+)(?:/versions/(?P<version>[^/]+))?(?P<rest>/.*)?$"
)
_SHM_URI = re.compile(
    r"^/v2/(?P<kind>systemsharedmemory|cudasharedmemory|tpusharedmemory)"
    r"(?:/region/(?P<region>[^/]+))?/(?P<verb>status|register|unregister)$"
)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # responses go out as header-write + body-write; with Nagle on, the body
    # write stalls ~40ms waiting for the client's delayed ACK of the headers
    disable_nagle_algorithm = True
    engine = None  # set by subclassing in HttpFrontend
    verbose = False

    def log_message(self, fmt, *args):  # quiet by default
        if self.verbose:
            super().log_message(fmt, *args)

    # -- plumbing ------------------------------------------------------------

    def _body(self):
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length) if length else b""
        return _codec.decompress(body, self.headers.get("Content-Encoding"))

    def _send(self, status, body=b"", headers=None):
        self.send_response(status)
        headers = headers or {}
        for k, v in headers.items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        if not any(k.lower() == "content-type" for k in headers):
            self.send_header("Content-Type", "application/json")
        self.end_headers()
        if body:
            self.wfile.write(body)

    def _send_json(self, obj, status=200):
        self._send(status, json.dumps(obj).encode("utf-8"))

    def _send_error_json(self, exc):
        status = 400
        if isinstance(exc, InferenceServerException) and exc.status():
            try:
                status = int(exc.status())
            except ValueError:
                pass
        msg = (
            exc.message()
            if isinstance(exc, InferenceServerException)
            else str(exc)
        )
        self._send(status, json.dumps({"error": msg}).encode("utf-8"))

    # -- request routing -----------------------------------------------------

    def do_GET(self):
        try:
            self._route_get()
        except InferenceServerException as e:
            self._send_error_json(e)
        except Exception as e:  # pragma: no cover - defensive
            self._send_error_json(InferenceServerException(str(e), status="500"))

    def do_POST(self):
        try:
            # drain the body up front: an error answered without reading it
            # would desync the next request on this keep-alive connection
            self._post_body = self._body()
            self._route_post()
        except InferenceServerException as e:
            self._send_error_json(e)
        except json.JSONDecodeError as e:
            self._send_error_json(
                InferenceServerException(f"malformed request JSON: {e}", status="400")
            )
        except Exception as e:  # pragma: no cover - defensive
            self._send_error_json(InferenceServerException(str(e), status="500"))

    def _route_get(self):
        path = self.path.split("?", 1)[0]
        eng = self.engine
        if path == "/v2/health/live":
            return self._send(200)
        if path == "/v2/health/ready":
            if eng.ready():
                return self._send(200)
            return self._send(
                503, json.dumps({"error": "server is not ready"}).encode("utf-8")
            )
        if path in ("/v2", "/v2/"):
            return self._send_json(
                {
                    "name": model_runtime.SERVER_NAME,
                    "version": model_runtime.SERVER_VERSION,
                    "extensions": model_runtime.SERVER_EXTENSIONS,
                }
            )
        shm = _SHM_URI.match(path)
        if shm and shm.group("verb") == "status":
            return self._shm_status(shm)
        m = _MODEL_URI.match(path)
        if m:
            model = unquote(m.group("model"))
            version = unquote(m.group("version")) if m.group("version") else ""
            rest = m.group("rest") or ""
            if rest == "/ready":
                if eng.model_ready(model, version):
                    return self._send(200)
                return self._send(
                    400, json.dumps({"error": "model not ready"}).encode()
                )
            if rest == "/config":
                return self._send_json(eng.get_model(model, version).config())
            if rest == "":
                return self._send_json(eng.get_model(model, version).metadata())
        raise InferenceServerException(f"unknown endpoint {path}", status="404")

    def _route_post(self):
        path = self.path.split("?", 1)[0]
        shm = _SHM_URI.match(path)
        if shm and shm.group("verb") != "status":
            return self._shm_action(shm)
        m = _MODEL_URI.match(path)
        if m and (m.group("rest") or "") == "/infer":
            return self._infer(
                unquote(m.group("model")),
                unquote(m.group("version")) if m.group("version") else "",
            )
        raise InferenceServerException(f"unknown endpoint {path}", status="404")

    # -- handlers ------------------------------------------------------------

    def _shm_status(self, match):
        kind = match.group("kind")
        region = unquote(match.group("region") or "")
        shm = self.engine.shm
        if kind == "systemsharedmemory":
            regions = shm.system_status(region or None)
        elif kind == "cudasharedmemory":
            regions = shm.cuda_status(region or None)
        else:
            regions = {}
        return self._send_json(list(regions.values()))

    def _shm_action(self, match):
        kind = match.group("kind")
        region = unquote(match.group("region") or "")
        verb = match.group("verb")
        shm = self.engine.shm
        if kind == "tpusharedmemory":
            if verb == "register":
                raise InferenceServerException(
                    "TPU shared memory is not supported by this server "
                    "(use cudasharedmemory)",
                    status="400",
                )
            return self._send_json({})  # unregister: a no-op, for symmetry
        body = self._post_body
        payload = json.loads(body.decode("utf-8")) if body else {}
        if kind == "systemsharedmemory":
            if verb == "register":
                shm.register_system(region, payload["key"],
                                    payload.get("offset", 0),
                                    payload["byte_size"])
            else:
                shm.unregister_system(region or None)
        elif verb == "register":
            raw = base64.b64decode(payload["raw_handle"]["b64"])
            shm.register_cuda(region, raw, payload.get("device_id", 0),
                              payload["byte_size"])
        else:
            shm.unregister_cuda(region or None)
        return self._send_json({})

    def _infer(self, model, version):
        header_length = self.headers.get("Inference-Header-Content-Length")
        request, binary = _codec.parse_infer_request_body(
            self._post_body,
            int(header_length) if header_length is not None else None,
        )
        result = self.engine.execute(model, version, request, binary)
        if not isinstance(result, tuple):  # decoupled (generator)
            responses = list(result)
            if len(responses) != 1:
                raise InferenceServerException(
                    f"model '{model}' is decoupled; HTTP requires exactly "
                    f"one response but got {len(responses)} — use gRPC "
                    "streaming",
                    status="400",
                )
            result = responses[0]
        response_json, blobs = result
        body, json_size = _codec.build_infer_response_body(response_json, blobs)
        headers = {}
        if json_size is not None:
            headers["Inference-Header-Content-Length"] = str(json_size)
        accept = (self.headers.get("Accept-Encoding") or "").lower()
        for algo in ("gzip", "deflate"):
            if algo in accept:
                body = _codec.compress(body, algo)
                headers["Content-Encoding"] = algo
                break
        self._send(200, body, headers)


class HttpFrontend:
    """Threaded HTTP server bound to an InferenceEngine."""

    def __init__(self, engine, host="127.0.0.1", port=0, verbose=False):
        handler = type(
            "BoundHandler", (_Handler,), {"engine": engine, "verbose": verbose}
        )
        # socketserver's default listen backlog of 5 overflows on a burst
        # of connections; spilled clients wait out a SYN retransmit (~1s)
        server_cls = type(
            "FrontDoorHTTPServer", (ThreadingHTTPServer,),
            {"request_queue_size": 128},
        )
        self._httpd = server_cls((host, port), handler)
        self._httpd.daemon_threads = True
        self._thread = None

    @property
    def address(self):
        host, port = self._httpd.server_address[:2]
        return f"{host}:{port}"

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="client_tpu_torch-http-server", daemon=True,
        )
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
