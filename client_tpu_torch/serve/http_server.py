"""KServe-v2 HTTP/REST frontend for the in-process inference engine.

Counterpart of client_tpu/serve/http_server.py on the stdlib
``ThreadingHTTPServer``: health (readiness answers 503 once the engine
drains), server and model metadata, model config and readiness, infer
(binary tensor extension + compression, ``traceparent`` sampling, the
``x-tenant-id`` tenant, one wire-profiler tick a request), repository
control (index, load with config and file overrides, unload),
statistics, trace and log settings, ``/metrics``, the debug endpoints
(``/v2/debug/flight``, ``/v2/debug/prof``, ``/v2/debug/slo``), and the
shared-memory verbs: system and CUDA regions (``tpusharedmemory``
register answers 400, as the JAX server answers for CUDA).  A 429 or 503
carries an integer ``Retry-After``.  Its sibling over gRPC is
serve/grpc_server.py; the fleet tier answers on a peer port of its own
(serve/fleet.py).
"""

import base64
import json
import math
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote

from client_tpu_torch import _codec
from client_tpu_torch.serve import model_runtime
from client_tpu_torch.serve.metrics import render_metrics
from client_tpu_torch.utils import TENANT_HEADER, InferenceServerException

_MODEL_URI = re.compile(
    r"^/v2/models/(?P<model>[^/]+)(?:/versions/(?P<version>[^/]+))?(?P<rest>/.*)?$"
)
_SHM_URI = re.compile(
    r"^/v2/(?P<kind>systemsharedmemory|cudasharedmemory|tpusharedmemory)"
    r"(?:/region/(?P<region>[^/]+))?/(?P<verb>status|register|unregister)$"
)
_REPO_URI = re.compile(
    r"^/v2/repository/(?:index|models/(?P<model>[^/]+)/(?P<verb>load|unload))$"
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
        headers = None
        if status in (429, 503):
            # overload, tenant quota and drain shedding are retryable: tell
            # clients when to come back.  A QoS rejection carries a computed
            # hint (when the token bucket refills), others 1 s.  RFC 9110
            # Retry-After is integer delta-seconds: a fractional value would
            # be dropped by strict parsers
            hint = getattr(exc, "retry_after_s", None)
            headers = {
                "Retry-After": str(max(1, math.ceil(float(hint))))
                if hint else "1"
            }
        self._send(status, json.dumps({"error": msg}).encode("utf-8"), headers)

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
            # drain() flips readiness false so load balancers stop routing
            # here while in-flight work finishes
            if eng.ready():
                return self._send(200)
            return self._send(
                503, json.dumps({"error": "server is draining"}).encode("utf-8")
            )
        if path == "/metrics":
            body = render_metrics(eng).encode("utf-8")
            return self._send(
                200, body, {"Content-Type": "text/plain; version=0.0.4"}
            )
        if path in ("/v2", "/v2/"):
            return self._send_json(
                {
                    "name": model_runtime.SERVER_NAME,
                    "version": model_runtime.SERVER_VERSION,
                    "extensions": model_runtime.SERVER_EXTENSIONS,
                }
            )
        if path == "/v2/logging":
            return self._send_json(eng.log_settings)
        if path == "/v2/trace/setting":
            return self._send_json(eng.trace_settings)
        query = parse_qs((self.path.split("?", 1) + [""])[1])
        if path == "/v2/debug/flight":
            # flight-recorder ring as JSON-lines (the on-demand dump);
            # ?dump=1 instead writes a file server-side and reports it
            if query.get("dump", [""])[-1] == "1":
                written = eng.flight.dump("debug_endpoint")
                return self._send_json({
                    "dumped": written,
                    "events": len(eng.flight.snapshot()),
                })
            body = eng.flight.render("debug_endpoint")
            return self._send(
                200, body.encode("utf-8"),
                {"Content-Type": "application/jsonl"},
            )
        if path == "/v2/debug/prof":
            # the profilers' windowed rollup: per-phase attribution, tick
            # counts, per-model MFU / compute share for this engine and
            # every adopted child.  ?window=SECONDS bounds it (0 = all)
            try:
                window = float(query.get("window", [""])[-1])
            except ValueError:
                window = None
            return self._send_json(eng.prof.report(window_s=window))
        if path == "/v2/debug/slo":
            slo = eng.slo
            return self._send_json(slo.check_now() if slo is not None else {})
        if path == "/v2/models/stats":
            return self._send_json({"model_stats": eng.statistics()})
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
            if rest == "/stats":
                return self._send_json(
                    {"model_stats": eng.statistics(model, version)}
                )
            if rest == "/trace/setting":
                return self._send_json(eng.trace_settings)
            if rest == "":
                return self._send_json(eng.get_model(model, version).metadata())
        raise InferenceServerException(f"unknown endpoint {path}", status="404")

    def _route_post(self):
        path = self.path.split("?", 1)[0]
        eng = self.engine
        if path == "/v2/repository/index":
            body = self._post_body
            ready = False
            if body:
                ready = bool(json.loads(body.decode("utf-8")).get("ready"))
            return self._send_json(eng.repository_index(ready))
        repo = _REPO_URI.match(path)
        if repo and repo.group("model"):
            model_name = unquote(repo.group("model"))
            if repo.group("verb") == "load":
                payload = (
                    json.loads(self._post_body.decode("utf-8"))
                    if self._post_body
                    else {}
                )
                params = payload.get("parameters", {}) or {}
                config = params.get("config")
                files = {
                    k: base64.b64decode(v)
                    for k, v in params.items()
                    if k.startswith("file:")
                }
                eng.load_model(
                    model_name,
                    config_override=json.loads(config) if config else None,
                    files=files or None,
                )
            else:
                eng.unload_model(model_name)
            return self._send_json({})
        shm = _SHM_URI.match(path)
        if shm and shm.group("verb") != "status":
            return self._shm_action(shm)
        if path == "/v2/logging":
            settings = json.loads(self._post_body.decode("utf-8") or "{}")
            eng.log_settings.update(
                {k: v for k, v in settings.items() if v is not None}
            )
            return self._send_json(eng.log_settings)
        m = _MODEL_URI.match(path)
        if path == "/v2/trace/setting" or (
                m and (m.group("rest") or "") == "/trace/setting"):
            settings = json.loads(self._post_body.decode("utf-8") or "{}")
            return self._send_json(eng.update_trace_settings(settings))
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
        engine = self.engine
        # wire-path profiling: deserialize / execute-wait / serialize /
        # send splits, committed as one "http" tick
        ptick = engine.wire_prof.start_tick("http")
        t_mark = time.perf_counter()
        header_length = self.headers.get("Inference-Header-Content-Length")
        request, binary = _codec.parse_infer_request_body(
            self._post_body,
            int(header_length) if header_length is not None else None,
        )
        ptick.add("deserialize", time.perf_counter() - t_mark)
        # request tracing: joins the client's trace id when the request
        # carries a W3C traceparent header (see serve/tracing.py)
        trace = engine.tracer.sample(
            self.headers.get("traceparent"), model_name=model,
            model_version=version, protocol="http",
        )
        # tenant identity for QoS/fair-queueing (serve/frontdoor.py);
        # header lookup is case-insensitive
        tenant = self.headers.get(TENANT_HEADER) or ""
        if trace is not None:
            trace.event("REQUEST_START")
        try:
            t_mark = time.perf_counter()
            result = engine.execute(
                model, version, request, binary, trace=trace, tenant=tenant
            )
            if not isinstance(result, tuple):  # decoupled (generator)
                # consuming it releases its admission and tenant slots
                responses = list(result)
                if len(responses) != 1:
                    raise InferenceServerException(
                        f"model '{model}' is decoupled; HTTP requires exactly "
                        f"one response but got {len(responses)} — use gRPC "
                        "streaming",
                        status="400",
                    )
                result = responses[0]
            ptick.add("wait", time.perf_counter() - t_mark)
            response_json, blobs = result
            t_mark = time.perf_counter()
            body, json_size = _codec.build_infer_response_body(
                response_json, blobs)
            headers = {}
            if json_size is not None:
                headers["Inference-Header-Content-Length"] = str(json_size)
            accept = (self.headers.get("Accept-Encoding") or "").lower()
            for algo in ("gzip", "deflate"):
                if algo in accept:
                    body = _codec.compress(body, algo)
                    headers["Content-Encoding"] = algo
                    break
            ptick.add("serialize", time.perf_counter() - t_mark)
            t_mark = time.perf_counter()
            self._send(200, body, headers)
            ptick.add("send", time.perf_counter() - t_mark)
            if trace is not None:
                trace.event("RESPONSE_SENT")
        except Exception as e:
            if trace is not None:
                trace.error = str(e)
            raise
        finally:
            engine.wire_prof.finish(ptick)
            if trace is not None:
                engine.tracer.complete(trace)


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
