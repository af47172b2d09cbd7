"""In-process KServe-v2 server: model runtime + HTTP/gRPC frontends.

Counterpart of client_tpu/serve/__init__.py.  Typical use:

    from client_tpu_torch.serve import Server
    from client_tpu_torch.serve.models.language import language_models

    with Server(models=language_models(), with_default_models=False,
                grpc_port=0) as s:
        ...  # KServe-v2 HTTP on s.http_address, gRPC on s.grpc_address

or standalone: ``python -m client_tpu_torch.serve --models language
--grpc-port 8001``.  The gRPC frontend needs grpcio and protobuf; without
them the package and the HTTP frontend still import and serve.
"""

from client_tpu_torch.serve.model_runtime import (  # noqa: F401
    InferenceEngine,
    Model,
    TensorSpec,
)


class Server:
    """Convenience wrapper starting the HTTP (and, given *grpc_port*, the
    gRPC) frontend over an engine.

    It serves *models* and, with ``with_default_models`` (the default, as
    in the reference), the builtin set (serve/builtins.py) beside them,
    whose vision pipeline runs on *device* (``cuda`` unless the caller
    passes ``device="cpu"``).  ``max_inflight``, ``response_cache``,
    ``coalescing``, ``qos``, ``fleet`` (a started serve/fleet.py
    ``FleetTier``), ``slo`` and ``flight`` go to the
    :class:`InferenceEngine`."""

    def __init__(self, models=None, http_port=0, grpc_port=None,
                 host="127.0.0.1", verbose=False, device=None, with_default_models=True,
                 max_inflight=None, response_cache=None, coalescing=False,
                 qos=None, fleet=None, slo=None, flight=None):
        all_models = list(models or [])
        if with_default_models:
            from client_tpu_torch.serve.builtins import default_models

            all_models.extend(default_models(device=device))
        self.engine = InferenceEngine(
            all_models,
            max_inflight=max_inflight,
            response_cache=response_cache,
            coalescing=coalescing,
            qos=qos,
            fleet=fleet,
            slo=slo,
            flight=flight,
        )
        self._http = None
        self._grpc = None
        self._http_port = http_port
        self._grpc_port = grpc_port
        self._host = host
        self._verbose = verbose

    @property
    def http_address(self):
        return self._http.address if self._http else None

    @property
    def grpc_address(self):
        return self._grpc.address if self._grpc else None

    def start(self):
        """Start the frontends.  The gRPC frontend's module is imported
        before either frontend binds, so a missing grpcio fails here
        (``ModuleNotFoundError``) with no socket bound and no thread
        started: the caller's ``with`` never entered, and nothing is left
        for ``stop`` to end."""
        from client_tpu_torch.serve.http_server import HttpFrontend

        GrpcFrontend = None
        if self._grpc_port is not None:
            from client_tpu_torch.serve.grpc_server import GrpcFrontend
        self._http = HttpFrontend(
            self.engine, self._host, self._http_port, self._verbose
        ).start()
        if GrpcFrontend is not None:
            self._grpc = GrpcFrontend(
                self.engine, self._host, self._grpc_port, self._verbose
            ).start()
        return self

    def stop(self):
        """Stop the frontends, then close the engine: every model's closer
        runs, so no scheduler thread outlives its server."""
        if self._http:
            self._http.stop()
        if self._grpc:
            self._grpc.stop()
        self.engine.close()

    def drain(self, timeout_s=None):
        """Graceful shutdown: flip ``/v2/health/ready`` (and gRPC
        ServerReady) to not-ready, reject new inference with retryable
        503/UNAVAILABLE, finish in-flight work, then stop both frontends.  Returns True when every in-flight request finished
        within *timeout_s*."""
        drained = self.engine.drain(timeout_s)
        self.stop()
        return drained

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
