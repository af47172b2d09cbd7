"""In-process KServe-v2 server: model runtime + HTTP frontend.

Counterpart of client_tpu/serve/__init__.py (HTTP only; the gRPC
frontend comes with a later slice of the port).  Typical use:

    from client_tpu_torch.serve import Server
    from client_tpu_torch.serve.models.language import language_models

    with Server(models=language_models(), with_default_models=False) as s:
        ...  # KServe-v2 HTTP on s.http_address

or standalone: ``python -m client_tpu_torch.serve --models language``.
"""

from client_tpu_torch.serve.model_runtime import (  # noqa: F401
    InferenceEngine,
    Model,
    TensorSpec,
)


class Server:
    """Convenience wrapper starting the HTTP frontend over an engine.

    It serves *models* and, with ``with_default_models`` (the default, as
    in the reference), the builtin set (serve/builtins.py) beside them,
    whose vision pipeline runs on *device* (``cuda`` unless the caller
    passes ``device="cpu"``).  ``max_inflight``, ``response_cache``,
    ``coalescing``, ``qos``, ``fleet`` (a started serve/fleet.py
    ``FleetTier``), ``slo`` and ``flight`` go to the
    :class:`InferenceEngine`."""

    def __init__(self, models=None, http_port=0, host="127.0.0.1",
                 verbose=False, device=None, with_default_models=True,
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
        self._http_port = http_port
        self._host = host
        self._verbose = verbose

    @property
    def http_address(self):
        return self._http.address if self._http else None

    def start(self):
        from client_tpu_torch.serve.http_server import HttpFrontend

        self._http = HttpFrontend(
            self.engine, self._host, self._http_port, self._verbose
        ).start()
        return self

    def stop(self):
        """Stop the frontend, then close the engine: every model's closer
        runs, so no scheduler thread outlives its server."""
        if self._http:
            self._http.stop()
        self.engine.close()

    def drain(self, timeout_s=None):
        """Graceful shutdown: flip ``/v2/health/ready`` to not-ready,
        reject new inference with retryable 503s, finish in-flight work,
        then stop.  Returns True when every in-flight request finished
        within *timeout_s*."""
        drained = self.engine.drain(timeout_s)
        self.stop()
        return drained

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
