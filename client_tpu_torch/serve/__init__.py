"""In-process KServe-v2 server: model runtime + HTTP frontend.

Counterpart of client_tpu/serve/__init__.py (HTTP only; the gRPC
frontend comes with a later slice of the port).  Typical use:

    from client_tpu_torch.serve import Server
    from client_tpu_torch.serve.models.language import language_models

    with Server(models=language_models()) as server:
        ...  # KServe-v2 HTTP on server.http_address

or standalone: ``python -m client_tpu_torch.serve --models language``.
"""

from client_tpu_torch.serve.model_runtime import (  # noqa: F401
    InferenceEngine,
    Model,
    TensorSpec,
)


class Server:
    """Convenience wrapper starting the HTTP frontend over an engine.

    With ``models=None`` it serves the language set on *device* (``cuda``
    unless the caller passes ``device="cpu"``)."""

    def __init__(self, models=None, http_port=0, host="127.0.0.1",
                 verbose=False, device=None):
        if models is None:
            from client_tpu_torch.serve.models import model_sets

            models = model_sets("language", device=device)
        self.engine = InferenceEngine(list(models))
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

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
