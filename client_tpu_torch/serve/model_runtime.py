"""In-process KServe-v2 model runtime: repository + request execution.

Counterpart of client_tpu/serve/model_runtime.py, cut to what serving the
language models needs: ``TensorSpec``, ``Model``, and an
``InferenceEngine`` with the repository verbs, request execution for
unary and decoupled models, and per-model success/failure counts.  The
front door (response cache, coalescing, tenant QoS), dynamic batching,
sequences, ensembles, shared memory, tracing and profiling wait for later
slices of the port.
"""

import threading

import numpy as np

from client_tpu_torch._infer_types import _np_from_json_data
from client_tpu_torch.serve.metrics import Registry
from client_tpu_torch.utils import (
    InferenceServerException,
    from_wire_bytes,
    to_wire_bytes,
)

SERVER_NAME = "client_tpu_torch.serve"
SERVER_VERSION = "0.1.0"
SERVER_EXTENSIONS = ["binary_tensor_data", "parameters", "statistics"]


class TensorSpec:
    """Metadata for one model input/output tensor."""

    def __init__(self, name, datatype, dims):
        self.name = name
        self.datatype = datatype
        self.dims = list(dims)

    def metadata(self):
        return {"name": self.name, "datatype": self.datatype, "shape": self.dims}


class Model:
    """A servable model: tensor specs + a python callable.

    ``fn(inputs, parameters, context)`` takes a dict of numpy arrays and
    returns a dict of numpy arrays, or, for ``decoupled=True`` models, an
    iterator of such dicts (the LLM token-streaming shape).  ``context`` is
    always None here (sequences come with a later slice).  Every model has
    the one version "1" and no batching dimension.

    ``closer`` (optional) releases model-owned resources (the batched LM
    engine's scheduler thread and KV pool) when the engine closes;
    ``binder`` (optional) is called by ``InferenceEngine.add_model`` with
    the engine, so model-owned subsystems pick up its metrics registry.
    """

    versions = ["1"]

    def __init__(self, name, inputs, outputs, fn, platform="python",
                 decoupled=False):
        self.name = name
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.fn = fn
        self.platform = platform
        self.decoupled = decoupled
        self.closer = None
        self.binder = None

    def metadata(self):
        return {
            "name": self.name,
            "versions": self.versions,
            "platform": self.platform,
            "inputs": [t.metadata() for t in self.inputs],
            "outputs": [t.metadata() for t in self.outputs],
        }

    def config(self):
        cfg = {
            "name": self.name,
            "platform": self.platform,
            "backend": "python",
            "max_batch_size": 0,
            "input": [
                {"name": t.name, "data_type": f"TYPE_{_cfg_type(t.datatype)}",
                 "dims": t.dims}
                for t in self.inputs
            ],
            "output": [
                {"name": t.name, "data_type": f"TYPE_{_cfg_type(t.datatype)}",
                 "dims": t.dims}
                for t in self.outputs
            ],
        }
        if self.decoupled:
            cfg["model_transaction_policy"] = {"decoupled": True}
        return cfg


def _cfg_type(datatype):
    return "STRING" if datatype == "BYTES" else datatype


class ModelStats:
    """Per-model request counts."""

    def __init__(self):
        self.lock = threading.Lock()
        self.success_count = 0
        self.fail_count = 0

    def record(self, ok):
        with self.lock:
            if ok:
                self.success_count += 1
            else:
                self.fail_count += 1

    def to_json(self, name, version):
        with self.lock:
            return {
                "name": name,
                "version": version,
                "inference_stats": {
                    "success": {"count": self.success_count},
                    "fail": {"count": self.fail_count},
                },
            }


class InferenceEngine:
    """Model repository + request execution shared by the frontends."""

    def __init__(self, models=None):
        self._lock = threading.Lock()
        self._models = {}
        self._stats = {}
        # series written by model-owned subsystems (the LM engine's lane,
        # KV and prefix gauges), bound through Model.binder
        self.metrics = Registry()
        for model in models or []:
            self.add_model(model)

    # repository -----------------------------------------------------------

    def add_model(self, model):
        with self._lock:
            self._models[model.name] = model
            self._stats.setdefault(model.name, ModelStats())
        # outside the repository lock: binders may take their own locks
        if model.binder is not None:
            model.binder(self)

    def close(self):
        """Release model-owned resources (e.g. the batched LM engine's
        scheduler thread and KV pool) with the engine, not the process."""
        with self._lock:
            models = list(self._models.values())
        for model in models:
            if model.closer is not None:
                model.closer()

    def get_model(self, name, version=""):
        with self._lock:
            model = self._models.get(name)
            if model is None:
                raise InferenceServerException(
                    f"Request for unknown model: '{name}' is not found",
                    status="400",
                )
            if version and version not in model.versions:
                raise InferenceServerException(
                    f"Request for unknown model version: '{name}' version "
                    f"{version} is not found",
                    status="400",
                )
            return model

    def model_ready(self, name, version=""):
        with self._lock:
            model = self._models.get(name)
            return bool(model and (not version or version in model.versions))

    def ready(self):
        """Server-level readiness (no drain in this slice: always True)."""
        return True

    def statistics(self, name="", version=""):
        with self._lock:
            stats = [
                self._stats[n].to_json(n, version or model.versions[-1])
                for n, model in sorted(self._models.items())
                if not name or n == name
            ]
        if name and not stats:
            raise InferenceServerException(
                f"Request for unknown model: '{name}' is not found",
                status="400",
            )
        return stats

    # execution ------------------------------------------------------------

    def execute(self, model_name, model_version, request, binary_section):
        """Run one inference request.

        *request* is the JSON-form header dict; *binary_section* the raw
        bytes after the header.  Returns ``(response_dict, binary_blobs)``,
        or for a decoupled model a generator of such tuples, one per
        response the model produces.
        """
        model = self.get_model(model_name, model_version)
        stats = self._stats[model_name]
        try:
            inputs = self._gather_inputs(model, request, binary_section)
            params = request.get("parameters", {}) or {}
            if model.decoupled:
                return self._decoupled_stream(
                    model, model_version, request, inputs, params, stats
                )
            result = model.fn(inputs, params, None)
            rendered = self._render_response(
                model, model_version, request, result
            )
        except InferenceServerException:
            stats.record(False)
            raise
        except Exception as e:
            stats.record(False)
            raise InferenceServerException(
                f"{model_name}: execution failed: {e}", status="500",
                debug_details=e,
            ) from e
        stats.record(True)
        return rendered

    def _decoupled_stream(self, model, model_version, request, inputs,
                          params, stats):
        """Generator of (response_dict, blobs) for a decoupled model.

        Exactly one count per request: success at exhaustion, failure on a
        model error or an abandoned stream (the consumer closes or drops
        the generator mid-flight)."""
        # Triton's decoupled completion protocol: every response carries
        # triton_final_response=false; with triton_enable_empty_final_response
        # the stream ends with one empty response marked final
        want_final = bool(params.get("triton_enable_empty_final_response"))
        recorded = False
        try:
            for partial in model.fn(inputs, params, None):
                rendered = self._render_response(
                    model, model_version, request, partial
                )
                rendered[0].setdefault("parameters", {})[
                    "triton_final_response"
                ] = False
                yield rendered
            if want_final:
                final = {
                    "model_name": model.name,
                    "model_version": model_version or model.versions[-1],
                    "outputs": [],
                    "parameters": {"triton_final_response": True},
                }
                if request.get("id"):
                    final["id"] = request["id"]
                yield final, []
            stats.record(True)
            recorded = True
        except InferenceServerException:
            stats.record(False)
            recorded = True
            raise
        except Exception as e:
            stats.record(False)
            recorded = True
            raise InferenceServerException(
                f"{model.name}: execution failed: {e}",
                status="500", debug_details=e,
            ) from e
        finally:
            if not recorded:  # abandoned mid-stream (GeneratorExit/GC)
                stats.record(False)

    def _gather_inputs(self, model, request, binary_section):
        """Resolve request inputs to numpy arrays: binary-extension tensors
        (back to back in *binary_section*, decoded as zero-copy views) or
        JSON ``data``."""
        specs = {t.name: t for t in model.inputs}
        arrays = {}
        offset = 0
        for entry in request.get("inputs", []):
            name = entry["name"]
            spec = specs.get(name)
            if spec is None:
                raise InferenceServerException(
                    f"unexpected inference input '{name}' for model "
                    f"'{model.name}'",
                    status="400",
                )
            shape = entry["shape"]
            datatype = entry["datatype"]
            if spec.datatype != datatype:
                raise InferenceServerException(
                    f"inference input '{name}' data-type is '{datatype}', but "
                    f"model expects '{spec.datatype}'",
                    status="400",
                )
            params = entry.get("parameters", {}) or {}
            if "shared_memory_region" in params:
                raise InferenceServerException(
                    f"input '{name}': shared-memory inputs are not served "
                    "yet by this server",
                    status="400",
                )
            if "binary_data_size" in params:
                size = params["binary_data_size"]
                raw = memoryview(binary_section)[offset : offset + size]
                offset += size
                if len(raw) != size:
                    raise InferenceServerException(
                        f"input '{name}' binary section underrun", status="400"
                    )
                arrays[name] = from_wire_bytes(raw, datatype, shape)
            elif "data" in entry:
                arrays[name] = _np_from_json_data(entry["data"], datatype, shape)
            else:
                raise InferenceServerException(
                    f"input '{name}' has no data", status="400"
                )
        missing = [t.name for t in model.inputs if t.name not in arrays]
        if missing:
            raise InferenceServerException(
                f"expected {len(model.inputs)} inputs but got "
                f"{len(arrays)} inputs for model '{model.name}' "
                f"(missing {missing})",
                status="400",
            )
        return arrays

    def _render_response(self, model, model_version, request, result_arrays):
        requested = request.get("outputs")
        req_params = request.get("parameters", {}) or {}
        specs = {t.name: t for t in model.outputs}
        if requested:
            selection = [
                (o["name"], o.get("parameters", {}) or {}) for o in requested
            ]
        else:
            default_binary = bool(req_params.get("binary_data_output"))
            selection = [
                (t.name, {"binary_data": default_binary}) for t in model.outputs
            ]

        outputs_json = []
        blobs = []
        for name, params in selection:
            if name not in specs or name not in result_arrays:
                raise InferenceServerException(
                    f"unexpected inference output '{name}' for model "
                    f"'{model.name}'",
                    status="400",
                )
            arr = np.asarray(result_arrays[name])
            datatype = specs[name].datatype
            entry = {"name": name, "datatype": datatype, "shape": list(arr.shape)}
            if "shared_memory_region" in params:
                raise InferenceServerException(
                    f"output '{name}': shared-memory outputs are not served "
                    "yet by this server",
                    status="400",
                )
            if params.get("binary_data", False):
                raw = to_wire_bytes(arr, datatype)
                entry["parameters"] = {"binary_data_size": len(raw)}
                blobs.append(raw)
            elif datatype == "BYTES":
                entry["data"] = [
                    v.decode("utf-8", errors="replace")
                    if isinstance(v, bytes)
                    else str(v)
                    for v in arr.flatten()
                ]
            else:
                entry["data"] = [v.item() for v in arr.flatten()]
            outputs_json.append(entry)

        response = {
            "model_name": model.name,
            "model_version": model_version or model.versions[-1],
            "outputs": outputs_json,
        }
        if request.get("id"):
            response["id"] = request["id"]
        return response, blobs
