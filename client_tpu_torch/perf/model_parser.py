"""Model metadata/config normalization for the perf harness.

Parity with the reference ModelParser (reference
src/c++/perf_analyzer/model_parser.h:59-193): one object that fuses the
metadata and config endpoints into the normalized facts the load engine
needs — resolved tensor shapes, max_batch_size, scheduler kind, decoupled
transaction policy, and the (transitive) composing models of an ensemble —
so the CLI and managers never poke at raw JSON again.

The port's copy of client_tpu/perf/model_parser.py.
"""

from client_tpu_torch.utils import InferenceServerException


class SchedulerType:
    NONE = "none"
    DYNAMIC = "dynamic"
    SEQUENCE = "sequence"
    ENSEMBLE = "ensemble"
    ENSEMBLE_SEQUENCE = "ensemble_sequence"


class ModelParser:
    """Normalized view over one model's metadata + config."""

    def __init__(self, model_name, model_version=""):
        self.model_name = model_name
        self.model_version = model_version
        self.inputs = []   # [{"name","datatype","shape"(int list)}]
        self.outputs = []
        self.max_batch_size = 0
        self.scheduler_type = SchedulerType.NONE
        self.is_decoupled = False
        self.composing_models = []  # transitive, ensemble order
        self.response_cache_enabled = False

    @classmethod
    def create(cls, backend, model_name, model_version="", batch_size=1):
        """Fetch + normalize (reference ModelParser::InitTriton)."""
        parser = cls(model_name, model_version)
        meta = backend.model_metadata(model_name, model_version)
        try:
            config = backend.model_config(model_name, model_version) or {}
        except (InferenceServerException, NotImplementedError):
            config = {}
        parser._init_tensors(meta, batch_size)
        parser._init_config(config)
        parser._init_composing(backend, config)
        return parser

    def _init_tensors(self, meta, batch_size):
        def norm(entries):
            out = []
            for m in entries:
                # protobuf-JSON renders int64 dims as strings; a dynamic
                # leading (batch) dim resolves to the requested batch size
                dims = [int(d) for d in m.get("shape", [])]
                if dims and dims[0] == -1:
                    dims[0] = batch_size
                out.append({
                    "name": m["name"],
                    "datatype": m.get("datatype", "FP32"),
                    "shape": dims,
                })
            return out

        self.inputs = norm(meta.get("inputs", []))
        self.outputs = norm(meta.get("outputs", []))

    def _init_config(self, config):
        self.max_batch_size = int(config.get("max_batch_size", 0) or 0)
        policy = config.get("model_transaction_policy", {}) or {}
        self.is_decoupled = bool(policy.get("decoupled", False))
        self.response_cache_enabled = bool(
            (config.get("response_cache") or {}).get("enable", False)
        )
        has_sequence = "sequence_batching" in config
        has_dynamic = "dynamic_batching" in config
        has_ensemble = bool(
            (config.get("ensemble_scheduling") or {}).get("step")
        )
        if has_ensemble:
            self.scheduler_type = (
                SchedulerType.ENSEMBLE_SEQUENCE
                if has_sequence
                else SchedulerType.ENSEMBLE
            )
        elif has_sequence:
            self.scheduler_type = SchedulerType.SEQUENCE
        elif has_dynamic:
            self.scheduler_type = SchedulerType.DYNAMIC
        else:
            self.scheduler_type = SchedulerType.NONE

    def _init_composing(self, backend, config, seen=None):
        seen = seen if seen is not None else {self.model_name}
        steps = (config.get("ensemble_scheduling") or {}).get("step") or []
        for step in steps:
            name = step.get("model_name")
            if not name or name in seen:
                continue
            seen.add(name)
            self.composing_models.append(name)
            try:
                sub_cfg = backend.model_config(name) or {}
            except (InferenceServerException, NotImplementedError):
                continue
            # nested ensembles recurse (reference GetEnsembleSchedulerType)
            self._init_composing(backend, sub_cfg, seen)
            sub_policy = sub_cfg.get("model_transaction_policy", {}) or {}
            if sub_policy.get("decoupled"):
                self.is_decoupled = True

    def requires_sequence_flags(self):
        return self.scheduler_type in (
            SchedulerType.SEQUENCE, SchedulerType.ENSEMBLE_SEQUENCE
        )
