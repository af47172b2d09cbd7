"""In-process KServe-v2 model runtime: repository + request execution.

Counterpart of client_tpu/serve/model_runtime.py, cut to what serving the
language and vision models needs: ``TensorSpec``, ``Model``, and an
``InferenceEngine`` with the repository verbs (add, load, unload),
request execution for unary and decoupled models, dynamic batching
(serve/dynamic_batcher.py), ensembles through the DAG scheduler
(serve/pipeline.py), per-model statistics and the shared-memory registry
(system regions by key, CUDA regions by IPC handle).  The front door
(response cache, coalescing, tenant QoS), sequences and tracing wait for
later slices of the port.

Request inputs are numpy arrays decoded from the wire or read from a
system region, or tensors: views of a CUDA region (zero-copy) and the
device tensors between the steps of an ensemble.  An output stays a
tensor until its disposition is known: one bound for a CUDA region is
copied on the device, never through the host.
"""

import mmap
import os
import threading
import time

import numpy as np
import torch

from client_tpu_torch._infer_types import _np_from_json_data
from client_tpu_torch.serve.dynamic_batcher import (
    ModelBatcher,
    batchable_request,
    device_stream,
)
from client_tpu_torch.serve.metrics import Registry
from client_tpu_torch.serve.pipeline import PipelineRunner, build_dag
from client_tpu_torch.serve.prof import PhaseProfiler
from client_tpu_torch.utils import (
    InferenceServerException,
    from_wire_bytes,
    to_wire_bytes,
)
from client_tpu_torch.utils import cuda_shared_memory as cudashm
from client_tpu_torch.utils.shared_memory import shm_path

SERVER_NAME = "client_tpu_torch.serve"
SERVER_VERSION = "0.1.0"
SERVER_EXTENSIONS = ["binary_tensor_data", "parameters", "statistics",
                     "system_shared_memory", "cuda_shared_memory"]


class TensorSpec:
    """Metadata for one model input/output tensor."""

    def __init__(self, name, datatype, dims, labels=None, optional=False):
        self.name = name
        self.datatype = datatype
        self.dims = list(dims)
        self.labels = labels or []
        self.optional = optional

    def metadata(self):
        return {"name": self.name, "datatype": self.datatype, "shape": self.dims}


class Model:
    """A servable model: tensor specs + a python callable.

    ``fn(inputs, parameters, context)`` takes a dict of numpy arrays (or,
    between the steps of an ensemble and inside the dynamic batcher, of
    tensors on ``device``) and returns a dict of arrays or tensors, or,
    for ``decoupled=True`` models, an iterator of such dicts (the LLM
    token-streaming shape).  ``context`` is always None here (sequences
    come with a later slice).  Every model has the one version "1".

    The batching fields are the reference's: ``max_batch_size`` (> 0: the
    first dim is the batch), ``dynamic_batching`` with
    ``max_queue_delay_us``, ``warmup`` (prepare every bucket at add),
    ``batch_device_inputs`` (device-tensor requests batch too),
    ``fused_batching`` (``fn`` is torch-pure: every group runs through one
    bucket program, a CUDA graph on the card), ``max_fused_arity`` (parts
    in a fused device group), ``max_queue_depth`` (shed beyond it, None =
    unbounded) and ``flops_per_item`` (one batch row's forward FLOPs, for
    MFU).  ``ensemble_steps`` makes the model an ensemble executed by the
    DAG scheduler (``fn`` is ignored).  ``device`` is the device a
    torch-backed model runs on.

    ``closer`` (optional) releases model-owned resources (the batched LM
    engine's scheduler thread and KV pool) when the engine closes;
    ``binder`` (optional) is called by ``InferenceEngine.add_model`` with
    the engine, so model-owned subsystems pick up its metrics registry.
    """

    versions = ["1"]

    def __init__(self, name, inputs, outputs, fn, platform="python",
                 backend="python", device=None, max_batch_size=0,
                 decoupled=False, dynamic_batching=False,
                 max_queue_delay_us=3000, warmup=False,
                 batch_device_inputs=False, fused_batching=False,
                 max_fused_arity=8, max_queue_depth=None,
                 ensemble_steps=None, flops_per_item=None):
        self.name = name
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.fn = fn
        self.platform = platform
        self.backend = backend
        self.device = device
        self.max_batch_size = max_batch_size
        self.decoupled = decoupled
        self.dynamic_batching = dynamic_batching
        self.max_queue_delay_us = max_queue_delay_us
        self.warmup = warmup
        self.batch_device_inputs = batch_device_inputs
        self.fused_batching = fused_batching
        self.max_fused_arity = max_fused_arity
        self.max_queue_depth = max_queue_depth
        self.ensemble_steps = list(ensemble_steps or [])
        self.flops_per_item = flops_per_item
        self.closer = None
        self.binder = None
        # validated ensemble DAG (serve/pipeline.py), built at add/load time
        self._dag = None

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
            "backend": self.backend,
            "max_batch_size": self.max_batch_size,
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
        if self.dynamic_batching:
            cfg["dynamic_batching"] = {
                "max_queue_delay_microseconds": self.max_queue_delay_us
            }
        if self.decoupled:
            cfg["model_transaction_policy"] = {"decoupled": True}
        if self.flops_per_item:
            # Triton-style config parameters map (string_value entries)
            cfg["parameters"] = {
                "flops_per_item": {
                    "string_value": str(int(self.flops_per_item))}
            }
        if self.ensemble_steps:
            cfg["ensemble_scheduling"] = {
                "step": [
                    {
                        "model_name": s["model_name"],
                        "model_version": s.get("model_version", -1),
                        "input_map": dict(s.get("input_map", {})),
                        "output_map": dict(s.get("output_map", {})),
                    }
                    for s in self.ensemble_steps
                ]
            }
        return cfg


def _cfg_type(datatype):
    return "STRING" if datatype == "BYTES" else datatype


class ModelStats:
    """Per-model cumulative statistics in the statistics extension's shape:
    request outcomes apart from executions (a batched execution serves
    several requests, so ``inference_count`` counts batch rows and
    ``execution_count`` forward passes)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.inference_count = 0
        self.execution_count = 0
        self.last_inference_ms = 0
        self.success_count = 0
        self.success_ns = 0
        self.fail_count = 0
        self.fail_ns = 0
        self.compute_infer_ns = 0
        self.compute_input_ns = 0
        self.compute_output_ns = 0
        self.queue_ns = 0

    def record(self, ok, total_ns=0, infer_ns=0, input_ns=0, output_ns=0,
               batch=1):
        """One request executed on its own (or its failure)."""
        with self.lock:
            if ok:
                self.inference_count += batch
                self.execution_count += 1
                self.success_count += 1
                self.success_ns += total_ns
                self.compute_infer_ns += infer_ns
                self.compute_input_ns += input_ns
                self.compute_output_ns += output_ns
                self.last_inference_ms = int(time.time() * 1000)
            else:
                self.fail_count += 1
                self.fail_ns += total_ns

    def record_batched(self, rows, infer_ns, input_ns, output_ns, queue_ns):
        """One dynamic-batched execution.  Per-request success outcomes are
        recorded by record_request_success once rendering finishes;
        failures go through record(False, ...) in execute()."""
        with self.lock:
            self.inference_count += rows
            self.execution_count += 1
            self.compute_infer_ns += infer_ns
            self.compute_input_ns += input_ns
            self.compute_output_ns += output_ns
            self.queue_ns += queue_ns
            self.last_inference_ms = int(time.time() * 1000)

    def record_request_success(self, total_ns):
        """One successful request served through the batched path."""
        with self.lock:
            self.success_count += 1
            self.success_ns += total_ns

    def to_json(self, name, version):
        with self.lock:
            count = self.success_count
            return {
                "name": name,
                "version": version,
                "last_inference": self.last_inference_ms,
                "inference_count": self.inference_count,
                "execution_count": self.execution_count,
                "inference_stats": {
                    "success": {"count": count, "ns": self.success_ns},
                    "fail": {"count": self.fail_count, "ns": self.fail_ns},
                    "queue": {"count": count, "ns": self.queue_ns},
                    "compute_input": {"count": count,
                                      "ns": self.compute_input_ns},
                    "compute_infer": {"count": count,
                                      "ns": self.compute_infer_ns},
                    "compute_output": {"count": count,
                                       "ns": self.compute_output_ns},
                },
            }


class SharedMemoryRegistry:
    """Server-side registry of system and CUDA shared-memory regions
    (counterpart of the JAX runtime's, with CUDA regions in place of TPU
    ones).

    System regions attach by POSIX shm key (``/dev/shm``).  A CUDA region
    carries a 64-byte ``cudaIpcMemHandle_t``: a handle this process made
    resolves to the live region through the broker of
    utils/cuda_shared_memory (``cudaIpcOpenMemHandle`` refuses those);
    another process's handle is opened over CUDA IPC, and a refused open
    answers 400 with cudart's message.  An input is a typed view of its
    region (zero-copy); an output is copied into its region on the device
    and waited for before the response goes out.  Unregistering drops
    the registry's hold on a mapping: a view a request still holds keeps
    it open until the request is done.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._system = {}
        self._cuda = {}

    # system ---------------------------------------------------------------

    def register_system(self, name, key, offset, byte_size):
        with self._lock:
            if name in self._system:
                old = self._system[name]
                if (old["key"], old["offset"], old["byte_size"]) != (
                    key,
                    offset,
                    byte_size,
                ):
                    raise InferenceServerException(
                        f"shared memory region '{name}' already registered "
                        "with different attributes",
                        status="400",
                    )
                return
            mm = _attach_posix_shm(key, offset + byte_size)
            self._system[name] = {
                "key": key,
                "offset": offset,
                "byte_size": byte_size,
                "mmap": mm,
            }

    def unregister_system(self, name=None):
        with self._lock:
            names = [name] if name else list(self._system)
            for n in names:
                region = self._system.pop(n, None)
                if region is not None:
                    region["mmap"].close()

    def system_status(self, name=None):
        with self._lock:
            regions = {}
            for n, r in self._system.items():
                if name and n != name:
                    continue
                regions[n] = {
                    "name": n,
                    "key": r["key"],
                    "offset": r["offset"],
                    "byte_size": r["byte_size"],
                }
            if name and not regions:
                raise InferenceServerException(
                    f"shared memory region '{name}' is not registered",
                    status="400",
                )
            return regions

    # cuda -----------------------------------------------------------------

    def register_cuda(self, name, raw_handle, device_id, byte_size):
        raw_handle = bytes(raw_handle)
        attrs = (raw_handle, device_id, byte_size)
        with self._lock:
            old = self._cuda.get(name)
        if old is None:
            region = cudashm.resolve_inprocess(raw_handle)
            opened = region is None
            if opened:
                # outside the lock: the first open may build the extension
                region = cudashm.open_region(name, raw_handle, byte_size,
                                             device_id)
            elif byte_size > region.byte_size:
                raise InferenceServerException(
                    f"CUDA shared memory region '{name}' holds "
                    f"{region.byte_size} bytes, not {byte_size}",
                    status="400")
            with self._lock:
                old = self._cuda.setdefault(name, {
                    "attrs": attrs, "region": region, "opened": opened})
            if old["region"] is region:
                return
            if opened:  # registered meanwhile under this name
                region.close()
        if old["attrs"] != attrs:
            raise InferenceServerException(
                f"CUDA shared memory region '{name}' already registered "
                "with different attributes",
                status="400",
            )

    def unregister_cuda(self, name=None):
        with self._lock:
            names = [name] if name else list(self._cuda)
            removed = [self._cuda.pop(n, None) for n in names]
        for entry in removed:
            # a region this server opened is its own to close (views a
            # request holds keep the mapping); a region of this process's
            # client belongs to that client
            if entry is not None and entry["opened"]:
                entry["region"].close()

    def cuda_status(self, name=None):
        with self._lock:
            regions = {}
            for n, entry in self._cuda.items():
                if name and n != name:
                    continue
                _, device_id, byte_size = entry["attrs"]
                regions[n] = {"name": n, "device_id": device_id,
                              "byte_size": byte_size}
            if name and not regions:
                raise InferenceServerException(
                    f"CUDA shared memory region '{name}' is not registered",
                    status="400",
                )
            return regions

    # data access ----------------------------------------------------------

    def _cuda_region(self, region_name, offset, nbytes):
        """The CUDA region registered as *region_name* if there is one,
        after checking that the span lies inside its registered size."""
        with self._lock:
            entry = self._cuda.get(region_name)
        if entry is None:
            return None
        size = entry["attrs"][2]
        if offset < 0 or offset + nbytes > size:
            raise InferenceServerException(
                f"{nbytes} bytes at offset {offset} overrun CUDA shared "
                f"memory region '{region_name}' ({size} bytes)",
                status="400",
            )
        return entry["region"]

    def read_tensor(self, region_name, offset, byte_size, datatype, shape):
        """An input tensor from a region: a typed view on the region's
        device for a CUDA region (BYTES copied to the host and decoded),
        a numpy array decoded from the bytes of a system region."""
        region = self._cuda_region(region_name, offset, byte_size)
        if region is None:
            raw = self.read(region_name, offset, byte_size)
            return from_wire_bytes(raw, datatype, shape)
        if datatype == "BYTES":
            return from_wire_bytes(region.read(offset, byte_size), datatype,
                                   shape)
        tensor = region.tensor
        if tensor is None:
            raise InferenceServerException(
                f"CUDA shared memory region '{region_name}' is closed",
                status="400")
        return cudashm.typed_view(tensor, offset, byte_size, datatype, shape)

    def write_tensor(self, region_name, offset, arr, datatype, max_byte_size):
        """Write an output tensor into a region; returns bytes written.
        Into a CUDA region a tensor is copied on the device (cast to the
        output's datatype there), and the copy is complete on return."""
        with self._lock:
            cuda = region_name in self._cuda
        if cuda and datatype != "BYTES" and isinstance(arr, torch.Tensor):
            want = cudashm.TORCH_DTYPES[datatype]
            src = arr if arr.dtype == want else arr.to(want)
            nbytes = src.numel() * src.element_size()
        else:
            src = to_wire_bytes(_host_array(arr), datatype)
            nbytes = len(src)
        if nbytes > max_byte_size:
            raise InferenceServerException(
                f"output needs {nbytes} bytes but region '{region_name}' "
                f"mapping holds {max_byte_size}",
                status="400",
            )
        region = self._cuda_region(region_name, offset, nbytes)
        if region is None:
            self.write(region_name, offset, src)
            return nbytes
        if (isinstance(src, torch.Tensor)
                and src.data_ptr() == region.span(offset, nbytes).data_ptr()):
            # written in place by the batcher (a sink), and complete
            return nbytes
        region.write(offset, src)
        # the client reads the region once the response arrives, and its
        # stream is not ordered after this one: wait for this copy
        region.sync()
        return nbytes

    def output_sink(self, region_name, offset, byte_size, datatype):
        """The bytes of a CUDA region an output of *datatype* is bound for,
        as a flat tensor of that dtype that the batcher can write the
        output's rows into at dispatch; None where it cannot (not a CUDA
        region, BYTES, an offset the dtype does not divide)."""
        dtype = cudashm.TORCH_DTYPES.get(datatype)
        region = self._cuda_region(region_name, offset, byte_size)
        if region is None or dtype is None:
            return None
        itemsize = torch.empty(0, dtype=dtype).element_size()
        span = region.span(offset, byte_size - byte_size % itemsize)
        if span.storage_offset() % itemsize:
            return None
        return span.view(dtype)

    def _find(self, region_name):
        """A system region or a 400."""
        region = self._system.get(region_name)
        if region is None:
            raise InferenceServerException(
                f"shared memory region '{region_name}' is not registered",
                status="400",
            )
        return region, region["offset"]

    def read(self, region_name, offset, byte_size):
        with self._lock:
            region, base = self._find(region_name)
            if offset < 0 or offset + byte_size > region["byte_size"]:
                raise InferenceServerException(
                    f"read of {byte_size} bytes at offset {offset} overruns "
                    f"region '{region_name}'",
                    status="400",
                )
            mm = region["mmap"]
            return bytes(mm[base + offset : base + offset + byte_size])

    def write(self, region_name, offset, data):
        with self._lock:
            region, base = self._find(region_name)
            if offset < 0 or offset + len(data) > region["byte_size"]:
                raise InferenceServerException(
                    f"write of {len(data)} bytes at offset {offset} overruns "
                    f"region '{region_name}'",
                    status="400",
                )
            mm = region["mmap"]
            mm[base + offset : base + offset + len(data)] = data

    def close(self):
        self.unregister_system()
        self.unregister_cuda()


def _host_array(arr):
    """An output as a numpy array (a bf16 tensor widened to float32, the
    dtype BF16 decodes to)."""
    if not isinstance(arr, torch.Tensor):
        return np.asarray(arr)
    arr = arr.detach().cpu()
    return (arr.float() if arr.dtype == torch.bfloat16 else arr).numpy()


def _attach_posix_shm(key, length):
    try:
        fd = os.open(shm_path(key), os.O_RDWR)
    except OSError as e:
        raise InferenceServerException(
            f"unable to open shared memory region key '{key}': {e}",
            status="400",
        ) from e
    try:
        return mmap.mmap(fd, length)
    except ValueError as e:
        raise InferenceServerException(
            f"unable to map {length} bytes of region key '{key}': {e}",
            status="400"
        ) from e
    finally:
        os.close(fd)


class InferenceEngine:
    """Model repository + request execution shared by the frontends."""

    def __init__(self, models=None):
        self._lock = threading.Lock()
        self._models = {}
        self._ready = {}
        self._stats = {}
        self._batchers = {}
        self._pipeline = None
        self.shm = SharedMemoryRegistry()
        # series written by model-owned subsystems (the LM engine's lane,
        # KV and prefix gauges, bound through Model.binder), the batcher's
        # sheds and the ensemble scheduler's counters
        self.metrics = Registry()
        # one "batch" tick per batched execution, with the per-model
        # FLOPs behind the MFU series
        self.prof = PhaseProfiler(name="serve", registry=self.metrics)
        for model in models or []:
            self.add_model(model)

    # repository -----------------------------------------------------------

    def add_model(self, model):
        # Validation and installation are ONE critical section: a DAG
        # validated against a snapshot that mutates before the install
        # could leave a READY ensemble describing a replaced model.
        with self._lock:
            known = dict(self._models)
            known[model.name] = model
            if model.ensemble_steps:
                # ensembles validate at ADD time -> 400 here, never a
                # surprise at infer time; composing models come first
                model._dag = build_dag(model, known.get)
            # every ready ensemble composing over this name revalidates
            # against the replacement: a compatible swap refreshes its
            # DAG, an incompatible one marks it NOT READY
            for n, dep in self._models.items():
                if (
                    n == model.name or not dep.ensemble_steps
                    or not self._ready.get(n)
                    or all(s.get("model_name") != model.name
                           for s in dep.ensemble_steps)
                ):
                    continue
                try:
                    dep._dag = build_dag(dep, known.get)
                except InferenceServerException:
                    self._ready[n] = False
            self._models[model.name] = model
            self._ready[model.name] = True
            self._stats.setdefault(model.name, ModelStats())
            # a replaced model must not keep serving through the old batcher
            stale = self._batchers.pop(model.name, None)
        if stale is not None:
            stale.close()
        # outside the repository lock: binders may take their own locks
        if model.binder is not None:
            model.binder(self)
        if model.dynamic_batching and model.warmup:
            self._batcher_for(model).warmup(model.inputs)

    def load_model(self, name):
        """Mark *name* ready again; an ensemble revalidates against the
        current repository first (a broken one fails the load with a 400
        and stays unready)."""
        from client_tpu_torch.serve.pipeline import build_dag

        with self._lock:
            if name not in self._models:
                raise InferenceServerException(
                    f"failed to load '{name}', no such model", status="400"
                )
            model = self._models[name]
            if model.ensemble_steps:
                model._dag = build_dag(model, dict(self._models).get)
            self._ready[name] = True

    def unload_model(self, name):
        with self._lock:
            if name not in self._models:
                raise InferenceServerException(
                    f"failed to unload '{name}', no such model", status="400"
                )
            self._ready[name] = False
            batcher = self._batchers.pop(name, None)
        if batcher is not None:
            batcher.close()

    def close(self):
        """Close the batchers, then release model-owned resources (e.g.
        the batched LM engine's scheduler thread and KV pool) with the
        engine, not the process."""
        with self._lock:
            batchers = list(self._batchers.values())
            self._batchers.clear()
            models = list(self._models.values())
        for batcher in batchers:
            batcher.close()
        for model in models:
            if model.closer is not None:
                model.closer()
        self.shm.close()

    def get_model(self, name, version=""):
        with self._lock:
            model = self._models.get(name)
            if model is None or not self._ready.get(name):
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
            return bool(
                model
                and self._ready.get(name)
                and (not version or version in model.versions)
            )

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

    def _batcher_for(self, model):
        with self._lock:
            batcher = self._batchers.get(model.name)
            if batcher is None:
                batcher = ModelBatcher(
                    model,
                    self._stats[model.name],
                    max_queue_delay_s=model.max_queue_delay_us / 1e6,
                    max_queue_depth=model.max_queue_depth,
                    registry=self.metrics,
                    prof=self.prof,
                )
                self._batchers[model.name] = batcher
            return batcher

    def _pipeline_runner(self):
        """The engine's ensemble DAG scheduler (one per engine, stateless
        across requests: see serve/pipeline.PipelineRunner)."""
        runner = self._pipeline
        if runner is None:
            runner = PipelineRunner(self)
            self._pipeline = runner
        return runner

    # execution ------------------------------------------------------------

    def execute(self, model_name, model_version, request, binary_section):
        """Run one inference request.

        *request* is the JSON-form header dict; *binary_section* the raw
        bytes after the header.  Returns ``(response_dict, binary_blobs)``,
        or for a decoupled model a generator of such tuples, one per
        response the model produces.  A batchable request waits in its
        model's dynamic batcher; an ensemble runs through the DAG
        scheduler; everything else calls the model directly.
        """
        t0 = time.monotonic_ns()
        model = self.get_model(model_name, model_version)
        stats = self._stats[model_name]
        try:
            inputs = self._gather_inputs(model, request, binary_section)
            params = request.get("parameters", {}) or {}
            t_in1 = time.monotonic_ns()
            if model.ensemble_steps:
                # work_ns, the summed per-step durations, is recorded as
                # the ensemble's compute_infer, so composing statistics
                # reconcile with the ensemble's
                result, work_ns = self._pipeline_runner().run(
                    model, inputs, params
                )
                t_inf1 = time.monotonic_ns()
                rendered = self._render_response(
                    model, model_version, request, result
                )
                t1 = time.monotonic_ns()
                stats.record(True, t1 - t0, work_ns, t_in1 - t0,
                             t1 - t_inf1, batch=_batch_of(model, request))
                return rendered
            if batchable_request(model, inputs, params, None, request):
                # the batcher records the execution; the request's success
                # is recorded here, and a failure (batched execution or
                # rendering) falls through to the except clauses below.
                # A device request's outputs bound for CUDA regions are
                # written there by the batcher, which returns once they
                # are: no device call on this thread, which would hold the
                # interpreter lock while a graph launch holds the driver
                result = self._batcher_for(model).submit(
                    inputs, sinks=self._output_sinks(model, request, inputs))
                rendered = self._render_response(
                    model, model_version, request, result
                )
                stats.record_request_success(time.monotonic_ns() - t0)
                return rendered
            if model.decoupled:
                return self._decoupled_stream(
                    model, model_version, request, inputs, params, stats
                )
            with device_stream(model.device):
                result = model.fn(inputs, params, None)
                t_inf1 = time.monotonic_ns()
                rendered = self._render_response(
                    model, model_version, request, result
                )
            t1 = time.monotonic_ns()
        except InferenceServerException:
            stats.record(False, time.monotonic_ns() - t0)
            raise
        except Exception as e:
            stats.record(False, time.monotonic_ns() - t0)
            raise InferenceServerException(
                f"{model_name}: execution failed: {e}", status="500",
                debug_details=e,
            ) from e
        stats.record(True, t1 - t0, t_inf1 - t_in1, t_in1 - t0, t1 - t_inf1,
                     batch=_batch_of(model, request))
        return rendered

    def _output_sinks(self, model, request, inputs):
        """``{output: flat tensor}`` of a device request's outputs bound
        for CUDA regions (``SharedMemoryRegistry.output_sink``)."""
        if not all(isinstance(a, torch.Tensor) for a in inputs.values()):
            return None
        specs = {t.name: t for t in model.outputs}
        sinks = {}
        for out in request.get("outputs") or []:
            params = out.get("parameters") or {}
            spec = specs.get(out["name"])
            if "shared_memory_region" not in params or spec is None:
                continue
            sink = self.shm.output_sink(
                params["shared_memory_region"],
                params.get("shared_memory_offset", 0),
                params["shared_memory_byte_size"], spec.datatype)
            if sink is not None:
                sinks[out["name"]] = sink
        return sinks

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
        """Resolve request inputs: tensors in shared-memory regions (views
        of a CUDA region, numpy arrays from a system region),
        binary-extension tensors (back to back in *binary_section*,
        decoded as zero-copy views) or JSON ``data``."""
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
                arrays[name] = self.shm.read_tensor(
                    params["shared_memory_region"],
                    params.get("shared_memory_offset", 0),
                    params["shared_memory_byte_size"],
                    datatype,
                    shape,
                )
            elif "binary_data_size" in params:
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
            # a tensor stays where it is until its disposition is known:
            # the CUDA-shm path copies it on the device, with no D2H
            arr = result_arrays[name]
            if not isinstance(arr, torch.Tensor):
                arr = np.asarray(arr)
            datatype = specs[name].datatype
            entry = {"name": name, "datatype": datatype, "shape": list(arr.shape)}
            if "shared_memory_region" in params:
                written = self.shm.write_tensor(
                    params["shared_memory_region"],
                    params.get("shared_memory_offset", 0),
                    arr,
                    datatype,
                    params["shared_memory_byte_size"],
                )
                entry["parameters"] = {
                    "shared_memory_region": params["shared_memory_region"],
                    "shared_memory_byte_size": written,
                }
                outputs_json.append(entry)
                continue
            arr = _host_array(arr)
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


def _batch_of(model, request):
    if model.max_batch_size <= 0:
        return 1
    inputs = request.get("inputs", [])
    if inputs and inputs[0].get("shape"):
        return int(inputs[0]["shape"][0])
    return 1
