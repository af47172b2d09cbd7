"""In-process KServe-v2 model runtime: repository + request execution.

Counterpart of client_tpu/serve/model_runtime.py: ``TensorSpec``,
``Model``, ``SequenceContext`` and an ``InferenceEngine`` with the
repository verbs (add, load with config and file overrides, unload,
index), request execution for unary, decoupled and stateful models
(sequences: per-sequence state, created on ``sequence_start`` or a miss,
dropped on ``sequence_end``, reaped past ``max_sequence_idle_s``), dynamic
batching (serve/dynamic_batcher.py; a fused model's request that is not
batched runs through its batcher's bucket program, as the reference's
direct path calls its batcher's jitted executable), ensembles through the DAG scheduler
(serve/pipeline.py), the classification extension, per-model statistics
with their histograms, the shared-memory registry (system regions by key,
CUDA regions by IPC handle), and the operational layer: the multi-tenant
front door (response cache, coalescing, tenant QoS: serve/frontdoor.py),
global admission (``max_inflight``) and graceful drain, request tracing
and trace settings (serve/tracing.py), the flight recorder
(serve/flight.py), the SLO watchdog (serve/slo.py), the duty-cycle
tracker and the phase profilers (serve/prof.py), and the fleet tier's
server half (serve/fleet.py): the response cache across replicas,
durable sequences (versioned snapshots replicated before a step acks,
resumed on a survivor, under a write quorum), idempotent step replay,
and drain's export of every live sequence.  Durable sequences and step
replay work with no tier attached, as in the JAX server: the state is
then local, and a declared step is still replayed exactly once.

Every hook reads and writes host state only: no device sync, no tensor
op.  A request that reads from or writes to a shared-memory region
bypasses the response cache and the coalescer.

Request inputs are numpy arrays decoded from the wire or read from a
system region, or tensors: views of a CUDA region (zero-copy) and the
device tensors between the steps of an ensemble.  An output stays a
tensor until its disposition is known: one bound for a CUDA region is
copied on the device, never through the host.
"""

import base64
import contextlib
import mmap
import os
import threading
import time

import numpy as np
import torch

from client_tpu_torch._infer_types import _np_from_json_data
from client_tpu_torch.resilience import is_connection_level
from client_tpu_torch.serve.dynamic_batcher import (
    ModelBatcher,
    batchable_request,
    device_stream,
    direct_program_request,
)
from client_tpu_torch.serve.flight import FlightRecorder
from client_tpu_torch.serve.frontdoor import Coalescer, request_digest
from client_tpu_torch.serve.metrics import (
    BATCH_BUCKETS,
    FLEET_HELP,
    Histogram,
    Registry,
)
from client_tpu_torch.serve.pipeline import PipelineRunner, build_dag
from client_tpu_torch.serve.prof import PhaseProfiler
from client_tpu_torch.serve.slo import SloWatchdog
from client_tpu_torch.serve.tracing import (
    TRACE_SETTING_DEFAULTS,
    Tracer,
    current_trace,
    normalize_trace_settings,
    push_trace,
)
from client_tpu_torch.utils import (
    InferenceServerException,
    from_wire_bytes,
    tensor_from_raw,
    tensor_raw_bytes,
    to_wire_bytes,
)
from client_tpu_torch.utils import cuda_shared_memory as cudashm
from client_tpu_torch.utils.shared_memory import shm_path

SERVER_NAME = "client_tpu_torch.serve"
SERVER_VERSION = "0.1.0"
SERVER_EXTENSIONS = ["model_repository", "model_configuration",
                     "binary_tensor_data", "parameters", "statistics",
                     "trace", "logging", "system_shared_memory",
                     "cuda_shared_memory", "classification", "sequence"]


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


def _seq_encode(value):
    """JSON-safe encoding of one sequence-state value (numpy arrays and
    torch tensors become tagged base64 dicts under the same ``__nd__`` tag
    and dtype names as the JAX package's, numpy scalars tagged item
    dicts; containers recurse; anything else must already be
    JSON-serializable — the fleet tier ships these snapshots as JSON
    frames)."""
    if isinstance(value, torch.Tensor):
        name, raw = tensor_raw_bytes(value)
        return {
            "__nd__": [
                name, list(value.shape),
                base64.b64encode(raw).decode("ascii"),
            ]
        }
    if isinstance(value, np.ndarray):
        return {
            "__nd__": [
                str(value.dtype),
                list(value.shape),
                base64.b64encode(
                    np.ascontiguousarray(value).tobytes()
                ).decode("ascii"),
            ]
        }
    if isinstance(value, (np.integer, np.floating, np.bool_)):
        return {"__np__": [str(value.dtype), value.item()]}
    if isinstance(value, bytes):
        return {"__b__": base64.b64encode(value).decode("ascii")}
    if isinstance(value, dict):
        return {k: _seq_encode(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_seq_encode(v) for v in value]
    return value


def _seq_decode(value, device=None):
    """Inverse of :func:`_seq_encode` (and the reader of the JAX
    package's snapshots).  An ``__nd__`` array comes back as a tensor on
    *device* (the context's), or as a numpy array when there is none —
    bf16, which numpy alone lacks, as a CPU tensor."""
    if isinstance(value, dict):
        if "__nd__" in value and len(value) == 1:
            dtype, shape, data = value["__nd__"]
            raw = base64.b64decode(data)
            if device is not None or dtype == "bfloat16":
                out = tensor_from_raw(raw, dtype, shape)
                return out.to(device) if device is not None else out
            return np.frombuffer(
                raw, dtype=np.dtype(dtype)
            ).reshape(shape).copy()
        if "__np__" in value and len(value) == 1:
            dtype, item = value["__np__"]
            return np.dtype(dtype).type(item)
        if "__b__" in value and len(value) == 1:
            return base64.b64decode(value["__b__"])
        return {k: _seq_decode(v, device) for k, v in value.items()}
    if isinstance(value, list):
        return [_seq_decode(v, device) for v in value]
    return value


class SequenceContext:
    """Per-sequence state handed to stateful model functions.

    ``step`` is the monotonic applied-step counter: the engine bumps it
    once per successfully executed request of the sequence, and requests
    that declare their own ``sequence_step`` parameter are replayed
    idempotently when the counter already covers them (the retained
    ``last_response`` rendering answers the duplicate without
    re-applying).  ``export()``/``restore()`` are the versioned snapshot
    pair the fleet tier replicates: versions order by ``(epoch, step)``
    and a snapshot that does not beat the stored version is stale and
    rejected, so replication can never move a sequence backwards.
    ``epoch`` stamps the sequence INCARNATION (wall clock at creation;
    restores keep the original): a client that restarts a sequence id
    with ``sequence_start`` mints a new, higher epoch, so the fresh
    incarnation's step-1 snapshot overwrites the dead incarnation's
    higher-step leftovers on every peer instead of being rejected as
    stale.  ``device`` is the serving model's (None for a host model):
    a restored tensor comes back there.
    """

    def __init__(self, sequence_id, durable=False, device=None):
        self.sequence_id = sequence_id
        self.state = {}
        self.step = 0
        # incarnation stamp, NOT a deadline: wall time so a restart on
        # any replica orders after the previous incarnation
        self.epoch = time.time()
        self.durable = bool(durable)
        self.device = device
        # (step, id-less response dict, blobs) of the last applied step —
        # what an idempotent duplicate replay returns
        self.last_response = None
        self.last_used = time.monotonic()
        # traceparent of the last committed step's request trace: rides
        # the replicated snapshot so a survivor resuming this sequence
        # can CONTINUE the dead replica's trace id (serve/tracing.py
        # resume_span) — a failover reads as one trace
        self.trace_ctx = None
        # set when a quorum-mode publish could not reach its peer-ack
        # floor: the step is applied locally but was answered 503, and
        # the idempotent replay path must re-attempt the publish before
        # releasing the retained rendering (a 200 always implies the
        # snapshot reached quorum)
        self.quorum_deficit = False

    def export(self):
        """Serializable snapshot: JSON-safe through the fleet tier's
        frame transport (array and tensor state base64-tagged)."""
        last = None
        if self.last_response is not None:
            step, response, blobs = self.last_response
            last = {
                "step": int(step),
                "response": response,
                "blobs": [
                    base64.b64encode(bytes(b)).decode("ascii")
                    for b in blobs
                ],
            }
        return {
            "sequence_id": self.sequence_id,
            "step": int(self.step),
            "epoch": float(self.epoch),
            "durable": self.durable,
            "state": _seq_encode(self.state),
            "last_response": last,
            "traceparent": self.trace_ctx,
        }

    @classmethod
    def restore(cls, snapshot, device=None):
        """Rebuild a context from an exported snapshot (the survivor-side
        half of sequence migration); tensors land on *device*."""
        ctx = cls(snapshot["sequence_id"],
                  durable=snapshot.get("durable", False), device=device)
        ctx.step = int(snapshot.get("step", 0))
        ctx.epoch = float(snapshot.get("epoch", 0.0))
        ctx.state = _seq_decode(snapshot.get("state") or {}, device)
        ctx.trace_ctx = snapshot.get("traceparent")
        last = snapshot.get("last_response")
        if last is not None:
            ctx.last_response = (
                int(last["step"]),
                last["response"],
                [base64.b64decode(b) for b in last.get("blobs") or ()],
            )
        return ctx


class Model:
    """A servable model: tensor specs + a python callable.

    ``fn(inputs, parameters, context)`` takes a dict of numpy arrays (or,
    between the steps of an ensemble and inside the dynamic batcher, of
    tensors on ``device``) and returns a dict of arrays or tensors, or,
    for ``decoupled=True`` models, an iterator of such dicts (the LLM
    token-streaming shape).  ``context`` is a :class:`SequenceContext`
    when the request carries a ``sequence_id``, else None; ``stateful``
    advertises the ``sequence_batching`` config block.  Every model has
    the one version "1".

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

    ``response_cache`` is the per-model cache-hint block (the
    reference's config block): ``{"cacheable"/"enable": bool, "ttl_s":
    float}``, and for LM models a ``prefix_cache`` sub-block; None =
    cacheable whenever the server runs a ResponseCache, no per-model TTL.

    ``closer`` (optional) releases model-owned resources (the batched LM
    engine's scheduler thread and KV pool) when the engine closes;
    ``binder`` (optional) is called by ``InferenceEngine.add_model`` with
    the engine, so model-owned subsystems pick up its metrics registry,
    tracer, flight recorder, profiler and tenant QoS.
    """

    versions = ["1"]

    def __init__(self, name, inputs, outputs, fn, platform="python",
                 backend="python", device=None, max_batch_size=0,
                 decoupled=False, stateful=False, dynamic_batching=False,
                 max_queue_delay_us=3000, warmup=False,
                 batch_device_inputs=False, fused_batching=False,
                 max_fused_arity=8, max_queue_depth=None,
                 ensemble_steps=None, flops_per_item=None,
                 response_cache=None):
        self.name = name
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.fn = fn
        self.platform = platform
        self.backend = backend
        self.device = device
        self.max_batch_size = max_batch_size
        self.decoupled = decoupled
        self.stateful = stateful
        self.dynamic_batching = dynamic_batching
        self.max_queue_delay_us = max_queue_delay_us
        self.warmup = warmup
        self.batch_device_inputs = batch_device_inputs
        self.fused_batching = fused_batching
        self.max_fused_arity = max_fused_arity
        self.max_queue_depth = max_queue_depth
        self.ensemble_steps = list(ensemble_steps or [])
        self.flops_per_item = flops_per_item
        self.response_cache = dict(response_cache or {}) or None
        self.config_override = None  # set by a repository load with config
        self.file_overrides = {}
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
        if self.config_override is not None:
            merged = dict(self._base_config())
            merged.update(self.config_override)
            merged["name"] = self.name
            return merged
        return self._base_config()

    def _base_config(self):
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
        if self.stateful:
            cfg["sequence_batching"] = {
                "max_sequence_idle_microseconds": 60000000}
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
        if self.response_cache is not None:
            cacheable, ttl_s = self.cache_hints()
            block = {"enable": cacheable}
            if ttl_s is not None:
                block["ttl_s"] = ttl_s
            if self.response_cache.get("prefix_cache") is not None:
                block["prefix_cache"] = dict(
                    self.response_cache["prefix_cache"]
                )
            cfg["response_cache"] = block
        return cfg

    def cache_hints(self):
        """(cacheable, ttl_s) from the model's ``response_cache`` block:
        the per-model front-door policy the engine consults before the
        all-models response cache (absent block = cacheable, no TTL
        override).  ``cacheable`` and ``enable`` are synonyms."""
        rc = self.response_cache or {}
        cacheable = rc.get("cacheable", rc.get("enable", True))
        return bool(cacheable), rc.get("ttl_s")


def _cfg_type(datatype):
    return "STRING" if datatype == "BYTES" else datatype


class ModelStats:
    """Per-model cumulative statistics in the statistics extension's shape:
    request outcomes apart from executions (a batched execution serves
    several requests, so ``inference_count`` counts batch rows and
    ``execution_count`` forward passes), response-cache hits and misses,
    and the distributions behind the /metrics histograms."""

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
        # response-cache accounting (the statistics extension's
        # cache_hit / cache_miss durations)
        self.cache_hit_count = 0
        self.cache_hit_ns = 0
        self.cache_miss_count = 0
        self.cache_miss_ns = 0
        # per-request end-to-end duration (success AND failure),
        # per-request batcher queue time, and execution batch size
        self.request_us = Histogram()
        self.queue_us = Histogram()
        self.batch_rows = Histogram(BATCH_BUCKETS)

    def record(self, ok, total_ns=0, infer_ns=0, input_ns=0, output_ns=0,
               batch=1):
        """One request executed on its own (or its failure)."""
        with self.lock:
            self.request_us.observe(total_ns / 1000)
            if ok:
                self.inference_count += batch
                self.execution_count += 1
                self.success_count += 1
                self.success_ns += total_ns
                self.compute_infer_ns += infer_ns
                self.compute_input_ns += input_ns
                self.compute_output_ns += output_ns
                self.batch_rows.observe(batch)
                self.last_inference_ms = int(time.time() * 1000)
            else:
                self.fail_count += 1
                self.fail_ns += total_ns

    def record_batched(self, rows, infer_ns, input_ns, output_ns, queue_ns,
                       queue_ns_each=None):
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
            self.batch_rows.observe(rows)
            for q_ns in queue_ns_each or ():
                self.queue_us.observe(q_ns / 1000)
            self.last_inference_ms = int(time.time() * 1000)

    def record_request_success(self, total_ns):
        """One successful request served through the batched path (or a
        coalesced follower)."""
        with self.lock:
            self.success_count += 1
            self.success_ns += total_ns
            self.request_us.observe(total_ns / 1000)

    def record_cache_hit(self, total_ns):
        """One request answered from the response cache: a request success
        with zero inferences executed (inference_count untouched)."""
        with self.lock:
            self.success_count += 1
            self.success_ns += total_ns
            self.request_us.observe(total_ns / 1000)
            self.cache_hit_count += 1
            self.cache_hit_ns += total_ns

    def record_cache_miss(self, lookup_ns):
        """One cacheable request that had to execute (the lookup cost is
        what the statistics extension's cache_miss duration measures)."""
        with self.lock:
            self.cache_miss_count += 1
            self.cache_miss_ns += lookup_ns

    def histograms(self):
        """Snapshots of (request_us, queue_us, batch_rows) for /metrics."""
        with self.lock:
            return (
                self.request_us.snapshot(),
                self.queue_us.snapshot(),
                self.batch_rows.snapshot(),
            )

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
                    "cache_hit": {"count": self.cache_hit_count,
                                  "ns": self.cache_hit_ns},
                    "cache_miss": {"count": self.cache_miss_count,
                                   "ns": self.cache_miss_ns},
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


class BusyTracker:
    """Wall-clock union of model-execution intervals (server duty cycle).

    Overlapping executions are unioned, so busy_ns/elapsed is the fraction
    of wall time the server had at least one model execution in flight —
    "is the card being fed?" as a counter.  Host clock only."""

    def __init__(self):
        self._lock = threading.Lock()
        self._active = 0
        self._since = 0
        self._busy_ns = 0

    def begin(self):
        with self._lock:
            if self._active == 0:
                self._since = time.monotonic_ns()
            self._active += 1

    def end(self):
        with self._lock:
            self._active -= 1
            if self._active == 0:
                self._busy_ns += time.monotonic_ns() - self._since

    def busy_ns(self):
        with self._lock:
            busy = self._busy_ns
            if self._active:
                busy += time.monotonic_ns() - self._since
            return busy


class StreamCancel:
    """The cancels of one streaming RPC, fired when the RPC ends.

    A frontend makes one for each stream (the gRPC frontend's
    ``ModelStreamInfer``, from ``context.add_callback``, which runs on
    grpc's own thread the moment the RPC ends, before the handler's next
    send fails) and binds it to its handler thread while the model's
    generator runs there (:meth:`bound`).  A model that holds a device
    handle registers its cancel with :func:`on_stream_cancel` and
    unregisters it when its stream ends; a cancel must be safe from
    another thread (the LM engine's ``cancel`` takes its lock).  The
    generator itself is never touched from that thread: it sees the
    cancel as its handle's end."""

    _bound = threading.local()

    def __init__(self):
        self._lock = threading.Lock()
        self._cancels = []
        self._fired = False

    def add(self, cancel):
        """Register *cancel*; returns the callable that unregisters it.
        After the RPC has ended it runs at once."""
        with self._lock:
            fired = self._fired
            if not fired:
                self._cancels.append(cancel)
        if fired:
            cancel()

        def remove():
            with self._lock:
                if cancel in self._cancels:
                    self._cancels.remove(cancel)
        return remove

    def fire(self):
        """Run every registered cancel once (the RPC ended)."""
        with self._lock:
            self._fired = True
            cancels, self._cancels = self._cancels, []
        for cancel in cancels:
            cancel()

    @contextlib.contextmanager
    def bound(self):
        """This scope is the calling thread's inside the block."""
        prev = getattr(StreamCancel._bound, "scope", None)
        StreamCancel._bound.scope = self
        try:
            yield self
        finally:
            StreamCancel._bound.scope = prev


def on_stream_cancel(cancel):
    """Register *cancel* with the stream scope bound to this thread, if a
    frontend bound one; returns the callable that unregisters it (a no-op
    where no scope is bound: HTTP, in-process callers)."""
    scope = getattr(StreamCancel._bound, "scope", None)
    if scope is None:
        return lambda: None
    return scope.add(cancel)


class _InflightStream:
    """Iterator adapter releasing one in-flight slot exactly once, when
    the wrapped decoupled-response generator is exhausted, fails, is
    closed, or is garbage-collected.  A plain wrapper generator would leak
    the slot when never started (its ``finally`` would not run) — e.g. a
    frontend that rejects the request before iterating."""

    def __init__(self, gen, release):
        self._gen = gen
        self._release = release
        self._done = False

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._gen)
        except BaseException:  # StopIteration included: stream is over
            self._finish()
            raise

    def close(self):
        try:
            self._gen.close()
        finally:
            self._finish()

    def _finish(self):
        if not self._done:
            self._done = True
            self._release()

    def __del__(self):
        try:
            self._finish()
        except Exception:  # pragma: no cover - interpreter teardown
            pass


class InferenceEngine:
    """Model repository + request execution shared by the frontends.

    Overload admission control (``max_inflight``) and graceful drain
    (:meth:`drain`) both shed work with a *retryable* 503, so client
    retry policies and server-side shedding compose: a shed request backs
    off and lands once capacity returns or on another replica.  The
    multi-tenant front door (``response_cache``, ``coalescing``, ``qos``:
    serve/frontdoor.py), the SLO watchdog (``slo``: serve/slo.py; None
    builds the observation-only default, False turns it off) and the
    flight recorder (``flight``: serve/flight.py) are the reference's.
    Sequences idle past ``max_sequence_idle_s`` are dropped.  ``fleet``
    (a started serve/fleet.py ``FleetTier``) attaches the cross-replica
    tier: the response cache, the LM engines' prefix tier (through each
    model's binder), durable sequences and fleet-wide tenant quotas.
    """

    def __init__(self, models=None, max_sequence_idle_s=60.0,
                 max_inflight=None, response_cache=None, coalescing=False,
                 qos=None, fleet=None, slo=None, flight=None):
        self._lock = threading.Lock()
        self._models = {}
        self._ready = {}
        self._stats = {}
        self._batchers = {}
        self._pipeline = None
        # Admission control: cap on concurrently executing requests (None =
        # unbounded).  Work beyond the cap is rejected retryably (503).
        self.max_inflight = max_inflight
        self._inflight = 0
        self._draining = False
        self._flight_cv = threading.Condition()
        self.busy = BusyTracker()
        self.shm = SharedMemoryRegistry()
        self._sequences = {}
        self.max_sequence_idle_s = max_sequence_idle_s
        self.trace_settings = {
            k: (list(v) if isinstance(v, list) else v)
            for k, v in TRACE_SETTING_DEFAULTS.items()
        }
        # request tracing (trace extension): the tracer reads
        # trace_settings live.  The registry holds the series written by
        # model-owned subsystems (the LM engine's lane, KV and prefix
        # gauges, bound through Model.binder), the batcher's sheds, the
        # ensemble scheduler's counters and the front door's
        self.tracer = Tracer(self.trace_settings)
        self.metrics = Registry()
        # Flight recorder: a bounded ring of recent spans + anomaly events
        # dumped on demand (/v2/debug/flight) and automatically on SLO
        # breach or engine wedge
        self.flight = flight if flight is not None else FlightRecorder(
            registry=self.metrics
        )
        self.tracer.on_complete = self.flight.note_span
        # Continuous profiler: one tick per unary, ensemble or batched
        # execution with the per-model FLOPs behind the MFU series; LM
        # schedulers keep their own profiler and are adopted through
        # Model.binder, so /v2/debug/prof and flight dumps cover them
        self.prof = PhaseProfiler(name="serve", registry=self.metrics)
        # the frontend's wire-path ticks (deserialize/wait/serialize/send)
        # keep their own ring: their "wait" CONTAINS the engine's execute
        # ticks, so sharing a ring would double-count
        self.wire_prof = PhaseProfiler(name="wire", registry=self.metrics)
        self.prof.adopt(self.wire_prof)
        if self.flight.prof is None:
            self.flight.prof = self.prof
        if slo is None:
            slo = SloWatchdog()
        self.slo = slo or None
        if self.slo is not None:
            if self.slo.registry is None:
                self.slo.registry = self.metrics
            if self.slo.flight is None:
                self.slo.flight = self.flight
        # Multi-tenant front door, all opt-in; its metrics land in this
        # engine's registry unless already bound elsewhere
        self.response_cache = response_cache
        if response_cache is not None and response_cache.registry is None:
            response_cache.registry = self.metrics
        self.qos = qos
        if qos is not None and qos.registry is None:
            qos.registry = self.metrics
        self._coalescer = (
            Coalescer(registry=self.metrics) if coalescing else None
        )
        # Cross-replica cache tier (serve/fleet.py): a local response-
        # cache miss consults peer replicas before dispatching, the LM
        # engine's prefix cache spans the fleet (wired per-model through
        # Model.binder), and tenant quotas account fleet-wide via gossip.
        self.fleet = None
        if fleet is not None:
            fleet.attach(self)
        self.log_settings = {
            "log_file": "",
            "log_info": True,
            "log_warning": True,
            "log_error": True,
            "log_verbose_level": 0,
            "log_format": "default",
        }
        for model in models or []:
            self.add_model(model)

    # repository -----------------------------------------------------------

    def add_model(self, model, ready=True):
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
            self._ready[model.name] = ready
            self._stats.setdefault(model.name, ModelStats())
            # a replaced model must not keep serving through the old batcher
            stale = self._batchers.pop(model.name, None)
        if stale is not None:
            stale.close()
        self._invalidate_cache()
        # outside the repository lock: binders may take their own locks
        # (registry/QoS) and must never nest under self._lock
        if model.binder is not None:
            model.binder(self)
        if model.dynamic_batching and model.warmup:
            self._batcher_for(model).warmup(model.inputs)

    def _invalidate_cache(self):
        """Repository mutations (add/load/unload) drop the whole response
        cache: the digest keys on request CONTENT, so a model swapped with
        new weights or a config/file override would keep answering from
        its pre-mutation cache forever."""
        if self.response_cache is not None:
            self.response_cache.clear()

    def load_model(self, name, config_override=None, files=None):
        """Mark *name* ready again, with an optional config override (and
        file overrides, which need one); an ensemble revalidates against
        the current repository first (a broken one fails the load with a
        400 and stays unready)."""
        with self._lock:
            if name not in self._models:
                raise InferenceServerException(
                    f"failed to load '{name}', no such model", status="400"
                )
            if files and config_override is None:
                raise InferenceServerException(
                    "load with file override requires a config override too",
                    status="400",
                )
            model = self._models[name]
            if model.ensemble_steps:
                model._dag = build_dag(model, dict(self._models).get)
            model.config_override = config_override
            model.file_overrides = files or {}
            self._ready[name] = True
        self._invalidate_cache()

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
        self._invalidate_cache()

    def repository_index(self, ready_only=False):
        with self._lock:
            index = []
            for name, model in sorted(self._models.items()):
                is_ready = self._ready.get(name, False)
                if ready_only and not is_ready:
                    continue
                index.append({
                    "name": name,
                    "version": model.versions[-1],
                    "state": "READY" if is_ready else "UNAVAILABLE",
                    "reason": "",
                })
            return index

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
        self.tracer.flush()  # buffered trace records reach trace_file
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

    def stats_objects(self):
        """(name, version, ModelStats) per model, for /metrics histograms."""
        with self._lock:
            return [
                (n, model.versions[-1], self._stats[n])
                for n, model in sorted(self._models.items())
            ]

    # observability: trace settings / live gauges ---------------------------

    def update_trace_settings(self, updates):
        """Apply a trace-settings update through the canonical schema
        (serve/tracing.normalize_trace_settings) and return the settings."""
        normalized = normalize_trace_settings(updates)
        with self._lock:
            self.trace_settings.update(normalized)
        if "trace_count" in normalized:
            # the reference trace API restarts the budget on update
            self.tracer.reset_budget()
        return self.trace_settings

    def queue_depths(self):
        """Dynamic-batcher queue depth per model (live gauge)."""
        with self._lock:
            batchers = dict(self._batchers)
        return {name: b.queue_depth() for name, b in batchers.items()}

    def tenant_queue_depths(self):
        """{(model, tenant): queued count} across batcher fair-queue lanes
        (the per-tenant /metrics queue gauge)."""
        with self._lock:
            batchers = dict(self._batchers)
        out = {}
        for name, batcher in batchers.items():
            for tenant, depth in batcher.queue_depths_by_tenant().items():
                out[(name, tenant)] = depth
        return out

    def inflight_count(self):
        with self._flight_cv:
            return self._inflight

    # lifecycle: readiness / drain ------------------------------------------

    def ready(self):
        """Server-level readiness: False once drain() has begun (the load
        balancer's signal to stop routing here)."""
        with self._flight_cv:
            return not self._draining

    def drain(self, timeout_s=None):
        """Graceful drain: stop admitting new work (readiness flips false,
        new requests are rejected with retryable 503), then wait for every
        in-flight request — a decoupled stream until it is consumed or
        closed — to finish.  Returns True when fully drained within
        *timeout_s* (None = wait indefinitely)."""
        deadline = (
            time.monotonic() + timeout_s if timeout_s is not None else None
        )
        self.metrics.inc(
            "ctpu_drain_total",
            help_="Graceful drains initiated",
        )
        drained = True
        with self._flight_cv:
            self._draining = True
            while self._inflight:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        drained = False
                        break
                self._flight_cv.wait(timeout=remaining)
        # Planned retire: replicate every live sequence into the fleet
        # tier (timed-out drains included — stranded sequence state is
        # exactly what the tier exists to carry).  Peer pushes run with
        # no engine lock held.
        fleet = self.fleet
        if fleet is not None:
            for snapshot in self.export_sequences():
                try:
                    fleet.publish_sequence(snapshot)
                except Exception:  # pragma: no cover - defensive
                    pass
        return drained

    def _admit(self):
        """One request enters execution, or is shed with a retryable 503."""
        shed_reason = None
        with self._flight_cv:
            if self._draining:
                shed_reason = "draining"
            elif (
                self.max_inflight is not None
                and self._inflight >= self.max_inflight
            ):
                shed_reason = "overload"
            else:
                self._inflight += 1
        if shed_reason is None:
            return
        self.metrics.inc(
            "ctpu_requests_shed_total", {"reason": shed_reason},
            help_="Requests shed with a retryable 503",
        )
        if shed_reason == "draining":
            raise InferenceServerException(
                "server is draining and not accepting new requests",
                status="503",
            )
        raise InferenceServerException(
            f"server overloaded: {self._inflight} requests in flight "
            f"(limit {self.max_inflight}); retry after backoff",
            status="503",
        )

    def _release(self):
        with self._flight_cv:
            self._inflight -= 1
            self._flight_cv.notify_all()

    def _batcher_for(self, model):
        with self._lock:
            batcher = self._batchers.get(model.name)
            if batcher is None:
                batcher = ModelBatcher(
                    model,
                    self._stats[model.name],
                    max_queue_delay_s=model.max_queue_delay_us / 1e6,
                    busy=self.busy,
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

    def execute(self, model_name, model_version, request, binary_section,
                trace=None, tenant=""):
        """Run one inference request through the front door + admission.

        *request* is the JSON-form header dict; *binary_section* the raw
        bytes after the header (from gRPC, the list of per-tensor
        buffers).  Returns ``(response_dict, binary_blobs)``,
        or for a decoupled model an iterator of such tuples, one per
        response the model produces (it holds its admission and tenant
        slots until it is exhausted or closed).  *trace* is an optional
        RequestTrace the frontend sampled; the engine (and the dynamic
        batcher) record the queue/compute timeline onto it.  *tenant* is
        the caller identity from the ``x-tenant-id`` header (empty = the
        default tenant).

        Order of the front door: response-cache lookup → in-flight
        coalescing → per-tenant QoS admission (429 with Retry-After) →
        global admission (503) → execution.  Cache hits and coalesced
        followers never consume an execution slot OR a tenant quota slot
        (they still count in the per-tenant request series).  The SLO
        watchdog observes every completion; 4xx rejections count as
        latency only (the client's fault, not a server error).
        """
        # on the untraced hot path the thread-local needs no touch at all
        if trace is None:
            return self._execute_measured(
                model_name, model_version, request, binary_section,
                trace, tenant,
            )
        # the queue starts where the engine receives the request, next
        # to the frontend's REQUEST_START, so that little of the span
        # lies outside queue and compute
        trace.event("QUEUE_START")
        trace.tenant = tenant
        with push_trace(trace):
            return self._execute_measured(
                model_name, model_version, request, binary_section,
                trace, tenant,
            )

    def _execute_measured(self, model_name, model_version, request,
                          binary_section, trace, tenant):
        """SLO accounting bracket: every completion (or failure) of one
        request lands in the watchdog's sketch; 5xx/transport count
        against the error-rate objective, 4xx as latency only.  A
        decoupled request is observed when its stream is handed out."""
        t0 = time.monotonic_ns()
        status = ""
        try:
            return self._execute_request(
                model_name, model_version, request, binary_section,
                trace, tenant, t0,
            )
        except InferenceServerException as e:
            status = str(e.status())
            raise
        except BaseException:
            status = "500"
            raise
        finally:
            slo = self.slo
            if slo is not None:
                slo.observe(
                    model_name, tenant,
                    (time.monotonic_ns() - t0) / 1e9,
                    error=bool(status) and not status.startswith("4"),
                )

    def _execute_request(self, model_name, model_version, request,
                         binary_section, trace, tenant, t0):
        front = self._front_key(model_name, model_version, request,
                                binary_section)
        if front is not None:
            key, cacheable, ttl_s = front
            return self._front_door(
                key, model_name, model_version, request, binary_section,
                trace, tenant, t0, cacheable, ttl_s,
            )
        qos_release = self.qos.admit(tenant) if self.qos is not None else None
        try:
            result = self._execute_slot(
                model_name, model_version, request, binary_section,
                trace, tenant, extra_release=qos_release,
            )
            if isinstance(result, _InflightStream):
                qos_release = None  # the stream owns the QoS slot now
            return result
        finally:
            if qos_release is not None:
                qos_release()

    def _front_key(self, model_name, model_version, request, binary_section):
        """``(digest, cacheable, ttl_s)`` for this request, or None when
        the front door does not apply: no cache or coalescer configured;
        decoupled or stateful model; unknown model (the normal path raises the proper
        error); or a request that reads from or writes to a shared-memory
        region, system or CUDA (``request_digest`` returns None): its
        tensors are the region's, and an output sink written on the
        device can never be replayed from a cached answer.

        ``cacheable``/``ttl_s`` come from the model's ``response_cache``
        config block: a model that opts out of caching still coalesces,
        and a model with a freshness bound caches with its own TTL."""
        if self.response_cache is None and self._coalescer is None:
            return None
        with self._lock:
            model = self._models.get(model_name)
            if model is None or not self._ready.get(model_name):
                return None
        if model.decoupled or model.stateful:
            return None
        cacheable, ttl_s = model.cache_hints()
        if not cacheable and self._coalescer is None:
            return None  # nothing left for the front door to do
        key = request_digest(model_name, model_version, request,
                             binary_section)
        if key is None:
            return None
        return key, cacheable, ttl_s

    def _front_door(self, key, model_name, model_version, request,
                    binary_section, trace, tenant, t0, cacheable=True,
                    ttl_s=None):
        """Serve one cacheable unary request: cache hit, coalesced follower,
        or (leader / uncoalesced) QoS-admitted execution + cache fill.  A
        shared rendering is host data (JSON and wire bytes): the leader's
        device tensors became bytes in its render, before publication."""
        stats = self._stats[model_name]
        use_cache = self.response_cache is not None and cacheable
        lookup_ns = 0
        if use_cache:
            lookup0 = time.monotonic_ns()
            cached = self.response_cache.get(key)
            lookup_ns = time.monotonic_ns() - lookup0
            if cached is not None:
                if trace is not None:
                    trace.event("CACHE_HIT")
                if self.qos is not None:
                    self.qos.note(tenant)
                fleet = self.fleet
                if fleet is not None:
                    # hot-entry signal for proactive replication: a pure
                    # host-side counter bump, never a peer RPC
                    fleet.note_cache_hit(key)
                response, blobs = cached
                stats.record_cache_hit(time.monotonic_ns() - t0)
                return _stamp_id(response, request), blobs
        if self._coalescer is None:
            if use_cache:
                fleet_hit = self._fleet_cached(key, ttl_s)
                if fleet_hit is not None:
                    return self._serve_fleet_hit(
                        fleet_hit, request, trace, tenant, stats, t0
                    )
            result = self._front_dispatch(
                model_name, model_version, request, binary_section, trace,
                tenant,
            )
            if not isinstance(result, tuple):
                # the model was hot-swapped to a decoupled shape between
                # the front-key check and execution: a stream is not
                # cacheable — hand it straight to the caller
                return result
            # a miss is a request that EXECUTED after missing: coalesced
            # followers and shed requests never dispatched
            if use_cache:
                stats.record_cache_miss(lookup_ns)
                self._cache_fill(key, (_strip_id(result[0]), result[1]),
                                 ttl_s)
            return result
        while True:
            is_leader, flight = self._coalescer.join(key)
            if not is_leader:
                # identical request already dispatching: wait for its
                # result (the leader ALWAYS completes the flight — so
                # this wait is bounded by the leader's execution)
                flight.event.wait()
                if flight.retry:
                    # the leader was shed by ITS OWN tenant's admission:
                    # that 429 is tenant identity, not request content —
                    # re-contend so a compliant tenant's request becomes
                    # the next leader under its own quota
                    continue
                if trace is not None:
                    trace.event("COALESCED")
                if self.qos is not None:
                    self.qos.note(tenant)
                if flight.error is not None:
                    stats.record(False, time.monotonic_ns() - t0, 0, 0, 0)
                    raise flight.error
                response, blobs = flight.result
                stats.record_request_success(time.monotonic_ns() - t0)
                return _stamp_id(response, request), blobs
            if use_cache:
                # LEADER-only fleet lookup (followers coalesce onto it):
                # a hot key's peer fan-out stays one lookup per flight,
                # not one per request in the herd
                fleet_hit = self._fleet_cached(key, ttl_s)
                if fleet_hit is not None:
                    self._coalescer.publish(key, flight, fleet_hit)
                    return self._serve_fleet_hit(
                        fleet_hit, request, trace, tenant, stats, t0
                    )
            try:
                result = self._front_dispatch(
                    model_name, model_version, request, binary_section,
                    trace, tenant,
                )
            except InferenceServerException as e:
                if e.status() == "429" or is_connection_level(e):
                    # tenant-scoped QoS rejection — or a leader that died
                    # with its transport: neither says anything about the
                    # request CONTENT, so followers re-contend instead of
                    # inheriting the error
                    self._coalescer.retry_followers(key, flight)
                    raise
                # content-scoped errors fan out to every follower: a
                # byte-identical request would have failed identically
                self._coalescer.fail(key, flight, e)
                raise
            except BaseException as e:
                self._coalescer.fail(key, flight, e)
                raise
            if not isinstance(result, tuple):
                # hot-swap TOCTOU (see the uncoalesced branch): nothing
                # shareable was produced — followers re-contend
                self._coalescer.retry_followers(key, flight)
                return result
            # publish/cache the id-less rendering: followers and later
            # hits stamp their own request id — under a guard, because a
            # flight left incomplete here would strand every follower on
            # an untimed wait
            try:
                if use_cache:
                    stats.record_cache_miss(lookup_ns)  # leader executed
                shared = (_strip_id(result[0]), result[1])
            except BaseException as e:  # pragma: no cover - defensive
                self._coalescer.fail(key, flight, e)
                raise
            self._coalescer.publish(key, flight, shared)
            if use_cache:
                self._cache_fill(key, shared, ttl_s)
            return result

    def _front_dispatch(self, model_name, model_version, request,
                        binary_section, trace, tenant):
        """One front-door request that missed every fast path: per-tenant
        QoS admission (429) then a real execution slot.  Always unary —
        the front door never applies to decoupled models."""
        qos_release = self.qos.admit(tenant) if self.qos is not None else None
        try:
            return self._execute_slot(
                model_name, model_version, request, binary_section, trace,
                tenant,
            )
        finally:
            if qos_release is not None:
                qos_release()

    def _fleet_cached(self, key, ttl_s):
        """Peer-replica response-cache lookup for a local miss: the
        id-less ``(response, blobs)`` rendering, filled into the local
        cache, or None.  The peer RPC runs on the request thread with NO
        engine lock held and is bounded by the tier's fan-out x timeout
        (breaker-gated: a dead fleet degrades to local-only)."""
        fleet = self.fleet
        if fleet is None or self.response_cache is None:
            return None
        remote = fleet.cache_lookup(key)
        if remote is None:
            return None
        response, blobs = remote
        self.response_cache.put(key, response, blobs, ttl_s=ttl_s)
        self.metrics.inc(
            "ctpu_fleet_cache_hits_total",
            help_=FLEET_HELP["ctpu_fleet_cache_hits_total"],
        )
        return response, blobs

    def _serve_fleet_hit(self, shared, request, trace, tenant, stats, t0):
        """Render one fleet cache hit exactly like a local hit: own
        request id stamped, tenant request counted, no execution slot."""
        if trace is not None:
            trace.event("CACHE_HIT")
        if self.qos is not None:
            self.qos.note(tenant)
        response, blobs = shared
        stats.record_cache_hit(time.monotonic_ns() - t0)
        return _stamp_id(response, request), blobs

    def _cache_fill(self, key, shared, ttl_s=None):
        """Store one id-less ``(response, blobs)`` rendering, under the
        model's own TTL when its config block sets one."""
        if self.response_cache is not None:
            self.response_cache.put(key, shared[0], shared[1], ttl_s=ttl_s)

    def _execute_slot(self, model_name, model_version, request,
                      binary_section, trace, tenant, extra_release=None):
        """Global admission + execution.  ``extra_release`` (the QoS slot)
        transfers to the returned stream for decoupled results."""
        self._admit()
        streamed = False
        try:
            result = self._execute_admitted(
                model_name, model_version, request, binary_section, trace,
                tenant,
            )
            if not isinstance(result, tuple):  # decoupled generator
                streamed = True

                # the stream stays counted as in-flight (engine slot AND
                # tenant slot) until the consumer exhausts, closes, or
                # drops it — drain must not cut a stream mid-generation
                def release(engine=self, extra=extra_release):
                    engine._release()
                    if extra is not None:
                        extra()

                return _InflightStream(result, release)
            return result
        finally:
            if not streamed:
                self._release()

    def _execute_admitted(self, model_name, model_version, request,
                          binary_section, trace=None, tenant=""):
        """Execute one admitted request.  A batchable request waits in its
        model's dynamic batcher; an ensemble runs through the DAG
        scheduler; a decoupled model streams; everything else, a sequence
        request included, calls the model directly."""
        t0 = time.monotonic_ns()
        model = self.get_model(model_name, model_version)
        stats = self._stats[model_name]
        try:
            # trace timestamps use the wall clock (comparable with client
            # spans); queue/compute events are emitted once the scheduling
            # path is known — the batcher owns them on the batched path
            w_in0 = time.time_ns() if trace is not None else 0
            inputs = self._gather_inputs(model, request, binary_section)
            params = request.get("parameters", {}) or {}
            context = self._sequence_context(params, model.device)
            if context is not None:
                if model.decoupled and (
                    params.get("sequence_durable")
                    or params.get("sequence_step")
                ):
                    # the commit path (step counter, retained rendering,
                    # snapshot push) only exists on the unary direct
                    # path: pretending otherwise would silently drop the
                    # durability the client asked for
                    raise InferenceServerException(
                        f"{model.name}: sequence_durable/sequence_step "
                        "apply to unary stateful models only — decoupled "
                        "streams do not replicate sequence state",
                        status="400",
                    )
                replayed = self._sequence_replay(context, params, request)
                if replayed is not None:
                    # duplicate declared step: answer from the retained
                    # rendering without re-applying (exactly-once resume)
                    stats.record_request_success(time.monotonic_ns() - t0)
                    return replayed
            t_in1 = time.monotonic_ns()
            w_in1 = time.time_ns() if trace is not None else 0
            if model.ensemble_steps:
                if trace is not None:
                    trace.event("QUEUE_END", w_in0)
                    trace.event("COMPUTE_START", w_in0)
                    trace.event("COMPUTE_INPUT_END", w_in1)
                # work_ns, the summed per-step durations, is recorded as
                # the ensemble's compute_infer, so composing statistics
                # reconcile with the ensemble's
                result, work_ns = self._pipeline_runner().run(
                    model, inputs, params
                )
                t_inf1 = time.monotonic_ns()
                if trace is not None:
                    trace.event("COMPUTE_OUTPUT_START")
                rendered = self._render_response(
                    model, model_version, request, result
                )
                t1 = time.monotonic_ns()
                if trace is not None:
                    trace.event("COMPUTE_END")
                stats.record(True, t1 - t0, work_ns, t_in1 - t0,
                             t1 - t_inf1, batch=_batch_of(model, request))
                # the profiler reuses the timestamps stats already took
                self.prof.commit(
                    "ensemble", (t1 - t0) / 1e9,
                    phases={
                        "host": (t_in1 - t0) / 1e9,
                        "compute": work_ns / 1e9,
                        "render": (t1 - t_inf1) / 1e9,
                    },
                    model=model.name,
                    items=_batch_of(model, request),
                    flops_per_item=model.flops_per_item,
                )
                return rendered
            if batchable_request(model, inputs, params, context, request):
                # the batcher records the execution (and the trace's
                # QUEUE_END/COMPUTE_* events); the request's success is
                # recorded here, and a failure (batched execution or
                # rendering) falls through to the except clauses below.
                # A device request's outputs bound for CUDA regions are
                # written there by the batcher, which returns once they
                # are: no device call on this thread, which would hold the
                # interpreter lock while a graph launch holds the driver
                weight = (
                    self.qos.weight(tenant) if self.qos is not None else 1.0
                )
                result = self._batcher_for(model).submit(
                    inputs, trace=trace, tenant=tenant, weight=weight,
                    sinks=self._output_sinks(model, request, inputs))
                rendered = self._render_response(
                    model, model_version, request, result
                )
                stats.record_request_success(time.monotonic_ns() - t0)
                return rendered
            if trace is not None:
                trace.event("QUEUE_END", w_in0)
                trace.event("COMPUTE_START", w_in0)
                trace.event("COMPUTE_INPUT_END", w_in1)
            if model.decoupled:
                # LAZY stream: responses render as the model produces them,
                # so the first token reaches the wire at first-token time
                return self._decoupled_stream(
                    model, model_version, request, inputs, params, context,
                    stats, t0, t_in1, trace, tenant,
                )
            # direct path: the busy span closes after rendering, which
            # has the outputs on the host (or written into their regions).
            # A fused model replays its batcher's bucket program (on the
            # card a CUDA graph: no eager forward, so no cuDNN plan on this
            # thread); others, and requests no bucket holds, call fn
            self.busy.begin()
            try:
                with device_stream(model.device):
                    if direct_program_request(model, inputs, context):
                        result = self._batcher_for(model).run_direct(inputs)
                    else:
                        result = model.fn(inputs, params, context)
                    t_inf1 = time.monotonic_ns()
                    if trace is not None:
                        trace.event("COMPUTE_OUTPUT_START")
                    rendered = self._render_response(
                        model, model_version, request, result
                    )
            finally:
                self.busy.end()
            t1 = time.monotonic_ns()
            if trace is not None:
                trace.event("COMPUTE_END")
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
        # pre-measured splits (same timestamps stats used) fold into the
        # continuous profiler without touching another clock
        self.prof.commit(
            "unary", (t1 - t0) / 1e9,
            phases={
                "host": (t_in1 - t0) / 1e9,
                "compute": (t_inf1 - t_in1) / 1e9,
                "render": (t1 - t_inf1) / 1e9,
            },
            model=model.name,
            items=_batch_of(model, request),
            flops_per_item=model.flops_per_item,
        )
        if context is not None:
            # applied-step accounting + durable snapshot replication
            # (peer push BEFORE the response leaves this method)
            self._sequence_commit(context, params, rendered)
        return rendered

    def _sequence_context(self, params, device=None):
        """The request's :class:`SequenceContext` (its tensors on the
        serving model's *device*), or None without a ``sequence_id``."""
        seq_id = params.get("sequence_id", 0)
        if not seq_id:
            return None
        durable = bool(params.get("sequence_durable"))
        ctx = self._sequence_context_local(seq_id, params, durable, device)
        if ctx is not None:
            return ctx
        # Local miss mid-sequence with a fleet tier attached: the replica
        # that held this sequence may have died, and its replicated
        # snapshot lives in the tier.  The peer RPC runs on the REQUEST
        # thread with no engine lock held (the PEER-CALL-UNDER-LOCK
        # shape) and is bounded by the tier's fan-out x timeout.
        snapshot = None
        fleet = self.fleet
        if fleet is not None:
            lookup = getattr(fleet, "sequence_lookup", None)
            if lookup is not None:
                snapshot = lookup(seq_id)
        return self._install_sequence(seq_id, params, durable,
                                      snapshot, device)

    def _sequence_context_local(self, seq_id, params, durable, device=None):
        """Fast path under the lock: the context when it exists locally
        (or must be created fresh), None when a fleet recovery attempt
        should run first."""
        now = time.monotonic()
        with self._lock:
            # Expire sequences idle past the advertised
            # max_sequence_idle_microseconds so abandoned sequences (client
            # crashed before sequence_end) don't leak state forever.
            expired = [
                sid
                for sid, ctx in self._sequences.items()
                if now - ctx.last_used > self.max_sequence_idle_s
            ]
            for sid in expired:
                del self._sequences[sid]
            missing = seq_id not in self._sequences
            if missing and not params.get("sequence_start") \
                    and self.fleet is not None:
                return None  # try the tier before forking fresh state
            if params.get("sequence_start") or missing:
                self._sequences[seq_id] = SequenceContext(
                    seq_id, durable=durable, device=device
                )
            ctx = self._sequences[seq_id]
            ctx.durable = ctx.durable or durable
            ctx.last_used = now
            if params.get("sequence_end"):
                self._sequences.pop(seq_id, None)
            return ctx

    def _install_sequence(self, seq_id, params, durable, snapshot,
                          device=None):
        """Install the recovered (or fresh) context after a fleet lookup.
        A context another thread installed meanwhile wins unless the
        snapshot is strictly newer — replication must never move a
        sequence backwards."""
        resumed = False
        with self._lock:
            ctx = self._sequences.get(seq_id)
            if snapshot is not None and (
                ctx is None
                or (float(snapshot.get("epoch", 0.0)),
                    int(snapshot.get("step", 0))) > (ctx.epoch, ctx.step)
            ):
                ctx = SequenceContext.restore(snapshot, device)
                resumed = True
                self.metrics.inc(
                    "ctpu_fleet_seq_resumes_total",
                    help_=FLEET_HELP["ctpu_fleet_seq_resumes_total"],
                )
            elif ctx is None:
                if durable:
                    # a DURABLE mid-sequence request whose snapshot is
                    # nowhere in the fleet must fail LOUDLY: executing
                    # against a silently forked fresh context would
                    # return wrong answers with no error — the exact
                    # state split SequenceRestartError exists to prevent
                    raise InferenceServerException(
                        f"durable sequence {seq_id!r} has no local state "
                        "and no replicated snapshot in the fleet — its "
                        "replica died before any step was replicated; "
                        "restart the sequence (sequence_start=True)",
                        status="409",
                    )
                ctx = SequenceContext(seq_id, durable=durable, device=device)
            ctx.durable = ctx.durable or durable
            ctx.last_used = time.monotonic()
            self._sequences[seq_id] = ctx
            if params.get("sequence_end"):
                self._sequences.pop(seq_id, None)
        if resumed:
            # record the resume AFTER releasing the engine lock (span
            # completion may flush to the trace file).  The marker span
            # CONTINUES the dead replica's trace id (the snapshot's
            # traceparent); the current request's own trace is tagged so
            # both directions of the join are explicit in traceview.
            trace = current_trace()
            span = self.tracer.resume_span(
                ctx.trace_ctx, seq_id, step=ctx.step,
                resumed_by=(trace.trace_id if trace is not None else ""),
            )
            if trace is not None:
                trace.event("SEQ_RESUME")
                trace.tags["resumed_sequence"] = seq_id
                if span is not None:
                    trace.tags["resumed_trace"] = span.trace_id
            self.flight.note(
                "seq_resume", sequence_id=seq_id, step=ctx.step,
                trace=ctx.trace_ctx,
            )
        return ctx

    def _sequence_replay(self, context, params, request):
        """Idempotent duplicate-step short-circuit.

        Requests may declare a monotonic ``sequence_step`` parameter
        (1-based).  A declared step the context already applied returns
        the retained rendering re-stamped with this request's id — the
        retried step after a failover lands exactly once, never twice.
        A declared step AHEAD of the applied counter means intermediate
        steps were lost (a non-durable sequence resumed from a stale
        snapshot): that is the state fork ``SequenceRestartError``
        exists to prevent, so it is rejected with a restartable 409.
        Returns None when the step is fresh and must execute."""
        declared = params.get("sequence_step")
        if not declared:
            return None
        declared = int(declared)
        with self._lock:
            step = context.step
            last = context.last_response
        if declared > step + 1:
            # The client saw step declared-1 acked somewhere, so this
            # context is provably stale (a failover resumed from an old
            # snapshot while the newest one was briefly unreachable).
            # Re-look the fleet up, bounded, before declaring a fork.
            step, last = self._heal_seq_gap(context, declared)
        if declared == step + 1:
            return None  # the expected next step: apply it
        if declared > step:
            raise InferenceServerException(
                f"sequence {context.sequence_id}: declared step {declared} "
                f"skips ahead of the applied counter ({step}) — "
                "intermediate steps were never applied here; restart the "
                "sequence (sequence_start=True)",
                status="409",
            )
        if last is not None and last[0] == declared:
            self._retry_seq_quorum(context)
            response, blobs = last[1], last[2]
            return _stamp_id(response, request), list(blobs)
        raise InferenceServerException(
            f"sequence {context.sequence_id}: step {declared} was already "
            f"applied (counter at {step}) and its response is no longer "
            "retained",
            status="409",
        )

    def _heal_seq_gap(self, context, declared, timeout_s=2.0):
        """Bounded fleet re-lookup when a declared step skips ahead of
        the applied counter.  A declared step N means the client holds
        an ack for step N-1, so a counter below N-1 is not a client
        bug — it is this replica resuming from a stale snapshot while
        the replica (or peer copy) holding the newest one was briefly
        unreachable.  Retrying the lookup for a short window turns that
        transient miss into a clean resume; only when the window closes
        without finding step >= N-1 does the caller raise the
        restartable 409 (the snapshot really is gone).  Peer RPCs run
        with no engine lock held.  Returns the refreshed
        ``(step, last_response)`` pair."""
        fleet = self.fleet
        with self._lock:
            durable = context.durable
            step, last = context.step, context.last_response
        lookup = getattr(fleet, "sequence_lookup", None)
        if lookup is None or not durable:
            return step, last
        deadline = time.monotonic() + timeout_s
        while True:
            try:
                snapshot = lookup(context.sequence_id)
            except Exception:  # pragma: no cover - defensive
                snapshot = None
            if snapshot is not None:
                fresh = SequenceContext.restore(snapshot, context.device)
                with self._lock:
                    if (fresh.epoch, fresh.step) > (
                        context.epoch, context.step
                    ):
                        context.step = fresh.step
                        context.epoch = fresh.epoch
                        context.state = fresh.state
                        context.last_response = fresh.last_response
                        context.trace_ctx = fresh.trace_ctx
                    step, last = context.step, context.last_response
                if step + 1 >= declared:
                    self.metrics.inc(
                        "ctpu_fleet_seq_heals_total",
                        help_=FLEET_HELP["ctpu_fleet_seq_heals_total"],
                    )
                    return step, last
            if time.monotonic() >= deadline:
                return step, last
            time.sleep(0.05)

    def _retry_seq_quorum(self, context):
        """Replay-path half of the quorum gate: a retried step whose
        original commit was refused for quorum deficit re-attempts the
        publish before the retained rendering is released.  Success
        clears the deficit (the retry acks 200, now quorum-durable);
        another shortfall refuses again, so no response ever reaches the
        wire without its snapshot at quorum.  No-op when the context is
        not in deficit — the common replay path costs one flag read."""
        with self._lock:
            deficit = context.quorum_deficit
        if not deficit:
            return
        fleet = self.fleet
        if fleet is None or not context.durable:
            return
        acked = fleet.publish_sequence(context.export())
        self._enforce_seq_quorum(fleet, context, acked)

    def _sequence_commit(self, context, params, rendered):
        """Advance the applied-step counter, retain the rendering for
        idempotent replay, and — for durable sequences with a fleet tier
        attached — push the snapshot to peer replicas BEFORE the response
        reaches the wire: an acked step must survive this replica's
        unplanned death.  The peer push runs with no engine lock held and
        is bounded by the tier's fan-out x timeout x per-peer breakers
        (an unreachable fleet degrades to local-only durability)."""
        response, blobs = rendered
        ended = bool(params.get("sequence_end"))
        trace = current_trace()
        with self._lock:
            context.step += 1
            context.last_response = (
                context.step, _strip_id(response), list(blobs),
            )
            if trace is not None:
                # the snapshot carries the committing request's trace
                # context: a survivor resuming this sequence after our
                # death continues the SAME trace id (resume_span)
                context.trace_ctx = trace.traceparent()
        fleet = self.fleet
        if fleet is None or not context.durable:
            return
        if not ended:
            # export OUTSIDE the engine lock: encoding multi-MB numpy
            # state under the repository-wide _lock would stall every
            # concurrent admission.  Steps of ONE sequence are serial by
            # contract, so the context is stable while we encode.
            acked = fleet.publish_sequence(context.export())
            self._enforce_seq_quorum(fleet, context, acked)
        else:
            # the sequence is complete: peers can drop their snapshots
            fleet.forget_sequence(context.sequence_id)

    def _enforce_seq_quorum(self, fleet, context, acked):
        """Quorum gate for a durable step's ack.

        Under ``quorum="majority"`` a step whose snapshot reached fewer
        than ceil((K+1)/2) peers must NOT ack: the step stays applied
        locally (with its retained rendering), the context is flagged
        ``quorum_deficit``, and the client gets a retryable 503 carrying
        breaker evidence.  The retry declares the SAME ``sequence_step``;
        the idempotent replay path re-attempts the publish and only
        releases the retained rendering once quorum is met — so a 200
        always implies the snapshot is quorum-durable, and the model
        never re-applies the step (exactly-once holds).  If this replica
        dies while in deficit, the step was never acked, so losing it is
        a correct (unacked) loss, not acks-then-loses."""
        required = fleet.seq_quorum_required()
        if required <= 0:
            return
        ok = acked >= required
        fleet.note_quorum(ok)
        with self._lock:
            context.quorum_deficit = not ok
        if ok:
            return
        evidence = fleet.quorum_evidence()
        raise InferenceServerException(
            f"sequence {context.sequence_id} step {context.step}: write "
            f"quorum unreachable ({acked}/{required} peer acks, "
            f"replicate_k={fleet.replicate_k}); step applied locally but "
            "not acked — retry the same sequence_step "
            f"(open breakers: {evidence or 'none'})",
            status="503",
        )

    def export_sequence(self, seq_id):
        """One live sequence's snapshot (the fleet tier's ``seq_get``
        handler reads this so a survivor can pull live state during a
        planned handoff), or None.  The encode runs OUTSIDE the
        engine-wide lock (see _sequence_commit) — only the context
        reference is taken under it."""
        with self._lock:
            ctx = self._sequences.get(seq_id)
        return ctx.export() if ctx is not None else None

    def export_sequences(self):
        """Snapshots of every live sequence (the planned-drain export).
        Encoding runs outside the lock; by drain time no request is
        mutating these contexts."""
        with self._lock:
            contexts = list(self._sequences.values())
        return [ctx.export() for ctx in contexts]

    def pressure(self):
        """Autoscaling signal: queued + in-flight work on this replica.
        Gossiped on fleet probes (``FleetTier.local_summary``) and
        surfaced per-endpoint through ``EndpointPool.pressures()``."""
        with self._flight_cv:
            inflight = self._inflight
        with self._lock:
            batchers = list(self._batchers.values())
        depth = 0
        for batcher in batchers:
            try:
                depth += batcher.queue_depth()
            except Exception:  # pragma: no cover - defensive
                pass
        return {"queue_depth": depth + inflight, "inflight": inflight}

    def _output_sinks(self, model, request, inputs):
        """``{output: flat tensor}`` of a device request's outputs bound
        for CUDA regions (``SharedMemoryRegistry.output_sink``); a
        classified output is rendered first (BYTES), so it has no sink."""
        if not all(isinstance(a, torch.Tensor) for a in inputs.values()):
            return None
        specs = {t.name: t for t in model.outputs}
        sinks = {}
        for out in request.get("outputs") or []:
            params = out.get("parameters") or {}
            spec = specs.get(out["name"])
            if ("shared_memory_region" not in params or spec is None
                    or params.get("classification")):
                continue
            sink = self.shm.output_sink(
                params["shared_memory_region"],
                params.get("shared_memory_offset", 0),
                params["shared_memory_byte_size"], spec.datatype)
            if sink is not None:
                sinks[out["name"]] = sink
        return sinks

    def _decoupled_stream(self, model, model_version, request, inputs,
                          params, context, stats, t0, t_in1, trace=None,
                          tenant=""):
        """Generator of (response_dict, blobs) for a decoupled model.

        Exactly one statistics entry per request: success at exhaustion,
        failure on a model error or an abandoned stream (the consumer
        closes or drops the generator mid-flight).  The busy span covers
        only the model's production time (each next() + render), never
        the suspension at yield — a slow-reading client must not inflate
        the duty cycle."""
        # Triton's decoupled completion protocol: every response carries
        # triton_final_response=false; with triton_enable_empty_final_response
        # the stream ends with one empty response marked final
        want_final = bool(params.get("triton_enable_empty_final_response"))
        # Decoupled models bypass the front door, so the tenant identity
        # (x-tenant-id) reaches them through the RESERVED __tenant__
        # parameter on a COPY of the request params — stamped by the
        # engine, never trusted from the client (a spoofed value would
        # let one tenant bill its decode lanes to another)
        params = dict(params)
        params.pop("__tenant__", None)
        if tenant:
            params["__tenant__"] = tenant
        recorded = False
        try:
            gen = model.fn(inputs, params, context)
            while True:
                self.busy.begin()
                try:
                    try:
                        # generator bodies run at next(), often on the
                        # consumer's thread, outside execute()'s bracket:
                        # the request trace is pushed again around each
                        # step (untraced streams skip the thread-local)
                        if trace is None:
                            partial = next(gen)
                        else:
                            with push_trace(trace):
                                partial = next(gen)
                    except StopIteration:
                        break
                    rendered = self._render_response(
                        model, model_version, request, partial
                    )
                    rendered[0].setdefault("parameters", {})[
                        "triton_final_response"
                    ] = False
                finally:
                    self.busy.end()
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
            t1 = time.monotonic_ns()
            if trace is not None:
                trace.event("COMPUTE_END")
            stats.record(True, t1 - t0, t1 - t_in1, t_in1 - t0, 0)
            recorded = True
        except InferenceServerException:
            stats.record(False, time.monotonic_ns() - t0)
            recorded = True
            raise
        except Exception as e:
            stats.record(False, time.monotonic_ns() - t0)
            recorded = True
            raise InferenceServerException(
                f"{model.name}: execution failed: {e}",
                status="500", debug_details=e,
            ) from e
        finally:
            if not recorded:  # abandoned mid-stream (GeneratorExit/GC)
                stats.record(False, time.monotonic_ns() - t0)

    def _gather_inputs(self, model, request, binary_section):
        """Resolve request inputs: tensors in shared-memory regions (views
        of a CUDA region, numpy arrays from a system region),
        binary-extension tensors or JSON ``data``.

        *binary_section* is either one contiguous bytes object (the HTTP
        binary extension: tensors back to back after the JSON header) or a
        list of per-tensor buffers (the gRPC frontend hands over the
        proto's ``raw_input_contents`` untouched).  Both decode as
        zero-copy views: no tensor bytes are copied between the transport
        and the model."""
        specs = {t.name: t for t in model.inputs}
        arrays = {}
        offset = 0
        part_cursor = 0
        sectioned = not isinstance(binary_section, (list, tuple))
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
                if sectioned:
                    raw = memoryview(binary_section)[offset : offset + size]
                    offset += size
                else:
                    if part_cursor >= len(binary_section):
                        raise InferenceServerException(
                            f"input '{name}' binary section underrun",
                            status="400",
                        )
                    raw = binary_section[part_cursor]
                    part_cursor += 1
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
            # the CUDA-shm path copies it on the device, with no D2H; a
            # classified output is read on the host
            arr = result_arrays[name]
            if not isinstance(arr, torch.Tensor):
                arr = np.asarray(arr)
            datatype = specs[name].datatype
            class_count = params.get("classification", 0)
            if class_count:
                arr = _classify(
                    _host_array(arr), class_count, specs[name].labels
                )
                datatype = "BYTES"
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
        # reserved result key: a model sets response-level parameters by
        # including "__parameters__": {...} beside its output tensors (a
        # fused model's program drops it: it replays no python)
        extra_params = result_arrays.get("__parameters__")
        if extra_params:
            response["parameters"] = dict(extra_params)
        if request.get("id"):
            response["id"] = request["id"]
        return response, blobs


def _classify(arr, class_count, labels):
    """Classification extension: top-N "score:index[:label]" BYTES strings."""
    def topk_strings(vec):
        k = min(class_count, vec.size)
        idx = np.argsort(vec)[::-1][:k]
        out = []
        for i in idx:
            s = f"{float(vec[i]):f}:{int(i)}"
            if labels and int(i) < len(labels):
                s += f":{labels[int(i)]}"
            out.append(s.encode("utf-8"))
        return out

    if arr.ndim <= 1:
        return np.array(topk_strings(np.atleast_1d(arr)), dtype=np.object_)
    flat = arr.reshape(arr.shape[0], -1)
    rows = [topk_strings(row) for row in flat]
    return np.array(rows, dtype=np.object_)


def _batch_of(model, request):
    if model.max_batch_size <= 0:
        return 1
    inputs = request.get("inputs", [])
    if inputs and inputs[0].get("shape"):
        return int(inputs[0]["shape"][0])
    return 1


def _strip_id(response):
    """The id-less rendering shared via cache/coalescing (the request id is
    caller identity, not content; every reader stamps its own)."""
    if "id" in response:
        return {k: v for k, v in response.items() if k != "id"}
    return response


def _stamp_id(response, request):
    """A shallow per-caller copy of a shared response with this request's
    id (nested structures stay shared — readers only serialize them)."""
    out = dict(response)
    if request.get("id"):
        out["id"] = request["id"]
    return out
