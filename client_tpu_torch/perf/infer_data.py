"""Materialize per-request InferInput/InferRequestedOutput objects.

Parity with the reference's InferDataManager family (reference
src/c++/perf_analyzer/iinfer_data_manager.h:39-60 and
infer_data_manager{,_base,_shm,_factory}): a factory picks the plain variant
(tensor bytes inline in each request) or a shared-memory variant that
pre-stages input data in system or CUDA regions and hands out
region-referencing inputs.

The port's copy of client_tpu/perf/infer_data.py, with
:class:`CudaShmInferDataManager` in place of ``TpuShmInferDataManager``:
the device-resident path.  Each region is one device allocation
(client_tpu_torch.utils.cuda_shared_memory) filled once at init and
registered by its 64-byte CUDA IPC handle; requests carry only region
references.  A server in another process opens the handle over CUDA IPC;
an in-process server (``--hermetic``) resolves it through the
process-local broker, since CUDA refuses to open a handle its own process
made.
"""

import os
import uuid

import numpy as np

from client_tpu_torch.utils import (
    InferenceServerException,
    serialized_byte_size,
)
from client_tpu_torch.utils import cuda_shared_memory as cudashm
from client_tpu_torch.utils import shared_memory as sysshm


class SharedMemoryType:
    NONE = "none"
    SYSTEM = "system"
    CUDA = "cuda"


class InferData:
    """Prepared request objects for one (stream, step)."""

    def __init__(self, inputs, outputs):
        self.inputs = inputs
        self.outputs = outputs


def _nbytes(arr):
    if arr.dtype == np.object_:
        return serialized_byte_size(arr)
    return arr.nbytes


class InferDataManager:
    """Plain variant: every request carries tensor bytes.

    Request objects are built once per (stream, step) at init and reused for
    every send (the reference prepares infer data per context and rotates;
    per-request re-serialization would inflate measured client latency).
    The cached objects are treated as immutable by the workers.
    """

    def __init__(self, backend, data_loader, inputs_metadata, outputs_metadata):
        self._backend = backend
        self._loader = data_loader
        self._inputs_meta = inputs_metadata
        self._outputs_meta = outputs_metadata
        self._cache = {}

    def init(self):
        for s in range(self._loader.num_streams):
            for t in range(self._loader.num_steps(s)):
                self._cache[(s, t)] = self._build(s, t)

    def _build(self, stream_id, step_id):
        step = self._loader.get_input_data(stream_id, step_id)
        InferInput = self._backend.infer_input_cls
        Requested = self._backend.requested_output_cls
        inputs = []
        for meta in self._inputs_meta:
            name = meta["name"]
            td = step.get(name)
            if td is None:
                continue  # optional input absent from this step
            inp = InferInput(name, list(td.array.shape), meta["datatype"])
            inp.set_data_from_numpy(td.array)
            inputs.append(inp)
        outputs = [Requested(m["name"]) for m in self._outputs_meta]
        return InferData(inputs, outputs)

    def get_infer_data(self, stream_id, step_id):
        return self._cache[(stream_id, step_id)]

    def cleanup(self):
        pass


class _ShmInferDataManagerBase(InferDataManager):
    """Pre-stages every (stream, step) tensor into regions at init; requests
    reference regions by name+offset (infer_data_manager_shm.h analog)."""

    region_prefix = "perf_shm"

    def __init__(self, backend, data_loader, inputs_metadata, outputs_metadata,
                 output_byte_size=0):
        super().__init__(backend, data_loader, inputs_metadata, outputs_metadata)
        # region names (and the system regions' /dev/shm keys) are this
        # manager's own: two runs on one host never open each other's
        self.prefix = (f"{self.region_prefix}_{os.getpid()}_"
                       f"{uuid.uuid4().hex[:8]}")
        self._regions = {}  # (stream, step, name) -> (region_name, nbytes)
        self._out_regions = {}  # name -> (region_name, byte_size)
        self._output_byte_size = output_byte_size

    def region_names(self):
        """This manager's regions, inputs and outputs; its cleanup
        unregisters these and no other run's."""
        return ([n for n, _ in self._regions.values()]
                + [n for n, _ in self._out_regions.values()])

    def _create_and_register(self, region_name, arrays, total):
        raise NotImplementedError

    def _create_output_region(self, region_name, byte_size):
        raise NotImplementedError

    def init(self):
        for s, steps in enumerate(self._loader.streams):
            for t, step in enumerate(steps):
                for name, td in step.items():
                    region_name = f"{self.prefix}_{s}_{t}_{name}"
                    nbytes = _nbytes(td.array)
                    self._create_and_register(region_name, [td.array], nbytes)
                    self._regions[(s, t, name)] = (region_name, nbytes)
        if self._output_byte_size:
            for meta in self._outputs_meta:
                region_name = f"{self.prefix}_out_{meta['name']}"
                self._create_output_region(region_name, self._output_byte_size)
                self._out_regions[meta["name"]] = (
                    region_name, self._output_byte_size
                )
        for s in range(self._loader.num_streams):
            for t in range(self._loader.num_steps(s)):
                self._cache[(s, t)] = self._build(s, t)

    def _build(self, stream_id, step_id):
        step = self._loader.get_input_data(stream_id, step_id)
        InferInput = self._backend.infer_input_cls
        Requested = self._backend.requested_output_cls
        inputs = []
        for meta in self._inputs_meta:
            name = meta["name"]
            td = step.get(name)
            if td is None:
                continue
            region_name, nbytes = self._regions[(stream_id, step_id, name)]
            inp = InferInput(name, list(td.array.shape), meta["datatype"])
            inp.set_shared_memory(region_name, nbytes)
            inputs.append(inp)
        outputs = []
        for meta in self._outputs_meta:
            out = Requested(meta["name"])
            if meta["name"] in self._out_regions:
                region_name, byte_size = self._out_regions[meta["name"]]
                out.set_shared_memory(region_name, byte_size)
            outputs.append(out)
        return InferData(inputs, outputs)


class SystemShmInferDataManager(_ShmInferDataManagerBase):
    region_prefix = "perf_sysshm"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._handles = []

    def _create_and_register(self, region_name, arrays, total):
        key = "/" + region_name
        h = sysshm.create_shared_memory_region(region_name, key, total)
        sysshm.set_shared_memory_region(h, arrays)
        self._backend.register_system_shared_memory(region_name, key, total)
        self._handles.append(h)

    def _create_output_region(self, region_name, byte_size):
        key = "/" + region_name
        h = sysshm.create_shared_memory_region(region_name, key, byte_size)
        self._backend.register_system_shared_memory(region_name, key, byte_size)
        self._handles.append(h)

    def cleanup(self):
        try:
            self._backend.unregister_shared_memory(self.region_names())
        except InferenceServerException:
            pass
        for h in self._handles:
            try:
                sysshm.destroy_shared_memory_region(h)
            except InferenceServerException:
                pass
        self._handles = []


class CudaShmInferDataManager(_ShmInferDataManagerBase):
    """Device-resident input staging over
    client_tpu_torch.utils.cuda_shared_memory.  ``device`` is where the
    regions live: ``cuda`` (device ``device_id``) unless the caller passes
    ``"cpu"``, whose regions only an in-process server resolves."""

    region_prefix = "perf_cudashm"

    def __init__(self, *args, device_id=0, completion_sync=False,
                 device=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._device_id = device_id
        self._device = device
        self.completion_sync = completion_sync
        self._handles = []
        self._out_handles = []

    def _make_region(self, region_name, byte_size):
        h = cudashm.create_shared_memory_region(
            region_name, byte_size, self._device_id, device=self._device
        )
        self._handles.append(h)
        return h

    def sync_outputs(self):
        """Read every output region back to the host, so the request
        latency covers the outputs' arrival (--cuda-shm-sync)."""
        for h, byte_size in self._out_handles:
            h.read(0, byte_size)

    def _create_and_register(self, region_name, arrays, total):
        h = self._make_region(region_name, total)
        cudashm.set_shared_memory_region(h, arrays)
        self._backend.register_cuda_shared_memory(
            region_name, cudashm.get_raw_handle(h), self._device_id, total
        )

    def _create_output_region(self, region_name, byte_size):
        h = self._make_region(region_name, byte_size)
        self._out_handles.append((h, byte_size))
        self._backend.register_cuda_shared_memory(
            region_name, cudashm.get_raw_handle(h), self._device_id,
            byte_size
        )

    def cleanup(self):
        try:
            self._backend.unregister_shared_memory(self.region_names())
        except InferenceServerException:
            pass
        for h in self._handles:
            try:
                cudashm.destroy_shared_memory_region(h)
            except InferenceServerException:
                pass
        self._handles = []
        self._out_handles = []


def create_infer_data_manager(backend, data_loader, inputs_meta, outputs_meta,
                              shared_memory=SharedMemoryType.NONE,
                              output_shm_byte_size=0, device_id=0,
                              cuda_completion_sync=False, device=None):
    """Factory (infer_data_manager_factory.h analog).
    ``cuda_completion_sync`` makes each request latency cover reading its
    output regions back; ``device`` places CUDA regions (``cuda`` unless
    the caller passes ``"cpu"``)."""
    if shared_memory == SharedMemoryType.NONE:
        return InferDataManager(backend, data_loader, inputs_meta, outputs_meta)
    if shared_memory == SharedMemoryType.SYSTEM:
        return SystemShmInferDataManager(
            backend, data_loader, inputs_meta, outputs_meta,
            output_byte_size=output_shm_byte_size,
        )
    if shared_memory == SharedMemoryType.CUDA:
        return CudaShmInferDataManager(
            backend, data_loader, inputs_meta, outputs_meta,
            output_byte_size=output_shm_byte_size, device_id=device_id,
            completion_sync=cuda_completion_sync, device=device,
        )
    raise InferenceServerException(
        f"unknown shared memory type '{shared_memory}'"
    )
