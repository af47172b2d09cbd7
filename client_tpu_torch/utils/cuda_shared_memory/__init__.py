"""CUDA shared-memory transport: device regions shared over CUDA IPC.

Counterpart of client_tpu/utils/tpu_shared_memory, whose API mirrors the
reference client's ``tritonclient.utils.cuda_shared_memory``: this module
is that API again, over cudart.  A region is one flat device allocation
(``cudaMalloc``) exported as a 64-byte ``cudaIpcMemHandle_t``, the raw
handle a client registers with ``register_cuda_shared_memory``.  A server
in another process opens the handle (``cudaIpcOpenMemHandle``) and reads
and writes the same device memory: no host copy on either side.  The
native half is ``cudashm.cpp``, built at first use (``_build.py``).

Where the JAX package keeps device-array slots, dirty ranges and a lazily
synced host window (PJRT has no IPC export), a region here is one flat
device buffer: a byte read or write at any offset is a copy of a slice of
it, and ``get_contents_as_torch`` is a live view of it.

``cudaIpcOpenMemHandle`` refuses a handle the same process made, so a
process-local broker, keyed by the handle's bytes, resolves the regions
this process created (``resolve_inprocess``): an in-process server uses
them directly.  ``device="cpu"`` (and only that) makes a region a CPU
uint8 tensor that only the broker resolves, so the whole server path runs
on a machine without CUDA; without CUDA and without ``device="cpu"``,
creating a region raises.

Ordering across processes: ``set_shared_memory_region`` waits for its
copies before it returns, and the server waits for its output copies
before it answers, so each side reads what the other wrote.  Destroy a
region only after every server that opened it has unregistered it.
"""

import threading
import uuid

import numpy as np
import torch

from client_tpu_torch import resolve_device
from client_tpu_torch.utils import (
    InferenceServerException,
    serialize_byte_tensor,
)
from client_tpu_torch.utils.shared_memory import contents_as_numpy

HANDLE_BYTES = 64  # sizeof(cudaIpcMemHandle_t)

# KServe datatype -> the torch dtype a region's bytes are viewed as
TORCH_DTYPES = {
    "BOOL": torch.bool, "INT8": torch.int8, "INT16": torch.int16,
    "INT32": torch.int32, "INT64": torch.int64, "UINT8": torch.uint8,
    "UINT16": torch.uint16, "UINT32": torch.uint32, "UINT64": torch.uint64,
    "FP16": torch.float16, "FP32": torch.float32, "FP64": torch.float64,
    "BF16": torch.bfloat16,
}


def _torch_dtype(datatype):
    if isinstance(datatype, torch.dtype):
        return datatype
    if not isinstance(datatype, str):
        return torch.from_numpy(np.zeros(0, dtype=datatype)).dtype
    dtype = TORCH_DTYPES.get(datatype)
    if dtype is None:
        raise InferenceServerException(
            f"a {datatype} tensor has no typed view in a region")
    return dtype


def typed_view(flat, offset, byte_size, datatype, shape):
    """The tensor of ``(datatype, shape)`` in ``byte_size`` bytes at
    ``offset`` of the uint8 tensor ``flat``: a view (no copy, no
    synchronization) wherever the offset is aligned to the element size."""
    dtype = _torch_dtype(datatype)
    count = int(np.prod(shape)) if len(shape) else 1
    itemsize = torch.empty(0, dtype=dtype).element_size()
    if byte_size != count * itemsize:
        raise InferenceServerException(
            f"{byte_size} bytes cannot hold a {list(shape)} tensor of "
            f"{dtype}", status="400")
    if offset < 0 or offset + byte_size > flat.numel():
        raise InferenceServerException(
            f"{byte_size} bytes at offset {offset} overrun a region of "
            f"{flat.numel()} bytes", status="400")
    raw = flat.narrow(0, offset, byte_size)
    if raw.storage_offset() % itemsize:
        # view(dtype) needs an aligned start: an unaligned tensor is read
        # by a copy into a fresh tensor, right but not zero-copy
        raw = raw.clone()
    return raw.view(dtype).reshape(shape)


def _as_bytes(value):
    """A tensor, numpy array or bytes-like value as a flat uint8 tensor
    of its bytes (BYTES arrays in their wire serialization)."""
    if isinstance(value, torch.Tensor):
        return value.detach().contiguous().reshape(-1).view(torch.uint8)
    if not isinstance(value, np.ndarray):
        value = np.frombuffer(bytes(value), dtype=np.uint8)
    if value.dtype == np.object_ or value.dtype.type in (np.bytes_, np.str_):
        raw = serialize_byte_tensor(value)
    else:
        raw = np.ascontiguousarray(value).reshape(-1).view(np.uint8)
    # torch.from_numpy needs a writable array; a wire view is read-only
    return torch.from_numpy(np.require(raw, requirements=["W"]))


class CudaRegion:
    """One region: ``tensor``, a flat uint8 tensor of ``byte_size`` bytes
    on its device, and the raw handle that names it.  ``mapping`` is the
    native allocation or IPC mapping (None for a CPU region); the memory
    stays until the region is closed and every view of it is gone."""

    def __init__(self, name, byte_size, device_id, tensor, handle,
                 mapping=None):
        self.name = name
        self.byte_size = byte_size
        self.device_id = device_id
        self.tensor = tensor
        self._handle = handle
        self._mapping = mapping

    def raw_handle(self):
        return self._handle

    def span(self, offset, nbytes):
        """The uint8 view of ``nbytes`` bytes at ``offset``."""
        tensor = self.tensor
        if tensor is None:
            raise InferenceServerException(
                f"CUDA shared memory region '{self.name}' is closed")
        if offset < 0 or nbytes < 0 or offset + nbytes > self.byte_size:
            raise InferenceServerException(
                f"{nbytes} bytes at offset {offset} overrun CUDA shared "
                f"memory region '{self.name}' ({self.byte_size} bytes)",
                status="400")
        return tensor.narrow(0, offset, nbytes)

    def write(self, offset, data):
        """Copy ``data`` (bytes-like, a numpy array or a tensor) into the
        region at ``offset``; returns the bytes written.  The copy is
        queued on the current stream: ``sync`` waits for it."""
        src = _as_bytes(data)
        self.span(offset, src.numel()).copy_(src)
        return src.numel()

    def read(self, offset, nbytes):
        """A copy of ``nbytes`` bytes at ``offset`` (a device-to-host copy
        for a CUDA region)."""
        return self.span(offset, nbytes).cpu().numpy().tobytes()

    def sync(self):
        """Wait for the copies queued on the current stream of this
        region's device.  The wait blocks the thread where CUDA's default
        wait would spin a core: a server waits on many threads at once."""
        if self.tensor is not None and self.tensor.is_cuda:
            done = torch.cuda.Event(blocking=True)
            done.record(torch.cuda.current_stream(self.tensor.device))
            done.synchronize()

    def close(self):
        """Drop this object's hold on the memory (views keep it)."""
        self.tensor = None
        self._mapping = None


# Process-local broker: raw handle bytes -> CudaRegion created here
_broker = {}
_broker_lock = threading.Lock()


def resolve_inprocess(raw_handle):
    """The live region this process created under ``raw_handle``, or
    None (a handle of another process)."""
    with _broker_lock:
        return _broker.get(bytes(raw_handle))


def open_region(name, raw_handle, byte_size, device_id=0):
    """Open another process's region by its raw handle (server side).
    Raises with cudart's message if the handle cannot be opened."""
    raw_handle = bytes(raw_handle)
    if len(raw_handle) != HANDLE_BYTES:
        raise InferenceServerException(
            f"CUDA shared memory region '{name}': a raw handle is "
            f"{HANDLE_BYTES} bytes, got {len(raw_handle)}", status="400")
    if not torch.cuda.is_available():
        raise InferenceServerException(
            f"CUDA shared memory region '{name}' is another process's: "
            "opening it needs CUDA, and this server has none", status="400")
    from client_tpu_torch.utils.cuda_shared_memory import _build

    try:
        mapping = _build.extension().open(raw_handle, byte_size, device_id)
    except RuntimeError as e:
        raise InferenceServerException(
            f"unable to open CUDA shared memory region '{name}': {e}",
            status="400") from e
    return CudaRegion(name, byte_size, device_id, mapping.as_tensor(),
                      raw_handle, mapping)


# -- the reference client's cuda_shared_memory API -------------------------


def create_shared_memory_region(triton_shm_name, byte_size, device_id=0,
                                device=None):
    """Allocate a region of ``byte_size`` zeroed bytes on CUDA device
    ``device_id``, or, with ``device="cpu"``, in host memory that only
    this process's server resolves."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        tensor = torch.zeros(byte_size, dtype=torch.uint8)
        handle = (b"client_tpu_torch cpu region "
                  + uuid.uuid4().bytes).ljust(HANDLE_BYTES, b"\0")
        region = CudaRegion(triton_shm_name, byte_size, device_id, tensor,
                            handle)
    elif dev.type == "cuda":
        from client_tpu_torch.utils.cuda_shared_memory import _build

        mapping = _build.extension().create(byte_size, device_id)
        region = CudaRegion(triton_shm_name, byte_size, device_id,
                            mapping.as_tensor(), mapping.handle(), mapping)
        region.tensor.zero_()
        region.sync()
    else:
        raise InferenceServerException(
            f"a CUDA shared memory region lives on cuda or cpu, not {dev}")
    with _broker_lock:
        _broker[region.raw_handle()] = region
    return region


def get_raw_handle(cuda_shm_handle):
    """The 64 bytes to pass to ``register_cuda_shared_memory``."""
    return cuda_shm_handle.raw_handle()


def set_shared_memory_region(cuda_shm_handle, input_values, offset=0):
    """Copy a list of tensors (numpy arrays or torch tensors) into the
    region back to back from ``offset``; returns once the copies are
    done, so another process reads them."""
    if not isinstance(input_values, (list, tuple)):
        raise InferenceServerException(
            "input_values must be a list of tensors")
    cur = offset
    for value in input_values:
        cur += cuda_shm_handle.write(cur, value)
    cuda_shm_handle.sync()


def get_contents_as_numpy(cuda_shm_handle, datatype, shape, offset=0):
    """A host copy of the tensor of ``(datatype, shape)`` at ``offset``;
    ``datatype`` is a numpy dtype or a KServe datatype string."""
    return contents_as_numpy(cuda_shm_handle.read, cuda_shm_handle.byte_size,
                             datatype, shape, offset)


def get_contents_as_torch(cuda_shm_handle, datatype, shape, offset=0):
    """The live tensor of ``(datatype, shape)`` at ``offset``, on the
    region's device: no copy and no synchronization (the counterpart of
    ``get_contents_as_jax``).  ``datatype`` is a KServe datatype string,
    a numpy dtype or a torch dtype."""
    dtype = _torch_dtype(datatype)
    count = int(np.prod(shape)) if len(shape) else 1
    nbytes = count * torch.empty(0, dtype=dtype).element_size()
    return typed_view(cuda_shm_handle.span(offset, nbytes), 0, nbytes,
                      dtype, shape)


def allocated_shared_memory_regions():
    """Names of the regions this process created and has not destroyed."""
    with _broker_lock:
        return [r.name for r in _broker.values()]


def destroy_shared_memory_region(cuda_shm_handle):
    """Release the region: the memory goes once no view of it is left."""
    with _broker_lock:
        _broker.pop(cuda_shm_handle.raw_handle(), None)
    cuda_shm_handle.close()
