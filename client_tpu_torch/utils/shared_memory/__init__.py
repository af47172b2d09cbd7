"""System shared-memory utilities: POSIX regions under ``/dev/shm``.

Counterpart of client_tpu/utils/shared_memory (the reference client's
``tritonclient.utils.shared_memory`` API): create, fill, read and destroy
regions that a KServe-v2 server maps by key, and a process-local list of
the regions this process mapped.  Where the JAX package loads its native
library, this module maps ``/dev/shm/<key>`` with ``os.open`` and
``mmap`` directly.
"""

import mmap
import os
import threading

import numpy as np

from client_tpu_torch.utils import (
    InferenceServerException,
    deserialize_bytes_tensor,
    from_wire_bytes,
    np_to_triton_dtype,
    serialize_byte_tensor,
    triton_to_np_dtype,
)


def shm_path(key):
    """The file behind a POSIX shm key (``/name`` or ``name``)."""
    return "/dev/shm/" + key.lstrip("/")


class SharedMemoryRegion:
    """One created-or-attached system shm region."""

    def __init__(self, triton_shm_name, shm_key, byte_size, mm):
        self._triton_shm_name = triton_shm_name
        self._shm_key = shm_key
        self._byte_size = byte_size
        self._mmap = mm

    def _span(self, offset, nbytes, what):
        if offset < 0 or nbytes < 0 or offset + nbytes > self._byte_size:
            raise InferenceServerException(
                f"{what} of {nbytes} bytes at offset {offset} overruns "
                f"shared memory region '{self._triton_shm_name}' "
                f"({self._byte_size} bytes)")
        if self._mmap is None:
            raise InferenceServerException(
                f"shared memory region '{self._triton_shm_name}' is "
                "destroyed")
        return self._mmap

    def write(self, offset, data):
        data = memoryview(data).cast("B")
        mm = self._span(offset, len(data), "write")
        mm[offset:offset + len(data)] = data

    def read(self, offset, nbytes):
        mm = self._span(offset, nbytes, "read")
        return bytes(mm[offset:offset + nbytes])


# name -> SharedMemoryRegion, mirroring the reference's mapped_shm_regions
_mapped_regions = {}
_lock = threading.Lock()


def create_shared_memory_region(triton_shm_name, shm_key, byte_size,
                                create=True):
    """Create (or attach to, with ``create=False``) a POSIX shm region of
    ``byte_size`` bytes under ``shm_key``, mapped read-write."""
    flags = os.O_RDWR | (os.O_CREAT if create else 0)
    try:
        fd = os.open(shm_path(shm_key), flags, 0o600)
    except OSError as e:
        raise InferenceServerException(
            f"unable to create shared memory region '{shm_key}': {e}") from e
    try:
        if create:
            os.ftruncate(fd, byte_size)
        mm = mmap.mmap(fd, byte_size)
    except (OSError, ValueError) as e:
        raise InferenceServerException(
            f"unable to map {byte_size} bytes of shared memory region "
            f"'{shm_key}': {e}") from e
    finally:
        os.close(fd)
    region = SharedMemoryRegion(triton_shm_name, shm_key, byte_size, mm)
    with _lock:
        _mapped_regions[triton_shm_name] = region
    return region


def set_shared_memory_region(shm_handle, input_values, offset=0):
    """Copy a list of numpy arrays into the region back to back from
    ``offset`` (BYTES arrays in their wire serialization)."""
    if not isinstance(input_values, (list, tuple)):
        raise InferenceServerException(
            "input_values must be a list of numpy arrays")
    cur = offset
    for arr in input_values:
        arr = np.asarray(arr)
        if arr.dtype == np.object_ or arr.dtype.type in (np.bytes_, np.str_):
            raw = serialize_byte_tensor(arr)
        else:
            raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
        shm_handle.write(cur, raw)
        cur += raw.nbytes


def get_contents_as_numpy(shm_handle, datatype, shape, offset=0):
    """A copy of the tensor of ``(datatype, shape)`` at ``offset``;
    ``datatype`` is a numpy dtype or a KServe datatype string."""
    return contents_as_numpy(shm_handle.read, shm_handle._byte_size,
                             datatype, shape, offset)


def contents_as_numpy(read, byte_size, datatype, shape, offset=0):
    """The tensor of ``(datatype, shape)`` at ``offset`` of a region of
    ``byte_size`` bytes whose ``read(offset, nbytes)`` returns bytes."""
    wire = datatype if isinstance(datatype, str) else np_to_triton_dtype(
        np.dtype(datatype))
    count = int(np.prod(shape)) if len(shape) else 1
    if wire == "BYTES":
        # the region's tail past the tensor is arbitrary bytes, not
        # length-prefixed data: stop at exactly count elements
        flat = deserialize_bytes_tensor(read(offset, byte_size - offset),
                                        max_elements=count)
        if flat.size < count:
            raise InferenceServerException(
                f"region holds {flat.size} BYTES elements, need {count}")
        return flat.reshape(shape)
    np_dtype = triton_to_np_dtype(wire)
    if np_dtype is None:
        raise InferenceServerException(f"unsupported datatype {datatype}")
    itemsize = 2 if wire == "BF16" else np.dtype(np_dtype).itemsize
    raw = read(offset, count * itemsize)
    return np.array(from_wire_bytes(raw, wire, list(shape)))


def mapped_shared_memory_regions():
    """Names of the regions this process has mapped."""
    with _lock:
        return list(_mapped_regions)


def destroy_shared_memory_region(shm_handle, unlink=True):
    """Unmap the region and (by default) unlink its shm key."""
    with _lock:
        _mapped_regions.pop(shm_handle._triton_shm_name, None)
    mm, shm_handle._mmap = shm_handle._mmap, None
    if mm is not None:
        mm.close()
    if unlink:
        try:
            os.unlink(shm_path(shm_handle._shm_key))
        except FileNotFoundError:
            pass
