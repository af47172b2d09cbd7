"""Datatype mapping and tensor (de)serialization for the KServe-v2 protocol.

Counterpart of client_tpu/utils/__init__.py (the exception, the dtype
tables, the BYTES/BF16 wire codecs and the tenant header name).  numpy has no bfloat16, so BF16
tensors decode to float32 (exact: every bf16 value is a float32) and
encode from any float array by rounding to nearest even through torch.
The module imports numpy alone: encoding BF16 and the tensor codec
below import torch on first use, and without torch they raise a message
naming it, as the reference's BF16 codec raises without ml_dtypes.

:func:`tensor_raw_bytes` and :func:`tensor_from_raw` carry a tensor's
raw little-endian bytes under the numpy dtype names the JAX package
writes (``"float32"``, ``"bfloat16"``, ...): the fleet tier's KV blocks
and the sequence snapshots travel in that form, so each package reads
the other's.  bf16 goes through a 16-bit integer view, never through a
numpy bf16 dtype, which numpy alone does not have.
"""

import functools
import struct

import numpy as np

from client_tpu_torch import require_torch

__all__ = [
    "InferenceServerException",
    "raise_error",
    "np_to_triton_dtype",
    "triton_to_np_dtype",
    "triton_dtype_element_size",
    "serialize_byte_tensor",
    "deserialize_bytes_tensor",
    "serialize_bf16_tensor",
    "deserialize_bf16_tensor",
    "to_wire_bytes",
    "from_wire_bytes",
    "tensor_raw_bytes",
    "tensor_from_raw",
    "escape_label",
    "serialized_byte_size",
    "SERVER_READY",
    "SERVER_NOT_READY",
    "SERVER_UNREACHABLE",
    "TENANT_HEADER",
    "stamp_tenant",
]

# The wire key tenant identity rides on (HTTP header name / gRPC metadata
# key).  Lives here, not in serve/frontdoor, because both sides speak it:
# the serving front door reads it and the clients stamp it.
TENANT_HEADER = "x-tenant-id"


def stamp_tenant(headers, tenant):
    """Merge a client's tenant identity into *headers* for one request
    (an explicitly passed x-tenant-id, any case, wins)."""
    if tenant is None:
        return headers
    if headers and any(k.lower() == TENANT_HEADER for k in headers):
        return headers
    merged = dict(headers or {})
    merged[TENANT_HEADER] = tenant
    return merged


# Server health states reported by the client's ``server_state()`` verb:
# a draining server answers not-ready, a dead one never answers.
SERVER_READY = "READY"
SERVER_NOT_READY = "NOT_READY"
SERVER_UNREACHABLE = "UNREACHABLE"


class InferenceServerException(Exception):
    """Error raised for any server-reported or client-side protocol failure."""

    def __init__(self, msg, status=None, debug_details=None):
        self._msg = msg
        self._status = status
        self._debug_details = debug_details
        super().__init__(msg)

    def __str__(self):
        msg = self._msg if self._msg is not None else "Unknown error"
        if self._status is not None:
            msg = f"[{self._status}] {msg}"
        return msg

    def message(self):
        """The error message string."""
        return self._msg

    def status(self):
        """Protocol-specific status code (HTTP status)."""
        return self._status

    def debug_details(self):
        """Any low-level exception or payload that accompanied the failure."""
        return self._debug_details


def raise_error(msg):
    """Raise an InferenceServerException with *msg* and no status."""
    raise InferenceServerException(msg=msg)


def escape_label(value):
    """Escape a Prometheus label value (backslash, quote, newline): the
    server's /metrics renderer and the perf scraper share it."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


# KServe-v2 datatype string <-> numpy dtype tables (the protocol's names)
_NP_TO_TRITON = {
    np.dtype(np.bool_): "BOOL",
    np.dtype(np.int8): "INT8",
    np.dtype(np.int16): "INT16",
    np.dtype(np.int32): "INT32",
    np.dtype(np.int64): "INT64",
    np.dtype(np.uint8): "UINT8",
    np.dtype(np.uint16): "UINT16",
    np.dtype(np.uint32): "UINT32",
    np.dtype(np.uint64): "UINT64",
    np.dtype(np.float16): "FP16",
    np.dtype(np.float32): "FP32",
    np.dtype(np.float64): "FP64",
}
_TRITON_TO_NP = {v: k for k, v in _NP_TO_TRITON.items()}
_TRITON_TO_NP["BYTES"] = np.dtype(np.object_)

# sizeof on the wire for fixed-width types (BYTES is length-prefixed)
_TRITON_ELEMENT_SIZE = {
    "BOOL": 1,
    "INT8": 1,
    "INT16": 2,
    "INT32": 4,
    "INT64": 8,
    "UINT8": 1,
    "UINT16": 2,
    "UINT32": 4,
    "UINT64": 8,
    "FP16": 2,
    "BF16": 2,
    "FP32": 4,
    "FP64": 8,
}


def np_to_triton_dtype(np_dtype):
    """Map a numpy dtype to its KServe datatype string (None if unknown)."""
    dt = np.dtype(np_dtype)
    if dt in _NP_TO_TRITON:
        return _NP_TO_TRITON[dt]
    if dt.kind in ("O", "S", "U"):
        return "BYTES"
    return None


def triton_to_np_dtype(dtype):
    """Map a KServe datatype string to a numpy dtype (BF16 -> float32, the
    dtype BF16 tensors decode to)."""
    if dtype == "BF16":
        return np.dtype(np.float32)
    return _TRITON_TO_NP.get(dtype, None)


def triton_dtype_element_size(dtype):
    """Bytes per element on the wire for fixed-width datatypes; None for
    BYTES."""
    return _TRITON_ELEMENT_SIZE.get(dtype, None)


def _iter_elements_as_bytes(input_tensor):
    flat = np.ascontiguousarray(input_tensor).flatten()
    for obj in flat:
        if isinstance(obj, (bytes, bytearray)):  # covers np.bytes_
            yield bytes(obj)
        else:
            yield str(obj).encode("utf-8")


def serialize_byte_tensor(input_tensor):
    """Serialize a BYTES tensor: each element as <u32le length><payload>,
    row-major.  Returns a 1-D uint8 array whose buffer is the wire payload."""
    if input_tensor.size == 0:
        return np.empty([0], dtype=np.object_)
    if input_tensor.dtype != np.object_ and input_tensor.dtype.type not in (
        np.bytes_,
        np.str_,
    ):
        raise_error("cannot serialize bytes tensor: invalid datatype")
    parts = []
    for b in _iter_elements_as_bytes(input_tensor):
        parts.append(struct.pack("<I", len(b)))
        parts.append(b)
    return np.frombuffer(b"".join(parts), dtype=np.uint8)


def deserialize_bytes_tensor(encoded_tensor, max_elements=None):
    """Inverse of serialize_byte_tensor: wire payload -> 1-D object array of
    bytes.  ``max_elements`` stops after that many elements: a shared-memory
    region's tail beyond the tensor is arbitrary bytes."""
    strs = []
    offset = 0
    view = memoryview(encoded_tensor)
    n = len(view)
    while offset < n and (max_elements is None or len(strs) < max_elements):
        if offset + 4 > n:
            raise_error("malformed BYTES tensor: truncated length prefix")
        (length,) = struct.unpack_from("<I", view, offset)
        offset += 4
        if offset + length > n:
            raise_error("malformed BYTES tensor: element overruns payload")
        strs.append(bytes(view[offset : offset + length]))
        offset += length
    return np.array(strs, dtype=np.object_)


def serialize_bf16_tensor(input_tensor):
    """Serialize a float tensor to BF16 wire bytes (round to nearest even);
    returns a uint8 view of the 2-byte little-endian words."""
    arr = np.asarray(input_tensor)
    if arr.dtype.kind != "f":
        raise_error("cannot serialize bf16 tensor: invalid datatype")
    try:
        torch = require_torch("BF16 encoding")
    except ModuleNotFoundError as e:
        raise InferenceServerException(str(e)) from e
    words = (
        torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
        .to(torch.bfloat16)
        .view(torch.int16)
        .numpy()
    )
    return np.frombuffer(words.astype("<i2").tobytes(), dtype=np.uint8)


def deserialize_bf16_tensor(encoded_tensor):
    """Inverse of serialize_bf16_tensor -> 1-D float32 array (exact)."""
    words = np.frombuffer(bytes(encoded_tensor), dtype="<u2").astype(np.uint32)
    return (words << 16).view(np.float32)


def serialized_byte_size(np_array):
    """Wire size in bytes of *np_array* (length-prefixed accounting for BYTES)."""
    if np_array.dtype == np.object_ or np_array.dtype.type in (np.bytes_, np.str_):
        total = 0
        for b in _iter_elements_as_bytes(np_array):
            total += 4 + len(b)
        return total
    return np_array.nbytes


def to_wire_bytes(array, datatype):
    """Array -> contiguous little-endian wire bytes for *datatype*."""
    arr = np.asarray(array)
    if datatype == "BYTES":
        return serialize_byte_tensor(arr).tobytes()
    if datatype == "BF16":
        return serialize_bf16_tensor(arr).tobytes()
    expected = triton_to_np_dtype(datatype)
    if expected is None:
        raise_error(f"unsupported datatype {datatype}")
    if arr.dtype != expected:
        raise_error(
            f"input array dtype {arr.dtype} does not match datatype {datatype}"
        )
    return np.ascontiguousarray(arr).tobytes()


def from_wire_bytes(buf, datatype, shape):
    """Wire bytes -> numpy array of *datatype* reshaped to *shape*.

    Fixed-width datatypes decode as a read-only zero-copy ``np.frombuffer``
    view over *buf*; BF16 widens to a float32 copy.
    """
    if datatype == "BYTES":
        arr = deserialize_bytes_tensor(
            buf if isinstance(buf, bytes) else bytes(buf)
        )
    elif datatype == "BF16":
        arr = deserialize_bf16_tensor(buf)
    else:
        np_dtype = triton_to_np_dtype(datatype)
        if np_dtype is None:
            raise_error(f"unsupported datatype {datatype}")
        arr = np.frombuffer(buf, dtype=np_dtype)
    return arr.reshape(shape)


@functools.cache
def _torch_dtype_names():
    """torch dtype -> the numpy dtype name the JAX package writes for it
    (built on first use: the table needs torch)."""
    torch = require_torch("the tensor codec")
    return {
        torch.bool: "bool",
        torch.int8: "int8",
        torch.uint8: "uint8",
        torch.int16: "int16",
        torch.int32: "int32",
        torch.int64: "int64",
        torch.float16: "float16",
        torch.bfloat16: "bfloat16",
        torch.float32: "float32",
        torch.float64: "float64",
    }


@functools.cache
def _torch_dtypes():
    return {name: dt for dt, name in _torch_dtype_names().items()}


def tensor_raw_bytes(tensor):
    """``(dtype name, raw little-endian bytes)`` of a tensor (copied to
    the host when it lies on a device)."""
    torch = require_torch("the tensor codec")
    t = tensor.detach().to("cpu").contiguous()
    name = _torch_dtype_names().get(t.dtype)
    if name is None:
        raise_error(f"no wire name for dtype {t.dtype}")
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return name, t.numpy().tobytes()


def tensor_from_raw(raw, dtype_name, shape):
    """A CPU tensor of *shape* from raw bytes written under *dtype_name*
    (the inverse of :func:`tensor_raw_bytes`, and the reader of the JAX
    package's ``str(array.dtype)`` + ``tobytes()``).  Raises ValueError on
    an unknown name or a size that does not match the shape."""
    torch = require_torch("the tensor codec")
    dtype = _torch_dtypes().get(str(dtype_name))
    if dtype is None:
        raise ValueError(f"unknown dtype name {dtype_name!r}")
    carrier = torch.int16 if dtype == torch.bfloat16 else dtype
    shape = [int(d) for d in shape]
    try:
        if not raw:
            flat = torch.empty((0,), dtype=carrier)
        else:
            flat = torch.frombuffer(bytearray(raw), dtype=carrier)
        return flat.view(dtype).reshape(shape)
    except RuntimeError as e:
        raise ValueError(f"{dtype_name} payload does not fit {shape}: {e}")
