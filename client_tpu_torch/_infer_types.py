"""Transport-independent inference value types.

Counterpart of client_tpu/_infer_types.py: one implementation holds the
tensor payload and attributes of a request's inputs and requested
outputs, and the gRPC client (client_tpu_torch/grpc) and the perf
harness's in-process backend render it at request-build time.  Where the
reference's ``set_data_from_array`` takes a ``jax.Array``, the port's
takes a torch tensor on any device (a BF16 tensor keeps its own bits).
The module imports numpy alone: a tensor is recognised through the torch
the caller has loaded, as the reference recognises a ``jax.Array``.
"""

import numpy as np

from client_tpu_torch import is_tensor, loaded_torch
from client_tpu_torch.utils import (
    InferenceServerException,
    np_to_triton_dtype,
    raise_error,
    tensor_raw_bytes,
    to_wire_bytes,
    triton_to_np_dtype,
)


class InferInput:
    """One named input tensor of an inference request.

    Payload is either wire bytes (``_raw_data``), a JSON-able nested list
    (``_data``, non-binary mode), or a shared-memory reference.
    """

    def __init__(self, name, shape, datatype):
        self._name = name
        self._shape = list(shape)
        self._datatype = datatype
        self._parameters = {}
        self._raw_data = None
        self._data = None  # non-binary (JSON) payload

    def name(self):
        return self._name

    def datatype(self):
        return self._datatype

    def shape(self):
        return self._shape

    def set_shape(self, shape):
        self._shape = list(shape)
        return self

    def parameters(self):
        return self._parameters

    def raw_data(self):
        """Wire bytes if set via binary path, else None."""
        return self._raw_data

    def nonbinary_data(self):
        """JSON-able payload if set via binary_data=False, else None."""
        return self._data

    def _set_raw(self, raw):
        self._parameters.pop("shared_memory_region", None)
        self._parameters.pop("shared_memory_byte_size", None)
        self._parameters.pop("shared_memory_offset", None)
        self._data = None
        self._raw_data = raw
        self._parameters["binary_data_size"] = len(raw)
        return self

    def _check_shape(self, shape):
        if list(shape) != self._shape:
            raise_error(
                f"got unexpected numpy array shape {list(shape)}, "
                f"expected {self._shape}"
            )

    def set_data_from_numpy(self, input_tensor, binary_data=True):
        """Attach tensor data. Validates dtype and shape against this input.

        With ``binary_data=False`` the values travel in the JSON header (not
        valid for FP16/BF16, which JSON cannot represent — protocol rule).
        """
        if not isinstance(input_tensor, np.ndarray):
            raise_error("input tensor must be a numpy array")
        dtype = np_to_triton_dtype(input_tensor.dtype)
        if self._datatype != dtype:
            raise_error(
                f"got unexpected datatype {dtype} from numpy array, "
                f"expected {self._datatype}"
            )
        self._check_shape(input_tensor.shape)
        if binary_data:
            return self._set_raw(to_wire_bytes(input_tensor, self._datatype))
        if self._datatype in ("FP16", "BF16"):
            raise_error(
                f"{self._datatype} tensors must use binary_data=True "
                "(JSON cannot represent them)"
            )
        self._parameters.pop("shared_memory_region", None)
        self._parameters.pop("shared_memory_byte_size", None)
        self._parameters.pop("shared_memory_offset", None)
        self._raw_data = None
        self._parameters.pop("binary_data_size", None)
        if self._datatype == "BYTES":
            self._data = [
                b.decode("utf-8") if isinstance(b, bytes) else str(b)
                for b in input_tensor.flatten()
            ]
        else:
            self._data = [v.item() for v in input_tensor.flatten()]
        return self

    def set_data_from_array(self, device_array, binary_data=True):
        """Attach a torch tensor on any device (or anything np.asarray
        accepts).  The device-to-host copy happens here, once; for zero
        host copies use CUDA shared memory
        (client_tpu_torch.utils.cuda_shared_memory) + ``set_shared_memory``.
        A bfloat16 tensor is sent as BF16 bit for bit."""
        if is_tensor(device_array):
            t = device_array.detach()
            if t.dtype == loaded_torch().bfloat16:
                if self._datatype != "BF16":
                    raise_error(
                        "device array datatype BF16 does not match input "
                        f"{self._datatype}"
                    )
                if not binary_data:
                    raise_error(
                        "BF16 tensors must use binary_data=True "
                        "(JSON cannot represent them)"
                    )
                self._check_shape(t.shape)
                return self._set_raw(tensor_raw_bytes(t)[1])
            arr = t.cpu().numpy()
        else:
            arr = np.asarray(device_array)
        got = np_to_triton_dtype(arr.dtype)
        if got != self._datatype:
            raise_error(
                f"device array datatype {got} does not match input "
                f"{self._datatype}"
            )
        return self.set_data_from_numpy(arr, binary_data=binary_data)

    def set_shared_memory(self, region_name, byte_size, offset=0):
        """Reference a registered shared-memory region instead of inline bytes."""
        self._data = None
        self._raw_data = None
        self._parameters.pop("binary_data_size", None)
        self._parameters["shared_memory_region"] = region_name
        self._parameters["shared_memory_byte_size"] = byte_size
        if offset:
            self._parameters["shared_memory_offset"] = offset
        return self

    def reset(self):
        """Drop payload + payload parameters so the object can be reused."""
        self._raw_data = None
        self._data = None
        for k in (
            "binary_data_size",
            "shared_memory_region",
            "shared_memory_byte_size",
            "shared_memory_offset",
        ):
            self._parameters.pop(k, None)
        return self


class InferRequestedOutput:
    """One requested output: binary/JSON rendering, classification, or shm target."""

    def __init__(self, name, binary_data=True, class_count=0):
        self._name = name
        self._parameters = {}
        self._binary = binary_data
        if binary_data:
            self._parameters["binary_data"] = True
        if class_count:
            self._parameters["classification"] = class_count

    def name(self):
        return self._name

    def parameters(self):
        return self._parameters

    def set_shared_memory(self, region_name, byte_size, offset=0):
        self._parameters.pop("binary_data", None)
        self._parameters["shared_memory_region"] = region_name
        self._parameters["shared_memory_byte_size"] = byte_size
        if offset:
            self._parameters["shared_memory_offset"] = offset
        return self

    def unset_shared_memory(self):
        self._parameters.pop("shared_memory_region", None)
        self._parameters.pop("shared_memory_byte_size", None)
        self._parameters.pop("shared_memory_offset", None)
        if self._binary:
            self._parameters["binary_data"] = True
        return self


def _np_from_json_data(data, datatype, shape):
    if datatype == "BYTES":
        flat = [
            d.encode("utf-8") if isinstance(d, str) else bytes(d) for d in data
        ]
        return np.array(flat, dtype=np.object_).reshape(shape)
    np_dtype = triton_to_np_dtype(datatype)
    if np_dtype is None:
        raise InferenceServerException(f"unsupported datatype {datatype}")
    return np.array(data, dtype=np_dtype).reshape(shape)
