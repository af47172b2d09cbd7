"""Shared gRPC request-building and result-parsing.

Counterpart of client_tpu/_grpc_infer.py, copied onto the port's own
protos and codecs: ``set_infer_parameter``, ``build_infer_request``
(InferInput/InferRequestedOutput lists -> ``ModelInferRequest``), the
``_CONTENTS_FIELD`` table the gRPC frontend (serve/grpc_server.py) also
reads, and ``InferResult``, the gRPC client's result wrapper.
"""

import numpy as np

from client_tpu_torch._proto import inference_pb2 as pb
from client_tpu_torch.utils import (
    InferenceServerException,
    from_wire_bytes,
    to_wire_bytes,
    triton_to_np_dtype,
)


def set_infer_parameter(param, value):
    """Assign a python value to an InferParameter oneof."""
    if isinstance(value, bool):
        param.bool_param = value
    elif isinstance(value, int):
        param.int64_param = value
    elif isinstance(value, float):
        param.double_param = value
    elif isinstance(value, str):
        param.string_param = value
    else:
        raise InferenceServerException(
            f"unsupported parameter type {type(value).__name__}"
        )


def build_infer_request(
    model_name,
    inputs,
    model_version="",
    outputs=None,
    request_id="",
    sequence_id=0,
    sequence_start=False,
    sequence_end=False,
    priority=0,
    timeout=None,
    parameters=None,
):
    """InferInput/InferRequestedOutput lists -> ModelInferRequest proto."""
    request = pb.ModelInferRequest(
        model_name=model_name, model_version=str(model_version or "")
    )
    if request_id:
        request.id = request_id
    if sequence_id:
        if isinstance(sequence_id, str):
            request.parameters["sequence_id"].string_param = sequence_id
        else:
            request.parameters["sequence_id"].int64_param = sequence_id
        request.parameters["sequence_start"].bool_param = bool(sequence_start)
        request.parameters["sequence_end"].bool_param = bool(sequence_end)
    if priority:
        request.parameters["priority"].int64_param = priority
    if timeout is not None:
        request.parameters["timeout"].int64_param = timeout
    for key, value in (parameters or {}).items():
        if key in ("sequence_id", "sequence_start", "sequence_end", "priority",
                   "timeout", "binary_data_output"):
            raise InferenceServerException(
                f"parameter '{key}' is reserved; use the dedicated argument"
            )
        set_infer_parameter(request.parameters[key], value)

    for inp in inputs:
        tensor = request.inputs.add()
        tensor.name = inp.name()
        tensor.datatype = inp.datatype()
        tensor.shape.extend(inp.shape())
        params = inp.parameters()
        if "shared_memory_region" in params:
            tensor.parameters["shared_memory_region"].string_param = params[
                "shared_memory_region"
            ]
            tensor.parameters["shared_memory_byte_size"].int64_param = params[
                "shared_memory_byte_size"
            ]
            if params.get("shared_memory_offset"):
                tensor.parameters["shared_memory_offset"].int64_param = params[
                    "shared_memory_offset"
                ]
        else:
            raw = inp.raw_data()
            if raw is None and inp.nonbinary_data() is not None:
                # gRPC has no JSON mode; payload set with binary_data=False still
                # travels as raw bytes.
                arr = np.array(inp.nonbinary_data())
                raw = to_wire_bytes(
                    arr.astype(_np_dtype_for(inp.datatype())), inp.datatype()
                )
            if raw is None:
                raise InferenceServerException(
                    f"input '{inp.name()}' has no data; call set_data_from_numpy "
                    "or set_shared_memory"
                )
            request.raw_input_contents.append(raw)

    for out in outputs or []:
        requested = request.outputs.add()
        requested.name = out.name()
        params = out.parameters()
        if "shared_memory_region" in params:
            requested.parameters["shared_memory_region"].string_param = params[
                "shared_memory_region"
            ]
            requested.parameters["shared_memory_byte_size"].int64_param = params[
                "shared_memory_byte_size"
            ]
            if params.get("shared_memory_offset"):
                requested.parameters["shared_memory_offset"].int64_param = params[
                    "shared_memory_offset"
                ]
        elif params.get("classification"):
            requested.parameters["classification"].int64_param = params[
                "classification"
            ]
    return request


def _np_dtype_for(datatype):
    dt = triton_to_np_dtype(datatype)
    if dt is None:
        raise InferenceServerException(f"unsupported datatype {datatype}")
    return dt


_CONTENTS_FIELD = {
    "BOOL": "bool_contents",
    "INT8": "int_contents",
    "INT16": "int_contents",
    "INT32": "int_contents",
    "INT64": "int64_contents",
    "UINT8": "uint_contents",
    "UINT16": "uint_contents",
    "UINT32": "uint_contents",
    "UINT64": "uint64_contents",
    "FP32": "fp32_contents",
    "FP64": "fp64_contents",
    "BYTES": "bytes_contents",
}


class InferResult:
    """Wraps a ModelInferResponse; ``as_numpy`` decodes raw or typed contents."""

    def __init__(self, response):
        self._response = response
        self._index_of = {}
        self._raw_index_of = {}
        raw_cursor = 0
        for i, out in enumerate(response.outputs):
            self._index_of[out.name] = i
            # raw_output_contents holds one entry per non-shared-memory output,
            # in output order; shm outputs consume no raw slot.
            if "shared_memory_region" in out.parameters:
                continue
            if raw_cursor < len(response.raw_output_contents):
                self._raw_index_of[out.name] = raw_cursor
                raw_cursor += 1

    def get_response(self, as_json=False):
        if as_json:
            from google.protobuf import json_format

            return json_format.MessageToDict(
                self._response, preserving_proto_field_name=True
            )
        return self._response

    def get_output(self, name, as_json=False):
        i = self._index_of.get(name)
        if i is None:
            return None
        out = self._response.outputs[i]
        if as_json:
            from google.protobuf import json_format

            return json_format.MessageToDict(out, preserving_proto_field_name=True)
        return out

    def as_numpy(self, name):
        i = self._index_of.get(name)
        if i is None:
            return None
        out = self._response.outputs[i]
        shape = list(out.shape)
        if name in self._raw_index_of:
            raw = self._response.raw_output_contents[self._raw_index_of[name]]
            return from_wire_bytes(raw, out.datatype, shape)
        field = _CONTENTS_FIELD.get(out.datatype)
        if field is None:
            raise InferenceServerException(
                f"unsupported datatype {out.datatype}"
            )
        values = getattr(out.contents, field)
        if out.datatype == "BYTES":
            return np.array(list(values), dtype=np.object_).reshape(shape)
        return np.array(values, dtype=_np_dtype_for(out.datatype)).reshape(shape)
