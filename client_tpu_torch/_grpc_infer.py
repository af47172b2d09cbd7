"""Typed-contents field of each KServe-v2 datatype (counterpart of the
``_CONTENTS_FIELD`` table in client_tpu/_grpc_infer.py; the rest of that
module is the client's result wrapper, and the port has no client).  The
gRPC frontend (serve/grpc_server.py) reads a ``ModelInferRequest`` input's
``contents`` through it."""

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
