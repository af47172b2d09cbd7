"""Generated protobuf modules for the KServe-v2 protocol.

Byte-for-byte copies of client_tpu/_proto/inference_pb2.py and
model_config_pb2.py (generated from proto/inference.proto +
proto/model_config.proto by `make protos`; plain protoc --python_out),
and of tfserve_pb2.py (proto/tfserve.proto: the TF-Serving
PredictionService the perf harness's ``tfserve`` kind speaks; imported
where it is used, not here).
They register the same serialized files in protobuf's default descriptor
pool, so a process that imports both packages gets one set of message
classes; a regenerated or renamed copy would clash with the reference's
registration.
"""

from client_tpu_torch._proto import model_config_pb2  # noqa: F401
from client_tpu_torch._proto import inference_pb2  # noqa: F401
