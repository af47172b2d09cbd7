#!/usr/bin/env python
"""INT8 typed-contents gRPC example — parity with the reference's
grpc_explicit_int8_content_client.py: INT8 tensors through the identity
model, input via ``contents.int_contents`` (the proto packs sub-32-bit
integers into the int field), output read back from raw bytes."""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import grpc  # noqa: E402
import numpy as np  # noqa: E402

from client_tpu_torch._grpc_service import SERVICE, METHODS  # noqa: E402
from client_tpu_torch._proto import inference_pb2 as pb  # noqa: E402


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-u", "--url", default="localhost:8001")
    args = parser.parse_args()

    req_cls, resp_cls, _, _ = METHODS["ModelInfer"]
    with grpc.insecure_channel(args.url) as channel:
        infer = channel.unary_unary(
            f"/{SERVICE}/ModelInfer",
            request_serializer=req_cls.SerializeToString,
            response_deserializer=resp_cls.FromString,
        )
        request = pb.ModelInferRequest()
        request.model_name = "identity_int8"
        values = [-128, -1, 0, 1, 127, 42, -42, 7]
        tensor = request.inputs.add()
        tensor.name = "INPUT0"
        tensor.datatype = "INT8"
        tensor.shape.extend([len(values)])
        # INT8 payload rides the shared int contents field (the proto has
        # one integer field for INT8/INT16/INT32 — reference does the same)
        tensor.contents.int_contents.extend(values)

        response = infer(request)
        out = np.frombuffer(response.raw_output_contents[0], dtype=np.int8)
        print("echoed:", out.tolist())
        if out.tolist() != values:
            sys.exit("error: identity mismatch")
    print("PASS: grpc_explicit_int8_content_client")


if __name__ == "__main__":
    main()
