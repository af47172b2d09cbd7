#!/usr/bin/env python
"""BYTES typed-contents gRPC example — parity with the reference's
grpc_explicit_byte_content_client.py: string tensors ride
``contents.bytes_contents`` (one proto bytes entry per element, no 4-byte
length framing) through the string add/sub model."""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import grpc  # noqa: E402

from client_tpu_torch._grpc_service import SERVICE, METHODS  # noqa: E402
from client_tpu_torch._proto import inference_pb2 as pb  # noqa: E402
from client_tpu_torch.utils import deserialize_bytes_tensor  # noqa: E402


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
        request.model_name = "simple_string"
        input0 = [str(i) for i in range(16)]
        input1 = [str(3) for _ in range(16)]
        for name, values in (("INPUT0", input0), ("INPUT1", input1)):
            tensor = request.inputs.add()
            tensor.name = name
            tensor.datatype = "BYTES"
            tensor.shape.extend([1, 16])
            tensor.contents.bytes_contents.extend(
                v.encode() for v in values
            )  # element-per-entry, no length framing

        response = infer(request)
        raw = response.raw_output_contents
        by_name = {
            out.name: deserialize_bytes_tensor(raw[i]).flatten()
            for i, out in enumerate(response.outputs)
        }
        for i in range(16):
            total = by_name["OUTPUT0"][i].decode()
            print(f"{input0[i]} + {input1[i]} = {total}")
            if int(total) != i + 3:
                sys.exit("error: incorrect string sum")
    print("PASS: grpc_explicit_byte_content_client")


if __name__ == "__main__":
    main()
