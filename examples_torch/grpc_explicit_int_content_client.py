#!/usr/bin/env python
"""Typed-contents gRPC example — parity with the reference's
grpc_explicit_int_content_client.py: INT32 inputs ride the proto's
``contents.int_contents`` repeated field instead of raw_input_contents,
exercising the server's typed-tensor decode path."""

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
        request.model_name = "simple"
        input0 = list(range(16))
        input1 = [2] * 16
        for name, values in (("INPUT0", input0), ("INPUT1", input1)):
            tensor = request.inputs.add()
            tensor.name = name
            tensor.datatype = "INT32"
            tensor.shape.extend([1, 16])
            tensor.contents.int_contents.extend(values)  # typed, not raw

        response = infer(request)
        raw = response.raw_output_contents
        by_name = {
            out.name: np.frombuffer(raw[i], dtype=np.int32)
            for i, out in enumerate(response.outputs)
        }
        for i in range(16):
            print(f"{input0[i]} + {input1[i]} = {by_name['OUTPUT0'][i]}")
            if (by_name["OUTPUT0"][i] != input0[i] + input1[i]
                    or by_name["OUTPUT1"][i] != input0[i] - input1[i]):
                sys.exit("error: incorrect result")
    print("PASS: grpc_explicit_int_content_client")


if __name__ == "__main__":
    main()
