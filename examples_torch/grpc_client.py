#!/usr/bin/env python
"""Raw-stub gRPC client — parity with the reference's generated-stub
grpc_client.py (reference src/python/examples/grpc_client.py): builds
ModelInferRequest protos by hand over a bare grpc.Channel, no
InferenceServerClient wrapper, showing the wire protocol itself.  The
framework ships no grpcio-tools codegen; the method table in
client_tpu_torch._grpc_service plays the role of the generated stubs."""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import grpc  # noqa: E402
import numpy as np  # noqa: E402

from client_tpu_torch._grpc_service import SERVICE, METHODS  # noqa: E402
from client_tpu_torch._proto import inference_pb2 as pb  # noqa: E402


def _unary(channel, name):
    req_cls, resp_cls, _, _ = METHODS[name]
    return channel.unary_unary(
        f"/{SERVICE}/{name}",
        request_serializer=req_cls.SerializeToString,
        response_deserializer=resp_cls.FromString,
    )


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-u", "--url", default="localhost:8001")
    args = parser.parse_args()

    with grpc.insecure_channel(args.url) as channel:
        live = _unary(channel, "ServerLive")(pb.ServerLiveRequest())
        meta = _unary(channel, "ServerMetadata")(pb.ServerMetadataRequest())
        print(f"live={live.live} server={meta.name}")
        assert live.live

        request = pb.ModelInferRequest()
        request.model_name = "simple"
        request.id = "raw-stub-1"
        input0 = np.arange(16, dtype=np.int32)
        input1 = np.ones(16, dtype=np.int32)
        for name, arr in (("INPUT0", input0), ("INPUT1", input1)):
            tensor = request.inputs.add()
            tensor.name = name
            tensor.datatype = "INT32"
            tensor.shape.extend([1, 16])
            request.raw_input_contents.append(arr.tobytes())

        response = _unary(channel, "ModelInfer")(request)
        assert response.id == "raw-stub-1"
        raw = response.raw_output_contents
        by_name = {
            out.name: np.frombuffer(raw[i], dtype=np.int32)
            for i, out in enumerate(response.outputs)
        }
        sum_ = by_name["OUTPUT0"]
        diff = by_name["OUTPUT1"]
        for i in range(16):
            print(f"{input0[i]} + {input1[i]} = {sum_[i]}")
            if (sum_[i] != input0[i] + input1[i]
                    or diff[i] != input0[i] - input1[i]):
                sys.exit("error: incorrect result")
    print("PASS: grpc_client (raw stubs)")


if __name__ == "__main__":
    main()
