#!/usr/bin/env python
"""Raw-stub image-classification gRPC example — parity with the reference's
generated-stub grpc_image_client.py: hand-built ModelInferRequest against a
classification model, reading metadata first to size the input and asking
for the classification extension (top-N "score:index:label" strings)."""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import grpc  # noqa: E402
import numpy as np  # noqa: E402

from client_tpu_torch._grpc_service import SERVICE, METHODS  # noqa: E402
from client_tpu_torch._proto import inference_pb2 as pb  # noqa: E402
from client_tpu_torch.utils import deserialize_bytes_tensor  # noqa: E402


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
    parser.add_argument("-m", "--model-name", default="classifier")
    parser.add_argument("-c", "--classes", type=int, default=2)
    args = parser.parse_args()

    with grpc.insecure_channel(args.url) as channel:
        meta = _unary(channel, "ModelMetadata")(
            pb.ModelMetadataRequest(name=args.model_name)
        )
        spec = meta.inputs[0]
        dims = [1 if d < 0 else d for d in spec.shape]
        print(f"model {meta.name}: input {spec.name} {list(spec.shape)} "
              f"{spec.datatype}")

        rng = np.random.default_rng(0)
        image = rng.standard_normal(dims).astype(np.float32)

        request = pb.ModelInferRequest()
        request.model_name = args.model_name
        tensor = request.inputs.add()
        tensor.name = spec.name
        tensor.datatype = spec.datatype
        tensor.shape.extend(dims)
        request.raw_input_contents.append(image.tobytes())
        out = request.outputs.add()
        out.name = meta.outputs[0].name
        out.parameters["classification"].int64_param = args.classes

        response = _unary(channel, "ModelInfer")(request)
        results = deserialize_bytes_tensor(
            response.raw_output_contents[0]
        ).flatten()
        if len(results) != args.classes:
            sys.exit(f"error: wanted top-{args.classes}, got {len(results)}")
        prev = float("inf")
        for entry in results:
            score, idx, label = entry.decode().split(":")
            print(f"  {float(score):.4f} ({idx}) = {label}")
            if float(score) > prev:
                sys.exit("error: classification not sorted by score")
            prev = float(score)
    print("PASS: grpc_image_client (raw stubs)")


if __name__ == "__main__":
    main()
