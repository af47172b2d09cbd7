#!/usr/bin/env python
"""Minimal gRPC inference example — parity with the reference's
simple_grpc_infer_client.py."""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import client_tpu_torch.grpc as grpcclient  # noqa: E402


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-u", "--url", default="localhost:8001")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args()

    with grpcclient.InferenceServerClient(args.url, verbose=args.verbose) as client:
        inputs = [
            grpcclient.InferInput("INPUT0", [1, 16], "INT32"),
            grpcclient.InferInput("INPUT1", [1, 16], "INT32"),
        ]
        input0_data = np.arange(16, dtype=np.int32).reshape(1, 16)
        input1_data = np.ones((1, 16), dtype=np.int32)
        inputs[0].set_data_from_numpy(input0_data)
        inputs[1].set_data_from_numpy(input1_data)
        results = client.infer("simple", inputs)
        output0 = results.as_numpy("OUTPUT0")
        output1 = results.as_numpy("OUTPUT1")
        if not np.array_equal(output0, input0_data + input1_data):
            print("error: incorrect sum")
            sys.exit(1)
        if not np.array_equal(output1, input0_data - input1_data):
            print("error: incorrect difference")
            sys.exit(1)
        print("PASS: infer")


if __name__ == "__main__":
    main()
