#!/usr/bin/env python
"""Stateful streaming example: two sequences multiplexed on one bidi stream.

Parity with the reference's simple_grpc_sequence_stream_infer_client.py
(reference src/python/examples; cc variant drives two sequences concurrently,
cc:96-136). BASELINE.md config 4.
"""

import argparse
import os
import queue
import sys
from functools import partial

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import client_tpu_torch.grpc as grpcclient  # noqa: E402


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-u", "--url", default="localhost:8001")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("-d", "--dyna", action="store_true", help="unused compat flag")
    parser.add_argument("-o", "--offset", type=int, default=0, help="sequence id offset")
    args = parser.parse_args()

    values = [11, 7, 5, 3, 2, 0, 1]
    seq0, seq1 = 1000 + args.offset * 2, 1001 + args.offset * 2
    result_queue = queue.Queue()

    def callback(result_queue, result, error):
        result_queue.put((result, error))

    with grpcclient.InferenceServerClient(args.url, verbose=args.verbose) as client:
        client.start_stream(partial(callback, result_queue))
        for i, v in enumerate(values):
            start, end = i == 0, i == len(values) - 1
            for seq, value in ((seq0, v), (seq1, -v)):
                inp = grpcclient.InferInput("INPUT", [1], "INT32")
                inp.set_data_from_numpy(np.array([value], dtype=np.int32))
                client.async_stream_infer(
                    "simple_sequence",
                    [inp],
                    request_id=f"{seq}_{i}",
                    sequence_id=seq,
                    sequence_start=start,
                    sequence_end=end,
                )
        results = {seq0: [], seq1: []}
        for _ in range(2 * len(values)):
            result, error = result_queue.get(timeout=30)
            if error is not None:
                print(f"error: {error}")
                sys.exit(1)
            seq = int(result.get_response().id.split("_")[0])
            results[seq].append(int(result.as_numpy("OUTPUT")[0]))
        client.stop_stream()

    expected = list(np.cumsum(values))
    print(f"sequence {seq0}: {results[seq0]}")
    print(f"sequence {seq1}: {results[seq1]}")
    if results[seq0] != expected or results[seq1] != [-v for v in expected]:
        print("error: unexpected sequence results")
        sys.exit(1)
    print("PASS: sequence stream")


if __name__ == "__main__":
    main()
