#!/usr/bin/env python
"""Vision-pipeline ensemble client — parity with the reference's
ensemble_image_client.py (reference src/python/examples/
ensemble_image_client.py: one image request drives a server-side DAG of
composing models).  Sends a uint8 image batch to the ``vision_pipeline``
ensemble (preprocess -> resnet backbone -> classification postprocess,
serve/pipeline.py), requests the classification extension's top-K labels,
and checks that every composing model's statistics counted an execution —
the point of ensembles is that the hops never leave the server (the
intermediates stay in device memory between steps)."""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import client_tpu_torch.grpc as grpcclient  # noqa: E402

COMPOSING = ("vision_preprocess", "vision_backbone", "vision_postprocess")


def synthetic_image(size, batch=1, seed=7):
    """A deterministic uint8 NHWC gradient "photo" (no image deps needed)."""
    rng = np.random.default_rng(seed)
    ramp = np.linspace(0, 255, size, dtype=np.float32)
    img = np.stack(
        [
            np.add.outer(ramp, ramp[::-1]) / 2.0,
            np.tile(ramp, (size, 1)),
            rng.uniform(0, 255, (size, size)).astype(np.float32),
        ],
        axis=-1,
    )
    return np.broadcast_to(
        img.astype(np.uint8), (batch, size, size, 3)
    ).copy()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("-u", "--url", default="localhost:8001")
    parser.add_argument("-m", "--model-name", default="vision_pipeline")
    parser.add_argument("-c", "--classes", type=int, default=3,
                        help="top-K classification results per image")
    parser.add_argument("-b", "--batch", type=int, default=2)
    args = parser.parse_args()

    with grpcclient.InferenceServerClient(args.url) as client:
        def success_counts():
            stats = client.get_inference_statistics(as_json=True)
            return {
                s["name"]: int(
                    s.get("inference_stats", {}).get("success", {}).get(
                        "count", 0
                    )
                )
                for s in stats.get("model_stats", [])
            }

        stats_before = success_counts()

        meta = client.get_model_metadata(args.model_name, as_json=True)
        image_spec = meta["inputs"][0]
        size = int(image_spec["shape"][1])
        image = synthetic_image(size, batch=args.batch)

        inp = grpcclient.InferInput(
            "IMAGE", list(image.shape), image_spec["datatype"]
        )
        inp.set_data_from_numpy(image)
        outputs = [
            grpcclient.InferRequestedOutput("SCORES", class_count=args.classes)
        ]
        result = client.infer(args.model_name, [inp], outputs=outputs)
        top = result.as_numpy("SCORES")
        if top.shape != (args.batch, args.classes):
            sys.exit(f"error: unexpected classification shape {top.shape}")
        for row in top:
            best = row[0].decode() if isinstance(row[0], bytes) else str(row[0])
            score = float(best.split(":")[0])
            if not (0.0 < score <= 1.0):
                sys.exit(f"error: top-1 score {score} is not a probability")
            print(f"image top-{args.classes}:",
                  [v.decode() if isinstance(v, bytes) else str(v)
                   for v in row])

        stats_after = success_counts()
        for composing in COMPOSING:
            if stats_after.get(composing, 0) <= stats_before.get(composing, 0):
                sys.exit(f"error: composing model '{composing}' not executed")
        print("composing models executed server-side:", ", ".join(COMPOSING))
    print("PASS: ensemble_image_client")


if __name__ == "__main__":
    main()
