#!/usr/bin/env python
"""Image classification client — parity with the reference image_client.py
(reference src/python/examples/image_client.py: preprocess, batch, classify
via the classification extension).  OpenCV-free: numpy mean-pool resize.

``--shared-memory cuda`` stages the image batch in CUDA device memory via
client_tpu_torch.utils.cuda_shared_memory: against ``-u`` the region is
allocated here and the server opens it over CUDA IPC, with ``--hermetic``
the in-process server resolves it directly (with ``--device cpu`` it is a
host region only that server can resolve).  ``--hermetic`` serves the CNN
in-process on ``--device``.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def preprocess(path_or_none, size, rng):
    """Load (or synthesize) an image as [3, size, size] float32 CHW."""
    if path_or_none is None:
        return rng.standard_normal((3, size, size)).astype(np.float32)
    from PIL import Image  # optional; synthetic input needs no pillow

    img = Image.open(path_or_none).convert("RGB")
    arr = np.asarray(img, dtype=np.float32) / 255.0
    h, w, _ = arr.shape
    # nearest-neighbor resample: robust for images of any size
    rows = (np.arange(size) * h // size).clip(0, h - 1)
    cols = (np.arange(size) * w // size).clip(0, w - 1)
    arr = arr[rows][:, cols]
    return arr.transpose(2, 0, 1)


def region_device(args):
    """The device of the --hermetic server and of a CUDA region: --device
    with --hermetic; else CUDA, since a server in another process opens
    the region over CUDA IPC.  Exits with the refusal where it is absent."""
    from client_tpu_torch import resolve_device

    try:
        return resolve_device(args.device if args.hermetic else "cuda")
    except RuntimeError as e:
        if args.hermetic:
            sys.exit(f"error: {e}")
        sys.exit("error: a server in another process opens a CUDA shared "
                 "memory region over CUDA IPC, and this host has no CUDA "
                 "device (--device cpu needs --hermetic)")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("image", nargs="*", help="image files (synthetic if none)")
    parser.add_argument("-u", "--url", default="localhost:8001")
    parser.add_argument("-i", "--protocol", choices=["grpc", "http"],
                        default="grpc")
    parser.add_argument("-m", "--model-name", default="cnn_classifier")
    parser.add_argument("-c", "--classes", type=int, default=3,
                        help="top-N classification extension")
    parser.add_argument("-b", "--batch-size", type=int, default=1)
    parser.add_argument("--shared-memory", choices=["none", "cuda"],
                        default="none")
    parser.add_argument("--hermetic", action="store_true")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="device of the --hermetic server (cpu runs the "
                             "plain PyTorch path)")
    args = parser.parse_args()

    server = None
    url = args.url
    device = None
    if args.hermetic or args.shared_memory == "cuda":
        device = region_device(args)
    if args.hermetic:
        from client_tpu_torch.serve import Server
        from client_tpu_torch.serve.models.vision import cnn_classifier_model

        server = Server(models=[cnn_classifier_model(device=device)],
                        grpc_port=0, with_default_models=False,
                        device=device).start()
        url = server.grpc_address if args.protocol == "grpc" else None
        if url is None:
            url = server.http_address

    if args.protocol == "grpc":
        import client_tpu_torch.grpc as client_mod
    else:
        import client_tpu_torch.http as client_mod

    rng = np.random.default_rng(0)
    paths = args.image or [None] * args.batch_size
    batch = np.stack([preprocess(p, 224, rng) for p in paths])

    try:
        with client_mod.InferenceServerClient(url) as client:
            inp = client_mod.InferInput(
                "INPUT0", list(batch.shape), "FP32"
            )
            out = client_mod.InferRequestedOutput(
                "OUTPUT0", class_count=args.classes
            )
            shm_handle = None
            if args.shared_memory == "cuda":
                from client_tpu_torch.utils import cuda_shared_memory as cudashm

                shm_handle = cudashm.create_shared_memory_region(
                    "image_in", batch.nbytes, device=device
                )
                cudashm.set_shared_memory_region(shm_handle, [batch])
                client.register_cuda_shared_memory(
                    "image_in", cudashm.get_raw_handle(shm_handle), 0,
                    batch.nbytes,
                )
                inp.set_shared_memory("image_in", batch.nbytes)
            else:
                inp.set_data_from_numpy(batch)

            result = client.infer(args.model_name, [inp], outputs=[out])
            classes = result.as_numpy("OUTPUT0")
            for i, row in enumerate(np.atleast_2d(classes)):
                print(f"image {i}:")
                for entry in row:
                    score, idx, *label = (
                        entry.decode() if isinstance(entry, bytes) else str(entry)
                    ).split(":")
                    name = label[0] if label else idx
                    print(f"  {float(score):.4f} ({idx}) = {name}")
            if shm_handle is not None:
                client.unregister_cuda_shared_memory("image_in")
                cudashm.destroy_shared_memory_region(shm_handle)
            print("PASS: image_client")
    finally:
        if server:
            server.stop()


if __name__ == "__main__":
    main()
