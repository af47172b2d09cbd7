"""ResNet-50 served over the wire and from CUDA shared memory, in turns.

    python3 tools/shm_ab.py [REPS]

Serves resnet50 (224, bf16, warmup: one CUDA graph a bucket) behind the
port's Server on one card and drives it from client processes of their
own with chip_smoke.py's load generators: binary wire requests
(VISION_CLIENT) and requests whose tensors are in CUDA regions of the
client process (SHM_CLIENT, each answer read back).  Three paths, in
turns within each of REPS rounds (the order reversed every other round):

- ``wire``: 602,112 bytes of image in each request body;
- ``cuda``: the served path, where the batcher writes a fused request's
  scores into its output region and releases it when that copy is done;
- ``cuda_copy``: the same requests with those output sinks off, so each
  request thread copies its scores into its region and waits for the copy
  (a blocking CUDA event): the design the sinks replaced.

Each round: batch-1 requests at concurrency 1, 8 and 32 and a batch-64
stream at concurrency 1; then, once, the host time torch.profiler records
in CUDA runtime calls at concurrency 8 on each path.  One JSON line a
measurement, with the card's name and power limit.  Host-clock figures
vary between machines more than between the paths, so compare paths only
within one call.
"""

import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KEYS = ("infer_per_s", "images_per_s", "latency_ms_p50", "latency_ms_p99",
        "mean_fused_batch", "server_ms_per_request", "queue_ms_per_request",
        "execution_ms")
RUNS = ((1, 64, 1), (8, 256, 1), (32, 768, 1), (1, 16, 64))


def main():
    import torch

    import chip_smoke as cs
    from client_tpu_torch.serve import Server
    from client_tpu_torch.serve import model_runtime
    from client_tpu_torch.serve.models import vision
    from client_tpu_torch.utils.cuda_shared_memory import _build

    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    if not torch.cuda.is_available():
        cs.fail("tools/shm_ab.py needs a GPU")
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    card = {"gpu": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    _build.extension()  # before the client process loads it
    sinks = model_runtime.InferenceEngine._output_sinks

    def use(path):
        model_runtime.InferenceEngine._output_sinks = (
            sinks if path != "cuda_copy"
            else lambda self, model, request, inputs: None)

    model = vision.resnet50_model(warmup=True)
    images = cs.vision_images(8, 1).numpy()
    want = [w.numpy() for w in
            model.fn({"INPUT0": images}, {}, None)["OUTPUT0"].cpu()]
    with Server(models=[model], http_port=0,
                with_default_models=False) as server, \
            tempfile.TemporaryDirectory() as tmp:
        addr, engine = server.http_address, server.engine
        client = cs.ShmClient(addr, model.name, images, tmp, threads=32,
                              big=64)
        try:
            for rep in range(reps):
                paths = ["wire", "cuda", "cuda_copy"]
                for path in paths if rep % 2 == 0 else paths[::-1]:
                    use(path)
                    for concurrency, requests, batch in RUNS:
                        row = cs.served_rate(
                            addr, engine, model.name, images, want,
                            concurrency, requests, batch=batch,
                            shm_client=None if path == "wire" else client)
                        print(json.dumps({
                            "round": rep, "path": path,
                            "concurrency": concurrency, "batch": batch,
                            **{k: row[k] for k in KEYS}, **card}),
                            flush=True)
            for path in ("wire", "cuda", "cuda_copy"):
                use(path)
                print(json.dumps({"path": path, **runtime_api_ms(
                    cs, addr, engine, model.name, images, want,
                    None if path == "wire" else client), **card}),
                    flush=True)
        finally:
            use("cuda")
            client.close()


def runtime_api_ms(cs, addr, engine, name, images, want, client,
                   concurrency=8, requests=128):
    """Host ms torch.profiler records in each CUDA runtime call over a
    window of ``requests`` requests at ``concurrency``, with the calls'
    counts: the top eight by time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        row = cs.served_rate(addr, engine, name, images, want, concurrency,
                             requests, shm_client=client)
    calls = {}
    for e in prof.events():
        if e.name.startswith("cuda"):
            n, ms = calls.get(e.name, (0, 0.0))
            calls[e.name] = (n + 1, ms + e.cpu_time_total / 1e3)
    top = sorted(calls.items(), key=lambda kv: -kv[1][1])[:8]
    return {"concurrency": concurrency, "requests": requests,
            "infer_per_s_under_profiler": row["infer_per_s"],
            "runtime_calls": [{"call": k, "count": n, "host_ms": ms}
                              for k, (n, ms) in top]}


if __name__ == "__main__":
    try:
        main()
    finally:
        chip_smoke.stop_children()
