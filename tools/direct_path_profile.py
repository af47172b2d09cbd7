"""Where a served ResNet-50 request's time goes when it takes the direct
path (a host request whose outputs lie in shared memory is not batched,
so the server calls the model's eager forward on its gRPC thread), on the
card.

    python3 tools/direct_path_profile.py [OUT_JSON]

ResNet-50 (bf16, batch 1, 224 px, seed 0) on ``cuda``.  Prints one JSON
line a measurement, and writes them all to OUT_JSON when given:

- ``eager_main_thread``: the eager forward (``model.fn``) on this thread,
  synchronized, warm: ms a call; its kernels and their device time
  (torch.profiler), and the ops that take the most host time.
- ``eager_new_threads``: the same forward on a new thread each time: the
  first call's ms on each thread and a second call's on the same thread
  (PyTorch keeps cuDNN's execution plans in a per-thread cache).
- ``served``: the model behind ``Server(grpc_port=0)``, 24 requests at
  concurrency 1 from the port's gRPC client, over the wire (the batcher's
  graph) and from system shared-memory regions (the direct path); then 16
  clients at once over the wire, which grow gRPC's worker pool, and the
  system-shm requests again: the client's ms a request, the server's
  compute ms a request, and on the direct path the ms of each forward
  call with the thread it ran on and whether it was that thread's first.
"""

import json
import os
import sys
import threading
import time
import uuid

import numpy as np
import torch

REQUESTS = 24
WARM = 3


def ms_since(t0):
    return (time.perf_counter() - t0) * 1e3


def timed_forward(model, x):
    t0 = time.perf_counter()
    model.fn({"INPUT0": x}, {}, None)["OUTPUT0"].cpu()
    return ms_since(t0)


def eager_main_thread(model, x):
    for _ in range(WARM):
        timed_forward(model, x)
    times = [timed_forward(model, x) for _ in range(REQUESTS)]
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        timed_forward(model, x)
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events)
    kernels = sum(e.count for e in events if e.self_device_time_total > 0
                  and e.device_type == torch.autograd.DeviceType.CUDA)
    top = sorted(events, key=lambda e: e.self_cpu_time_total,
                 reverse=True)[:8]
    return {"ms": times, "median_ms": float(np.median(times)),
            "profiled": {"device_ms": device_us / 1e3,
                         "kernels": kernels,
                         "host_top": [{"op": e.key, "count": e.count,
                                       "self_cpu_ms":
                                       e.self_cpu_time_total / 1e3}
                                      for e in top]}}


def eager_new_threads(model, x, n=6):
    rows = []

    def run():
        rows.append({"first_ms": timed_forward(model, x),
                     "second_ms": timed_forward(model, x)})

    for _ in range(n):
        th = threading.Thread(target=run)
        th.start()
        th.join()
    return {"threads": rows,
            "first_median_ms": float(np.median([r["first_ms"]
                                                for r in rows])),
            "second_median_ms": float(np.median([r["second_ms"]
                                                 for r in rows]))}


def wire_burst(grpcclient, address, wire_in, clients=16, each=4):
    """*clients* threads, a client each, *each* wire requests apiece."""
    lat = []

    def run():
        with grpcclient.InferenceServerClient(address) as c:
            for _ in range(each):
                t0 = time.perf_counter()
                c.infer("resnet50", [wire_in])
                lat.append(ms_since(t0))

    threads = [threading.Thread(target=run) for _ in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return {"clients": clients, "requests": len(lat),
            "client_median_ms": float(np.median(lat))}


def served(model, x):
    from client_tpu_torch import grpc as grpcclient
    from client_tpu_torch.serve import Server
    from client_tpu_torch.utils import shared_memory as sysshm

    calls, warm_threads = [], set()
    fn = model.fn

    def traced_fn(inputs, params, ctx):
        t0 = time.perf_counter()
        out = fn(inputs, params, ctx)
        torch.cuda.synchronize()
        thread = threading.get_ident()
        calls.append({"thread": thread, "ms": ms_since(t0),
                      "first_on_thread": thread not in warm_threads})
        warm_threads.add(thread)
        return out

    out = {}
    with Server(models=[model], http_port=0, grpc_port=0,
                with_default_models=False) as server:
        # traced once the batcher's graphs are captured
        model.fn = traced_fn

        def compute_ms():
            stats = server.engine.statistics("resnet50")[0]
            agg = stats["inference_stats"]
            return (agg["compute_infer"]["ns"] / 1e6,
                    agg["success"]["count"])

        tag = f"direct_path_{os.getpid()}_{uuid.uuid4().hex[:8]}"
        h_in = sysshm.create_shared_memory_region(f"{tag}_in",
                                                  f"/{tag}_in", x.nbytes)
        h_out = sysshm.create_shared_memory_region(f"{tag}_out",
                                                   f"/{tag}_out", 4000)
        with grpcclient.InferenceServerClient(server.grpc_address) as c:
            try:
                sysshm.set_shared_memory_region(h_in, [x])
                c.register_system_shared_memory(f"{tag}_in", f"/{tag}_in",
                                                x.nbytes)
                c.register_system_shared_memory(f"{tag}_out", f"/{tag}_out",
                                                4000)
                shm_in = grpcclient.InferInput("INPUT0", list(x.shape), "FP32")
                shm_in.set_shared_memory(f"{tag}_in", x.nbytes)
                shm_out = grpcclient.InferRequestedOutput("OUTPUT0")
                shm_out.set_shared_memory(f"{tag}_out", 4000)
                wire_in = grpcclient.InferInput("INPUT0", list(x.shape),
                                                "FP32")
                wire_in.set_data_from_numpy(x)
                for leg, inputs, outputs in (
                        ("wire", [wire_in], None),
                        ("system_shm", [shm_in], [shm_out]),
                        ("wire_concurrency_16", [wire_in], None),
                        ("system_shm_after_16", [shm_in], [shm_out])):
                    if leg == "wire_concurrency_16":
                        # 16 clients at once: gRPC's worker pool grows
                        # to 16 threads or more, each cold for the eager
                        # forward
                        out[leg] = wire_burst(grpcclient,
                                              server.grpc_address, wire_in)
                        continue
                    for _ in range(WARM if leg == "wire" else 0):
                        c.infer("resnet50", inputs, outputs=outputs)
                    calls.clear()
                    before = compute_ms()
                    lat = []
                    for _ in range(REQUESTS):
                        t0 = time.perf_counter()
                        c.infer("resnet50", inputs, outputs=outputs)
                        lat.append(ms_since(t0))
                    after = compute_ms()
                    n = after[1] - before[1]
                    first = [r["ms"] for r in calls if r["first_on_thread"]]
                    again = [r["ms"] for r in calls
                             if not r["first_on_thread"]]
                    out[leg] = {
                        "client_median_ms": float(np.median(lat)),
                        "client_ms": lat,
                        "server_compute_ms_a_request":
                            (after[0] - before[0]) / n,
                        "direct_calls": list(calls),
                        "direct_threads": len({r["thread"] for r in calls}),
                        "first_on_thread_calls": len(first),
                        "first_on_thread_median_ms":
                            float(np.median(first)) if first else None,
                        "warm_thread_median_ms":
                            float(np.median(again)) if again else None,
                    }
            finally:
                c.unregister_system_shared_memory(f"{tag}_in")
                c.unregister_system_shared_memory(f"{tag}_out")
                sysshm.destroy_shared_memory_region(h_in)
                sysshm.destroy_shared_memory_region(h_out)
                model.fn = fn
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("direct_path_profile needs a GPU")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from client_tpu_torch.serve.models import vision

    card = os.popen("nvidia-smi --query-gpu=name,power.limit "
                    "--format=csv,noheader").read().strip()
    model = vision.resnet50_model(warmup=True)
    x = np.random.default_rng(0).random((1, 3, 224, 224), dtype=np.float32)
    rows = []
    for name, run in (("eager_main_thread", eager_main_thread),
                      ("eager_new_threads", eager_new_threads),
                      ("served", served)):
        row = {"measurement": name, "card": card, **run(model, x)}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
