"""Why the port's sharded model computes on local shards: the first call of
a DTensor op on a multi-dim mesh pays DTensor's sharding-rule search.

Spawns a world of 8 gloo ranks on the CPU (``parallel.spawn_world``) with
the mesh dp=2, tp=2, sp=2 (``--dims 5``: ``parallel.make_mesh``'s five
dims, ep and pp of size 1), and times on rank 0, three times each, one
activation [4, 16, 8] laid out (dp, sp, None) times one weight [8, 12]
laid out (None, tp): as DTensors, and as the local shards the port's
regions use.  Prints one JSON line; a world that outlasts ``--timeout``
seconds raises.

    python tools/dtensor_propagation_cost.py [--dims 3|5] [--timeout 600]
"""

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rank(rank, n, dims):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from client_tpu_torch import parallel

    if dims == 5:
        mesh = parallel.make_mesh(dp=2, tp=2, sp=2, device="cpu")
    else:
        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("dp", "tp", "sp"))
    gen = torch.Generator().manual_seed(0)
    x = distribute_tensor(torch.randn(4, 16, 8, generator=gen), mesh,
                          parallel.placements(mesh, parallel.P("dp", "sp")))
    w = distribute_tensor(torch.randn(8, 12, generator=gen), mesh,
                          parallel.placements(mesh, parallel.P(None, "tp")))
    out = {}
    for name, (a, b) in (("dtensor", (x, w)),
                         ("local", (x.to_local(), w.to_local()))):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            a @ b
            times.append(time.perf_counter() - t0)
        out[f"{name}_matmul_s"] = times
    if rank == 0:
        print(json.dumps({"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                          "world": n, "backend": "gloo", "device": "cpu",
                          **out}), flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", type=int, choices=(3, 5), default=3)
    ap.add_argument("--timeout", type=float, default=600)
    opts = ap.parse_args()
    sys.path.insert(0, ROOT)
    from client_tpu_torch.parallel import spawn_world

    sys.stdout.write(spawn_world("dtensor_propagation_cost:rank", 8,
                                 args=(opts.dims,), device="cpu",
                                 paths=(os.path.join(ROOT, "tools"),),
                                 timeout_s=opts.timeout)[0])
