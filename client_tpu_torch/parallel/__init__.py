"""Several devices: the mesh, the parameter layout and the sharded regions.

Counterpart of client_tpu/parallel/__init__.py.  The JAX package builds a
``jax.sharding.Mesh`` and lets GSPMD insert the collectives; here every
device is a process of a ``torch.distributed`` world (NCCL when each rank
owns a GPU, gloo on the CPU) and the collectives are written out:

- :func:`make_mesh`: a ``DeviceMesh`` over the default process group with
  the five dims ``("dp","tp","sp","ep","pp")`` in JAX's order (data /
  tensor / sequence / expert / pipeline parallel);
- :class:`P`, :func:`param_specs`, :func:`named_shardings` and
  :func:`device_put`: JAX's PartitionSpecs, the Megatron layout of the
  transformer, and DTensors laid out by them (one ``Shard(d)`` or
  ``Replicate()`` a mesh dim);
- :mod:`.ring_attention`: ring attention over ``sp``;
  :mod:`.pipeline`: the GPipe schedule over ``pp``;
  :mod:`.collectives`: the differentiable permute and all-reduces;
- :func:`init_world` and :func:`spawn_world`: a process group for this
  process, and a world of processes started and joined with a deadline.

Params live as DTensors; the model's sharded regions take each one's
local shard (``to_local``) and run on plain tensors (see
serve/models/transformer.py).
"""

import dataclasses
import datetime
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from client_tpu_torch import resolve_device
from client_tpu_torch.parallel.ring_attention import ring_attention  # noqa: F401

AXES = ("dp", "tp", "sp", "ep", "pp")


class P(tuple):
    """A PartitionSpec: for each tensor dim, the mesh axis it is split
    over, or None (replicated along that dim)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


def mesh_shape(n, dp=None, tp=None, sp=None, ep=None, pp=None):
    """The (dp, tp, sp, ep, pp) sizes for ``n`` devices, by JAX's rules:
    an unspecified size is 1 and dp absorbs the remaining devices; a
    product other than ``n`` raises ValueError."""
    tp = 1 if tp is None else tp
    sp = 1 if sp is None else sp
    ep = 1 if ep is None else ep
    pp = 1 if pp is None else pp
    denom = tp * sp * ep * pp
    if dp is None:
        if n % denom:
            raise ValueError(
                f"{n} devices not divisible by tp*sp*ep*pp={denom}"
            )
        dp = n // denom
    if dp * denom != n:
        raise ValueError(f"dp*tp*sp*ep*pp={dp * denom} != {n} devices")
    return dp, tp, sp, ep, pp


def make_mesh(dp=None, tp=None, sp=None, ep=None, pp=None, device=None):
    """Build a ("dp","tp","sp","ep","pp") DeviceMesh over the default
    process group: one device a rank, on ``cuda`` unless *device* names
    another.  Sizes as :func:`mesh_shape` (the world size is the device
    count)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh builds on the default process group; start one "
            "first (parallel.init_world)"
        )
    device = resolve_device(device)
    shape = mesh_shape(dist.get_world_size(), dp, tp, sp, ep, pp)
    return init_device_mesh(device.type, shape, mesh_dim_names=AXES)


def batch_spec():
    """Activation spec: batch over dp, sequence over sp."""
    return P("dp", "sp")


def logit_spec():
    return P("dp", "sp", "tp")


def param_specs(cfg):
    """PartitionSpecs for transformer params (serve/models/transformer.py),
    JAX's Megatron layout: q/k/v column-parallel over heads (tp), o
    row-parallel; MLP up/gate column-parallel over d_ff, down row-parallel;
    embedding and LM head over vocab; norm scales replicated.  For MoE the
    expert dim goes over ep and each expert's hidden dim over tp; the
    router is replicated."""
    layer = {
        "attn": {
            "wq": P(None, "tp"),
            "wk": P(None, "tp"),
            "wv": P(None, "tp"),
            "wo": P("tp", None),
        },
        "ln_attn": P(None),
        "ln_mlp": P(None),
    }
    if getattr(cfg, "n_experts", 0) > 0:
        layer["moe"] = {
            "router": P(None, None),
            "w_gate": P("ep", None, "tp"),
            "w_up": P("ep", None, "tp"),
            "w_down": P("ep", "tp", None),
        }
    else:
        layer["mlp"] = {
            "w_gate": P(None, "tp"),
            "w_up": P(None, "tp"),
            "w_down": P("tp", None),
        }
    return {
        "embed": P("tp", None),
        "layers": [layer for _ in range(cfg.n_layers)],
        "ln_f": P(None),
        "lm_head": P(None, "tp"),
    }


def placements(mesh, spec):
    """One placement for each mesh dim: ``Shard(d)`` where ``spec`` puts
    tensor dim d over that dim, else ``Replicate()``."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, axis in enumerate(spec) if axis == name]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``."""

    mesh: object
    spec: P

    @property
    def placements(self):
        return placements(self.mesh, self.spec)


def tree_map(fn, tree, *rest):
    """Map over dicts, lists and tuples; :class:`P` and tensors are
    leaves."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def named_shardings(mesh, specs):
    """Map a :class:`P` tree to :class:`NamedSharding` on ``mesh``."""
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


def device_put(tree, shardings):
    """Lay each tensor of ``tree`` out as a DTensor by its sharding (the
    counterpart of ``jax.device_put``).  Every rank passes the same full
    tensor; rank 0's copy is the one scattered."""
    def put(x, sh):
        x = x.detach().to(sh.mesh.device_type)
        return distribute_tensor(x, sh.mesh, sh.placements)

    return tree_map(put, tree, shardings)


def local_shard(x, mesh, spec, partial=()):
    """This rank's shard of ``x`` laid out by ``spec``, as a plain tensor:
    what the model's local regions compute on.

    For a DTensor laid out so (``device_put``), the shard is the DTensor's
    own local tensor; where the DTensor requires grad, the shard becomes
    an autograd leaf whose gradient is this rank's part, partial over the
    mesh dims in ``partial`` (``shard.partial_over``: the optimizer sums
    it over them, see serve/models/transformer.py's ``_MeshAdam``).  The
    gradient never passes through DTensor dispatch, which costs a
    fraction of a millisecond a tensor.  A plain tensor, the same on every
    rank, is cut here (no collective, no gradient)."""
    layout = placements(mesh, spec)
    if not isinstance(x, DTensor):
        return distribute_tensor(x.detach(), mesh, layout,
                                 src_data_rank=None).to_local()
    if tuple(x.placements) != layout:
        if x.requires_grad:
            raise ValueError(
                f"a trained param laid out {tuple(x.placements)} where its "
                f"spec {spec} gives {layout}; lay the params out with "
                "device_put(params, named_shardings(mesh, specs))")
        return x.redistribute(mesh, layout).to_local()
    with torch.no_grad():
        shard = x.to_local()
    if x.requires_grad:
        shard.requires_grad_(True)
        shard.partial_over = tuple(partial)
    return shard


# -- a world of processes --------------------------------------------------

def init_world(rank, world_size, store, device=None, backend=None,
               timeout_s=300):
    """Join this process to a world of ``world_size`` ranks through
    ``store`` (a ``torch.distributed`` Store).  ``backend`` defaults to
    NCCL when *device* is CUDA and each rank owns a GPU, else gloo; a CUDA
    rank binds ``cuda:(rank % GPUs)``.  Collectives that outlast
    ``timeout_s`` raise."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if backend is None:
        owns_gpu = (device.type == "cuda"
                    and torch.cuda.device_count() >= world_size)
        backend = "nccl" if owns_gpu else "gloo"
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return backend


_CHILD = (
    "import faulthandler, json, os\n"
    "import signal\n"
    "faulthandler.enable(all_threads=True)\n"
    "faulthandler.register(signal.SIGUSR1, all_threads=True)\n"
    "from client_tpu_torch.parallel import _world_child\n"
    "_world_child(json.loads(os.environ['CTPU_WORLD']))\n"
)


def _world_child(spec):
    """A rank of :func:`spawn_world`: join the world, call the target with
    (rank, world_size, *args), leave the world."""
    import importlib

    if torch.device(spec["device"]).type == "cpu":
        # the ranks share the host's cores: one intra-op pool each
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // spec["world"]))
    store = dist.TCPStore("127.0.0.1", spec["port"], is_master=False,
                          timeout=datetime.timedelta(seconds=spec["timeout"]))
    init_world(spec["rank"], spec["world"], store, device=spec["device"],
               backend=spec["backend"], timeout_s=spec["timeout"])
    try:
        module, name = spec["target"].split(":")
        getattr(importlib.import_module(module), name)(
            spec["rank"], spec["world"], *spec["args"])
    finally:
        dist.destroy_process_group()


def spawn_world(target, n, args=(), device=None, backend=None,
                timeout_s=300, paths=()):
    """Run ``target`` ("module:function", called as ``fn(rank, n, *args)``
    with JSON ``args``) on ``n`` ranks, each a Python process of its own
    (``paths`` go on its ``PYTHONPATH``), joined through a store this
    process serves on loopback.  The ranks run on CUDA unless *device*
    names another (``init_world`` picks the backend).  Returns each
    rank's standard output.  A rank that fails, or a world that outlasts
    ``timeout_s``, raises RuntimeError with the ranks' error output; every
    process is stopped before this returns."""
    device = str(resolve_device(device))
    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout_s))
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    pythonpath = os.pathsep.join(
        [root, *paths, os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    procs, logs = [], []
    try:
        for rank in range(n):
            spec = {"rank": rank, "world": n, "port": store.port,
                    "target": target, "args": list(args), "device": device,
                    "backend": backend, "timeout": timeout_s}
            out = tempfile.TemporaryFile()
            err = tempfile.TemporaryFile()
            logs.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _CHILD], stdout=out, stderr=err,
                env={**os.environ, "PYTHONPATH": pythonpath,
                     "CTPU_WORLD": json.dumps(spec)}))
        # a rank that fails leaves the others waiting in a collective:
        # stop the world at the first failure or at the deadline
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(codes):
                break
            time.sleep(0.05)
    finally:
        # the ranks still running write their Python stacks (their
        # faulthandler's SIGUSR1) before they are stopped
        alive = [p for p in procs if p.poll() is None]
        for p in alive:
            p.send_signal(signal.SIGUSR1)
        if alive:
            time.sleep(0.5)
        for p in alive:
            p.kill()
            p.wait()
    outs, errs = [], []
    for out, err in logs:
        out.seek(0)
        err.seek(0)
        outs.append(out.read().decode(errors="replace"))
        errs.append(err.read().decode(errors="replace"))
        out.close()
        err.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        tails = "\n".join(
            f"--- rank {r} (exit {_exit_name(c)}):\n{e[-3000:]}"
            for r, (c, e) in enumerate(zip(codes, errs)) if c)
        raise RuntimeError(
            f"world of {n} ranks running {target} failed or outlasted "
            f"{timeout_s} s: exit codes {codes}\n{tails}")
    return outs


def _exit_name(code):
    """A rank's exit code, with the signal's name where a signal ended it
    (``-11`` is ``-11 (SIGSEGV)``)."""
    if code < 0:
        try:
            return f"{code} ({signal.Signals(-code).name})"
        except ValueError:
            pass
    return str(code)
