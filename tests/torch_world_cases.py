"""The port's side of tests/test_torch_parallel.py and
tests/test_torch_ring_attention.py: functions each rank of a spawned
world runs (``client_tpu_torch.parallel.spawn_world``), then writes its
results for the test process to compare with the JAX package.

Imports torch and the port only (the ranks never import jax).  Inputs come
in a pickle of numpy arrays the test process wrote; rank 0 writes a pickle
of numpy results.  Every case runs in one world per test module.
"""

import os
import pickle
import signal
import time
import traceback

import torch

from client_tpu_torch import convert, parallel
from client_tpu_torch.parallel import (
    collectives,
    device_put,
    make_mesh,
    named_shardings,
    param_specs,
)
from client_tpu_torch.parallel.ring_attention import (
    plain_attention,
    ring_attention_sharded,
)
from client_tpu_torch.serve.models import transformer as tfm


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _dump(path, obj):
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    os.replace(tmp, path)


def _full(x):
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().cpu().numpy().copy()  # not a view of a live tensor


def _tree_full(tree):
    return parallel.tree_map(_full, tree)


def _cfg(d):
    return tfm.TransformerConfig(**d)


def _run_cases(rank, cases, inputs, out_path):
    """Run every case; a case that raises records its error (the others
    still run, in the same order on every rank)."""
    results = {}
    for name, fn in cases:
        try:
            results[name] = fn(inputs[name] if name in inputs else None)
        except Exception:  # noqa: BLE001 -- reported by the test
            results[name] = {"error": traceback.format_exc()}
    if rank == 0:
        _dump(out_path, results)


# -- ring attention ----------------------------------------------------------

def _ring_case(mesh, impl, causal):
    def run(inp):
        q, k, v, cot = (torch.from_numpy(inp[n]) for n in "qkvc")
        layout = parallel.placements(mesh, parallel.P("dp", "sp", "tp", None))
        from torch.distributed.tensor import distribute_tensor

        dq, dk, dv = (distribute_tensor(x, mesh, layout).requires_grad_()
                      for x in (q, k, v))
        out = ring_attention_sharded(dq, dk, dv, mesh, causal=causal,
                                     impl=impl)
        cot_local = distribute_tensor(cot, mesh, layout).to_local()
        (out.to_local() * cot_local).sum().backward()
        # against the port's own one-device attention on the same inputs
        plain = plain_attention(q, k, v, causal=causal)
        return {"out": _full(out), "dq": _full(dq.grad), "dk": _full(dk.grad),
                "dv": _full(dv.grad), "plain": plain.numpy()}
    return run


def _causality(mesh):
    """Perturbing future tokens leaves earlier outputs as they were."""
    def run(inp):
        q, k, v = (torch.from_numpy(inp[n]) for n in "qkv")
        base = _full(ring_attention_sharded(q, k, v, mesh))
        k2, v2 = k.clone(), v.clone()
        k2[:, 12:] = 99.0
        v2[:, 12:] = -99.0
        pert = _full(ring_attention_sharded(q, k2, v2, mesh))
        return {"base": base, "pert": pert}
    return run


def _permute_join(mesh):
    """A ring whose every rank but the last skips the last KV shard still
    runs each permute's backward on every rank (the join), and the
    permute's counts add up: forward and backward, sp - 1 each."""
    def run(inp):
        collectives.reset_stats()
        q, k, v = (torch.from_numpy(inp[n]).requires_grad_()
                   for n in "qkv")
        from client_tpu_torch.parallel.ring_attention import ring_attention

        out = ring_attention(q, k, v, mesh.get_group("sp"), causal=True)
        out.sum().backward()
        return {"ppermute": collectives.STATS["ppermute"],
                "bytes_staged": collectives.STATS["bytes_staged"]}
    return run


def ring_cases(rank, n, in_path, out_path):
    inputs = _load(in_path)
    mesh = make_mesh(dp=2, tp=2, sp=2, device="cpu")
    cases = [(f"{impl}_{'causal' if causal else 'full'}",
              _ring_case(mesh, impl, causal))
             for impl in ("plain", "flash") for causal in (True, False)]
    cases += [("causality", _causality(mesh)),
              ("permute_join", _permute_join(mesh))]
    _run_cases(rank, cases, inputs, out_path)


def ring_on_card(rank, n, in_path, out_path):
    """Phase 19b at the test's size: ``ring_attention_sharded(impl=
    "flash")`` on ``make_mesh(sp=2)`` over two gloo ranks on one CUDA card,
    forward and backward."""
    from torch.distributed.tensor import DTensor

    from client_tpu_torch import ops

    inp = _load(in_path)
    mesh = make_mesh(sp=n)
    layout = parallel.placements(mesh, parallel.P("dp", "sp", "tp", None))
    q, k, v, g = (torch.from_numpy(inp[c]).to("cuda", torch.bfloat16)
                  for c in "qkvg")
    t = q.shape[1] // n
    shard = slice(rank * t, (rank + 1) * t)
    ql, kl, vl = (x[:, shard].clone().requires_grad_() for x in (q, k, v))
    ops.reset_launches()
    collectives.reset_stats()
    out = ring_attention_sharded(
        *(DTensor.from_local(x, mesh, layout, run_check=False, shape=q.shape,
                             stride=q.stride()) for x in (ql, kl, vl)),
        mesh, causal=True, impl="flash").to_local()
    out.backward(g[:, shard])
    torch.cuda.synchronize()
    res = {"out": out.detach().float().cpu().numpy(), "dq": ql.grad.float().cpu().numpy(),
           "dk": kl.grad.float().cpu().numpy(),
           "dv": vl.grad.float().cpu().numpy(),
           "launches": dict(ops.LAUNCHES), "stats": dict(collectives.STATS)}
    _dump(f"{out_path}.{rank}", res)


# -- the sharded model -------------------------------------------------------

def _params(inp, mesh, cfg):
    params = convert.params_from_numpy(inp["params"], "cpu")
    return device_put(params, named_shardings(mesh, param_specs(cfg)))


def _train_case(mesh, attn_impl):
    def run(inp):
        cfg = _cfg(inp["cfg"])
        params = _params(inp, mesh, cfg)
        opt, step = tfm.make_train_step(
            cfg, attn_impl=attn_impl, learning_rate=inp["lr"], mesh=mesh)
        state = opt.init(params)
        toks = torch.from_numpy(inp["tokens"])
        logits = tfm.forward(params, toks[:, :-1], cfg, attn_impl, mesh=mesh)
        params, state, loss = step(params, state, toks)
        return {"loss": float(loss), "params": _tree_full(params),
                "logits": _full(logits),
                "logit_placements": [str(p) for p in logits.placements]}
    return run


def _grads(params, opt_state):
    """The gradients the step's Adam took (summed over the ranks that
    share each param), as full arrays in the params' tree."""
    from torch.distributed.tensor import DTensor

    by_param = {id(w): DTensor.from_local(
        shard.grad, w.device_mesh, w.placements, run_check=False,
        shape=w.shape, stride=w.stride()) for w, shard in opt_state._pairs()}
    return parallel.tree_map(lambda w: _full(by_param[id(w)]), params)


def _moe_case(mesh):
    def run(inp):
        cfg = _cfg(inp["cfg"])
        params = _params(inp, mesh, cfg)
        logits, aux = tfm.forward(params, torch.from_numpy(inp["fwd_tokens"]),
                                  cfg, with_aux=True, mesh=mesh)
        opt, step = tfm.make_train_step(cfg, learning_rate=inp["lr"],
                                        mesh=mesh)
        params, state, loss = step(params, opt.init(params),
                                   torch.from_numpy(inp["tokens"]))
        return {"logits": _full(logits), "aux": float(aux),
                "loss": float(loss), "params": _tree_full(params),
                "grads": _grads(params, state)}
    return run


def _pipeline_case(mesh):
    def run(inp):
        cfg = _cfg(inp["cfg"])
        plain = convert.params_from_numpy(inp["params"], "cpu")
        pparams = tfm.stack_pipeline_params(plain, 2)
        # the converter takes JAX's pipeline-stacked tree as it is
        stacked = convert.params_from_numpy(inp["stacked"], "cpu")
        same = all(tfm._leaves(parallel.tree_map(
            lambda a, b: torch.equal(a, b), pparams, stacked)))
        pparams = device_put(pparams, named_shardings(
            mesh, tfm.pipeline_param_specs(pparams)))
        logits = tfm.forward_pipelined(pparams, torch.from_numpy(
            inp["fwd_tokens"]), cfg, mesh, n_microbatches=2)
        opt, step = tfm.make_pipeline_train_step(
            cfg, mesh, n_microbatches=2, learning_rate=inp["lr"])
        pparams, state, loss = step(pparams, opt.init(pparams),
                                    torch.from_numpy(inp["tokens"]))
        return {"logits": _full(logits), "loss": float(loss),
                "params": _tree_full(pparams), "converter_equal": same,
                "grads": _grads(pparams, state)}
    return run


def _mesh_validation(inp):
    errors = []
    for kw in ({"dp": 2, "tp": 2, "sp": 2, "pp": 2}, {"tp": 3}):
        try:
            make_mesh(device="cpu", **kw)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    mesh = make_mesh(dp=2, tp=2, pp=2, device="cpu")
    return {"errors": errors, "names": list(mesh.mesh_dim_names),
            "shape": list(mesh.shape)}


def _specs(meshes):
    def run(inp):
        out = {}
        for name, cfg_d in inp["cfgs"].items():
            cfg = _cfg(cfg_d)
            mesh = meshes[name]
            specs = param_specs(cfg)
            params = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                                     "cpu")
            put = device_put(params, named_shardings(mesh, specs))
            out[name] = {
                "specs": parallel.tree_map(tuple, specs),
                "placements": parallel.tree_map(
                    lambda x: [str(p) for p in x.placements], put),
                "local_shapes": parallel.tree_map(
                    lambda x: tuple(x.to_local().shape), put),
            }
        return out
    return run


def _restore(mesh, ckpt_dir):
    def run(inp):
        from torch.distributed.tensor import DTensor

        from client_tpu_torch.train import CheckpointManager

        cfg = _cfg(inp["cfg"])
        template = _params({"params": inp["template"]}, mesh, cfg)
        with CheckpointManager(ckpt_dir) as mgr:
            restored = mgr.restore({"params": template}, step=0)["params"]
        leaf = restored["layers"][0]["attn"]["wq"]
        want = template["layers"][0]["attn"]["wq"]
        layout_kept = all(
            isinstance(a, DTensor) and a.placements == b.placements
            and a.device_mesh == b.device_mesh
            for a, b in zip(tfm._leaves(restored), tfm._leaves(template)))
        out = {"layout_kept": layout_kept,
               "wq_placements": [str(p) for p in leaf.placements],
               "wq_local_shape": tuple(leaf.to_local().shape),
               "wq_template_local_shape": tuple(want.to_local().shape),
               "restored": _tree_full(restored)}
        toks = torch.from_numpy(inp["tokens"])
        opt, step = tfm.make_train_step(cfg, attn_impl="ring", mesh=mesh)
        params, state, loss = step(restored, opt.init(restored), toks)
        # resume: a second run restored from the checkpoint, its optimizer
        # state loaded from the first's (moments as full tensors, which
        # each rank slices), takes the second step bit for bit
        with CheckpointManager(ckpt_dir) as mgr:
            params2 = mgr.restore({"params": template}, step=0)["params"]
        state2 = opt.init(params2)
        full = state.state_dict()
        # copies, as a checkpoint holds (a replicated moment's
        # full_tensor() and Adam's "step" are the optimizer's own tensors)
        full["state"] = {i: {k: (v.full_tensor() if isinstance(v, DTensor)
                                 else v).clone() for k, v in st.items()}
                         for i, st in full["state"].items()}
        state2.load_state_dict(full)
        for a, b in zip(tfm._leaves(params2), tfm._leaves(params)):
            with torch.no_grad():
                a.to_local().copy_(b.to_local())
        params, state, loss2 = step(params, state, toks)
        params2, state2, resumed = step(params2, state2, toks)
        same = all(torch.equal(a.to_local(), b.to_local()) for a, b in
                   zip(tfm._leaves(params), tfm._leaves(params2)))
        return {**out, "loss": float(loss), "resumed_loss": float(resumed),
                "uninterrupted_loss": float(loss2), "resumed_equal": same}
    return run


def _refusals(mesh):
    def run(inp):
        cfg = _cfg(inp["cfg"])
        params = _params(inp, mesh, cfg)
        toks = torch.from_numpy(inp["tokens"])
        out = {}
        try:
            tfm.forward(params, toks, cfg, attn_impl="flash", mesh=mesh)
            out["flash"] = None
        except ValueError as e:
            out["flash"] = str(e)
        plain = convert.params_from_numpy(inp["params"], "cpu")
        try:
            tfm.forward(tfm.quantize_params(plain), toks, cfg, mesh=mesh)
            out["quantized"] = None
        except ValueError as e:
            out["quantized"] = str(e)
        return out
    return run


def parallel_cases(rank, n, in_path, out_path, ckpt_dir):
    inputs = _load(in_path)
    mesh = make_mesh(dp=2, tp=2, sp=2, device="cpu")
    emesh = make_mesh(dp=2, tp=2, ep=2, device="cpu")
    pmesh = make_mesh(dp=2, tp=2, pp=2, device="cpu")
    cases = [
        ("mesh_validation", _mesh_validation),
        ("param_specs", _specs({"dense": mesh, "moe": emesh})),
        ("train_ring", _train_case(mesh, "ring")),
        ("train_ring_flash", _train_case(mesh, "ring_flash")),
        ("moe_ep", _moe_case(emesh)),
        ("pipeline", _pipeline_case(pmesh)),
        ("restore", _restore(mesh, ckpt_dir)),
        ("refusals", _refusals(mesh)),
    ]
    _run_cases(rank, cases, inputs, out_path)


def segfault_rank(rank, n):
    """Rank 1 dies by SIGSEGV; the others sleep until they are stopped
    (the world's error must name the signal and hold each rank's Python
    stack).  Every rank enters the case before rank 1 dies: a barrier
    of the world's process group first, so rank 0's stack holds it."""
    torch.distributed.barrier()
    if rank == 1:
        os.kill(os.getpid(), signal.SIGSEGV)
    time.sleep(600)
