"""Entry points of the port: the flagship forward, and the dryrun of the
sharded training paths over several devices.

Counterpart of ``__graft_entry__.py``.  ``entry()`` returns a forward step
on the flagship transformer LM and its example args, on the card unless
the caller asks for another device.  ``dryrun_multichip(n)`` runs the
reference's four phases, each one real Adam step on tiny shapes, in a
world of ``n`` gloo ranks on the CPU (each rank a process of its own, the
counterpart of the reference's CPU-pinned child): a dp/tp/sp step with
ring attention, the same with the flash kernels' ring (``ring_flash``), a
dp/tp/ep mixture-of-experts step, and a dp/tp/pp GPipe step.  Rank 0
prints the reference's lines.

    python -m client_tpu_torch.graft 8
"""

import dataclasses
import math
import sys

import numpy as np
import torch

from client_tpu_torch import resolve_device
from client_tpu_torch.serve.models import transformer as tfm

FLAGSHIP = tfm.TransformerConfig(
    vocab_size=8192, d_model=512, n_layers=4, n_heads=8, n_kv_heads=4,
    d_ff=1536, max_seq=512,
)
DRYRUN = tfm.TransformerConfig(
    vocab_size=256, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq=32, dtype="float32",
)


def entry(device=None):
    """Return (fn, example_args): the forward on the flagship LM, its
    params from seed 0 and tokens [4, 128] from seed 1."""
    device = resolve_device(device)
    params = tfm.init_params(torch.Generator().manual_seed(0), FLAGSHIP,
                             device)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, FLAGSHIP.vocab_size, (4, 128))).to(device)

    def fn(params, tokens):
        return tfm.forward(params, tokens, FLAGSHIP)

    return fn, (params, tokens)


def _tokens(seed, shape, vocab):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, shape))


def _step_once(step, opt, params, tokens, what):
    params, _, loss = step(params, opt.init(params), tokens)
    loss = float(loss)
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite {what} loss {loss}")
    return params, loss


def _dryrun_rank(rank, n_devices):
    """One rank of :func:`dryrun_multichip`'s world."""
    from client_tpu_torch.parallel import (
        device_put,
        make_mesh,
        named_shardings,
        param_specs,
    )

    say = print if rank == 0 else (lambda *a, **k: None)
    tp = 2 if n_devices % 2 == 0 else 1
    sp = 2 if (n_devices // tp) % 2 == 0 else 1
    dp = n_devices // (tp * sp)
    mesh = make_mesh(dp=dp, tp=tp, sp=sp, device="cpu")
    cfg = DRYRUN
    batch = max(4 // dp, 1) * dp  # >=4 when possible, always dp-divisible
    seq = 16 * sp  # forward sees `seq` tokens after the shift; sp-divisible

    params = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    params = device_put(params, named_shardings(mesh, param_specs(cfg)))
    tokens = _tokens(1, (batch, seq + 1), cfg.vocab_size)
    opt, step = tfm.make_train_step(cfg, attn_impl="ring", mesh=mesh)
    params, loss = _step_once(step, opt, params, tokens, "ring")
    say(f"dryrun_multichip: mesh dp={dp} tp={tp} sp={sp}, loss={loss:.4f}",
        flush=True)

    # phase 1b: same mesh, ring attention with the flash kernels as the
    # per-step engine
    fopt, fstep = tfm.make_train_step(cfg, attn_impl="ring_flash", mesh=mesh)
    params, floss = _step_once(fstep, fopt, params, tokens, "ring_flash")
    say(f"dryrun_multichip: ring_flash step on the same mesh, "
        f"loss={floss:.4f}", flush=True)

    # phase 2: expert parallelism (MoE, expert dim over ep)
    ep = 2 if n_devices % 2 == 0 else 1
    if ep > 1:
        edp = dp
        etp = n_devices // (edp * ep)
        emesh = make_mesh(dp=edp, tp=etp, ep=ep, device="cpu")
        ecfg = dataclasses.replace(cfg, n_experts=2 * ep, top_k=2)
        eparams = tfm.init_params(torch.Generator().manual_seed(2), ecfg,
                                  "cpu")
        eparams = device_put(eparams,
                             named_shardings(emesh, param_specs(ecfg)))
        eopt, estep = tfm.make_train_step(ecfg, mesh=emesh)
        _, eloss = _step_once(estep, eopt, eparams,
                              _tokens(3, (batch, 17), ecfg.vocab_size), "MoE")
        say(f"dryrun_multichip: MoE mesh dp={edp} tp={etp} ep={ep}, "
            f"loss={eloss:.4f}", flush=True)

    # phase 3: pipeline parallelism (GPipe schedule, permutes over pp)
    pp = 2 if n_devices % 2 == 0 else 1
    if pp > 1:
        pdp = n_devices // (pp * (2 if n_devices % 4 == 0 else 1))
        ptp = n_devices // (pdp * pp)
        pmesh = make_mesh(dp=pdp, tp=ptp, pp=pp, device="cpu")
        pcfg = dataclasses.replace(cfg, n_layers=2 * pp)
        plain = tfm.init_params(torch.Generator().manual_seed(4), pcfg, "cpu")
        pparams = tfm.stack_pipeline_params(plain, pp)
        pparams = device_put(pparams, named_shardings(
            pmesh, tfm.pipeline_param_specs(pparams)))
        popt, pstep = tfm.make_pipeline_train_step(pcfg, pmesh,
                                                   n_microbatches=2)
        # the microbatch (batch/2) splits over this mesh's dp
        _, ploss = _step_once(pstep, popt, pparams,
                              _tokens(5, (2 * pdp, 17), pcfg.vocab_size),
                              "pipeline")
        say(f"dryrun_multichip: pipeline mesh dp={pdp} tp={ptp} pp={pp} "
            f"(GPipe microbatches=2), loss={ploss:.4f}", flush=True)


def dryrun_multichip(n_devices, timeout_s=600):
    """One sharded training step of each phase on ``n_devices`` gloo ranks
    on the CPU (tiny shapes); prints rank 0's lines and returns them.  A
    rank that fails, or a non-finite loss, raises RuntimeError."""
    from client_tpu_torch.parallel import spawn_world

    outs = spawn_world("client_tpu_torch.graft:_dryrun_rank", n_devices,
                       device="cpu", timeout_s=timeout_s)
    sys.stdout.write(outs[0])
    sys.stdout.flush()
    return outs[0].splitlines()


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
