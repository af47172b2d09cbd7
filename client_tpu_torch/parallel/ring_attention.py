"""Causal ring attention over a sequence-parallel mesh dim, and attention
on one device.

Counterpart of client_tpu/parallel/ring_attention.py.  Q/K/V are split
along the sequence over the ``sp`` ranks; each rank keeps its Q shard and
rotates the K/V shards around the ring (``collectives.ppermute``, the
counterpart of ``lax.ppermute``), accumulating the softmax blockwise with
the flash recurrence (running max, denominator and weighted sum, all f32).
After ``sp`` steps every Q shard has seen every KV shard and no rank held
the whole [T, T] scores or the whole K/V.  Under causality a KV shard in
the future of the Q shard is skipped; the diagonal one is masked.

``impl="flash"`` runs each ring step through the flash kernels
(ops/flash_attention.py: ``flash_attention_with_lse``) and merges the
steps by log-sum-exp; the merge hands the kernels' backward a non-zero lse
cotangent.  K and V travel as one packed tensor, so a ring is one chain of
permutes on every rank (see collectives.join for the skipped steps).
"""

import torch

from client_tpu_torch.parallel import collectives

_NEG = -1e30  # stand-in for -inf that keeps exp() NaN-free


def _block_accumulate(o, m, l, q, kb, vb, q_pos, kv_pos, scale, causal):
    """One flash accumulation step against KV block (kb, vb).

    Layouts: q [B,H,Tq,D]; kb/vb [B,H,Tk,D]; o [B,H,Tq,D] f32; m/l
    [B,H,Tq,1] f32.  q_pos [Tq], kv_pos [Tk] are global token positions."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kb.float()) * scale
    if causal:
        mask = q_pos[:, None] >= kv_pos[None, :]
        s = s.masked_fill(~mask[None, None], _NEG)
    blk_max = torch.amax(s, dim=-1, keepdim=True)
    new_m = torch.maximum(m, blk_max)
    corr = torch.exp(m - new_m)
    p = torch.exp(s - new_m)
    new_l = l * corr + torch.sum(p, dim=-1, keepdim=True)
    pv = torch.einsum("bhqk,bhkd->bhqd", p, vb.float())
    return o * corr + pv, new_m, new_l


def _ring_schedule(state, kv, group, causal, step_fn):
    """THE ring schedule, shared by both impls: rotate the packed KV
    around the ring, calling ``step_fn(state, kv, kv_idx, idx)`` for every
    non-future shard pair (under causality, strictly-future KV shards are
    skipped: they contribute nothing).  A skipped step joins the received
    KV to the state, so its permute's backward runs on this rank too."""
    n = collectives.group_size(group)
    idx = 0 if n == 1 else torch.distributed.get_rank(group)
    for step in range(n):
        kv_idx = (idx - step) % n
        if causal and kv_idx > idx:
            state = (collectives.join(state[0], kv),) + tuple(state[1:])
        else:
            state = step_fn(state, kv, kv_idx, idx)
        if step != n - 1:
            kv = collectives.ppermute(kv, group)
    return state


def ring_attention(q, k, v, group=None, causal=True, scale=None,
                   impl="plain"):
    """Per-shard ring attention body: the counterpart of JAX's, with the
    ``sp`` process group in place of the axis name.

    Args:
      q, k, v: [B, T_local, H, D], the local shard of a sequence laid out
        in order over the ranks of ``group`` (None: the default group).
      causal: apply the causal mask at *global* token positions.
      scale: score scale; defaults to D**-0.5.
      impl: "plain" (each step one [Tloc, Tloc] score block in f32) or
        "flash" (each step the flash kernels, merged by log-sum-exp).

    Returns [B, T_local, H, D] in q's dtype.
    """
    if impl == "flash":
        return _ring_attention_flash(q, k, v, group, causal, scale)
    b, t_loc, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    n = collectives.group_size(group)
    idx = 0 if n == 1 else torch.distributed.get_rank(group)
    qh = q.transpose(1, 2)  # [B,H,T,D]
    f32 = dict(dtype=torch.float32, device=q.device)
    o = torch.zeros(qh.shape, **f32)
    m = torch.full((b, h, t_loc, 1), _NEG, **f32)
    l = torch.zeros((b, h, t_loc, 1), **f32)
    positions = torch.arange(t_loc, device=q.device)
    q_pos = idx * t_loc + positions
    # transpose KV once; the schedule rotates whatever layout it is given
    kv = torch.stack([k.transpose(1, 2), v.transpose(1, 2)])

    def step_fn(state, kv, kv_idx, idx):
        o, m, l = state
        kv_pos = kv_idx * t_loc + positions
        return _block_accumulate(o, m, l, qh, kv[0], kv[1], q_pos, kv_pos,
                                 scale, causal)

    o, m, l = _ring_schedule((o, m, l), kv, group, causal, step_fn)
    out = (o / l).to(q.dtype)
    return out.transpose(1, 2)


def _ring_attention_flash(q, k, v, group, causal, scale):
    """Ring schedule with the flash kernels as the per-step engine: each
    step's (out_s, lse_s) for the resident Q shard against the rotating KV
    shard merges by the exact softmax combine ``o <- o*a + o_s*a_s``, the
    a's renormalising by ``logaddexp(lse, lse_s)``."""
    from client_tpu_torch.ops.flash_attention import flash_attention_with_lse

    b, t_loc, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, t_loc, d), **f32)
    lse = torch.full((b, h, t_loc, 1), _NEG, **f32)

    def step_fn(state, kv, kv_idx, idx):
        acc, lse = state
        # the diagonal shard takes the kernel's local causal mask; past
        # shards attend fully (the schedule skipped the future ones)
        out_s, lse_s = flash_attention_with_lse(
            q, kv[0], kv[1], causal=causal and kv_idx == idx, scale=scale)
        out_s = out_s.transpose(1, 2).float()
        new_lse = torch.logaddexp(lse, lse_s)
        return (acc * torch.exp(lse - new_lse)
                + out_s * torch.exp(lse_s - new_lse), new_lse)

    acc, lse = _ring_schedule((acc, lse), torch.stack([k, v]), group,
                              causal, step_fn)
    return acc.to(q.dtype).transpose(1, 2)


def plain_attention(q, k, v, causal=True, scale=None):
    """Reference attention on [B,T,H,D] q and [B,S,H,D] k, v (heads already
    repeated for GQA).  Scores and softmax in f32; out in q's dtype."""
    b, t, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        kt = k.shape[1]
        # offset so the last q row attends to the full kv length (decode case)
        pos_q = torch.arange(t, device=q.device) + (kt - t)
        mask = pos_q[:, None] >= torch.arange(kt, device=q.device)[None, :]
        s = s.masked_fill(~mask[None, None], _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return out.to(q.dtype)


def ring_attention_sharded(q, k, v, mesh, causal=True, scale=None,
                           impl="plain"):
    """The ``shard_map`` counterpart: q, k, v are global [B,T,H,D]
    DTensors on ``mesh`` (a plain tensor, the same on every rank, is laid
    out first), batch over ``dp``, sequence over ``sp``, heads over
    ``tp``.  Each rank runs the ring on its local shards over the ``sp``
    group; the output is a DTensor of the same layout."""
    from torch.distributed.tensor import DTensor

    from client_tpu_torch.parallel import P, placements

    layout = placements(mesh, P("dp", "sp", "tp", None))

    def local(x):
        if not isinstance(x, DTensor):
            from torch.distributed.tensor import distribute_tensor

            x = distribute_tensor(x.detach(), mesh, layout)
        return collectives.contiguous_grad(
            x.redistribute(mesh, layout).to_local())

    out = ring_attention(local(q), local(k), local(v), mesh.get_group("sp"),
                         causal, scale, impl)
    return DTensor.from_local(out, mesh, layout, run_check=False,
                              shape=q.shape, stride=q.stride())
