"""Differentiable collectives: the port's ``lax.ppermute`` and ``lax.psum``.

JAX differentiates straight through its collectives (the transpose of a
ppermute is the reverse ppermute, of a psum a broadcast).  Autograd does
not pass through ``torch.distributed``'s point-to-point calls, so each
collective here is a ``torch.autograd.Function`` with its transpose
written out:

- ``ppermute(x, group, shift)``: rank i sends to rank i + shift of
  ``group`` and receives from rank i - shift; the backward sends the
  cotangent the other way round;
- ``psum(xs, groups)``: forward all-reduce (sum) over every group in
  ``groups``, backward the identity: what follows the sum is computed alike
  on every rank of the groups, so each rank's share of the gradient is the
  cotangent itself (Megatron's "g");
- ``pbroadcast(xs, groups)``: the forward identity, the backward an
  all-reduce: a replicated value read by rank-local work whose cotangents
  are partial (Megatron's "f");
- ``join(x, *deps)``: x unchanged, with an edge to each of ``deps`` that
  carries a zero cotangent.  A rank that skips work on a received tensor
  joins it to what it keeps, so that the backward of every collective runs
  on every rank, in the same order (each rank's autograd graph has the
  same chain of collectives).

Gloo has no send or receive of CUDA tensors: where a group's backend is
gloo and the tensor lies on CUDA, ``ppermute`` copies it through a pinned
host buffer and back (``STATS["bytes_staged"]``: bytes copied to the host
plus bytes copied back).  NCCL never stages.  Groups of one rank skip their
collective.
"""

import threading

import torch
import torch.distributed as dist

# ppermute calls (forward and backward) and the bytes they staged through
# host memory (gloo with CUDA tensors); reset with reset_stats()
STATS = {"ppermute": 0, "bytes_staged": 0}
_lock = threading.Lock()


def reset_stats():
    with _lock:
        for key in STATS:
            STATS[key] = 0


def _count(name, n=1):
    with _lock:
        STATS[name] += n


def group_size(group):
    return 1 if group is None else dist.get_world_size(group)


def _staged(x, group):
    return x.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _sendrecv(x, group, shift):
    """Send ``x`` to rank (i + shift) of ``group``, receive its like from
    rank (i - shift); returns the received tensor."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    x = x.contiguous()
    staged = _staged(x, group)
    if staged:
        send = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        send.copy_(x)
    else:
        send = x
    recv = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, dst, group),
        dist.P2POp(dist.irecv, recv, src, group),
    ])
    for req in reqs:
        req.wait()
    _count("ppermute")
    if staged:
        _count("bytes_staged", 2 * x.numel() * x.element_size())
        return recv.to(x.device)
    return recv


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _sendrecv(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _sendrecv(g, ctx.group, -ctx.shift), None, None


def ppermute(x, group, shift=1):
    """Rotate ``x`` around ``group``'s ring by ``shift`` ranks (the
    counterpart of ``lax.ppermute`` with perm ``[(i, (i + shift) % n)]``)."""
    if group_size(group) == 1:
        return x
    return _PPermute.apply(x, group, shift)


def _live(groups):
    return tuple(g for g in groups if group_size(g) > 1)


def _all_reduce(xs, groups, op=dist.ReduceOp.SUM):
    outs = []
    for x in xs:
        x = x.clone(memory_format=torch.contiguous_format)
        for group in groups:
            dist.all_reduce(x, op=op, group=group)
        outs.append(x)
    return outs


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, groups, *xs):
        return tuple(_all_reduce(xs, groups))

    @staticmethod
    def backward(ctx, *gs):
        return (None, *gs)


class _PBroadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, groups, *xs):
        ctx.groups = groups
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *_all_reduce(gs, ctx.groups))


def psum(xs, groups):
    """All-reduce (sum) each tensor of ``xs`` over every group in
    ``groups``; the backward passes the cotangent through (see the module
    docstring).  Returns a tuple like ``xs``."""
    groups = _live(groups)
    if not groups:
        return tuple(xs)
    return _PSum.apply(groups, *xs)


def pmax(x, groups):
    """All-reduce (max) ``x`` over ``groups``, outside autograd (a
    stabilising shift whose gradient cancels)."""
    groups = _live(groups)
    if not groups:
        return x.detach()
    return _all_reduce([x.detach()], groups, dist.ReduceOp.MAX)[0]


def pbroadcast(xs, groups):
    """Each tensor of ``xs`` unchanged; its cotangent all-reduced (sum)
    over ``groups`` in the backward.  Returns a tuple like ``xs``."""
    groups = _live(groups)
    if not groups:
        return tuple(xs)
    return _PBroadcast.apply(groups, *xs)


class _Join(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *deps):
        ctx.deps = [(d.shape, d.dtype, d.device) for d in deps]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # zeros, not None: the engine skips a node whose every cotangent
        # is None, and the permute behind a dep must run on every rank
        return (g, *(torch.zeros(shape, dtype=dtype, device=device)
                     for shape, dtype, device in ctx.deps))


def join(x, *deps):
    """``x``, with autograd edges to ``deps`` that carry no gradient."""
    return _Join.apply(x, *deps)


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def contiguous_grad(x):
    """``x``, whose cotangent is made contiguous on its way back.  Put on
    a DTensor's ``to_local()``: the autograd engine copies a leaf's
    gradient that does not match the leaf's strides, and for a DTensor
    that copy goes through DTensor dispatch, whose sharding rule costs
    seconds to look up on a five-dim mesh."""
    return _ContiguousGrad.apply(x)
