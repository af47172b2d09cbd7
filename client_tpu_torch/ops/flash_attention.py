"""Flash attention with hand-written CUDA kernels for the forward and backward.

Counterpart of client_tpu/ops/flash_attention.py, on the same [B, T, H, D]
interface and with the same dispatch rules:

- ``flash_attention`` pads T to ``lcm(block_q, block_k)`` on the causal path
  and sends ragged non-causal input to ``plain_attention``;
- ``flash_attention_with_lse`` returns ``(out, lse)`` (lse [B, H, T, 1]
  f32), takes ``_reference_lse`` for a ragged shard of length <= 1024 and
  refuses a longer one.

``block_q``/``block_k`` only decide that dispatch, as in the JAX package;
the CUDA kernels pick their own tiles and mask a ragged T edge themselves
(bf16 on the tensor cores in ``csrc/flash_fwd_bf16.cu`` and
``csrc/flash_bwd_bf16.cu``, f32 in ``csrc/flash_attention.cu``).  The two ``jax.custom_vjp``s become one
``torch.autograd.Function`` whose backward is the dQ kernel plus the dK/dV
kernel (the FA-2 two-kernel scheme: no atomics, the same result on every
run), with ``delta = rowsum(dO * O)`` computed in plain torch between them.

On a CUDA tensor each step launches its kernel (``flash_fwd``,
``flash_bwd_dq``, ``flash_bwd_dkv`` in ``ops.LAUNCHES``); on a CPU tensor
it takes ``_fa_forward_reference`` / ``_fa_backward_reference``, the plain
PyTorch versions of the same arithmetic: scores, p and every product in
f32, as the Pallas kernels take them.
"""

import math

import torch

from client_tpu_torch.ops import count_launch
from client_tpu_torch.parallel.ring_attention import _NEG, plain_attention


def _causal_mask(t, device):
    pos = torch.arange(t, device=device)
    return pos[:, None] >= pos[None, :]


def _scores(q, k, scale, causal):
    """[BH,T,T] f32 scores, scaled and causally masked with ``_NEG``."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        s = s.masked_fill(~_causal_mask(q.shape[1], q.device), _NEG)
    return s


def _fa_forward_reference(q, k, v, scale, causal):
    """Plain version of the forward kernel on [BH,T,D]: (out in q's dtype,
    lse [BH,T,1] f32).  p·V is taken in f32, as the Pallas kernel does."""
    s = _scores(q, k, scale, causal)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.exp(s - lse)
    out = torch.einsum("bqk,bkd->bqd", p, v.float())
    return out.to(q.dtype), lse


def _fa_backward_reference(q, k, v, out, lse, g, g_lse, scale, causal):
    """Plain version of the dQ and dK/dV kernels on [BH,T,D]: the JAX
    kernels' algebra (``_block_dscores``) written out, not autograd:
    p = exp(s - lse), ds = p·(dO·Vᵀ - delta + dLSE)·scale."""
    delta = _delta(g, out)
    s = _scores(q, k, scale, causal)
    p = torch.exp(s - lse)
    do = g.float()
    dp = torch.einsum("bqd,bkd->bqk", do, v.float())
    ds = p * (dp - delta + g_lse) * scale
    dq = torch.einsum("bqk,bkd->bqd", ds, k.float())
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float())
    dv = torch.einsum("bqk,bqd->bkd", p, do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _delta(g, out):
    """rowsum(dO ⊙ O) in f32, [BH,T,1]: the softmax Jacobian's row term."""
    return torch.sum(g.float() * out.float(), dim=-1, keepdim=True)


def _kernels():
    from client_tpu_torch.ops._build import kernels

    return kernels()


def _fa_forward(q, k, v, scale, causal):
    """[BH,T,D] q, k, v -> (out [BH,T,D], lse [BH,T,1] f32)."""
    if q.device.type == "cpu":
        return _fa_forward_reference(q, k, v, scale, causal)
    out, lse = _kernels().flash_fwd(q, k, v, float(scale), bool(causal))
    count_launch("flash_fwd")
    return out, lse


def _fa_backward(q, k, v, out, lse, g, g_lse, scale, causal):
    """Fused flash backward on [BH,T,D] -> (dq, dk, dv).  ``g_lse`` is the
    cotangent of the forward's lse ([BH,T,1] f32; zeros when only the
    attention output is differentiated)."""
    if q.device.type == "cpu":
        return _fa_backward_reference(q, k, v, out, lse, g, g_lse, scale,
                                      causal)
    ext = _kernels()
    g = g.contiguous()
    delta = _delta(g, out)
    g_lse = g_lse.float().contiguous()
    dq = ext.flash_bwd_dq(q, k, v, g, lse, delta, g_lse, float(scale),
                          bool(causal))
    count_launch("flash_bwd_dq")
    dk, dv = ext.flash_bwd_dkv(q, k, v, g, lse, delta, g_lse, float(scale),
                               bool(causal))
    count_launch("flash_bwd_dkv")
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """(out, lse) with the flash backward.  JAX's two custom_vjps are one
    Function here: ``_fa_lse``'s backward takes the lse cotangent, and
    where only ``out`` is used (JAX's ``_fa``) autograd hands the backward
    a zero lse cotangent, which is ``_fa``'s."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        out, lse = _fa_forward(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _fa_backward(q, k, v, out, lse, g, g_lse, ctx.scale,
                                  ctx.causal)
        return dq, dk, dv, None, None


def _prep(t, d, scale, block_q, block_k):
    """Default score scale and the JAX package's 32-aligned block clamps
    (never clamped to a ragged t)."""
    if scale is None:
        scale = d ** -0.5
    align = 32
    block_q = min(block_q, -(-t // align) * align)
    block_k = min(block_k, -(-t // align) * align)
    return scale, block_q, block_k


def _fold(x, b, t, h, d):
    """[B,T,H,D] -> contiguous [B*H, T, D]."""
    return x.permute(0, 2, 1, 3).reshape(b * h, t, d).contiguous()


def _reference_lse(q, k, v, causal, scale):
    """(out, lse) on [BH,T,D] by plain einsums (differentiated by autograd):
    the ragged-shard path of ``flash_attention_with_lse``."""
    s = _scores(q, k, scale, causal)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.exp(s - lse)
    out = torch.einsum("bqk,bkd->bqd", p.to(v.dtype), v).to(q.dtype)
    return out, lse


def flash_attention_with_lse(q, k, v, causal=True, scale=None, block_q=128,
                             block_k=128):
    """Flash attention returning ``(out, lse)`` on the [B, T, H, D] layout.

    ``lse`` is [B, H, T, 1] f32, the per-row log-sum-exp that lets partial
    results over disjoint KV shards merge exactly.  T must tile by the
    (aligned) blocks; a ragged shard of length <= 1024 takes the einsum
    reference, a longer one raises ValueError.
    """
    b, t, h, d = q.shape
    scale, block_q, block_k = _prep(t, d, scale, block_q, block_k)
    qf = _fold(q, b, t, h, d)
    kf = _fold(k, b, t, h, d)
    vf = _fold(v, b, t, h, d)
    if t % block_q or t % block_k:
        if t > 1024:
            raise ValueError(
                f"shard length {t} does not tile by blocks "
                f"({block_q},{block_k}) and is too long for the dense "
                "fallback; pad the sequence so shards tile"
            )
        out, lse = _reference_lse(qf, kf, vf, causal, scale)
    else:
        out, lse = _FlashAttention.apply(qf, kf, vf, scale, causal)
    out = out.reshape(b, h, t, d).permute(0, 2, 1, 3)
    return out, lse.reshape(b, h, t, 1)


def flash_attention(q, k, v, causal=True, scale=None, block_q=128,
                    block_k=128):
    """Flash attention with the ``plain_attention`` interface.

    Args:
      q, k, v: [B, T, H, D] (same head count: repeat GQA KV first).
      causal: apply the causal mask (q and kv of one length).
      scale: score scale; defaults to D**-0.5.
      block_q, block_k: the JAX package's tile sizes, clamped to the padded
        length; they decide the padding and the dispatch.

    Returns [B, T, H, D] in q's dtype.
    """
    b, t, h, d = q.shape
    scale, block_q, block_k = _prep(t, d, scale, block_q, block_k)
    pad = (-t) % math.lcm(block_q, block_k)

    if pad and not causal:
        # no positional mask neutralises padded keys: the ragged remainder
        # takes the plain formulation, as in the JAX package
        return plain_attention(q, k, v, causal=False, scale=scale)

    qf = _fold(q, b, t, h, d)
    kf = _fold(k, b, t, h, d)
    vf = _fold(v, b, t, h, d)
    if pad:
        # padded KV rows sit in the causal future of every real Q row;
        # padded Q rows are sliced off below
        qf, kf, vf = (torch.nn.functional.pad(x, (0, 0, 0, pad))
                      for x in (qf, kf, vf))

    out, _ = _FlashAttention.apply(qf, kf, vf, scale, causal)
    if pad:
        out = out[:, :t]
    return out.reshape(b, h, t, d).permute(0, 2, 1, 3)
