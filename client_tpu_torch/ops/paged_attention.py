"""Paged attention with a hand-written CUDA kernel.

Counterpart of client_tpu/serve/models/transformer.py:paged_attention, the
attention of every step the continuous-batching engine runs: roped ``q``
``[B, T, H, hd]`` attends to one layer's block pools ``[n_blocks+1,
block_size, KV, hd]`` through the per-lane block tables ``[B, W]`` int32,
query head ``h`` reading KV head ``h // (H // KV)``, a key at logical
position ``j`` attended iff ``j <= pos[b, t]`` (``pos [B, T]`` int32),
scores and softmax in f32, the output in the pools' dtype.

On a CUDA tensor ``paged_attention`` launches ``csrc/paged_attention.cu``,
which walks each lane's table only up to the mask bound; on a CPU tensor it
takes ``paged_attention_reference``, the plain PyTorch version, which
mirrors the JAX function step by step (the whole-table gather, the KV-head
repeat, f32 scores, the ``-1e30`` mask, softmax, ``p`` cast to the pools'
dtype for P.V).  Nothing on the card's main path calls the plain version.
"""

import torch

from client_tpu_torch.ops import count_launch

_MASKED = -1e30  # the reference's mask value: exp() of it is exactly 0


def paged_attention_reference(q, pool_k, pool_v, tables, pos, block_size):
    """The plain PyTorch version of the kernel (see the module docstring)."""
    b = q.shape[0]
    _, _, n_kv, hd = pool_k.shape
    n_rep = q.shape[2] // n_kv
    s_len = tables.shape[-1] * block_size
    idx = tables.long()
    kk = pool_k[idx].reshape(b, s_len, n_kv, hd)
    vv = pool_v[idx].reshape(b, s_len, n_kv, hd)
    if n_rep > 1:
        kk = torch.repeat_interleave(kk, n_rep, dim=2)
        vv = torch.repeat_interleave(vv, n_rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * (hd ** -0.5)
    keys = torch.arange(s_len, device=q.device)
    valid = keys[None, None, :] <= pos[:, :, None]  # [B,T,S]
    s = s.masked_fill(~valid[:, None], _MASKED)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(vv.dtype), vv)


def _launch(q, pool_k, pool_v, tables, pos, block_size):
    from client_tpu_torch.ops._build import kernels

    out = kernels().paged_attention(q, pool_k, pool_v, tables, pos,
                                    int(block_size))
    count_launch("paged_attention")
    return out


def paged_attention(q, pool_k, pool_v, tables, pos, block_size):
    """Paged attention; returns ``[B, T, H, hd]`` in the pools' dtype.

    A CUDA tensor always goes to the kernel, which refuses (raises on) a
    shape, dtype or layout it does not take; a CPU tensor goes to the plain
    version."""
    if q.device.type == "cpu":
        return paged_attention_reference(q, pool_k, pool_v, tables, pos,
                                         block_size)
    return _launch(q, pool_k, pool_v, tables, pos, block_size)
