"""client_tpu_torch's paged_attention held against
client_tpu.serve.models.transformer.paged_attention.

The same numpy inputs (made from a seed) go through the JAX function and
the port's (``transformer.paged_attention``, which on CPU tensors takes
the kernel's plain version, ``ops.paged_attention.paged_attention_reference``)
at the engine's three shapes: decode (T = 1 over several lanes), verify
(T = width at consecutive positions) and prefill (B = 1, T = chunk, with
padded positions past the prompt).  Block tables are shuffled physical
blocks with their tails mapped to the trash block 0, last blocks are
partly filled, and the query heads group over fewer KV heads (GQA).

Stated tolerances: float32 within 1e-5 (f32 sums in another order);
bfloat16 within one bf16 ulp of the reference output at its magnitude
(both round p to bf16 before P.V; their f32 softmaxes differ in the last
bits, which can move a rounding by one ulp).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from client_tpu.serve.models import transformer as jtfm
from client_tpu_torch import convert, ops
from client_tpu_torch.ops import paged_attention as pa
from client_tpu_torch.serve.models import transformer as tfm

F32_ATOL = 1e-5


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significand bits)."""
    mag = np.maximum(np.abs(x), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


def _case(kind, n_heads, n_kv, hd, seed, block_size=8, table_width=6,
          n_blocks=24):
    """(q, pool_k, pool_v, tables, pos) numpy f32/int32 for one shape."""
    rng = np.random.default_rng(seed)
    s_len = table_width * block_size
    if kind == "decode":
        b, t = 4, 1
        # one lane at position 0, one at a block's last row, one mid-block
        pos = np.array([[0], [block_size - 1], [block_size + 3],
                        [s_len - 2]], np.int32)
    elif kind == "verify":
        b, t = 3, 5
        lens = np.array([2, block_size - 2, 3 * block_size + 1])
        pos = (lens[:, None] + np.arange(t)[None, :]).astype(np.int32)
    else:  # prefill: one lane, a chunk whose tail pads past the prompt
        b, t = 1, 16
        pos = (block_size + 5 + np.arange(t)[None, :]).astype(np.int32)
    tables = np.zeros((b, table_width), np.int32)
    perm = rng.permutation(np.arange(1, n_blocks + 1))
    used = 0
    for i in range(b):
        # the lane owns the blocks its furthest position needs; the rest
        # of its row maps to the trash block
        own = min(int(pos[i].max()) // block_size + 1, table_width)
        tables[i, :own] = perm[used:used + own]
        used += own
    shape = (n_blocks + 1, block_size, n_kv, hd)
    pool_k = rng.standard_normal(shape).astype(np.float32)
    pool_v = rng.standard_normal(shape).astype(np.float32)
    q = rng.standard_normal((b, t, n_heads, hd)).astype(np.float32)
    return q, pool_k, pool_v, tables, pos, block_size


def _configs(n_heads, n_kv, hd, dtype):
    jcfg = jtfm.TransformerConfig(
        vocab_size=16, d_model=n_heads * hd, n_layers=1, n_heads=n_heads,
        n_kv_heads=n_kv, d_ff=32, max_seq=64, dtype=dtype,
    )
    return jcfg, tfm.TransformerConfig(**dataclasses.asdict(jcfg))


def _both(kind, n_heads, n_kv, hd, dtype, seed=0):
    q, pool_k, pool_v, tables, pos, bs = _case(kind, n_heads, n_kv, hd, seed)
    jcfg, cfg = _configs(n_heads, n_kv, hd, dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    arrays = {"q": q, "k": pool_k, "v": pool_v}
    jarr = {k: np.asarray(jnp.asarray(v, jdt)) for k, v in arrays.items()}
    want = jtfm.paged_attention(
        jnp.asarray(jarr["q"]), jnp.asarray(jarr["k"]),
        jnp.asarray(jarr["v"]), jnp.asarray(tables), jnp.asarray(pos), jcfg,
        bs,
    )
    t = convert.params_from_numpy(
        {**jarr, "tables": tables, "pos": pos}, "cpu")
    got = tfm.paged_attention(t["q"], t["k"], t["v"], t["tables"], t["pos"],
                              cfg, bs)
    return got, np.asarray(want.astype(jnp.float32)), t


def _hold(got, want, dtype):
    got = got.float().numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want)
    if dtype == "float32":
        assert err.max() <= F32_ATOL, err.max()
    else:
        assert (err <= _bf16_ulp(want)).all(), err.max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["decode", "verify", "prefill"])
@pytest.mark.parametrize("heads", [(4, 2, 16), (8, 2, 32), (4, 4, 16)],
                         ids=["gqa2-hd16", "gqa4-hd32", "mha-hd16"])
def test_paged_attention_matches_jax(kind, heads, dtype):
    got, want, _ = _both(kind, *heads, dtype)
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    _hold(got, want, dtype)


@pytest.mark.parametrize("kind", ["decode", "verify", "prefill"])
def test_masked_rows_never_change_the_output(kind):
    """Rows the mask excludes (the trash block, table tails, rows past
    pos in a lane's last block) can hold anything: rewriting them leaves
    the output unchanged.  The kernel goes further and never loads them
    (tests/test_torch_cuda.py poisons them with NaN on the card)."""
    q, pool_k, pool_v, tables, pos, bs = _case(kind, 4, 2, 16, seed=3)
    _, cfg = _configs(4, 2, 16, "float32")
    attended = np.zeros(pool_k.shape[:2], bool)
    for b in range(tables.shape[0]):
        for j in range(int(pos[b].max()) + 1):
            if j < tables.shape[1] * bs:
                attended[tables[b, j // bs], j % bs] = True
    args = [torch.from_numpy(x) for x in (q, pool_k, pool_v, tables, pos)]
    base = tfm.paged_attention(*args, cfg, bs)
    k2, v2 = pool_k.copy(), pool_v.copy()
    k2[~attended] = 1e4
    v2[~attended] = -1e4
    args[1], args[2] = torch.from_numpy(k2), torch.from_numpy(v2)
    assert torch.equal(tfm.paged_attention(*args, cfg, bs), base)


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    _, _, t = _both("decode", 4, 2, 16, "float32")
    before = ops.LAUNCHES["paged_attention"]
    _, cfg = _configs(4, 2, 16, "float32")
    got = tfm.paged_attention(t["q"], t["k"], t["v"], t["tables"], t["pos"],
                              cfg, 8)
    want = pa.paged_attention_reference(t["q"], t["k"], t["v"], t["tables"],
                                        t["pos"], 8)
    assert torch.equal(got, want)
    assert ops.LAUNCHES["paged_attention"] == before


def test_head_counts_must_match_the_config():
    _, _, t = _both("decode", 4, 2, 16, "float32")
    _, cfg = _configs(8, 2, 16, "float32")
    with pytest.raises(ValueError, match="heads"):
        tfm.paged_attention(t["q"], t["k"], t["v"], t["tables"], t["pos"],
                            cfg, 8)
