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


# -- the redesigned kernel's arithmetic, emulated -----------------------------
#
# The CUDA kernel (ops/csrc/paged_attention.cu) splits each lane's keys into
# fixed 64-key splits, writes per-split partials (m, l, acc) and combines
# them in split order.  The card tests hold the kernel itself; here the same
# arithmetic, written out in numpy float32 below (not in the package),
# is held against the JAX function at 1e-5.

def _row_bound(pos, n_keys):
    """(last attended key, uniform): pos < 0 attends every key of the table
    with one score, as the reference's all-masked softmax does."""
    if pos < 0:
        return n_keys - 1, True
    return min(pos, n_keys - 1), False


def _split_k(q, pool_k, pool_v, tables, pos, block_size, split_keys):
    """out [B,T,H,hd] by the kernel's split-K arithmetic in float32: for
    every (lane, KV head), the splits' partials over keys [k0, k0 +
    split_keys) (keys past the block's bound read as zero rows and every
    row masks its own), then the fixed-order combine."""
    b_n, t_n, n_heads, hd = q.shape
    n_kv = pool_k.shape[2]
    rep = n_heads // n_kv
    n_keys = tables.shape[1] * block_size
    n_splits = -(-n_keys // split_keys)
    scale = np.float32(hd ** -0.5)
    n_pool = pool_k.shape[0]
    out = np.zeros(q.shape, np.float32)
    for b in range(b_n):
        bounds = [_row_bound(int(p), n_keys) for p in pos[b]]
        block_last = max(last for last, _ in bounds)
        for g in range(n_kv):
            parts = []  # per split: (m [T,rep], l [T,rep], acc [T,rep,hd])
            for s in range(n_splits):
                k0 = s * split_keys
                m = np.full((t_n, rep), -np.inf, np.float32)
                l = np.zeros((t_n, rep), np.float32)
                acc = np.zeros((t_n, rep, hd), np.float32)
                if k0 <= block_last:
                    keys = np.arange(k0, min(k0 + split_keys, n_keys))
                    blk = np.clip(tables[b, keys // block_size], 0, n_pool - 1)
                    kk = pool_k[blk, keys % block_size, g].astype(np.float32)
                    vv = pool_v[blk, keys % block_size, g].astype(np.float32)
                    kk[keys > block_last] = 0
                    vv[keys > block_last] = 0
                    for t in range(t_n):
                        last, uniform = bounds[t]
                        for i in range(rep):
                            qv = q[b, t, g * rep + i].astype(np.float32)
                            sc = np.zeros(len(keys), np.float32) if uniform \
                                else (kk @ qv) * scale
                            sc = np.where(keys > last, -np.inf, sc)
                            mx = sc.max()
                            if mx == -np.inf:
                                continue  # no key of this row here
                            e = np.exp(sc - mx).astype(np.float32)
                            m[t, i], l[t, i] = mx, e.sum(dtype=np.float32)
                            acc[t, i] = e @ vv
                parts.append((m, l, acc))
            mx = np.max([p[0] for p in parts], axis=0)
            l_all = np.zeros((t_n, rep), np.float32)
            acc_all = np.zeros((t_n, rep, hd), np.float32)
            for m, l, acc in parts:  # the splits in order
                w = np.where(m == -np.inf, 0,
                             np.exp(np.where(m == -np.inf, 0, m - mx)))
                w = w.astype(np.float32)
                l_all += w * l
                acc_all += w[..., None] * acc
            out[b, :, g * rep:(g + 1) * rep] = acc_all / l_all[..., None]
    return out


def _split_case(seed, n_heads=4, n_kv=2, hd=16, block_size=16, width=32):
    """The engine's table (32 blocks of 16 keys: 8 splits of 64) with lanes
    at every edge: contexts ending mid-block (most splits attend no key),
    one exactly on a split boundary, a lane filling the whole table (one
    position past its end), verify rows and a lane at pos = -1."""
    rng = np.random.default_rng(seed)
    n_keys = width * block_size
    t = 3
    ends = [5, 63, 64, 200, n_keys - 1, n_keys + 1]
    pos = np.array([[e - 2, e - 1, e] for e in ends] + [[-1, -1, -1]],
                   np.int32)
    b = pos.shape[0]
    n_blocks = b * width
    perm = rng.permutation(np.arange(1, n_blocks + 1)).astype(np.int32)
    tables = np.zeros((b, width), np.int32)
    for i in range(b):
        own = min(int(pos[i].max()) // block_size + 1, width)
        tables[i, :own] = perm[i * width:i * width + own]
    tables[-1] = perm[-width:]  # the pos = -1 lane: a full table
    shape = (n_blocks + 1, block_size, n_kv, hd)
    pool_k = rng.standard_normal(shape).astype(np.float32)
    pool_v = rng.standard_normal(shape).astype(np.float32)
    q = rng.standard_normal((b, t, n_heads, hd)).astype(np.float32)
    return q, pool_k, pool_v, tables, pos, block_size


@pytest.mark.parametrize("split_keys", [64, 16])
def test_split_k_arithmetic_matches_jax(split_keys):
    """The kernel's split-K arithmetic (64-key splits as in the kernel, and
    16-key ones for more splits a lane) against the JAX paged_attention in
    float32 at 1e-5: splits past every row's bound, contexts ending
    mid-block and on a split boundary, a lane whose context fills (and
    passes) the table, and pos = -1 (the uniform row)."""
    q, pool_k, pool_v, tables, pos, bs = _split_case(seed=split_keys)
    jcfg, _ = _configs(q.shape[2], pool_k.shape[2], q.shape[3], "float32")
    want = np.asarray(jtfm.paged_attention(
        jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v),
        jnp.asarray(tables), jnp.asarray(pos), jcfg, bs))
    got = _split_k(q, pool_k, pool_v, tables, pos, bs, split_keys)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= F32_ATOL, np.abs(got - want).max()
    # the pos = -1 lane is the mean of every V row its table gathers
    mean = pool_v[tables[-1]].reshape(-1, *pool_v.shape[2:]).mean(axis=0)
    np.testing.assert_allclose(got[-1, 0], np.repeat(mean, 2, axis=0),
                               atol=F32_ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_no_attended_key_matches_jax(dtype):
    """A query at pos = -1 attends no key: the reference's softmax over
    all-masked scores is uniform, so its output is the mean of the V rows
    its whole table gathers.  The plain version (which the kernel is held
    against on the card) gives the same, beside ordinary lanes."""
    q, pool_k, pool_v, tables, pos, bs = _case("decode", 4, 2, 16, seed=9)
    pos = pos.copy()
    pos[1, 0] = -1
    jcfg, cfg = _configs(4, 2, 16, dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jarr = {k: np.asarray(jnp.asarray(v, jdt))
            for k, v in {"q": q, "k": pool_k, "v": pool_v}.items()}
    want = np.asarray(jtfm.paged_attention(
        jnp.asarray(jarr["q"]), jnp.asarray(jarr["k"]),
        jnp.asarray(jarr["v"]), jnp.asarray(tables), jnp.asarray(pos), jcfg,
        bs).astype(jnp.float32))
    t = convert.params_from_numpy(
        {**jarr, "tables": tables, "pos": pos}, "cpu")
    got = tfm.paged_attention(t["q"], t["k"], t["v"], t["tables"], t["pos"],
                              cfg, bs)
    _hold(got, want, dtype)
    v32 = jarr["v"].astype(np.float32)
    mean = v32[tables[1]].reshape(-1, 2, 16).mean(axis=0)
    tol = F32_ATOL if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got[1, 0].float().numpy(),
                               np.repeat(mean, 2, axis=0), atol=tol)
