"""The port on the card: tests marked ``cuda`` skip on a machine without
an NVIDIA GPU.  This file imports neither jax nor client_tpu, so it also
runs on the GPU machine, which has neither:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest`` skips tests/conftest.py, which sets up jax for the rest
of the suite.)
"""

import numpy as np
import pytest
import torch

from client_tpu_torch import ops
from client_tpu_torch.ops import flash_attention as fa
from client_tpu_torch.ops import quant
from client_tpu_torch.serve.models import transformer as tfm

_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# a kernel against its plain version: f32 sums in another order; bf16
# within one ulp of the f32-summed result (as in chip_smoke.py)
_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 1e-2)}
_TINY = tfm.TransformerConfig(
    vocab_size=258, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq=64, dtype="float32",
)


@pytest.fixture
def cuda_device():
    """Decided at test time, never at import (xdist workers must collect
    the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run this file on the card")
    return torch.device("cuda")


def _weights(seed, k, n):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version(cuda_device, dtype):
    """The CUDA kernel against int8_matmul_reference on the card, at the
    served shapes and ragged M; one counted launch per call."""
    atol, rtol = _TOL[dtype]
    rng = np.random.default_rng(11)
    for m in (1, 7, 37, 128):
        for k, n in ((256, 256), (256, 128), (256, 768), (64, 128)):
            x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
            x = x.to(_DT[dtype]).to(cuda_device)
            qw = quant.quantize_int8(_weights(m * k, k, n).to(cuda_device))
            before = ops.LAUNCHES["int8_matmul"]
            got = quant.int8_matmul(x, qw)
            assert ops.LAUNCHES["int8_matmul"] == before + 1
            want = quant.int8_matmul_reference(x, qw["q"], qw["s"])
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_both_routes_match_plain_version(cuda_device, dtype):
    """Both routes of int8_matmul.cu against int8_matmul_reference: the GEMV
    kernel at M <= 8 (N a multiple of 16), the tiled one at M = 9 and 16, at
    N = 40 (not a multiple of 16) and for a q whose rows the 16-byte loads
    cannot take; one counted launch a call."""
    atol, rtol = _TOL[dtype]
    rng = np.random.default_rng(12)
    for m in list(range(1, 10)) + [16]:
        for k, n in ((256, 256), (256, 128), (256, 768), (64, 40)):
            x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
            x = x.to(_DT[dtype]).to(cuda_device)
            qw = quant.quantize_int8(_weights(m * n + k, k, n).to(cuda_device))
            want = quant.int8_matmul_reference(x, qw["q"], qw["s"])
            # the same q one byte off a 16-byte boundary: the tiled route
            shifted = torch.empty(k * n + 1, dtype=torch.int8,
                                  device=cuda_device)[1:].view(k, n)
            shifted.copy_(qw["q"])
            for q in (qw["q"], shifted):
                before = ops.LAUNCHES["int8_matmul"]
                got = quant.int8_matmul(x, {"q": q, "s": qw["s"]})
                assert ops.LAUNCHES["int8_matmul"] == before + 1
                torch.cuda.synchronize()
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_bf16_flash_forward_matches_plain_version(cuda_device, d, causal):
    """The tensor-core bf16 forward (flash_fwd_bf16.cu) against
    _fa_forward_reference: out within one bf16 ulp of the f32-summed
    result, lse (f32 on both sides) at 1e-4; T = 1 and 100 leave a ragged
    64-row tile; one counted launch a call."""
    atol, rtol = _TOL["bfloat16"]
    gen = torch.Generator().manual_seed(d + causal)
    for t in (1, 64, 100, 512):
        q, k, v = (torch.randn(3, t, d, generator=gen).bfloat16()
                   .to(cuda_device) for _ in range(3))
        scale = d ** -0.5
        before = ops.LAUNCHES["flash_fwd"]
        out, lse = fa._fa_forward(q, k, v, scale, causal)
        assert ops.LAUNCHES["flash_fwd"] == before + 1
        want_out, want_lse = fa._fa_forward_reference(q, k, v, scale, causal)
        torch.cuda.synchronize()
        assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
        torch.testing.assert_close(out.float(), want_out.float(), atol=atol,
                                   rtol=rtol)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    # a negative scale flips q's sign inside the kernel: the same function
    out, lse = fa._fa_forward(q, k, v, -scale, causal)
    want_out, want_lse = fa._fa_forward_reference(q, k, v, -scale, causal)
    torch.testing.assert_close(out.float(), want_out.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_bf16_flash_forward_refuses_a_misaligned_tensor(cuda_device):
    """The 16-byte copies need 16-byte aligned rows: a q two bytes off
    raises instead of launching (no fallback to another kernel)."""
    x = torch.ones(2, 64, 64, dtype=torch.bfloat16, device=cuda_device)
    off = torch.empty(x.numel() + 1, dtype=torch.bfloat16,
                      device=cuda_device)[1:].view(2, 64, 64)
    off.copy_(x)
    with pytest.raises(RuntimeError, match="misaligned"):
        fa._fa_forward(off, x, x, 0.125, True)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_bf16_flash_backward_matches_plain_version(cuda_device, d, causal):
    """The tensor-core bf16 dQ and dK/dV kernels (flash_bwd_bf16.cu) against
    _fa_backward_reference, within one bf16 ulp of the f32-summed result,
    with a zero and a randn lse cotangent; T = 1 and 100 leave a ragged
    64-row tile, and a negative scale must mask p itself; one counted
    launch of each kernel a call."""
    atol, rtol = _TOL["bfloat16"]
    gen = torch.Generator().manual_seed(100 + d + causal)

    def held(q, k, v, g, scale):
        out, lse = fa._fa_forward(q, k, v, scale, causal)
        for g_lse in (torch.zeros_like(lse),
                      torch.randn(*lse.shape, generator=gen).to(cuda_device)):
            before = dict(ops.LAUNCHES)
            got = fa._fa_backward(q, k, v, out, lse, g, g_lse, scale, causal)
            assert ops.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
            assert ops.LAUNCHES["flash_bwd_dkv"] == \
                before["flash_bwd_dkv"] + 1
            want = fa._fa_backward_reference(q, k, v, out, lse, g, g_lse,
                                             scale, causal)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert a.dtype == torch.bfloat16
                torch.testing.assert_close(a.float(), b.float(), atol=atol,
                                           rtol=rtol)

    for t in (1, 64, 100, 512):
        q, k, v, g = (torch.randn(3, t, d, generator=gen).bfloat16()
                      .to(cuda_device) for _ in range(4))
        held(q, k, v, g, d ** -0.5)
    held(q, k, v, g, -d ** -0.5)


@pytest.mark.cuda
def test_bf16_flash_backward_refuses_a_misaligned_tensor(cuda_device):
    """Each backward kernel's 16-byte copies need 16-byte aligned rows: a q
    two bytes off raises instead of launching (no fallback)."""
    x = torch.ones(2, 64, 64, dtype=torch.bfloat16, device=cuda_device)
    off = torch.empty(x.numel() + 1, dtype=torch.bfloat16,
                      device=cuda_device)[1:].view(2, 64, 64)
    off.copy_(x)
    rows = torch.zeros(2, 64, 1, device=cuda_device)
    ext = fa._kernels()
    with pytest.raises(RuntimeError, match="misaligned"):
        ext.flash_bwd_dq(off, x, x, x, rows, rows, rows, 0.125, True)
    with pytest.raises(RuntimeError, match="misaligned"):
        ext.flash_bwd_dkv(off, x, x, x, rows, rows, rows, 0.125, True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_backward_repeats_bit_for_bit(cuda_device, dtype):
    """Two launches of the dQ and dK/dV kernels on the same inputs give
    equal dq, dk and dv: no atomics, so a checkpoint resume can be exact."""
    gen = torch.Generator().manual_seed(31)
    q, k, v, g = (torch.randn(8, 512, 64, generator=gen).to(_DT[dtype])
                  .to(cuda_device) for _ in range(4))
    out, lse = fa._fa_forward(q, k, v, 0.125, True)
    g_lse = torch.randn(8, 512, 1, generator=gen).to(cuda_device)
    first = fa._fa_backward(q, k, v, out, lse, g, g_lse, 0.125, True)
    second = fa._fa_backward(q, k, v, out, lse, g, g_lse, 0.125, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    qw = quant.quantize_int8(_weights(0, 128, 128).to(cuda_device))
    with pytest.raises(RuntimeError, match="float32 or bfloat16"):
        quant.int8_matmul(torch.ones(2, 128, dtype=torch.float16,
                                     device=cuda_device), qw)
    with pytest.raises(RuntimeError, match="one device|CUDA"):
        quant._launch(torch.ones(2, 128, device=cuda_device),
                      qw["q"].cpu(), qw["s"])
    with pytest.raises(RuntimeError, match=r"do not agree: x \[2, 64\]"):
        quant._launch(torch.ones(2, 64, device=cuda_device), qw["q"], qw["s"])


@pytest.mark.cuda
def test_int8_model_on_cuda_equals_cpu(cuda_device):
    """The tiny int8 model in float32: greedy stream on the card (kernel)
    equal to the CPU's (plain version).  Here w_down ([128, 64]) tiles too,
    so 7 projections a layer launch the kernel; only lm_head (N=258) takes
    the fallback."""
    params = tfm.quantize_params(
        tfm.init_params(torch.Generator().manual_seed(0), _TINY, "cpu"))

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, device) for v in tree]
        return tree.to(device)

    gpu = to(params, cuda_device)
    prompt = np.array([256, 1, 2, 3, 4], dtype=np.int32)
    ops.reset_launches()
    got = list(tfm.generate(gpu, _TINY, prompt, 16))
    assert ops.LAUNCHES["int8_matmul"] == 7 * _TINY.n_layers * 16
    assert got == list(tfm.generate(params, _TINY, prompt, 16))


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernels_match_plain_versions(cuda_device, dtype):
    """The forward, dQ and dK/dV kernels against _fa_forward_reference and
    _fa_backward_reference on the card, with a zero and a nonzero lse
    cotangent; T=100 and 96 leave a ragged edge in the 64-row tile."""
    atol, rtol = _TOL[dtype]
    gen = torch.Generator().manual_seed(21)
    for t, d, causal in ((128, 64, True), (100, 32, True), (96, 128, False),
                         (512, 64, True)):
        q, k, v, g = (torch.randn(3, t, d, generator=gen).to(_DT[dtype])
                      .to(cuda_device) for _ in range(4))
        scale = d ** -0.5
        before = dict(ops.LAUNCHES)
        out, lse = fa._fa_forward(q, k, v, scale, causal)
        want_out, want_lse = fa._fa_forward_reference(q, k, v, scale, causal)
        torch.testing.assert_close(out.float(), want_out.float(), atol=atol,
                                   rtol=rtol)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
        for g_lse in (torch.zeros_like(lse),
                      torch.randn(3, t, 1, generator=gen).to(cuda_device)):
            got = fa._fa_backward(q, k, v, out, lse, g, g_lse, scale, causal)
            want = fa._fa_backward_reference(q, k, v, out, lse, g, g_lse,
                                             scale, causal)
            for a, b in zip(got, want):
                torch.testing.assert_close(a.float(), b.float(), atol=atol,
                                           rtol=rtol)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["flash_fwd"] == before["flash_fwd"] + 1
        assert ops.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 2
        assert ops.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 2


@pytest.mark.cuda
def test_flash_kernels_reject_what_they_do_not_take(cuda_device):
    """Each refusal raises (and its message names the numbers) instead of
    launching or crashing."""
    q = torch.ones(2, 64, 16, device=cuda_device)
    with pytest.raises(RuntimeError, match="head dim must be 32, 64 or 128, "
                                           "got 16"):
        fa._fa_forward(q, q, q, 0.25, True)
    rows = torch.zeros(2, 64, 1, device=cuda_device)
    with pytest.raises(RuntimeError, match="head dim"):
        fa._fa_backward(q, q, q, q, rows, q, rows, 0.25, True)
    h = torch.ones(2, 64, 64, dtype=torch.float16, device=cuda_device)
    with pytest.raises(RuntimeError, match="float32 or bfloat16"):
        fa._fa_forward(h, h, h, 0.125, True)
    x = torch.ones(2, 64, 64, device=cuda_device)
    with pytest.raises(RuntimeError, match="one dtype"):
        fa._fa_forward(x, x.bfloat16(), x, 0.125, True)
    with pytest.raises(RuntimeError, match="contiguous"):
        fa._fa_forward(x.transpose(1, 2), x, x, 0.125, True)
    with pytest.raises(RuntimeError, match=r"one shape .*\[2, 32, 64\]"):
        fa._fa_forward(x, x[:, :32].contiguous(), x, 0.125, True)
    ext = fa._kernels()
    with pytest.raises(RuntimeError, match=r"\[BH,T,1\], got \[2, 64\]"):
        ext.flash_bwd_dkv(x, x, x, x, rows[..., 0], rows, rows, 0.125, True)


@pytest.mark.cuda
def test_flash_training_on_cuda_equals_cpu(cuda_device):
    """The tiny float32 model at head dim 32: flash forward on the card
    (kernels) against the CPU (plain versions), and three flash train
    steps' losses, at 1e-4; 2 layers -> 2 launches of each kernel a
    step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tfm.TransformerConfig(vocab_size=258, d_model=128, n_layers=2,
                                n_heads=4, n_kv_heads=2, d_ff=256,
                                max_seq=64, dtype="float32")
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    gpu = _to(params, cuda_device)
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, 258, (2, 49)).astype(np.int64))
    want = tfm.forward(params, toks[:, :-1], cfg, attn_impl="flash")
    got = tfm.forward(gpu, toks[:, :-1].to(cuda_device), cfg,
                      attn_impl="flash")
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    opt, step = tfm.make_train_step(cfg, attn_impl="flash", learning_rate=1e-3)
    state, gstate = opt.init(params), opt.init(gpu)
    ops.reset_launches()
    for _ in range(3):
        params, state, loss = step(params, state, toks)
        gpu, gstate, gloss = step(gpu, gstate, toks.to(cuda_device))
        assert abs(loss.item() - gloss.item()) <= 1e-4
    assert ops.LAUNCHES["flash_fwd"] == ops.LAUNCHES["flash_bwd_dq"] == \
        ops.LAUNCHES["flash_bwd_dkv"] == 3 * cfg.n_layers


# -- paged attention and the continuous-batching engine ---------------------

def _paged_case(batch, t, hd, dtype, seed, n_heads=8, n_kv=4, bs=16,
                width=32):
    """One paged-attention input at the engine's layout: shuffled physical
    blocks per lane, table tails on the trash block 0, contexts ending
    mid-block.  Returns (args on the card, the same args with every pool
    row the mask excludes set to NaN)."""
    rng = np.random.default_rng(seed)
    ctx = rng.integers(1, width * bs - t, size=batch)
    ctx[0] = 1
    ctx[-1] = width * bs - t  # the longest context with a partial block
    pos = (ctx[:, None] - 1 + np.arange(t)[None, :]).astype(np.int32)
    own = np.minimum(pos.max(axis=1) // bs + 1, width)
    n_blocks = int(own.sum()) + 3
    perm = rng.permutation(np.arange(1, n_blocks + 1))
    tables = np.zeros((batch, width), np.int32)
    live = np.zeros((n_blocks + 1, bs), bool)
    start = 0
    for b in range(batch):
        tables[b, :own[b]] = perm[start:start + own[b]]
        start += own[b]
        for j in range(int(pos[b].max()) + 1):
            live[tables[b, j // bs], j % bs] = True
    shape = (n_blocks + 1, bs, n_kv, hd)
    k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(_DT[dtype]) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal(
        (batch, t, n_heads, hd)).astype(np.float32)).to(_DT[dtype])
    dead = torch.from_numpy(~live)
    kn, vn = k.clone(), v.clone()
    kn[dead] = float("nan")
    vn[dead] = float("nan")
    to = lambda *xs: [x.cuda() for x in xs]  # noqa: E731
    return (to(q, k, v, torch.from_numpy(tables), torch.from_numpy(pos)),
            to(q, kn, vn, torch.from_numpy(tables), torch.from_numpy(pos)),
            bs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("shape", [(8, 1), (4, 5), (1, 64)],
                         ids=["decode", "verify", "prefill"])
def test_paged_attention_matches_plain_on_nan_poisoned_pools(
        cuda_device, shape, hd, dtype):
    """The kernel on pools whose every masked row (the trash block, table
    tails, rows past pos) is NaN equals the plain version on the clean
    pools: it never loads a masked row.  One counted launch a call."""
    from client_tpu_torch.ops import paged_attention as pa

    atol, rtol = _TOL[dtype]
    clean, poisoned, bs = _paged_case(*shape, hd, dtype, seed=hd + shape[1])
    before = ops.LAUNCHES["paged_attention"]
    got = pa.paged_attention(*poisoned, bs)
    assert ops.LAUNCHES["paged_attention"] == before + 1
    want = pa.paged_attention_reference(*clean, bs)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
def test_paged_attention_repeats_bit_for_bit(cuda_device):
    from client_tpu_torch.ops import paged_attention as pa

    _, poisoned, bs = _paged_case(8, 5, 32, "bfloat16", seed=5)
    assert torch.equal(pa.paged_attention(*poisoned, bs),
                       pa.paged_attention(*poisoned, bs))


@pytest.mark.cuda
def test_paged_attention_refuses_what_it_does_not_take(cuda_device):
    from client_tpu_torch.ops import paged_attention as pa

    (q, k, v, tables, pos), _, bs = _paged_case(2, 1, 32, "float32", seed=1)
    with pytest.raises(RuntimeError, match="float32 or bfloat16"):
        pa.paged_attention(q.half(), k.half(), v.half(), tables, pos, bs)
    with pytest.raises(RuntimeError, match="one dtype"):
        pa.paged_attention(q, k.bfloat16(), v.bfloat16(), tables, pos, bs)
    with pytest.raises(RuntimeError, match="contiguous"):
        pa.paged_attention(q, k, v, tables.t().contiguous().t(), pos, bs)
    with pytest.raises(RuntimeError, match="int32"):
        pa.paged_attention(q, k, v, tables, pos.long(), bs)
    with pytest.raises(RuntimeError, match="head dim must be"):
        pa.paged_attention(q[..., :24].contiguous(), k[..., :24].contiguous(),
                           v[..., :24].contiguous(), tables, pos, bs)
    with pytest.raises(RuntimeError, match="block size"):
        pa.paged_attention(q, k, v, tables, pos, bs // 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        pa._launch(q, k.cpu(), v, tables, pos, bs)


@pytest.mark.cuda
def test_engine_on_cuda_equals_serial_generate(cuda_device):
    """The float32 engine on the card (paged-attention kernel, one launch a
    layer a step) streams what the serial generate streams there, for
    concurrent prompts of one to three prefill chunks, and releases every
    KV block at close."""
    from client_tpu_torch.serve.lm import LmEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tfm.TransformerConfig(vocab_size=128, d_model=64, n_layers=2,
                                n_heads=4, n_kv_heads=2, d_ff=128,
                                max_seq=96, dtype="float32")
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                             cuda_device)
    prompts = [[1, 2, 3], [7, 9], list(range(1, 41)), [11, 3, 2, 8]]
    lengths = [20, 9, 12, 30]
    eng = LmEngine(params, cfg, max_slots=4, lane_counts=(4,), block_size=8,
                   prefill_chunk=16, min_bucket=4, device=cuda_device)
    ops.reset_launches()
    try:
        qs = [eng.submit(p, n)[0] for p, n in zip(prompts, lengths)]
        got = []
        for q in qs:
            toks = []
            while (tok := q.get(timeout=120)) is not LmEngine.CLOSE:
                toks.append(tok)
            got.append(toks)
    finally:
        eng.close()
    assert ops.LAUNCHES["paged_attention"] > 0
    assert ops.LAUNCHES["paged_attention"] % cfg.n_layers == 0
    for p, n, toks in zip(prompts, lengths, got):
        assert toks == list(tfm.generate(params, cfg, p, n,
                                         readback_depth=0)), (p, n)
    assert eng.kv.used_blocks == 0 and eng.kv.ref_counts() == {}
