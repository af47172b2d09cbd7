"""The port on the card: tests marked ``cuda`` skip on a machine without
an NVIDIA GPU.  This file imports neither jax nor client_tpu, so it also
runs on the GPU machine, which has neither:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest`` skips tests/conftest.py, which sets up jax for the rest
of the suite.)
"""

import dataclasses
import os
import subprocess
import sys
import threading

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
    served shapes, the MoE LM's (d_model 512: wq and wo, wk and wv, the
    8192-wide LM head) and ragged M; one counted launch per call."""
    atol, rtol = _TOL[dtype]
    rng = np.random.default_rng(11)
    for m in (1, 7, 37, 128):
        for k, n in ((256, 256), (256, 128), (256, 768), (64, 128),
                     (512, 512), (512, 256), (512, 8192)):
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
    """Every route of int8_matmul.cu against int8_matmul_reference: the
    GEMV kernel at M <= 8 (f32) or 4 (bf16; N a multiple of 16), the tensor
    cores for bf16 from M = 5, the CUDA-core tiled kernel for f32 at M = 9
    and 16, at N = 40 (not a multiple of 16) and for a q whose rows the
    16-byte loads cannot take; one counted launch a call."""
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


# int8_matmul.cu's forced routes (the binding's int8_matmul_route)
_GEMV, _TILED, _MMA = 1, 2, 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_tiled_and_mma_routes_match_plain_version(cuda_device, dtype):
    """The CUDA-core tiled route (both dtypes) and the tensor-core route
    (bf16) against int8_matmul_reference at the engine's M (prefill chunks
    16-64, verify 40, the served prompt 63) and beyond, the served (K, N)
    and K = 1024 (the mma route's two-stage ring); f32 within (1e-4, 1e-4),
    bf16 within (2e-2, 1e-2): one bf16 ulp of the f32-summed result."""
    atol, rtol = _TOL[dtype]
    ext = quant_kernels()
    rng = np.random.default_rng(13)
    routes = (_TILED, _MMA) if dtype == "bfloat16" else (_TILED,)
    for m in (16, 32, 40, 63, 64, 128, 511):
        for k, n in ((256, 256), (256, 128), (256, 768), (1024, 256)):
            x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
            x = x.to(_DT[dtype]).to(cuda_device)
            qw = quant.quantize_int8(_weights(m + n + k, k, n).to(cuda_device))
            want = quant.int8_matmul_reference(x, qw["q"], qw["s"])
            for route in routes:
                got = ext.int8_matmul_route(x, qw["q"], qw["s"], route)
                torch.cuda.synchronize()
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_int8_mma_route_repeats_bit_for_bit(cuda_device):
    """Two launches of the tensor-core route on the same inputs are equal
    bit for bit (no atomics), at one and at two K chunks."""
    ext = quant_kernels()
    gen = torch.Generator().manual_seed(3)
    for k in (256, 1024):
        x = torch.randn(63, k, generator=gen).bfloat16().to(cuda_device)
        qw = quant.quantize_int8(_weights(k, k, 768).to(cuda_device))
        a = ext.int8_matmul_route(x, qw["q"], qw["s"], _MMA)
        b = ext.int8_matmul_route(x, qw["q"], qw["s"], _MMA)
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_int8_routes_refuse_what_they_do_not_take(cuda_device):
    """A forced route raises on a shape it does not take; the dispatch rule
    sends such shapes elsewhere (a misaligned bf16 x goes to the tiled
    kernel and still matches)."""
    ext = quant_kernels()
    qw = quant.quantize_int8(_weights(5, 256, 256).to(cuda_device))
    x = torch.randn(32, 256).bfloat16().to(cuda_device)
    with pytest.raises(RuntimeError, match="does not take"):
        ext.int8_matmul_route(x.float(), qw["q"], qw["s"], _MMA)  # f32 x
    with pytest.raises(RuntimeError, match="does not take"):
        ext.int8_matmul_route(x, qw["q"], qw["s"], _GEMV)  # M = 32
    off = torch.empty(x.numel() + 1, dtype=torch.bfloat16,
                      device=cuda_device)[1:].view(32, 256)
    off.copy_(x)
    with pytest.raises(RuntimeError, match="does not take"):
        ext.int8_matmul_route(off, qw["q"], qw["s"], _MMA)
    qn = quant.quantize_int8(_weights(6, 256, 40).to(cuda_device))
    with pytest.raises(RuntimeError, match="does not take"):
        ext.int8_matmul_route(x, qn["q"], qn["s"], _MMA)  # N = 40
    with pytest.raises(RuntimeError, match="route must be"):
        ext.int8_matmul_route(x, qw["q"], qw["s"], 4)
    want = quant.int8_matmul_reference(x, qw["q"], qw["s"])
    torch.testing.assert_close(quant.int8_matmul(off, qw).float(),
                               want.float(), atol=2e-2, rtol=1e-2)


def quant_kernels():
    from client_tpu_torch.ops._build import kernels

    return kernels()


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
@pytest.mark.parametrize("shape", [(8, 1), (8, 2), (8, 4), (4, 5), (1, 16),
                                   (1, 64)],
                         ids=["decode", "verify2", "verify4", "verify5",
                              "prefill16", "prefill64"])
def test_paged_attention_matches_plain_on_nan_poisoned_pools(
        cuda_device, shape, hd, dtype):
    """The kernel on pools whose every masked row (the trash block, table
    tails, rows past pos) is NaN equals the plain version on the clean
    pools: it never loads a masked row.  Decode and verify (and f32) take
    the CUDA-core split route, bf16 prefill the tensor-core one.  One
    counted launch a call, though a call launches a split kernel and a
    combine."""
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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 1), (8, 5), (1, 64)],
                         ids=["decode", "verify", "prefill"])
def test_paged_attention_repeats_bit_for_bit(cuda_device, shape, dtype):
    """Relaunches are equal bit for bit on both routes: the splits combine
    in a fixed order, with no atomics."""
    from client_tpu_torch.ops import paged_attention as pa

    _, poisoned, bs = _paged_case(*shape, 32, dtype, seed=5)
    first = pa.paged_attention(*poisoned, bs)
    for _ in range(3):
        assert torch.equal(pa.paged_attention(*poisoned, bs), first)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 1), (8, 5), (1, 64)],
                         ids=["decode", "verify", "prefill"])
def test_paged_attention_no_attended_key(cuda_device, shape, dtype):
    """A query at pos = -1 gets the reference's result, the mean of the V
    rows its lane's whole table gathers (the only case that reads past the
    mask bound, so the pools are clean), beside ordinary rows; within the
    kernel tolerances of the plain version."""
    from client_tpu_torch.ops import paged_attention as pa

    atol, rtol = _TOL[dtype]
    (q, k, v, tables, pos), _, bs = _paged_case(*shape, 32, dtype, seed=17)
    pos = pos.clone()
    pos[0, :] = -1
    if shape[1] > 1:
        pos[-1, 0] = -1
    got = pa.paged_attention(q, k, v, tables, pos, bs)
    want = pa.paged_attention_reference(q, k, v, tables, pos, bs)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 5, 64])
def test_paged_attention_graph_replays_at_another_context(cuda_device, t,
                                                          dtype):
    """Captured in a CUDA graph at context 64, then replayed after pos and
    tables are copy_'d to context 511: the output equals the plain version
    at 511, so the grid does not depend on pos (which lives on the
    device)."""
    from client_tpu_torch.ops import paged_attention as pa

    atol, rtol = _TOL[dtype]
    batch = 8 if t < 16 else 1
    n_heads, n_kv, hd, bs, width = 8, 4, 32, 16, 32
    rng = np.random.default_rng(23 + t)
    n_blocks = batch * width
    shape = (n_blocks + 1, bs, n_kv, hd)
    k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(_DT[dtype]).to(cuda_device) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal(
        (batch, t, n_heads, hd)).astype(np.float32)).to(_DT[dtype]).to(
        cuda_device)

    def at(ctx):
        pos = (ctx - t + np.arange(t))[None, :].repeat(batch, 0)
        own = (ctx - 1) // bs + 1
        tables = np.zeros((batch, width), np.int32)
        perm = rng.permutation(np.arange(1, n_blocks + 1))
        for b in range(batch):
            tables[b, :own] = perm[b * width:b * width + own]
        return (torch.from_numpy(tables).to(cuda_device),
                torch.from_numpy(pos.astype(np.int32)).to(cuda_device))

    tables, pos = at(64)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pa.paged_attention(q, k, v, tables, pos, bs)  # build and warm up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pa.paged_attention(q, k, v, tables, pos, bs)
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out.float(), pa.paged_attention_reference(q, k, v, tables, pos,
                                                  bs).float(),
        atol=atol, rtol=rtol)
    t511, p511 = at(511)
    tables.copy_(t511)
    pos.copy_(p511)
    graph.replay()
    torch.cuda.synchronize()
    want = pa.paged_attention_reference(q, k, v, tables, pos, bs)
    torch.testing.assert_close(out.float(), want.float(), atol=atol,
                               rtol=rtol)


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
    with pytest.raises(RuntimeError, match="empty"):
        pa.paged_attention(q, k, v, tables[:, :0].contiguous(), pos, bs)
    # the 16-byte copies refuse a misaligned tensor, bf16 and f32 alike
    for x in (q.bfloat16(), q):
        off = torch.empty(x.numel() + 1, dtype=x.dtype,
                          device=cuda_device)[1:].view(x.shape)
        off.copy_(x)
        kk, vv = k.to(x.dtype), v.to(x.dtype)
        with pytest.raises(RuntimeError, match="misaligned"):
            pa.paged_attention(off, kk, vv, tables, pos, bs)


@pytest.mark.cuda
def test_engine_on_cuda_equals_serial_generate(cuda_device):
    """The float32 engine on the card (every tick a replayed CUDA graph,
    the paged-attention kernel one launch a layer a tick) streams what the
    serial generate streams there, for
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
        graphs = eng.graph_stats()["graphs"]
    finally:
        eng.close()
    assert ops.LAUNCHES["paged_attention"] > 0
    assert ops.LAUNCHES["paged_attention"] % cfg.n_layers == 0
    # every tick replayed a captured graph: decode at the one lane count,
    # prefill at the widths {4, 8, 16}
    assert graphs == {"decode": 1, "verify": 0, "prefill": 3}
    for p, n, toks in zip(prompts, lengths, got):
        assert toks == list(tfm.generate(params, cfg, p, n,
                                         readback_depth=0)), (p, n)
    assert eng.kv.used_blocks == 0 and eng.kv.ref_counts() == {}


# -- the engine's programs as CUDA graphs -------------------------------------

_GRAPH_CFG = tfm.TransformerConfig(
    vocab_size=258, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq=512, dtype="float32",
)
_GRAPH_BS = 16
_GRAPH_WIDTH = _GRAPH_CFG.max_seq // _GRAPH_BS  # table width


def _graph_engine(cuda_device, dtype, poison=False, n_experts=0):
    """An engine on the card with its device state allocated and every
    program captured (8 slots, lane counts {2, 8}, prefill widths {16,
    32, 64}, verify widths {2, 4, 5}), the scheduler not started.  With
    ``poison`` every pool row but the trash block's is NaN and the lane
    buffers hold sentinels while it captures; ``n_experts`` > 0 makes
    every FFN a mixture of experts (top 2)."""
    from client_tpu_torch.serve.lm import LmEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(
        _GRAPH_CFG, dtype="float32" if dtype == "float32" else "bfloat16",
        n_experts=n_experts)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                             cuda_device)
    if dtype == "int8":
        params = tfm.quantize_params(params)
    eng = LmEngine(params, cfg, max_slots=8, lane_counts=(2, 8),
                   block_size=_GRAPH_BS, prefill_chunk=64, min_bucket=16,
                   speculative={"k": 4}, device=cuda_device)
    with eng._cv:
        eng._init_device_locked()
        if poison:
            for pool in eng.kv.pools["k"] + eng.kv.pools["v"]:
                pool[1:] = float("nan")
            eng._tokens.fill_(7)
            eng._keys.fill_(9)
    eng._build_programs()
    return eng


def _program_values(kind, shape, rng, context):
    """Host inputs of one program: every lane on blocks of its own, at
    ``context`` keys (decode, verify) or a chunk ending 3 tokens into the
    bucket padding at ``context`` (prefill); greedy and sampled lanes."""
    perm = rng.permutation(np.arange(1, 8 * _GRAPH_WIDTH + 1))
    own = min(-(-(context + 8) // _GRAPH_BS), _GRAPH_WIDTH)
    if kind == "prefill":
        table = np.zeros((_GRAPH_WIDTH,), np.int32)
        table[:own] = perm[:own]
        start = context - shape + 3
        return {"chunk": rng.integers(0, 258, (1, shape)), "table": table,
                "start": start, "prompt_len": context, "key": (123, 2),
                "temperature": 0.8, "top_k": 10}
    n = shape if kind == "decode" else shape[0]
    tables = np.zeros((n, _GRAPH_WIDTH), np.int32)
    for b in range(n):
        tables[b, :own] = perm[b * _GRAPH_WIDTH:b * _GRAPH_WIDTH + own]
    values = {"tables": tables, "lens": rng.integers(context - 8, context,
                                                     n),
              "temps": np.where(np.arange(n) % 2, 0.7, 0.0),
              "topks": np.arange(n) % 3 * 5}
    if kind == "verify":
        values["props"] = rng.integers(0, 258, (n, shape[1] - 1))
        values["counts"] = rng.integers(0, shape[1], n)
    return values


def _replay_against_eager(eng, kind, shape, values, seed):
    """Run one program's body eagerly on clones of its state, then replay
    its graph on the live state with the same feeds: every output buffer,
    lane buffer and pool row outside the trash block bit-equal, and the
    replay counts the launches the eager run made."""
    prog = {"decode": eng._decode_programs, "verify": eng._verify_programs,
            "prefill": eng._prefill_programs}[kind][shape]
    gen = torch.Generator(device=eng.device).manual_seed(seed)
    for pool in eng.kv.pools["k"] + eng.kv.pools["v"]:
        pool.copy_(torch.randn(pool.shape, generator=gen,
                               device=eng.device))
    eng._tokens.copy_(torch.randint(0, 258, eng._tokens.shape,
                                    generator=gen, device=eng.device))
    eng._keys.copy_(torch.randint(0, 2 ** 31, eng._keys.shape,
                                  generator=gen, device=eng.device))
    prog.feed(values)
    clone = {name: ({k: [p.clone() for p in v] for k, v in buf.items()}
                    if name == "pools" else buf.clone())
             for name, buf in prog.state.items()}
    ops.reset_launches()
    prog.body(prog.feeds, clone)
    torch.cuda.synchronize()
    eager = dict(ops.LAUNCHES), {k: dict(v) for k, v in ops.ROUTES.items()}
    ops.reset_launches()
    prog.run()
    torch.cuda.synchronize()
    assert prog.graph is not None
    assert (dict(ops.LAUNCHES),
            {k: dict(v) for k, v in ops.ROUTES.items()}) == eager
    assert eager[0]["paged_attention"] == eng.cfg.n_layers
    for name, buf in prog.state.items():
        if name == "pools":  # from block 1: nothing reads the trash block,
            for k in ("k", "v"):  # which a tick's writes hit in any order
                for got, want in zip(buf[k], clone["pools"][k]):
                    assert torch.equal(got[1:], want[1:]), (kind, shape, k)
        else:
            assert torch.equal(buf, clone[name]), (kind, shape, name,
                                                   buf, clone[name])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("kind,shape", [("decode", 2), ("decode", 8),
                                        ("verify", (8, 5)),
                                        ("prefill", 16), ("prefill", 64)])
def test_engine_graph_replays_its_eager_program(cuda_device, dtype, kind,
                                                shape):
    """Each captured program against its eager function on clones of the
    same pools and buffers, at context 200: tokens, RNG carry, outputs
    and every pool bit-equal, and the replay's launch and route counts
    equal the eager run's (int8: 6 projections a layer)."""
    eng = _graph_engine(cuda_device, dtype)
    try:
        # every bound: 2 lane counts, 3 verify widths, 3 buckets
        assert eng.graph_stats()["graphs"] == {
            "decode": 2, "verify": 6, "prefill": 3}
        rng = np.random.default_rng(len(str(shape)) + len(kind))
        _replay_against_eager(eng, kind, shape,
                              _program_values(kind, shape, rng, 200), 1)
    finally:
        eng.close()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("kind,shape", [("decode", 8), ("verify", (8, 5)),
                                        ("prefill", 64)])
def test_moe_engine_graph_replays_its_eager_program(cuda_device, dtype,
                                                    kind, shape):
    """The same with every FFN a mixture of 4 experts (top 2): the router,
    its top-k and the dense expert einsums capture, and each replay is
    bit-equal to the eager program (int8: the attention projections
    only; the expert stacks stay bf16)."""
    eng = _graph_engine(cuda_device, dtype, n_experts=4)
    try:
        assert "moe" in eng.params["layers"][0]
        rng = np.random.default_rng(len(str(shape)) + len(kind) + 7)
        _replay_against_eager(eng, kind, shape,
                              _program_values(kind, shape, rng, 200), 2)
    finally:
        eng.close()


@pytest.mark.cuda
def test_moe_forward_on_the_card_matches_the_cpu(cuda_device):
    """A float32 MoE forward (TF32 off) and its router aux loss on the
    card against the same weights on the CPU: logits at 1e-4, aux at
    rtol 1e-5; every gradient of one loss_fn at 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(_TINY, n_experts=4, top_k=2)
    cpu = tfm.init_params(torch.Generator().manual_seed(3), cfg, "cpu")
    gpu = _to(cpu, cuda_device)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 17)))
    want, want_aux = tfm.forward(cpu, toks[:, :-1], cfg, with_aux=True)
    got, got_aux = tfm.forward(gpu, toks[:, :-1].to(cuda_device), cfg,
                               with_aux=True)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)
    for params, t in ((cpu, toks), (gpu, toks.to(cuda_device))):
        for w in tfm._leaves(params):
            w.requires_grad_(True)
        tfm.loss_fn(params, t, cfg).backward()
    for a, b in zip(tfm._leaves(gpu), tfm._leaves(cpu)):
        np.testing.assert_allclose(a.grad.cpu().numpy(), b.grad.numpy(),
                                   atol=1e-4, rtol=1e-3)


@pytest.mark.cuda
def test_engine_decode_graph_replays_at_another_context(cuda_device):
    """One decode graph replayed at context 64 and then at 511 (the grid
    of every kernel in it is fixed by shapes, never by the lengths fed):
    each replay equals the eager program there."""
    eng = _graph_engine(cuda_device, "bfloat16")
    try:
        rng = np.random.default_rng(3)
        for seed, context in enumerate((64, 511)):
            _replay_against_eager(
                eng, "decode", 8,
                _program_values("decode", 8, rng, context), seed)
    finally:
        eng.close()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_engine_capture_writes_no_live_row(cuda_device, dtype):
    """Warm-up and capture of every program leave every pool row outside
    the trash block NaN as poisoned, and the lane buffers as they were."""
    eng = _graph_engine(cuda_device, dtype, poison=True)
    try:
        torch.cuda.synchronize()
        for pool in eng.kv.pools["k"] + eng.kv.pools["v"]:
            assert bool(torch.isnan(pool[1:]).all())
        assert bool((eng._tokens == 7).all() and (eng._keys == 9).all())
        assert sum(eng.graph_stats()["graphs"].values()) == 11
    finally:
        eng.close()
    assert eng.decode_executables() == 0  # close() released the graphs


# -- the serial LM programs and the train step as CUDA graphs -----------------

_PROG_CFG = tfm.TransformerConfig(
    vocab_size=258, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=512, max_seq=128, dtype="float32",
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_serial_graphs_equal_the_eager_loop(cuda_device, dtype):
    """generate through its CUDA graphs against the eager loop on the same
    weights: 48 greedy tokens equal; one decode replay counts the int8
    projections it replays; a second prompt length captures its own
    prefill graph."""
    cfg = dataclasses.replace(
        _PROG_CFG, dtype="float32" if dtype == "float32" else "bfloat16")
    params = tfm.init_params(torch.Generator().manual_seed(5), cfg,
                             cuda_device)
    if dtype == "int8":
        params = tfm.quantize_params(params)
    from client_tpu_torch.serve.models.programs import serial_pool

    pool = serial_pool(params, cfg)
    for n in (7, 12):
        prompt = np.arange(1, n + 1, dtype=np.int32)
        want = list(tfm.generate(params, cfg, prompt, 48, eager=True))
        ops.reset_launches()
        got = list(tfm.generate(params, cfg, prompt, 48))
        assert got == want
        with pool.acquire(params, 1) as progs:
            assert "decode" in progs.captures and n in progs.captures
            per_replay = progs.decode_launches
    if dtype == "int8":
        per_step = sum(c for (name, _), c in per_replay.items()
                       if name == "int8_matmul")
        assert per_step > 0
        # the second stream: its prefill replay and 47 decode replays
        assert ops.LAUNCHES["int8_matmul"] >= 47 * per_step
    else:
        assert per_replay == {}


@pytest.mark.cuda
@pytest.mark.parametrize("attn_impl", ["plain", "flash"])
def test_train_step_graph_replays_equal_eager(cuda_device, attn_impl):
    """make_train_step's graph (eager first call, capture on the second,
    replays after) against the eager step from the same float32 weights:
    losses within 1e-5 over 6 steps, every flash kernel counted once a
    layer per replay, the params and state updated in place."""
    cfg = _PROG_CFG
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 65))).to(cuda_device)
    runs = {}
    for eager in (True, False):
        params = tfm.init_params(torch.Generator().manual_seed(6), cfg,
                                 cuda_device)
        opt, step = tfm.make_train_step(cfg, attn_impl=attn_impl,
                                        learning_rate=1e-3, eager=eager)
        state = opt.init(params)
        losses = []
        for _ in range(6):
            params, state, loss = step(params, state, toks)
            losses.append(float(loss))
        runs[eager] = (losses, params, step)
    np.testing.assert_allclose(runs[False][0], runs[True][0], atol=1e-5,
                               rtol=0)
    for a, b in zip(tfm._leaves(runs[False][1]), tfm._leaves(runs[True][1])):
        np.testing.assert_allclose(a.detach().cpu().numpy(),
                                   b.detach().cpu().numpy(), atol=1e-4,
                                   rtol=0)
    launches = runs[False][2].program.launches
    if attn_impl == "flash":
        assert {name: c for (name, _), c in launches.items()} == {
            n: cfg.n_layers for n in ("flash_fwd", "flash_bwd_dq",
                                      "flash_bwd_dkv")}
    else:
        assert launches == {}


# -- the vision path: the dynamic batcher's bucket graphs ---------------------


def _vision_engine(cuda_device, max_batch_size=8, image_size=64):
    from client_tpu_torch.serve.model_runtime import InferenceEngine
    from client_tpu_torch.serve.models import vision

    model = vision.cnn_classifier_model(
        image_size=image_size, max_batch_size=max_batch_size, warmup=True,
        device=cuda_device)
    return model, InferenceEngine([model])


@pytest.mark.cuda
def test_vision_bucket_graphs_equal_eager(cuda_device):
    """Warmup captures one CUDA graph per bucket up to max_batch_size;
    each replayed on seeded images equals the eager forward bit for bit."""
    from client_tpu_torch.serve.dynamic_batcher import _buckets_up_to

    model, engine = _vision_engine(cuda_device)
    try:
        batcher = engine._batchers[model.name]
        progs = batcher.programs()
        assert sorted(progs) == _buckets_up_to(8)
        assert batcher.graph_stats()["graphs"] == len(progs)
        gen = torch.Generator().manual_seed(0)
        for b, prog in progs.items():
            assert prog.graph is not None
            x = torch.randn(b, 3, 64, 64, generator=gen).to(cuda_device)
            prog.inputs["INPUT0"].copy_(x)
            prog.run()
            want = model.fn({"INPUT0": x}, {}, None)["OUTPUT0"]
            assert torch.equal(prog.outputs["OUTPUT0"], want)
    finally:
        engine.close()


@pytest.mark.cuda
@pytest.mark.parametrize("device_group", [True, False])
def test_vision_back_to_back_groups_keep_their_rows(cuda_device,
                                                    device_group):
    """Two groups through bucket 3's graph back to back: the second replay
    overwrites the static output, and the first group's rows (copied out
    on the stream before it) are untouched."""
    model, engine = _vision_engine(cuda_device)
    try:
        batcher = engine._batchers[model.name]
        gen = torch.Generator().manual_seed(1)
        xs = [torch.randn(3, 3, 64, 64, generator=gen) for _ in range(2)]
        outs = [batcher.submit(
            {"INPUT0": x.to(cuda_device) if device_group else x.numpy()})
            for x in xs]
        for x, out in zip(xs, outs):
            want = model.fn({"INPUT0": x.to(cuda_device)}, {}, None)
            got = torch.as_tensor(out["OUTPUT0"]).to(cuda_device)
            assert torch.equal(got, want["OUTPUT0"])
    finally:
        engine.close()


@pytest.mark.cuda
def test_vision_pipeline_hands_cuda_tensors_over(cuda_device):
    """The tiny vision ensemble on the card: 0 host hops, 2 device
    handoffs, SCORES equal to the three steps called in turn."""
    from client_tpu_torch.serve.model_runtime import InferenceEngine
    from client_tpu_torch.serve.models import vision

    models = vision.vision_pipeline_models(device=cuda_device)
    engine = InferenceEngine(models)
    try:
        img = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3),
                                                dtype=np.uint8)
        response, blobs = engine.execute("vision_pipeline", "", {
            "inputs": [{"name": "IMAGE", "datatype": "UINT8",
                        "shape": [3, 32, 32, 3], "data": img.ravel().tolist()}],
            "outputs": [{"name": "SCORES",
                         "parameters": {"binary_data": True}}]}, b"")
        got = np.frombuffer(blobs[0], dtype=np.float32).reshape(3, 16)
        h = {"IMAGE": img}
        for m in models[:3]:
            h = m.fn(h, {}, None)
        assert h["SCORES"].is_cuda
        np.testing.assert_array_equal(got, h["SCORES"].cpu().numpy())
        assert not engine.metrics.get("ctpu_ensemble_host_hops_total",
                                      {"model": "vision_pipeline"})
        assert engine.metrics.get("ctpu_ensemble_device_handoffs_total",
                                  {"model": "vision_pipeline"}) == 2
    finally:
        engine.close()


def _count_flushes(monkeypatch):
    """Count calls of the device-wide sync and both cache flushes that
    ``torch.cuda.graph`` makes before a capture."""
    calls = {"synchronize": 0, "empty_cache": 0, "_host_emptyCache": 0}
    for owner, name in ((torch.cuda, "synchronize"),
                        (torch.cuda, "empty_cache"),
                        (torch._C, "_host_emptyCache")):
        real = getattr(owner, name)

        def counted(*args, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(owner, name, counted)
    return calls


def _graph_body(x, w):
    return torch.softmax(x @ w, dim=-1).cumsum(-1) * 0.5


@pytest.mark.cuda
def test_capture_graph_makes_no_device_sync_or_flush(cuda_device,
                                                     monkeypatch):
    """``ops.capture_graph`` calls none of ``torch.cuda.synchronize``,
    ``torch.cuda.empty_cache`` and ``torch._C._host_emptyCache`` (counted
    by a monkeypatch), where ``torch.cuda.graph``'s context calls each."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(16, 64, generator=gen).to(cuda_device)
    w = torch.randn(64, 32, generator=gen).to(cuda_device)
    calls = _count_flushes(monkeypatch)
    box = {}

    def body():
        box["out"] = _graph_body(x, w)

    graph = ops.capture_graph(body, body, torch.cuda.graph_pool_handle(),
                              torch.cuda.Stream())
    assert calls == {"synchronize": 0, "empty_cache": 0,
                     "_host_emptyCache": 0}
    assert graph.launches == {} and graph.seconds > 0
    # the counter sees the context's calls (the control)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(torch.cuda.CUDAGraph()):
        body()
    assert all(n >= 1 for n in calls.values()), calls


@pytest.mark.cuda
def test_capture_graph_replays_equal_the_eager_body(cuda_device):
    """A graph captured through ``ops.capture_graph`` and replayed on new
    inputs copied into its static input equals the eager body on them,
    bit for bit, each replay on the current stream."""
    gen = torch.Generator().manual_seed(4)
    w = torch.randn(64, 32, generator=gen).to(cuda_device)
    x = torch.zeros(16, 64, device=cuda_device)
    box = {}

    def body():
        box["out"] = _graph_body(x, w)

    graph = ops.capture_graph(body, body, torch.cuda.graph_pool_handle(),
                              torch.cuda.Stream())
    for _ in range(3):
        new = torch.randn(16, 64, generator=gen).to(cuda_device)
        x.copy_(new)
        graph.replay()
        assert torch.equal(box["out"], _graph_body(new, w))


@pytest.mark.cuda
def test_capture_survives_a_dead_graph_in_a_cycle(cuda_device):
    """A dead CUDA graph held in a reference cycle, then a capture whose
    body allocates past the collector's young-generation threshold:
    ``ops.capture_graph`` pauses automatic collection in the capture, so
    the dead graph is not destroyed on the capturing thread (which would
    invalidate the capture) and the replay equals the eager body."""
    import gc

    gen = torch.Generator().manual_seed(5)
    x = torch.randn(16, 64, generator=gen).to(cuda_device)
    w = torch.randn(64, 32, generator=gen).to(cuda_device)
    stream = torch.cuda.Stream()
    box = {}

    def body():
        box["out"] = _graph_body(x, w)
        box["junk"] = [[] for _ in range(10_000)]

    dead = [ops.capture_graph(body, body, torch.cuda.graph_pool_handle(),
                              stream)]
    dead.append(dead)
    del dead
    threshold = gc.get_threshold()
    gc.set_threshold(100)
    try:
        graph = ops.capture_graph(body, None,
                                  torch.cuda.graph_pool_handle(), stream)
    finally:
        gc.set_threshold(*threshold)
    graph.replay()
    assert torch.equal(box["out"], _graph_body(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("step", ["preprocess", "backbone", "postprocess"])
def test_vision_step_graphs_equal_eager(cuda_device, step):
    """Each vision step's program on the card (a CUDA graph captured at
    the shape's first sight) against its eager function at rows 1 and 3:
    bit for bit, no eager run, one graph per shape."""
    from client_tpu_torch.serve.models import vision

    runners = vision.vision_pipeline_models(device=cuda_device)[0] \
        .fn.__self__
    plain = {
        "preprocess": vision._preprocess_forward,
        "backbone": lambda x: vision._resnet_features(
            runners.params, x, stage_strides=runners.strides).float(),
        "postprocess": lambda h: torch.softmax(
            vision._resnet_head(runners.params, h), dim=-1),
    }
    name = {"preprocess": "IMAGE", "backbone": "PIXELS",
            "postprocess": "FEATURES"}[step]
    for rows in (1, 3, 1, 3):
        img = torch.from_numpy(np.random.default_rng(rows).integers(
            0, 256, (rows, 32, 32, 3), dtype=np.uint8)).to(cuda_device)
        x = img
        for prior in ("preprocess", "backbone", "postprocess"):
            if prior == step:
                break
            x = plain[prior](x)
        got = next(iter(getattr(runners, step)({name: x}, {}, None)
                        .values()))
        assert torch.equal(got, plain[step](x))
    stats = runners.graph_stats()[step]
    assert stats["graphs"] == 2 and stats["eager_runs"] == 0
    assert stats["replays"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("step", ["preprocess", "backbone", "postprocess"])
def test_vision_step_threads_at_two_shapes_equal_eager(cuda_device, step):
    """Four threads call a vision step at once, at rows 1 and 3 (two
    graphs in one memory pool), twenty times each on their own seeded
    input: every result equals the eager function of that input, bit for
    bit, though one shape's graph may write its intermediates where the
    other's static output lies."""
    from client_tpu_torch.serve.models import vision

    runners = vision.vision_pipeline_models(device=cuda_device)[0] \
        .fn.__self__
    plain = {
        "preprocess": vision._preprocess_forward,
        "backbone": lambda x: vision._resnet_features(
            runners.params, x, stage_strides=runners.strides).float(),
        "postprocess": lambda h: torch.softmax(
            vision._resnet_head(runners.params, h), dim=-1),
    }
    name = {"preprocess": "IMAGE", "backbone": "PIXELS",
            "postprocess": "FEATURES"}[step]
    inputs = []
    for i, rows in enumerate((1, 3, 1, 3)):
        x = torch.from_numpy(np.random.default_rng(40 + i).integers(
            0, 256, (rows, 32, 32, 3), dtype=np.uint8)).to(cuda_device)
        for prior in ("preprocess", "backbone", "postprocess"):
            if prior == step:
                break
            x = plain[prior](x)
        inputs.append(x)
    want = [plain[step](x) for x in inputs]
    torch.cuda.synchronize()
    results, errors = [None] * 4, []
    start = threading.Barrier(4)

    def worker(i):
        try:
            start.wait(timeout=30)
            ok = True
            for _ in range(20):
                got = next(iter(getattr(runners, step)(
                    {name: inputs[i]}, {}, None).values()))
                ok = ok and torch.equal(got, want[i])
            results[i] = ok
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert not errors and results == [True] * 4
    stats = runners.graph_stats()[step]
    assert stats["graphs"] == 2 and stats["eager_runs"] == 0


# -- CUDA shared memory: regions over CUDA IPC --------------------------------

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a process of its own that makes a CUDA region, fills it with
# arange(n) float32, prints its handle (hex) and waits for one line on
# stdin before it exits (its region lives until then)
_OWNER = r"""
import sys
import numpy as np
from client_tpu_torch.utils import cuda_shared_memory as cudashm
n = int(sys.argv[1])
h = cudashm.create_shared_memory_region("owner", 4 * n)
cudashm.set_shared_memory_region(h, [np.arange(n, dtype=np.float32)])
print(cudashm.get_raw_handle(h).hex(), flush=True)
sys.stdin.readline()
print(cudashm.get_contents_as_numpy(h, np.float32, [n]).tolist(), flush=True)
"""


def _spawn_owner(n):
    """The _OWNER process and the 64 handle bytes it printed (the shm
    extension is built in this process first: the two never race load's
    lock)."""
    from client_tpu_torch.utils.cuda_shared_memory import _build

    _build.extension()
    proc = subprocess.Popen(
        [sys.executable, "-c", _OWNER, str(n)], stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": _ROOT})
    line = proc.stdout.readline().strip()
    assert len(line) == 128, (line, proc.poll())
    return proc, bytes.fromhex(line)


def _finish_owner(proc):
    """Let the owner go; it prints its region's contents on the way."""
    out, _ = proc.communicate("\n", timeout=120)
    assert proc.returncode == 0
    return out.strip().splitlines()[-1]


@pytest.mark.cuda
def test_cuda_shm_two_process_round_trip(cuda_device):
    """Another process's region, opened here over CUDA IPC: this side
    reads what it wrote and writes at an offset what it then reads."""
    from client_tpu_torch.utils import cuda_shared_memory as cudashm

    proc, handle = _spawn_owner(16)
    try:
        assert cudashm.resolve_inprocess(handle) is None
        region = cudashm.open_region("peer", handle, 64)
        assert region.tensor.is_cuda and region._mapping.imported
        got = cudashm.get_contents_as_numpy(region, "FP32", [16])
        np.testing.assert_array_equal(got, np.arange(16, dtype=np.float32))
        live = cudashm.get_contents_as_torch(region, "FP32", [4], offset=16)
        assert live.data_ptr() == region.tensor.data_ptr() + 16
        cudashm.set_shared_memory_region(
            region, [torch.full((4,), 7.0, device=cuda_device)], offset=32)
        # the same handle again: the one mapping, not a second open
        again = cudashm.open_region("peer2", handle, 64)
        assert again.tensor.data_ptr() == region.tensor.data_ptr()
        region.close()
        again.close()
    finally:
        seen = _finish_owner(proc)
    want = list(range(16))
    want[8:12] = [7.0] * 4
    assert seen == str([float(v) for v in want])


@pytest.mark.cuda
def test_cuda_shm_inprocess_register_uses_the_broker(cuda_device):
    """A region of this process registered with this process's server:
    the broker hands over the live region (no IPC open), and a served
    CNN request through it equals the wire path's answer."""
    from client_tpu_torch.utils import cuda_shared_memory as cudashm

    model, engine = _vision_engine(cuda_device, image_size=32)
    x = np.random.default_rng(3).standard_normal((1, 3, 32, 32)).astype(
        np.float32)
    h_in = cudashm.create_shared_memory_region("in", x.nbytes)
    h_out = cudashm.create_shared_memory_region("out", 4000)
    try:
        cudashm.set_shared_memory_region(h_in, [x])
        engine.shm.register_cuda("in", cudashm.get_raw_handle(h_in), 0,
                                 x.nbytes)
        engine.shm.register_cuda("out", cudashm.get_raw_handle(h_out), 0,
                                 4000)
        assert engine.shm._cuda["in"]["region"] is h_in
        assert not engine.shm._cuda["in"]["opened"]
        engine.execute(model.name, "", {
            "inputs": [{"name": "INPUT0", "datatype": "FP32",
                        "shape": [1, 3, 32, 32], "parameters": {
                            "shared_memory_region": "in",
                            "shared_memory_byte_size": x.nbytes}}],
            "outputs": [{"name": "OUTPUT0", "parameters": {
                "shared_memory_region": "out",
                "shared_memory_byte_size": 4000}}]}, b"")
        raw = x.tobytes()
        _, blobs = engine.execute(model.name, "", {
            "inputs": [{"name": "INPUT0", "datatype": "FP32",
                        "shape": [1, 3, 32, 32],
                        "parameters": {"binary_data_size": len(raw)}}],
            "outputs": [{"name": "OUTPUT0",
                         "parameters": {"binary_data": True}}]}, raw)
        np.testing.assert_array_equal(
            cudashm.get_contents_as_numpy(h_out, "FP32", [1, 1000]),
            np.frombuffer(blobs[0], dtype=np.float32).reshape(1, 1000))
    finally:
        engine.close()
        cudashm.destroy_shared_memory_region(h_in)
        cudashm.destroy_shared_memory_region(h_out)


@pytest.mark.cuda
def test_cuda_shm_region_unregistered_mid_flight(cuda_device):
    """Another process's input region unregistered while a request that
    read it is in flight: the request's view keeps the IPC mapping open,
    the answer is right, and nothing crashes."""
    import gc
    import threading

    from client_tpu_torch.serve.model_runtime import (
        InferenceEngine,
        Model,
        TensorSpec,
    )
    from client_tpu_torch.utils import cuda_shared_memory as cudashm

    entered, release = threading.Event(), threading.Event()

    def fn(inputs, params, ctx):
        entered.set()
        assert release.wait(60)
        return {"OUT": inputs["IN"] * 2.0}

    model = Model("gated", inputs=[TensorSpec("IN", "FP32", [16])],
                  outputs=[TensorSpec("OUT", "FP32", [16])], fn=fn,
                  platform="torch", backend="torch", device=cuda_device)
    engine = InferenceEngine([model])
    proc, handle = _spawn_owner(16)
    h_out = cudashm.create_shared_memory_region("out", 64)
    result = {}
    try:
        engine.shm.register_cuda("in", handle, 0, 64)
        assert engine.shm._cuda["in"]["opened"]
        engine.shm.register_cuda("out", cudashm.get_raw_handle(h_out), 0, 64)
        request = {
            "inputs": [{"name": "IN", "datatype": "FP32", "shape": [16],
                        "parameters": {"shared_memory_region": "in",
                                       "shared_memory_byte_size": 64}}],
            "outputs": [{"name": "OUT", "parameters": {
                "shared_memory_region": "out",
                "shared_memory_byte_size": 64}}]}

        def run():
            result["response"] = engine.execute("gated", "", request, b"")

        thread = threading.Thread(target=run)
        thread.start()
        assert entered.wait(60)
        engine.shm.unregister_cuda("in")
        assert engine.shm.cuda_status() == {"out": {
            "name": "out", "device_id": 0, "byte_size": 64}}
        gc.collect()
        release.set()
        thread.join(timeout=60)
        assert not thread.is_alive()
        np.testing.assert_array_equal(
            cudashm.get_contents_as_numpy(h_out, np.float32, [16]),
            2.0 * np.arange(16, dtype=np.float32))
    finally:
        release.set()
        engine.close()
        cudashm.destroy_shared_memory_region(h_out)
        _finish_owner(proc)
    assert "response" in result


@pytest.mark.cuda
def test_cuda_shm_refused_handle_raises_cudart_message(cuda_device):
    """A handle no process exported: the open raises (a 400 through the
    registry) with cudart's own message, and CUDA keeps working."""
    from client_tpu_torch.serve.model_runtime import SharedMemoryRegistry
    from client_tpu_torch.utils import InferenceServerException
    from client_tpu_torch.utils import cuda_shared_memory as cudashm

    with pytest.raises(InferenceServerException,
                       match="cudaIpcOpenMemHandle failed: ") as info:
        cudashm.open_region("bogus", bytes(64), 64)
    assert info.value.status() == "400"
    registry = SharedMemoryRegistry()
    with pytest.raises(InferenceServerException, match="cudaIpcOpenMemHandle"):
        registry.register_cuda("bogus", bytes(64), 0, 64)
    assert registry.cuda_status() == {}
    x = torch.arange(8.0, device=cuda_device) * 2
    torch.cuda.synchronize()
    assert x.sum().item() == 56.0
