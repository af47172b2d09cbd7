"""client_tpu_torch.ops.flash_attention held against
client_tpu.ops.flash_attention, case for case with
tests/test_flash_attention.py.

Inputs come from numpy seeds and go through both packages on the CPU: the
JAX package's Pallas kernels in interpret mode (as its own tests run them),
the port's wrappers through their kernels' plain versions
(``_fa_forward_reference`` / ``_fa_backward_reference``), which is what a
CPU tensor takes.  The dispatch (padding, the plain_attention and
``_reference_lse`` paths, the ValueError) is the port's own code in both
places.

Stated tolerances: f32 outputs at atol 2e-5 / rtol 1e-4 and gradients at
atol 1e-4 / rtol 1e-3 (the JAX tests' own: sums in another order and
another blocking); bf16 outputs at 3e-2 (a bf16 ulp at |out| ~ 1-4).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from client_tpu_torch.ops import flash_attention as fa

jfa = importlib.import_module("client_tpu.ops.flash_attention")

OUT_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrays, jdtype=jnp.float32, tdtype=torch.float32):
    """The same numpy arrays as jax arrays and as CPU tensors (bf16 rounds
    to nearest even on both sides, so the inputs agree bit for bit)."""
    return ([jnp.asarray(a, jdtype) for a in arrays],
            [torch.from_numpy(a).to(tdtype) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize(
    "b,t,h,d,causal",
    [
        (2, 128, 4, 64, True),
        (1, 256, 2, 64, True),
        (2, 100, 4, 64, True),   # t not divisible by blocks -> padded path
        (2, 64, 4, 64, False),
        (1, 75, 2, 32, False),   # non-causal padded -> plain_attention
    ],
)
def test_matches_jax_flash_attention(b, t, h, d, causal):
    (jq, jk, jv), (q, k, v) = _both(_arrays(0, *[(b, t, h, d)] * 3))
    want = jfa.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                               block_k=32)
    got = fa.flash_attention(q, k, v, causal=causal, block_q=64, block_k=32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, t, h, d)
    np.testing.assert_allclose(_np(got), _np(want), **OUT_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_jax(causal):
    """d sum(out**2) / d(q, k, v) through the autograd.Function against
    jax.grad through the custom_vjp (both backward kernels)."""
    (jq, jk, jv), (q, k, v) = _both(_arrays(1, *[(1, 64, 2, 32)] * 3))

    def jloss(a, b_, c):
        return jnp.sum(jfa.flash_attention(a, b_, c, causal=causal) ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    for x in (q, k, v):
        x.requires_grad_(True)
    torch.sum(fa.flash_attention(q, k, v, causal=causal) ** 2).backward()
    for got, ref in zip((q.grad, k.grad, v.grad), want):
        np.testing.assert_allclose(_np(got), _np(ref), **GRAD_TOL)


def test_padded_path_gradients_match_jax():
    """Gradients through the causal padding (t=100 -> 128) and slicing."""
    (jq, jk, jv), (q, k, v) = _both(_arrays(7, *[(1, 100, 2, 32)] * 3))

    def jloss(a, b_, c):
        out = jfa.flash_attention(a, b_, c, block_q=64, block_k=32)
        return jnp.sum(out ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    for x in (q, k, v):
        x.requires_grad_(True)
    out = fa.flash_attention(q, k, v, block_q=64, block_k=32)
    torch.sum(out ** 2).backward()
    for got, ref in zip((q.grad, k.grad, v.grad), want):
        np.testing.assert_allclose(_np(got), _np(ref), **GRAD_TOL)


def test_bf16_inputs():
    (jq, jk, jv), (q, k, v) = _both(_arrays(2, *[(2, 128, 4, 64)] * 3),
                                    jnp.bfloat16, torch.bfloat16)
    got = fa.flash_attention(q, k, v)
    assert got.dtype == torch.bfloat16
    want = jfa.flash_attention(jq, jk, jv)
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


@pytest.mark.parametrize("t,causal", [(128, True), (64, False)])
def test_with_lse_matches_jax(t, causal):
    """(out, lse): lse is [B, H, T, 1] f32 on both sides."""
    (jq, jk, jv), (q, k, v) = _both(_arrays(3, *[(2, t, 2, 32)] * 3))
    jout, jlse = jfa.flash_attention_with_lse(jq, jk, jv, causal=causal,
                                              block_q=64, block_k=32)
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=causal,
                                           block_q=64, block_k=32)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (2, 2, t, 1)
    np.testing.assert_allclose(_np(out), _np(jout), **OUT_TOL)
    np.testing.assert_allclose(_np(lse), _np(jlse), **OUT_TOL)


@pytest.mark.parametrize("t", [64, 48])  # 48: ragged -> _reference_lse
def test_with_lse_gradients_under_lse_cotangent(t):
    """A loss that reads lse sends a nonzero lse cotangent into the
    backward: the dLSE term of ds."""
    qa, ka, va, w = _arrays(4, *[(1, t, 2, 32)] * 3, (1, 2, t, 1))
    (jq, jk, jv, jw), (q, k, v, tw) = _both([qa, ka, va, w])

    def jloss(a, b_, c):
        out, lse = jfa.flash_attention_with_lse(a, b_, c)
        return jnp.sum(out ** 2) + jnp.sum(lse * jw)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    for x in (q, k, v):
        x.requires_grad_(True)
    out, lse = fa.flash_attention_with_lse(q, k, v)
    (torch.sum(out ** 2) + torch.sum(lse * tw)).backward()
    for got, ref in zip((q.grad, k.grad, v.grad), want):
        np.testing.assert_allclose(_np(got), _np(ref), **GRAD_TOL)


def test_with_lse_ragged_takes_reference():
    """A ragged shard (t=48 does not tile by the clamped 64 blocks) takes
    _reference_lse on both sides: same out and lse."""
    (jq, jk, jv), (q, k, v) = _both(_arrays(5, *[(2, 48, 2, 32)] * 3))
    jout, jlse = jfa.flash_attention_with_lse(jq, jk, jv)
    out, lse = fa.flash_attention_with_lse(q, k, v)
    assert tuple(lse.shape) == (2, 2, 48, 1)
    np.testing.assert_allclose(_np(out), _np(jout), **OUT_TOL)
    np.testing.assert_allclose(_np(lse), _np(jlse), **OUT_TOL)


def test_with_lse_refuses_long_ragged_shard():
    """Above 1024 a ragged shard raises instead of going dense (O(T^2))."""
    shape = (1, 1100, 1, 32)
    (jq,), (q,) = _both(_arrays(6, shape))
    with pytest.raises(ValueError, match="does not tile"):
        jfa.flash_attention_with_lse(jq, jq, jq)
    with pytest.raises(ValueError, match="does not tile"):
        fa.flash_attention_with_lse(q, q, q)


@pytest.mark.parametrize("t,causal", [(128, True), (96, True), (64, False)])
def test_forward_reference_matches_jax_fa_forward(t, causal):
    """The forward kernel's plain version against the Pallas forward on
    [BH, T, D] (96 tiles by the 32-row blocks but not by the CUDA
    kernel's 64-row tile)."""
    (jq, jk, jv), (q, k, v) = _both(_arrays(8, *[(3, t, 32)] * 3))
    scale = 32 ** -0.5
    jout, jlse = jfa._fa_forward(jq, jk, jv, scale, 32, 32, causal, True)
    out, lse = fa._fa_forward_reference(q, k, v, scale, causal)
    assert tuple(lse.shape) == (3, t, 1) and lse.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(jout), **OUT_TOL)
    np.testing.assert_allclose(_np(lse), _np(jlse), **OUT_TOL)


@pytest.mark.parametrize("t,causal", [(128, True), (96, True), (64, False)])
def test_backward_reference_matches_jax_fa_backward(t, causal):
    """The dQ and dK/dV kernels' plain version against the Pallas backward,
    with a nonzero lse cotangent."""
    qa, ka, va, ga, gl = _arrays(9, *[(3, t, 32)] * 4, (3, t, 1))
    (jq, jk, jv, jg, jgl), (q, k, v, g, glse) = _both([qa, ka, va, ga, gl])
    scale = 32 ** -0.5
    jout, jlse = jfa._fa_forward(jq, jk, jv, scale, 32, 32, causal, True)
    want = jfa._fa_backward(jq, jk, jv, jout, jlse, jg, jgl, scale, 32, 32,
                            causal, True)
    out, lse = fa._fa_forward_reference(q, k, v, scale, causal)
    got = fa._fa_backward_reference(q, k, v, out, lse, g, glse, scale, causal)
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b_), **GRAD_TOL)
