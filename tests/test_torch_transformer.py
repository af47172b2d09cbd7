"""client_tpu_torch.serve.models.transformer held against
client_tpu.serve.models.transformer.

The JAX params (tfm.init_params from one PRNG key, quantized by
tfm.quantize_params where the test says int8) are carried across with
client_tpu_torch.convert and both packages run on the CPU: the JAX int8
projections through the Pallas kernel in interpret mode, the port's
through its kernel's plain version.  The config is tests/test_language.py's
tiny one; its projections tile, so the kernel path runs, and its lm_head
(N=258) is ragged, so the fallback runs too.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from client_tpu.serve.models import transformer as jtfm
from client_tpu_torch import convert
from client_tpu_torch.serve.models import transformer as tfm

_JTINY = jtfm.TransformerConfig(
    vocab_size=258, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq=64, dtype="float32",
)
_TINY = tfm.TransformerConfig(**dataclasses.asdict(_JTINY))

# stated tolerances: float32 logits agree to f32 rounding over two layers;
# bf16 logits to a few bf16 ulps at their magnitude, with argmax agreement
F32_ATOL = 1e-4
BF16_ATOL = 5e-2
MIN_AGREE = 0.9


def _cfgs(dtype):
    return (dataclasses.replace(_JTINY, dtype=dtype),
            dataclasses.replace(_TINY, dtype=dtype))


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    """{(dtype, int8): (jax params, port params)} from one JAX init."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jcfg, _ = _cfgs(dtype)
        jp = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
        for int8 in (False, True):
            jparams = jtfm.quantize_params(jp) if int8 else jp
            out[(dtype, int8)] = (
                jparams, convert.params_from_numpy(_to_numpy(jparams), "cpu")
            )
    return out


def _tokens(b, t, seed=0):
    return np.random.default_rng(seed).integers(0, 258, (b, t)).astype(np.int32)


@pytest.mark.parametrize("int8", [False, True])
def test_forward_float32_matches_jax(weights, int8):
    """forward against client_tpu's forward: float32 logits at 1e-4."""
    jparams, params = weights[("float32", int8)]
    toks = _tokens(2, 12)
    want = np.asarray(jtfm.forward(jparams, jnp.asarray(toks), _JTINY))
    got = tfm.forward(params, torch.from_numpy(toks), _TINY)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 12, 258)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("int8", [False, True])
def test_forward_bf16_matches_jax(weights, int8):
    """forward against client_tpu's forward in bf16: logits at 5e-2, argmax
    agreement >= 0.9."""
    jcfg, cfg = _cfgs("bfloat16")
    jparams, params = weights[("bfloat16", int8)]
    toks = _tokens(2, 16, seed=1)
    want = np.asarray(jtfm.forward(jparams, jnp.asarray(toks), jcfg))
    got = tfm.forward(params, torch.from_numpy(toks), cfg).numpy()
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)
    agree = float(np.mean(got.argmax(-1) == want.argmax(-1)))
    assert agree >= MIN_AGREE, agree


@pytest.mark.parametrize("dtype,atol", [("float32", F32_ATOL),
                                        ("bfloat16", BF16_ATOL)])
@pytest.mark.parametrize("int8", [False, True])
def test_prefill_decode_match_jax(weights, dtype, atol, int8):
    """prefill + 4 decode_steps against client_tpu's, fed the same tokens."""
    jcfg, cfg = _cfgs(dtype)
    jparams, params = weights[(dtype, int8)]
    toks = _tokens(2, 7, seed=2)
    jprefill, jdecode = jtfm._jitted_steps(jcfg)  # the JAX serving programs
    jlogits, jcache = jprefill(jparams, jnp.asarray(toks),
                               cache=jtfm.init_cache(jcfg, 2))
    cache = tfm.init_cache(cfg, 2, "cpu")
    logits, cache = tfm.prefill(params, torch.from_numpy(toks), cfg, cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=atol, rtol=0)
    feed = _tokens(4, 2, seed=3)
    for step in feed:
        jlogits, jcache = jdecode(jparams, jnp.asarray(step), cache=jcache)
        logits, cache = tfm.decode_step(params, torch.from_numpy(step), cfg,
                                        cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=atol, rtol=0)
    assert cache["len"].tolist() == np.asarray(jcache["len"]).tolist() == [11, 11]


@pytest.mark.parametrize("int8", [False, True])
def test_generate_greedy_float32_equals_jax(weights, int8):
    """Greedy generate against client_tpu's generate: 16 tokens, token for
    token, in float32 (and the serial schedule gives the same stream)."""
    jparams, params = weights[("float32", int8)]
    prompt = np.array([256, 72, 101, 108, 108, 111], dtype=np.int32)
    want = list(jtfm.generate(jparams, _JTINY, prompt, 16))
    got = list(tfm.generate(params, _TINY, prompt, 16))
    assert got == want
    assert list(tfm.generate(params, _TINY, prompt, 16,
                             readback_depth=0)) == want


def test_generate_stops_at_stop_token_and_cache_end(weights):
    """Stop tokens end the stream after yielding them; max_seq caps it."""
    _, params = weights[("float32", False)]
    prompt = np.array([256, 1, 2], dtype=np.int32)
    free = list(tfm.generate(params, _TINY, prompt, 8))
    stopped = list(tfm.generate(params, _TINY, prompt, 8,
                                stop_tokens=(free[2],)))
    assert stopped == free[: free.index(free[2]) + 1]
    assert len(list(tfm.generate(params, _TINY, prompt, 500))) == \
        _TINY.max_seq - len(prompt)


def test_sampling_is_seeded_and_repeatable(weights):
    """Temperature sampling cannot match JAX's threefry stream; inside the
    port one seed gives one stream and tokens stay in the vocabulary."""
    _, params = weights[("float32", False)]
    prompt = np.array([256, 5, 6, 7], dtype=np.int32)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return list(tfm.generate(params, _TINY, prompt, 12, temperature=1.0,
                                 generator=g))

    a = run(3)
    assert a == run(3)
    assert all(0 <= t < 258 for t in a)
    assert any(run(s) != a for s in (4, 5, 6))


def test_quantize_params_matches_jax(weights):
    """quantize_params against client_tpu's on the same float weights."""
    jparams, params = weights[("float32", False)]
    want = _to_numpy(jtfm.quantize_params(jparams))
    got = tfm.quantize_params(params)
    for name in ("wq", "wk", "wv", "wo"):
        np.testing.assert_array_equal(got["layers"][1]["attn"][name]["q"].numpy(),
                                      want["layers"][1]["attn"][name]["q"])
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(got["layers"][0]["mlp"][name]["q"].numpy(),
                                      want["layers"][0]["mlp"][name]["q"])
    np.testing.assert_array_equal(got["lm_head"]["q"].numpy(),
                                  want["lm_head"]["q"])
    np.testing.assert_allclose(got["lm_head"]["s"].numpy(),
                               want["lm_head"]["s"], rtol=1e-6)
    assert torch.equal(got["embed"], params["embed"])


def test_init_params_keeps_jax_layout():
    """init_params: the JAX package's pytree, shapes and dtype; one seed
    gives one set of weights."""
    _, cfg = _cfgs("bfloat16")
    jshapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape),
        jtfm.init_params(jax.random.PRNGKey(0), _cfgs("bfloat16")[0]),
    )
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), params)
    assert shapes == jshapes
    assert params["layers"][0]["attn"]["wq"].dtype == torch.bfloat16
    again = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert torch.equal(again["lm_head"], params["lm_head"])


@pytest.mark.parametrize("context", [0, 100])
def test_lm_flops_per_token_matches_jax(context):
    assert tfm.lm_flops_per_token(_TINY, context) == \
        jtfm.lm_flops_per_token(_JTINY, context)


def test_unported_paths_raise(weights):
    """Ring attention without a mesh names the mesh it needs instead of
    running something else (tests/test_torch_parallel.py runs it on one);
    an MoE config builds client_tpu's init_params layout (the expert
    stacks' shapes and dtypes, leaf for leaf)."""
    _, params = weights[("float32", False)]
    toks = torch.zeros((1, 4), dtype=torch.int32)
    for impl in ("ring", "ring_flash"):
        with pytest.raises(ValueError, match="mesh"):
            tfm.forward(params, toks, _TINY, attn_impl=impl)
    moe = dataclasses.replace(_TINY, n_experts=4)
    got = tfm.init_params(torch.Generator().manual_seed(0), moe, "cpu")
    want = jax.eval_shape(
        lambda: jtfm.init_params(jax.random.PRNGKey(0),
                                 dataclasses.replace(_JTINY, n_experts=4)))
    shapes = jax.tree_util.tree_map(lambda a: (tuple(a.shape), a.dtype.name),
                                    want)
    got_shapes = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")), got)
    assert got_shapes == shapes
    assert "mlp" not in got["layers"][0]
    assert tuple(got["layers"][0]["moe"]["w_down"].shape) == (4, 128, 64)
