"""Training in client_tpu_torch held against client_tpu: the flash forward,
the loss and its gradients, the Adam train step, and checkpoint resume.

The JAX package's params (``init_params`` from one PRNG key) are carried
across with ``convert.params_from_numpy``; tokens come from numpy seeds.
Both packages run on the CPU: the JAX flash path through its Pallas kernels
in interpret mode, the port's through its kernels' plain versions.  The
config is tests/test_flash_attention.py's tiny float32 one (head dim 8).

Stated tolerances (float32 throughout):
- logits at atol 1e-4 / rtol 1e-3 (the JAX flash test's own);
- the loss at 1e-5 and every gradient leaf at atol 1e-5 / rtol 1e-3: sums
  in another order over two layers;
- after five Adam steps at lr 1e-2, the losses at 1e-4 and every param
  leaf at atol 1e-4: Adam divides each gradient by its own running RMS, so
  a gradient entry near zero turns f32 rounding noise into an update of up
  to lr times that noise's relative size.
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
from client_tpu_torch.train import CheckpointManager

_JCFG = jtfm.TransformerConfig(
    vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=64, max_seq=64, dtype="float32",
)
_CFG = tfm.TransformerConfig(**dataclasses.asdict(_JCFG))

LOGIT_TOL = dict(atol=1e-4, rtol=1e-3)
GRAD_TOL = dict(atol=1e-5, rtol=1e-3)
STEP_LOSS_ATOL = 1e-4
STEP_PARAM_ATOL = 1e-4


def _jparams(seed, jcfg=_JCFG):
    return jtfm.init_params(jax.random.PRNGKey(seed), jcfg)


def _port(jparams, device="cpu"):
    return convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device)


def _tokens(seed, b=4, t=33):
    return np.random.default_rng(seed).integers(
        0, _CFG.vocab_size, (b, t)).astype(np.int32)


def _flat(tree):
    return list(tfm._leaves(tree))


def _pairs(tree, jtree):
    """(port leaf, JAX leaf) pairs, matched by key and index (JAX flattens
    dicts in sorted key order, the port in insertion order)."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], jtree[k])
    elif isinstance(tree, list):
        for a, b in zip(tree, jtree, strict=True):
            yield from _pairs(a, b)
    else:
        yield tree, jtree


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.detach().clone()


def test_forward_flash_matches_jax():
    """forward(attn_impl="flash") against the JAX package's (T=48 pads to
    64 inside flash_attention); with_aux gives (logits, 0)."""
    jp = _jparams(3)
    params = _port(jp)
    toks = np.random.default_rng(4).integers(0, 64, (2, 48)).astype(np.int32)
    want, jaux = jtfm.forward(jp, jnp.asarray(toks), _JCFG,
                              attn_impl="flash", with_aux=True)
    got, aux = tfm.forward(params, torch.from_numpy(toks), _CFG,
                           attn_impl="flash", with_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert float(aux) == float(jaux) == 0.0
    plain = tfm.forward(params, torch.from_numpy(toks), _CFG)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **LOGIT_TOL)


@pytest.mark.parametrize("attn_impl", ["plain", "flash"])
def test_loss_and_gradients_match_jax(attn_impl):
    """loss_fn and the gradient of every param leaf against
    jax.value_and_grad of the JAX loss_fn."""
    jp = _jparams(5)
    toks = _tokens(6)
    jloss, jgrads = jax.value_and_grad(jtfm.loss_fn)(
        jp, jnp.asarray(toks), _JCFG, None, attn_impl)
    params = _port(jp)
    leaves = _flat(params)
    for w in leaves:
        w.requires_grad_(True)
    loss = tfm.loss_fn(params, torch.from_numpy(toks), _CFG, attn_impl)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-5
    assert len(jax.tree_util.tree_leaves(jgrads)) == len(leaves)
    for w, jg in _pairs(params, jgrads):
        np.testing.assert_allclose(w.grad.numpy(), np.asarray(jg), **GRAD_TOL)


@pytest.mark.parametrize("attn_impl", ["plain", "flash"])
def test_train_steps_match_optax(attn_impl):
    """Five make_train_step steps at lr 1e-2 against the JAX package's
    optax steps: every loss and, at the end, every param leaf."""
    jp = _jparams(5)
    toks = _tokens(6)
    params = _port(jp)
    jopt, jstep = jtfm.make_train_step(_JCFG, attn_impl=attn_impl,
                                       learning_rate=1e-2)
    jstate = jopt.init(jp)
    opt, step = tfm.make_train_step(_CFG, attn_impl=attn_impl,
                                    learning_rate=1e-2)
    state = opt.init(params)
    for _ in range(5):
        jp, jstate, jloss = jstep(jp, jstate, jnp.asarray(toks))
        params, state, loss = step(params, state, torch.from_numpy(toks))
        assert abs(float(loss) - float(jloss)) <= STEP_LOSS_ATOL
    for w, jw in _pairs(params, jp):
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw),
                                   atol=STEP_PARAM_ATOL, rtol=0)


def test_flash_train_step_reduces_loss():
    """Training through the flash autograd.Function converges (the JAX
    package's test_flash_train_step_reduces_loss)."""
    params = _port(_jparams(5))
    opt, step = tfm.make_train_step(_CFG, attn_impl="flash",
                                    learning_rate=1e-2)
    state = opt.init(params)
    toks = torch.from_numpy(_tokens(7))
    losses = []
    for _ in range(5):
        params, state, loss = step(params, state, toks)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converted_params_are_trainable_leaves(dtype):
    """params_from_numpy on a float32 or bf16 JAX tree gives leaf tensors
    of that dtype that take requires_grad and train."""
    jcfg = dataclasses.replace(_JCFG, dtype=dtype)
    params = _port(_jparams(8, jcfg))
    leaves = _flat(params)
    want = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    assert all(w.is_leaf and w.dtype == want for w in leaves)
    opt, step = tfm.make_train_step(
        dataclasses.replace(_CFG, dtype=dtype), attn_impl="flash")
    state = opt.init(params)
    assert all(w.requires_grad for w in leaves)
    before = leaves[0].detach().clone()
    params, state, loss = step(params, state, torch.from_numpy(_tokens(9)))
    assert np.isfinite(float(loss))
    assert not torch.equal(before, params["embed"].detach())


def test_save_restore_resume_matches_uninterrupted(tmp_path):
    """Three flash steps, a checkpoint, a fresh restore and three more
    equal six uninterrupted steps bit for bit (the JAX package's
    tests/test_checkpoint.py, on the port)."""
    params0 = _port(_jparams(0))
    toks = torch.from_numpy(_tokens(1, b=4, t=17))
    opt, step = tfm.make_train_step(_CFG, attn_impl="flash",
                                    learning_rate=1e-2)

    p_ref = _clone(params0)
    s_ref = opt.init(p_ref)
    for _ in range(6):
        p_ref, s_ref, loss_ref = step(p_ref, s_ref, toks)

    p = _clone(params0)
    s = opt.init(p)
    for _ in range(3):
        p, s, _ = step(p, s, toks)
    with CheckpointManager(tmp_path / "ckpt") as mgr:
        mgr.save(3, params=p, opt_state=s.state_dict())
        assert mgr.latest_step() == 3
        template = _clone(params0)
        restored = mgr.restore({"params": template,
                                "opt_state": opt.init(template).state_dict()})
    p2 = restored["params"]
    s2 = opt.init(p2)
    s2.load_state_dict(restored["opt_state"])
    for _ in range(3):
        p2, s2, loss2 = step(p2, s2, toks)
    assert float(loss2) == float(loss_ref)
    for a, b in zip(_flat(p2), _flat(p_ref)):
        assert torch.equal(a, b)


def test_retention_latest_and_template(tmp_path):
    """max_to_keep retention, latest_step, restore by step onto the
    template's dtype as a leaf (the saved params required grad), a refused
    mismatched template, no temporary files left behind."""
    w = {"w": torch.arange(4, dtype=torch.float32).requires_grad_()}
    with CheckpointManager(tmp_path / "ckpt", max_to_keep=2) as mgr:
        assert mgr.latest_step() is None
        with pytest.raises(FileNotFoundError):
            mgr.restore(w)
        for i in range(4):
            mgr.save(i, w={"w": (w["w"] + i).detach().requires_grad_()})
        assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
        got = mgr.restore({"w": {"w": torch.zeros(4, dtype=torch.bfloat16)}},
                          step=2)
        assert got["w"]["w"].dtype == torch.bfloat16
        assert got["w"]["w"].is_leaf and not got["w"]["w"].requires_grad
        assert got["w"]["w"].tolist() == [2.0, 3.0, 4.0, 5.0]
        with pytest.raises(ValueError):
            mgr.restore({"w": {"w": torch.zeros(5)}})
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_2.pt", "step_3.pt"]


def test_quantized_params_and_ring_raise():
    """Quantized params are serving-only; ring attention without a mesh
    names the mesh it needs (tests/test_torch_parallel.py trains it on
    one)."""
    params = _port(_jparams(2))
    opt, _ = tfm.make_train_step(_CFG)
    with pytest.raises(ValueError, match="serving"):
        opt.init(tfm.quantize_params(params))
    toks = torch.from_numpy(_tokens(3, b=2, t=9))
    for impl in ("ring", "ring_flash"):
        ring_opt, step = tfm.make_train_step(_CFG, attn_impl=impl)
        with pytest.raises(ValueError, match="mesh"):
            step(params, ring_opt.init(params), toks)
