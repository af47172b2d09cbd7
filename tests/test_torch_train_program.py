"""The port's single-device train step as one program
(client_tpu_torch.serve.models.programs.TrainProgram, the counterpart of
the JAX package's jitted ``_make_adam_step``) and its Adam update
(``transformer._AdamState``, optax's formula as tensor ops with the step
count on the params' device) held against client_tpu's optax steps; and
the graph decision for the mesh and pipeline steps
(``programs.graphable``) on a one-rank mesh in this process.

On the CPU the program runs the body its CUDA graph captures on the card
(zero-grad, forward, backward, the update) eagerly, on its static token
buffer.  The JAX params are carried across with
``convert.params_from_numpy``; tokens come from numpy seeds.  Configs:
tests/test_torch_train.py's tiny dense one and tests/test_torch_moe.py's
MoE one, in float32.

Stated tolerances (as tests/test_torch_train.py:122-140): the loss at
1e-5 a step, every param leaf at atol 1e-4 after 3 steps at lr 1e-2
(Adam divides by each gradient's own running RMS, so f32 noise in a
near-zero gradient moves a weight by up to lr times its relative size).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from client_tpu.serve.models import transformer as jtfm
from client_tpu_torch import convert
from client_tpu_torch.serve.models import programs
from client_tpu_torch.serve.models import transformer as tfm

_JDENSE = jtfm.TransformerConfig(
    vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=64, max_seq=64, dtype="float32",
)
_JMOE = dataclasses.replace(_JDENSE, max_seq=32, n_experts=4, top_k=2)

LOSS_ATOL = 1e-5
STEP_PARAM_ATOL = 1e-4


def _port(jparams):
    return convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")


def _tokens(seed, cfg, b=4, t=17):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32)


def _pairs(tree, jtree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], jtree[k])
    elif isinstance(tree, list):
        for a, b in zip(tree, jtree, strict=True):
            yield from _pairs(a, b)
    else:
        yield tree, jtree


@pytest.mark.parametrize("kind,attn_impl", [("dense", "plain"),
                                            ("dense", "flash"),
                                            ("moe", "plain")])
def test_train_program_matches_optax(kind, attn_impl):
    """3 steps of make_train_step's program against client_tpu's optax
    steps: every loss at 1e-5 and every param leaf at STEP_PARAM_ATOL; the
    params and the optimizer state stay the same objects."""
    jcfg = _JDENSE if kind == "dense" else _JMOE
    cfg = tfm.TransformerConfig(**dataclasses.asdict(jcfg))
    jp = jtfm.init_params(jax.random.PRNGKey(5), jcfg)
    params = _port(jp)
    jopt, jstep = jtfm.make_train_step(jcfg, attn_impl=attn_impl,
                                       learning_rate=1e-2)
    jstate = jopt.init(jp)
    opt, step = tfm.make_train_step(cfg, attn_impl=attn_impl,
                                    learning_rate=1e-2)
    assert isinstance(step.program, programs.TrainProgram)
    state = opt.init(params)
    assert isinstance(state, tfm._AdamState)
    leaves = list(tfm._leaves(params))
    moments = [state.state[w]["exp_avg"] for w in leaves]
    for i in range(3):
        toks = _tokens(20 + i, cfg)
        jp, jstate, jloss = jstep(jp, jstate, jnp.asarray(toks))
        out, state2, loss = step(params, state, torch.from_numpy(toks))
        assert out is params and state2 is state
        assert abs(float(loss) - float(jloss)) <= LOSS_ATOL
    assert all(a is b for a, b in zip(tfm._leaves(params), leaves))
    assert all(state.state[w]["exp_avg"] is m
               for w, m in zip(leaves, moments))
    assert all(float(state.state[w]["step"]) == 3.0 for w in leaves)
    for w, jw in _pairs(params, jp):
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw),
                                   atol=STEP_PARAM_ATOL, rtol=0)


def test_adam_update_is_optax_formula():
    """One _AdamState update on hand-made gradients against
    optax.adam's, leaf by leaf, over three steps."""
    import optax

    rng = np.random.default_rng(3)
    w0 = [rng.standard_normal(s).astype(np.float32) for s in ((5, 3), (7,))]
    grads = [[rng.standard_normal(w.shape).astype(np.float32) for w in w0]
             for _ in range(3)]
    opt = optax.adam(3e-2)
    jw = [jnp.asarray(w) for w in w0]
    jstate = opt.init(jw)
    tw = [torch.from_numpy(w.copy()).requires_grad_() for w in w0]
    state = tfm._AdamState(tw, lr=3e-2, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        updates, jstate = opt.update([jnp.asarray(x) for x in g], jstate)
        jw = optax.apply_updates(jw, updates)
        for w, x in zip(tw, g):
            w.grad = torch.from_numpy(x)
        state.step()
    for w, j in zip(tw, jw):
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(j),
                                   atol=1e-6, rtol=0)
    assert all(state.state[w]["step"].device == w.device for w in tw)


def test_load_state_dict_copies_into_the_live_state():
    """A checkpoint's state goes into the tensors the step updates (a
    captured step keeps updating them); other hyperparameters refuse."""
    cfg = tfm.TransformerConfig(**dataclasses.asdict(_JDENSE))
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    opt, step = tfm.make_train_step(cfg, learning_rate=1e-2)
    state = opt.init(params)
    toks = torch.from_numpy(_tokens(1, cfg))
    for _ in range(2):
        step(params, state, toks)
    saved = {k: v for k, v in state.state_dict().items()}
    saved = {"state": {i: {k: t.clone() for k, t in st.items()}
                       for i, st in saved["state"].items()},
             "param_groups": saved["param_groups"]}
    fresh = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    other = opt.init(fresh)
    live = [other.state[w]["exp_avg_sq"] for w in tfm._leaves(fresh)]
    other.load_state_dict(saved)
    assert all(other.state[w]["exp_avg_sq"] is t
               for w, t in zip(tfm._leaves(fresh), live))
    for a, b in zip(tfm._leaves(fresh), tfm._leaves(params)):
        torch.testing.assert_close(other.state[a]["exp_avg_sq"],
                                   state.state[b]["exp_avg_sq"])
        assert float(other.state[a]["step"]) == 2.0
    bad = {**saved, "param_groups": [
        {**saved["param_groups"][0], "lr": 5e-3}]}
    with pytest.raises(ValueError, match="lr"):
        other.load_state_dict(bad)


def test_program_starts_over_for_other_state_or_shape():
    """The program belongs to one params tree, state and token shape:
    another of any starts it over (its first call runs eagerly again), and
    its losses are the eager step's."""
    cfg = tfm.TransformerConfig(**dataclasses.asdict(_JDENSE))

    def fresh():
        return tfm.init_params(torch.Generator().manual_seed(2), cfg, "cpu")

    _, eager = tfm.make_train_step(cfg, learning_rate=1e-2, eager=True)
    assert eager.program is None
    opt, step = tfm.make_train_step(cfg, learning_rate=1e-2)
    pa, pb = fresh(), fresh()
    sa, sb = opt.init(pa), opt.init(pb)
    toks = torch.from_numpy(_tokens(4, cfg))
    for t, calls in ((toks, 1), (toks, 2), (toks, 3), (toks[:, :9], 1),
                     (toks, 1)):
        _, _, got = step(pa, sa, t)
        _, _, want = eager(pb, sb, t)
        assert step.program._calls == calls
        assert float(got) == float(want)
    for a, b in zip(tfm._leaves(pa), tfm._leaves(pb)):
        assert torch.equal(a, b)
    other = fresh()
    step(other, opt.init(other), toks)
    assert step.program._calls == 1


@pytest.fixture(scope="module")
def one_rank_mesh():
    """make_mesh() over a one-rank gloo world in this process (every dim
    1), left at the module's end."""
    import torch.distributed as dist

    from client_tpu_torch import parallel

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield parallel.make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


_MESH_STEPS = {
    "ring": lambda mesh, eager: tfm.make_train_step(
        _cfg(_JDENSE), "ring", mesh=mesh, eager=eager),
    "ring_flash": lambda mesh, eager: tfm.make_train_step(
        _cfg(_JDENSE), "ring_flash", mesh=mesh, eager=eager),
    "moe": lambda mesh, eager: tfm.make_train_step(
        _cfg(_JMOE), "ring_flash", mesh=mesh, eager=eager),
    "gpipe": lambda mesh, eager: tfm.make_pipeline_train_step(
        _cfg(_JDENSE), mesh, 2, eager=eager),
}


def _cfg(jcfg):
    return tfm.TransformerConfig(**dataclasses.asdict(jcfg))


@pytest.mark.parametrize("eager", [False, True])
@pytest.mark.parametrize("backend", ["gloo", "nccl"])
@pytest.mark.parametrize("kind", sorted(_MESH_STEPS))
def test_mesh_and_pipeline_steps_stay_eager(one_rank_mesh, monkeypatch,
                                            kind, backend, eager):
    """The graph decision (programs.graphable) on a real mesh: a gloo
    world's mesh and pipeline steps carry no program (gloo stages CUDA
    tensors through host memory, which a capture cannot record); with
    every group on NCCL and the mesh on CUDA (both patched in here) they
    are a TrainProgram; ``eager=True`` carries none on either."""
    import torch.distributed as dist

    if backend == "nccl":
        monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
        monkeypatch.setattr(type(one_rank_mesh), "device_type",
                            property(lambda mesh: "cuda"))
    assert programs.graphable(one_rank_mesh) == (backend == "nccl")
    _, step = _MESH_STEPS[kind](one_rank_mesh, eager)
    if backend == "nccl" and not eager:
        assert isinstance(step.program, programs.TrainProgram)
    else:
        assert step.program is None
