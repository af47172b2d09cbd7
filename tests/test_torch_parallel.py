"""client_tpu_torch.parallel and the sharded transformer held against
client_tpu on the 8-device CPU mesh, mirroring the mesh cases of
tests/test_transformer.py, tests/test_pipeline_moe.py and
tests/test_checkpoint.py.

The port runs in one world of 8 gloo ranks on the CPU (a process each,
spawned once for the module: tests/torch_world_cases.py
``parallel_cases``), on the meshes dp=2/tp=2/sp=2, dp=2/tp=2/ep=2 and
dp=2/tp=2/pp=2; JAX runs the same functions on the conftest's 8-device
CPU mesh of the same shapes (one jitted program), meanwhile.  Params are
made in JAX and carried across with ``convert.params_from_numpy``; tokens
come from numpy seeds.  The same world runs the dp/tp/sp ring_flash
step, the ep MoE step and the pp GPipe step as programs
(``_make_adam_step(..., graph=True)``, TrainProgram's CPU path) beside
their eager steps.  Then ``graft.dryrun_multichip(8)`` runs its own
world.

Stated tolerances (float32 throughout):
- a loss at 1e-5 relative (sums in another order, over ranks);
- params after one Adam step at atol 1e-5 / rtol 1e-5 (the dp/tp/sp
  steps, everywhere).  Adam's first step moves each entry by
  lr * g / (|g| + eps), so where a gradient entry is itself rounding
  noise near zero (|g| ~ eps = 1e-8) the two packages' updates may differ
  by up to 2 * lr; the MoE and pipeline steps, whose expert and stage
  weights have such entries, are held at 1e-5 where JAX's |g| > 1e-6
  and within 2 * lr elsewhere, and their gradients are held themselves
  at atol 1e-5 / rtol 1e-3 (tests/test_torch_train.py's GRAD_TOL);
- logits at atol 1e-4 / rtol 1e-3 (tests/test_transformer.py's ring
  against plain);
- a mesh program's losses and params against the eager step's from the
  same weights: bit-equal (the same body on the same inputs).
"""

import dataclasses
import os
import pickle
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec

from client_tpu import parallel as jpar
from client_tpu.serve.models import transformer as jtfm
from client_tpu_torch import convert, graft
from client_tpu_torch import parallel as tpar
from client_tpu_torch.parallel import spawn_world
from client_tpu_torch.serve.models import transformer as tfm
from client_tpu_torch.train import CheckpointManager

TESTS = os.path.dirname(os.path.abspath(__file__))
WORLD_TIMEOUT_S = 240
LOSS_RTOL = 1e-5
PARAM_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-3)
GRAD_TOL = dict(atol=1e-5, rtol=1e-3)
G_MIN = 1e-6  # a gradient entry above Adam's eps by 100x
LR = 1e-3

# tests/test_transformer.py's CFG, and tests/test_pipeline_moe.py's CFG
# (four layers: two stages of two) and MOE_CFG
CFG = jtfm.TransformerConfig(
    vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq=32, dtype="float32")
PIPE_CFG = jtfm.TransformerConfig(
    vocab_size=64, d_model=32, n_layers=4, n_heads=4, n_kv_heads=2,
    d_ff=64, max_seq=32, dtype="float32")
MOE_CFG = dataclasses.replace(PIPE_CFG, n_layers=2, n_experts=4, top_k=2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _inputs():
    dense = _np(jtfm.init_params(jax.random.PRNGKey(5), CFG))
    train = {"cfg": dataclasses.asdict(CFG), "params": dense, "lr": LR,
             "tokens": _tokens(6, (4, 17), CFG.vocab_size)}
    pipe = _np(jtfm.init_params(jax.random.PRNGKey(0), PIPE_CFG))
    pipe_tokens = _tokens(4, (4, 9), PIPE_CFG.vocab_size)
    moe_params = _np(jtfm.init_params(jax.random.PRNGKey(7), MOE_CFG))
    moe_tokens = _tokens(8, (4, 17), MOE_CFG.vocab_size)
    return {
        "train_ring": train,
        "train_ring_flash": train,
        "moe_ep": {"cfg": dataclasses.asdict(MOE_CFG), "lr": LR,
                   "params": moe_params,
                   "fwd_tokens": _tokens(1, (4, 8), MOE_CFG.vocab_size),
                   "tokens": moe_tokens},
        "pipeline": {"cfg": dataclasses.asdict(PIPE_CFG), "lr": 1e-2,
                     "params": pipe,
                     "stacked": _np(jtfm.stack_pipeline_params(pipe, 2)),
                     "fwd_tokens": _tokens(1, (4, 8), PIPE_CFG.vocab_size),
                     "tokens": pipe_tokens},
        "graph_train_ring_flash": train,
        "graph_moe_ep": {"cfg": dataclasses.asdict(MOE_CFG), "lr": LR,
                         "params": moe_params, "tokens": moe_tokens},
        "graph_pipeline": {"cfg": dataclasses.asdict(PIPE_CFG), "lr": 1e-2,
                           "params": pipe, "tokens": pipe_tokens},
        "param_specs": {"cfgs": {"dense": dataclasses.asdict(CFG),
                                 "moe": dataclasses.asdict(MOE_CFG)}},
        # the same weights restored from a checkpoint this process writes
        "restore": {"cfg": dataclasses.asdict(CFG),
                    "template": _np(jtfm.init_params(jax.random.PRNGKey(2),
                                                     CFG)),
                    "tokens": train["tokens"]},
        "refusals": {"cfg": dataclasses.asdict(CFG), "params": dense,
                     "tokens": train["tokens"][:, :-1]},
    }


def _jax_refs(inputs):
    """JAX's side of every numeric case on its 8-device CPU mesh, in one
    jitted program."""
    mesh = jpar.make_mesh(dp=2, tp=2, sp=2)
    emesh = jpar.make_mesh(dp=2, tp=2, ep=2)
    pmesh = jpar.make_mesh(dp=2, tp=2, pp=2)

    def put(params, m, cfg):
        return jax.device_put(params, jpar.named_shardings(
            m, jpar.param_specs(cfg)))

    def rows(x, m):
        return jax.device_put(jnp.asarray(x),
                              NamedSharding(m, PartitionSpec("dp", None)))

    steps = {impl: jtfm.make_train_step(CFG, mesh=mesh, attn_impl=impl,
                                        learning_rate=LR)
             for impl in ("ring", "ring_flash")}
    eopt, estep = jtfm.make_train_step(MOE_CFG, mesh=emesh,
                                       learning_rate=LR)
    popt, pstep = jtfm.make_pipeline_train_step(
        PIPE_CFG, pmesh, n_microbatches=2, learning_rate=1e-2)

    def program(a):
        out = {}
        for impl, (_, step) in steps.items():
            p, _, loss = step(a["dense"], a["dense_state"][impl], a["toks"])
            out[f"train_{impl}"] = {
                "loss": loss, "params": p,
                "logits": jtfm.forward(a["dense"], a["toks"][:, :-1], CFG,
                                       mesh=mesh, attn_impl=impl)}
        logits, aux = jtfm.forward(a["moe"], a["moe_fwd"], MOE_CFG,
                                   mesh=emesh, with_aux=True)
        p, _, loss = estep(a["moe"], a["moe_state"], a["moe_toks"])
        grads = jax.grad(jtfm.loss_fn)(a["moe"], a["moe_toks"], MOE_CFG,
                                       emesh)
        out["moe_ep"] = {"logits": logits, "aux": aux, "loss": loss,
                         "params": p, "grads": grads}
        p, _, loss = pstep(a["pipe"], a["pipe_state"], a["pipe_toks"])
        grads = jax.grad(lambda pp, t: jtfm._next_token_nll(
            jtfm.forward_pipelined(pp, t[:, :-1], PIPE_CFG, pmesh, 2),
            t[:, 1:]))(a["pipe"], a["pipe_toks"])
        out["pipeline"] = {
            "logits": jtfm.forward_pipelined(a["pipe"], a["pipe_fwd"],
                                             PIPE_CFG, pmesh, 2),
            "loss": loss, "params": p, "grads": grads}
        return out

    tr, moe, pipe = inputs["train_ring"], inputs["moe_ep"], inputs["pipeline"]
    dense = put(tr["params"], mesh, CFG)
    moe_p = put(moe["params"], emesh, MOE_CFG)
    pipe_p = jtfm.stack_pipeline_params(pipe["params"], 2)
    args = {
        "dense": dense,
        "dense_state": {impl: opt.init(dense)
                        for impl, (opt, _) in steps.items()},
        "toks": rows(tr["tokens"], mesh),
        "moe": moe_p, "moe_state": eopt.init(moe_p),
        "moe_fwd": jax.device_put(jnp.asarray(moe["fwd_tokens"]),
                                  NamedSharding(emesh, jpar.batch_spec())),
        "moe_toks": rows(moe["tokens"], emesh),
        "pipe": pipe_p, "pipe_state": popt.init(pipe_p),
        "pipe_fwd": jnp.asarray(pipe["fwd_tokens"]),
        "pipe_toks": jnp.asarray(pipe["tokens"]),
    }
    return _np(jax.jit(program)(args))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(port results, JAX results, inputs, dryrun lines): the port's world
    (then the dryrun's) runs in a thread while this process computes
    JAX's."""
    tmp = tmp_path_factory.mktemp("parallel_world")
    inputs = _inputs()
    in_path, out_path = str(tmp / "in.pkl"), str(tmp / "out.pkl")
    with open(in_path, "wb") as f:
        pickle.dump(inputs, f)
    ckpt = str(tmp / "ckpt")
    with CheckpointManager(ckpt) as mgr:
        mgr.save(0, params=convert.params_from_numpy(
            inputs["restore"]["template"], "cpu"))
    failure, dryrun = [], []

    def run():
        try:
            spawn_world("torch_world_cases:parallel_cases", 8,
                        args=(in_path, out_path, ckpt), device="cpu",
                        paths=(TESTS,),
                        timeout_s=WORLD_TIMEOUT_S)
            dryrun.extend(graft.dryrun_multichip(8, timeout_s=120))
        except Exception as e:  # noqa: BLE001 -- reported below
            failure.append(e)

    thread = threading.Thread(target=run)
    thread.start()
    try:
        refs = _jax_refs(inputs)
    finally:
        thread.join()
    if failure:
        raise failure[0]
    with open(out_path, "rb") as f:
        return pickle.load(f), refs, inputs, dryrun


def _case(world, name):
    got = world[0][name]
    assert "error" not in got, got.get("error")
    return got


def _pairs(tree, jtree):
    """(port leaf, JAX leaf) pairs matched by key and index (tuples, such
    as specs and shapes, are leaves)."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], jtree[k])
    elif isinstance(tree, list):
        for a, b in zip(tree, jtree, strict=True):
            yield from _pairs(a, b)
    else:
        yield tree, jtree


def _assert_params(got, want):
    for path, a, b in _paths(got, want):
        np.testing.assert_allclose(a, b, **PARAM_TOL, err_msg=path)


def _assert_step(got, want, lr):
    """Gradients at GRAD_TOL; updated params at PARAM_TOL where JAX's
    gradient clears G_MIN, within 2 * lr where it is rounding noise."""
    for path, a, b in _paths(got["grads"], want["grads"]):
        np.testing.assert_allclose(a, b, **GRAD_TOL, err_msg=path)
    for (path, a, b), (_, _, g) in zip(_paths(got["params"], want["params"]),
                                       _paths(got["grads"], want["grads"])):
        big = np.abs(g) > G_MIN
        np.testing.assert_allclose(a[big], b[big], **PARAM_TOL, err_msg=path)
        assert np.abs(a - b).max() <= 2 * lr, path


def _paths(tree, jtree, path=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _paths(tree[k], jtree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, (a, b) in enumerate(zip(tree, jtree, strict=True)):
            yield from _paths(a, b, f"{path}/{i}")
    else:
        yield path, tree, jtree


def test_make_mesh_validation(world):
    """make_mesh's ValueErrors and dims, against jpar.make_mesh on 8
    devices (tests/test_pipeline_moe.py::test_make_mesh_five_axes)."""
    got = _case(world, "mesh_validation")
    want = []
    for kw in ({"dp": 2, "tp": 2, "sp": 2, "pp": 2}, {"tp": 3}):
        with pytest.raises(ValueError) as e:
            jpar.make_mesh(**kw)
        want.append(str(e.value))
    assert got["errors"] == want
    jmesh = jpar.make_mesh(dp=2, tp=2, pp=2)
    assert tuple(got["names"]) == jmesh.axis_names
    assert got["shape"] == [jmesh.shape[a] for a in jmesh.axis_names]
    with pytest.raises(ValueError):
        tpar.mesh_shape(8, dp=2, tp=2, sp=2, pp=2)


@pytest.mark.parametrize("which", ["dense", "moe"])
def test_param_specs_match_jax(world, which):
    """param_specs leaf by leaf against JAX's PartitionSpecs, and each
    DTensor's local shard against JAX's shard shape on the same mesh."""
    got = _case(world, "param_specs")[which]
    cfg = CFG if which == "dense" else MOE_CFG
    jmesh = (jpar.make_mesh(dp=2, tp=2, sp=2) if which == "dense"
             else jpar.make_mesh(dp=2, tp=2, ep=2))
    jspecs = jpar.param_specs(cfg)
    shapes = jax.eval_shape(lambda: jtfm.init_params(jax.random.PRNGKey(0),
                                                     cfg))
    n = 0
    for spec, jspec in _pairs(got["specs"], jax.tree_util.tree_map(
            tuple, jspecs, is_leaf=lambda x: isinstance(x, PartitionSpec))):
        assert tuple(spec) == tuple(jspec)
        n += 1
    jshard = jax.tree_util.tree_map(
        lambda s, a: NamedSharding(jmesh, s).shard_shape(a.shape),
        jspecs, shapes, is_leaf=lambda x: isinstance(x, PartitionSpec))
    for local, want in _pairs(got["local_shapes"], jshard):
        assert tuple(local) == tuple(want)
    assert n == len(jax.tree_util.tree_leaves(shapes))


@pytest.mark.parametrize("attn_impl", ["ring", "ring_flash"])
def test_sharded_train_step_matches_jax(world, attn_impl):
    """One dp=2/tp=2/sp=2 Adam step (tests/test_transformer.py::
    test_sharded_train_step_runs, tests/test_ring_attention.py's
    ring_flash step): the loss and every updated param against JAX's
    sharded step; the sharded forward's logits (a DTensor laid out
    dp/sp/tp) against JAX's (test_ring_forward_matches_plain)."""
    got = _case(world, f"train_{attn_impl}")
    want = world[1][f"train_{attn_impl}"]
    assert got["loss"] == pytest.approx(float(want["loss"]), rel=LOSS_RTOL)
    _assert_params(got["params"], want["params"])
    np.testing.assert_allclose(got["logits"], want["logits"], **LOGIT_TOL)
    assert got["logit_placements"] == [
        "S(0)", "S(2)", "S(1)", "R", "R"]


def test_moe_ep_step_matches_jax(world):
    """The dp=2/tp=2/ep=2 MoE forward with its aux loss and one Adam step
    (tests/test_pipeline_moe.py::test_moe_forward_and_sharded_ep,
    test_moe_ep_train_step_runs) against JAX's."""
    got, want = _case(world, "moe_ep"), world[1]["moe_ep"]
    np.testing.assert_allclose(got["logits"], want["logits"], **LOGIT_TOL)
    assert got["aux"] == pytest.approx(float(want["aux"]), rel=LOSS_RTOL)
    assert got["loss"] == pytest.approx(float(want["loss"]), rel=LOSS_RTOL)
    _assert_step(got, want, LR)


def test_pipeline_matches_jax(world):
    """forward_pipelined and one make_pipeline_train_step step at pp = 2,
    dp = 2, two microbatches (tests/test_pipeline_moe.py's pipeline
    cases) against JAX's; the converter takes JAX's stacked tree."""
    got, want = _case(world, "pipeline"), world[1]["pipeline"]
    assert got["converter_equal"]
    np.testing.assert_allclose(got["logits"], want["logits"], **LOGIT_TOL)
    assert got["loss"] == pytest.approx(float(want["loss"]), rel=LOSS_RTOL)
    _assert_step(got, want, 1e-2)


_GRAPH_CASES = ("moe_ep", "pipeline", "train_ring_flash")


@pytest.mark.parametrize("kind", _GRAPH_CASES)
def test_mesh_program_matches_eager_and_jax(world, kind):
    """The dp/tp/sp ring_flash step, the ep MoE step (DTensor tokens) and
    the pp GPipe step through ``_make_adam_step(..., graph=True)`` (the
    program's CPU path): two steps' losses and the params after them
    bit-equal to the eager step's from the same weights; the first loss
    at 1e-5 relative to JAX's sharded step."""
    got = _case(world, f"graph_{kind}")
    want = world[1][kind]
    assert got["program"] == "TrainProgram" and got["eager_program"] is None
    assert got["losses"] == got["eager_losses"]
    assert got["params_equal"]
    assert got["losses"][0] == pytest.approx(float(want["loss"]),
                                             rel=LOSS_RTOL)


@pytest.mark.parametrize("kind", _GRAPH_CASES)
def test_mesh_program_starts_over(world, kind):
    """The mesh program counts its calls with one params tree and state
    (2 after two steps); new params, then a new state, start it over (its
    first call again)."""
    got = _case(world, f"graph_{kind}")
    assert got["calls"] == 2
    assert got["new_params_calls"] == 1
    assert got["new_state_calls"] == 1


def test_stack_stage_params_shapes():
    """tests/test_pipeline_moe.py::test_stack_stage_params_shapes."""
    params = tfm.init_params(__import__("torch").Generator().manual_seed(0),
                             tfm.TransformerConfig(**dataclasses.asdict(
                                 PIPE_CFG)), "cpu")
    stages = tfm.stack_pipeline_params(params, 2)["stages"]
    assert tuple(stages["attn"]["wq"].shape) == (2, 2) + tuple(
        params["layers"][0]["attn"]["wq"].shape)
    with pytest.raises(ValueError):
        tfm.stack_pipeline_params(params, 3)


def test_restore_onto_placements(world):
    """tests/test_checkpoint.py::test_restore_onto_sharded_mesh: a
    checkpoint of plain params restored onto a DTensor template keeps the
    template's mesh and placements leaf by leaf (each rank's shard, JAX's
    shard shape), equals what was saved, and a sharded ring step runs
    straight off it."""
    got = _case(world, "restore")
    assert got["layout_kept"]
    assert got["wq_placements"] == ["R", "S(1)", "R", "R", "R"]
    jmesh = jpar.make_mesh(dp=2, tp=2, sp=2)
    wq = world[2]["restore"]["template"]["layers"][0]["attn"]["wq"]
    assert got["wq_local_shape"] == got["wq_template_local_shape"] == \
        NamedSharding(jmesh, PartitionSpec(None, "tp")).shard_shape(wq.shape)
    for path, a, b in _paths(got["restored"],
                             world[2]["restore"]["template"]):
        np.testing.assert_array_equal(a, b, err_msg=path)
    assert np.isfinite(got["loss"])
    # JAX's test_train_step_reduces_loss: the second step lowers the loss
    assert got["uninterrupted_loss"] < got["loss"]


def test_sharded_resume_is_bit_exact(world):
    """tests/test_checkpoint.py::test_save_restore_resume_matches_
    uninterrupted on the mesh: Adam's moments leave ``state_dict()`` as
    DTensors of their params' layouts and come back through
    ``load_state_dict`` (as full tensors each rank slices); the resumed
    step equals the uninterrupted one bit for bit."""
    got = _case(world, "restore")
    assert got["resumed_equal"]
    assert got["resumed_loss"] == got["uninterrupted_loss"]


def test_entry_runs_the_flagship_forward():
    """graft.entry() (``__graft_entry__.entry()``'s twin): the flagship
    config of the JAX entry and a forward of [4, 128] tokens to f32
    logits over its vocab, on the CPU when asked."""
    import torch

    fn, (params, tokens) = graft.entry(device="cpu")
    assert dataclasses.asdict(graft.FLAGSHIP) == dataclasses.asdict(
        jtfm.TransformerConfig(vocab_size=8192, d_model=512, n_layers=4,
                               n_heads=8, n_kv_heads=4, d_ff=1536,
                               max_seq=512))
    with torch.no_grad():
        logits = fn(params, tokens)
    assert tuple(tokens.shape) == (4, 128)
    assert logits.shape == (4, 128, 8192) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())


def test_refusals_match_jax(world):
    """attn_impl="flash" and quantized params refuse a mesh, with JAX's
    messages (tests/test_quant.py::test_quantized_params_reject_mesh)."""
    got = _case(world, "refusals")
    inp = world[2]["refusals"]
    jmesh = jpar.make_mesh(dp=2, tp=2, sp=2)
    toks = jnp.asarray(inp["tokens"])
    with pytest.raises(ValueError) as flash:
        jtfm.forward(inp["params"], toks, CFG, mesh=jmesh, attn_impl="flash")
    with pytest.raises(ValueError) as quant:
        jtfm.forward(jtfm.quantize_params(inp["params"]), toks, CFG,
                     mesh=jmesh)
    assert got == {"flash": str(flash.value), "quantized": str(quant.value)}


def test_rank_killed_by_signal_leaves_its_stack():
    """A rank that dies by a signal makes spawn_world raise with the
    signal's name and the rank's Python stack (its faulthandler); the
    rank still running writes its stack before it is stopped."""
    with pytest.raises(RuntimeError) as err:
        spawn_world("torch_world_cases:segfault_rank", 2, device="cpu",
                    paths=(TESTS,), timeout_s=WORLD_TIMEOUT_S)
    text = str(err.value)
    rank0, rank1 = text.split("--- rank 1 ")
    assert rank1.startswith("(exit -11 (SIGSEGV))")
    assert "Fatal Python error: Segmentation fault" in rank1
    assert "in segfault_rank" in rank1
    assert "--- rank 0 (exit -9 (SIGKILL))" in rank0
    assert "in segfault_rank" in rank0


def test_dryrun_multichip(world):
    """graft.dryrun_multichip(8) ran the reference's four phases on 8 gloo
    ranks: its lines, each with a finite loss."""
    lines = world[3]
    prefixes = ["dryrun_multichip: mesh dp=2 tp=2 sp=2, loss=",
                "dryrun_multichip: ring_flash step on the same mesh, loss=",
                "dryrun_multichip: MoE mesh dp=2 tp=2 ep=2, loss=",
                "dryrun_multichip: pipeline mesh dp=2 tp=2 pp=2 "
                "(GPipe microbatches=2), loss="]
    assert len(lines) == len(prefixes)
    for line, prefix in zip(lines, prefixes):
        assert line.startswith(prefix)
        assert np.isfinite(float(line[len(prefix):]))
