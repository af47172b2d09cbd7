"""client_tpu_torch.parallel.ring_attention held against
client_tpu.parallel.ring_attention, mirroring tests/test_ring_attention.py.

The port runs in one world of 8 gloo ranks on the CPU (a process each,
spawned once for the module: tests/torch_world_cases.py ``ring_cases``)
on the mesh dp=2, tp=2, sp=2; JAX runs ``ring_attention_sharded`` on the
conftest's 8-device CPU mesh of the same shape, meanwhile (imported in
the fixture: the card has no JAX, and runs this file's ``cuda`` test with
``--noconftest``).  The inputs
come from numpy seeds.  The flash ring runs each step through the port's
flash wrappers (on the CPU their plain versions) and JAX's Pallas kernels
in interpret mode, at shards of 32 tokens, which tile (no fallback).

Stated tolerances (float32): outputs at atol 2e-5 / rtol 1e-4, gradients
of sum(out * cot) at atol 1e-4 / rtol 1e-3 (the JAX flash tests' own: sums
in another order and another blocking).

The ``cuda`` test runs chip_smoke.py phase 19b's two-rank ring on one
card at shards of 128 (bf16) and skips without one.
"""

import os
import pickle
import threading

import numpy as np
import pytest
import torch

from client_tpu_torch.parallel import spawn_world

TESTS = os.path.dirname(os.path.abspath(__file__))
OUT_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)
# the world's own deadline: a hung collective fails the module's tests
WORLD_TIMEOUT_S = 240

# (impl, causal) -> input shape [B, T, H, D]; T splits over sp = 2
CASES = {("plain", True): (2, 16, 4, 8), ("plain", False): (2, 16, 4, 8),
         ("flash", True): (2, 64, 4, 8), ("flash", False): (2, 64, 4, 8)}


def _name(impl, causal):
    return f"{impl}_{'causal' if causal else 'full'}"


def _inputs():
    out = {}
    for i, ((impl, causal), shape) in enumerate(CASES.items()):
        rng = np.random.default_rng(10 + i)
        out[_name(impl, causal)] = {
            n: rng.standard_normal(shape).astype(np.float32) for n in "qkvc"}
    rng = np.random.default_rng(20)
    out["causality"] = {n: rng.standard_normal((2, 16, 4, 8)).astype(
        np.float32) for n in "qkv"}
    # the permute-count case: local [B, T_local, H, D] on every rank
    out["permute_join"] = {n: rng.standard_normal((1, 8, 2, 4)).astype(
        np.float32) for n in "qkv"}
    return out


def _jax_refs(inputs):
    """Every case's JAX output and gradients, in one jitted program (JAX
    is imported here: the card runs this file's cuda test without it)."""
    import jax
    import jax.numpy as jnp

    from client_tpu.parallel import make_mesh as jmake_mesh
    from client_tpu.parallel.ring_attention import (
        ring_attention_sharded as jring_attention_sharded,
    )

    mesh = jmake_mesh(dp=2, tp=2, sp=2)

    def one(impl, causal, q, k, v, cot):
        f = lambda a, b, c: jring_attention_sharded(  # noqa: E731
            a, b, c, mesh, causal=causal, impl=impl)
        out, vjp = jax.vjp(f, q, k, v)
        return (out, *vjp(cot))

    def all_cases(arrays):
        return {name: one(impl, causal, *arrays[name])
                for (impl, causal) in CASES
                for name in [_name(impl, causal)]}

    arrays = {name: tuple(jnp.asarray(inputs[name][n]) for n in "qkvc")
              for name in (_name(*c) for c in CASES)}
    res = jax.jit(all_cases)(arrays)
    return {name: dict(zip(("out", "dq", "dk", "dv"),
                           (np.asarray(x) for x in vals)))
            for name, vals in res.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(port results, JAX results): the port's world runs in a thread
    while this process computes JAX's."""
    tmp = tmp_path_factory.mktemp("ring_world")
    inputs = _inputs()
    in_path, out_path = str(tmp / "in.pkl"), str(tmp / "out.pkl")
    with open(in_path, "wb") as f:
        pickle.dump(inputs, f)
    failure = []

    def run():
        try:
            spawn_world("torch_world_cases:ring_cases", 8,
                        args=(in_path, out_path), device="cpu",
                        paths=(TESTS,),
                        timeout_s=WORLD_TIMEOUT_S)
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
        return pickle.load(f), refs, inputs


def _case(world, name):
    got = world[0][name]
    assert "error" not in got, got.get("error")
    return got


@pytest.mark.parametrize("impl,causal", list(CASES))
def test_ring_matches_jax(world, impl, causal):
    """ring_attention_sharded (JAX's, same mesh, same impl) against the
    port's: the output and the gradients of sum(out * cot) in q, k, v; the
    port's ring also equals its own plain_attention of the whole
    sequence."""
    name = _name(impl, causal)
    got, want = _case(world, name), world[1][name]
    np.testing.assert_allclose(got["out"], want["out"], **OUT_TOL)
    np.testing.assert_allclose(got["out"], got["plain"], **OUT_TOL)
    for g in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[g], want[g], **GRAD_TOL)


def test_causality(world):
    """tests/test_ring_attention.py::test_causality on the port: future
    tokens perturbed, earlier outputs unchanged, later ones moved."""
    got = _case(world, "causality")
    np.testing.assert_allclose(got["pert"][:, :12], got["base"][:, :12],
                               atol=1e-5)
    assert not np.allclose(got["pert"][:, 12:], got["base"][:, 12:])


def test_every_permute_runs_both_ways(world):
    """A causal ring over sp = 2 permutes once forward and once backward
    on every rank (rank 0 skips the received shard and joins it); the CPU
    stages nothing."""
    got = _case(world, "permute_join")
    assert got == {"ppermute": 2, "bytes_staged": 0}


@pytest.mark.cuda
def test_two_rank_flash_ring_on_one_card(tmp_path):
    """chip_smoke.py phase 19b at shards of 128: two gloo ranks on one
    card run ring_attention_sharded(impl="flash") on make_mesh(sp=2)
    forward and backward, bf16, causal; out, dQ, dK, dV against one-rank flash_attention within phase
    7's bf16 tolerance (atol 2e-2, rtol 1e-2); each rank launched every
    flash kernel; K/V went through host memory (gloo)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from client_tpu_torch.ops import _build
    from client_tpu_torch.ops.flash_attention import flash_attention

    _build.kernels()  # built once here, before the ranks load it
    rng = np.random.default_rng(19)
    shape = (2, 256, 4, 64)
    arrays = {c: rng.standard_normal(shape).astype(np.float32)
              for c in "qkvg"}
    in_path, out_path = str(tmp_path / "in.pkl"), str(tmp_path / "out")
    with open(in_path, "wb") as f:
        pickle.dump(arrays, f)
    spawn_world("torch_world_cases:ring_on_card", 2, args=(in_path, out_path),
                device="cuda", backend="gloo", paths=(TESTS,), timeout_s=300)
    q, k, v, g = (torch.from_numpy(arrays[c]).to("cuda", torch.bfloat16)
                  for c in "qkvg")
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = flash_attention(q, k, v)
    out.backward(g)
    want = {"out": out, "dq": q.grad, "dk": k.grad, "dv": v.grad}
    t = shape[1] // 2
    for rank in range(2):
        with open(f"{out_path}.{rank}", "rb") as f:
            got = pickle.load(f)
        for name, ref in want.items():
            ref = ref[:, rank * t:(rank + 1) * t].detach().float().cpu().numpy()
            np.testing.assert_allclose(got[name], ref, atol=2e-2, rtol=1e-2)
        assert all(got["launches"][k] > 0 for k in
                   ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
        assert got["stats"]["bytes_staged"] > 0
