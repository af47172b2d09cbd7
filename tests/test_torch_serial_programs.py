"""The port's serial LM programs (client_tpu_torch.serve.models.programs,
the counterpart of the JAX package's ``_jitted_steps``) held against
client_tpu's ``generate``.

On the CPU a program set runs the bodies its CUDA graphs capture on the
card, eagerly, on the same static buffers: ``prefill`` into the set's
static cache, then ``decode_step`` with ``cache["len"]`` advanced in place.
The JAX params (``init_params`` from one PRNG key) are carried across with
``convert.params_from_numpy``; prompts come from numpy seeds.  The config
is tests/test_language.py's tiny one, in float32, where greedy tokens
agree exactly (stated tolerance: token for token).
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import jax

from client_tpu.serve.models import transformer as jtfm
from client_tpu_torch import convert
from client_tpu_torch.serve.models import language, programs
from client_tpu_torch.serve.models import transformer as tfm

_JTINY = jtfm.TransformerConfig(
    vocab_size=258, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq=64, dtype="float32",
)
_TINY = tfm.TransformerConfig(**dataclasses.asdict(_JTINY))


@pytest.fixture(scope="module")
def weights():
    jp = jtfm.init_params(jax.random.PRNGKey(7), _JTINY)
    return jp, convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _prompt(n, seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([[256], rng.integers(0, 256, n - 1)]).astype(
        np.int32)


def _fresh(weights):
    """A params tree of its own (its own default pool) from the same JAX
    weights."""
    return convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, weights[0]), "cpu")


def _pool(runner):
    return programs.serial_pool(runner.params, runner.cfg)


def test_decode_step_advances_the_cache_length_in_place(weights):
    """prefill and decode_step write ``cache["len"]`` into the tensor the
    cache holds (a CUDA graph replays into the same buffer)."""
    _, params = weights
    cache = tfm.init_cache(_TINY, 2, "cpu")
    length = cache["len"]
    toks = torch.from_numpy(np.stack([_prompt(5, 1), _prompt(5, 2)]))
    logits, cache = tfm.prefill(params, toks, _TINY, cache)
    assert cache["len"] is length and length.tolist() == [5, 5]
    token = logits.argmax(-1).to(torch.int32)
    for step in range(3):
        logits, cache = tfm.decode_step(params, token, _TINY, cache)
        assert cache["len"] is length
        assert length.tolist() == [6 + step] * 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_static_buffer_greedy_tokens_equal_jax_generate(weights, seed):
    """The program set's prefill + decode bodies on its static buffers:
    48 float32 greedy tokens, token for token with client_tpu's generate,
    and with the port's eager loop."""
    jp, params = weights
    prompt = _prompt(4 + 3 * seed, 10 + seed)
    want = list(jtfm.generate(jp, _JTINY, prompt, 48))
    got = list(tfm.generate(params, _TINY, prompt, 48))
    assert got == want
    assert list(tfm.generate(params, _TINY, prompt, 48, eager=True)) == want
    # the set goes back to the params' pool; the next stream reuses it
    pool = programs.serial_pool(params, _TINY)
    with pool.acquire(params, 1) as progs:
        assert progs.batch == 1 and progs.captures == {}
        assert int(progs.cache["len"][0]) == len(prompt) + 47


def test_sampled_stream_equals_the_eager_loop(weights):
    """Token choice stays outside the programs: a seeded sampled stream is
    the eager loop's, draw for draw."""
    _, params = weights
    prompt = _prompt(6, 3)

    def run(**kw):
        g = torch.Generator().manual_seed(11)
        return list(tfm.generate(params, _TINY, prompt, 24, temperature=0.8,
                                 generator=g, **kw))

    assert run() == run(eager=True)


def test_prefill_programs_are_a_bounded_lru(weights):
    """One prefill program per exact prompt length, at most
    PREFILL_GRAPHS, the least recently used out (JAX's lru_cache(8))."""
    _, params = weights
    pool = programs.SerialPool(_TINY)
    lengths = list(range(2, 2 + programs.PREFILL_GRAPHS + 3))
    with pool.acquire(params, 1) as progs:
        for n in lengths:
            logits = progs.prefill(params, torch.from_numpy(_prompt(n, n))[None])
            want, _ = tfm.prefill(params, torch.from_numpy(_prompt(n, n))[None],
                                  _TINY, tfm.init_cache(_TINY, 1, "cpu"))
            torch.testing.assert_close(logits, want, atol=0, rtol=0)
        progs.prefill(params, torch.from_numpy(_prompt(lengths[-3], 0))[None])
        assert list(progs.prefill_lengths) == (lengths[3:-3] + lengths[-2:]
                                               + [lengths[-3]])


def test_concurrent_runner_streams_each_equal_the_serial_stream(weights):
    """Two _LmRunner.stream calls at once each get a program set of their
    own (JAX's jitted steps are reentrant) and each equals the stream run
    alone."""
    runner = language._LmRunner(cfg=_TINY, params=_fresh(weights),
                                device="cpu")
    prompts = [_prompt(5, 21), _prompt(9, 22)]
    alone = [list(runner.stream(p, 40)) for p in prompts]
    both = threading.Barrier(2)
    got, errors = [None, None], []

    def stream(i):
        try:
            out = []
            for tok in runner.stream(prompts[i], 40):
                if not out:
                    both.wait(timeout=30)  # both streams hold a set now
                out.append(tok)
            got[i] = out
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
            both.abort()

    threads = [threading.Thread(target=stream, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and got == alone
    assert len(_pool(runner).idle_sets()) == 2


def test_swapped_weights_get_new_programs(weights):
    """The pool keys its sets on the params' leaves: other weights drop
    every set, and their stream is their own."""
    runner = language._LmRunner(cfg=_TINY, params=_fresh(weights),
                                device="cpu")
    prompt = _prompt(5, 30)
    first = list(runner.stream(prompt, 16))
    pool = _pool(runner)
    assert len(pool.idle_sets()) == 1
    other = jtfm.init_params(jax.random.PRNGKey(8), _JTINY)
    runner.params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, other), "cpu")
    got = list(runner.stream(prompt, 16))
    want = list(jtfm.generate(other, _JTINY, prompt, 16))
    if language._EOS in want:  # the runner ends its stream there
        want = want[:want.index(language._EOS) + 1]
    assert got == want
    assert got != first and len(_pool(runner).idle_sets()) == 1
    assert _pool(runner) is not pool  # another head, another pool
    # a leaf swapped under the same head: the same pool drops its sets
    pool = _pool(runner)
    old_set = pool.idle_sets()[0]
    attn = runner.params["layers"][0]["attn"]
    attn["wq"] = attn["wq"] * 0.5
    got = list(runner.stream(prompt, 16))
    assert got == list(tfm.generate(runner.params, _TINY, prompt, 16,
                                    eager=True))[:len(got)]
    assert _pool(runner) is pool and pool.idle_sets()[0] is not old_set


def test_default_pool_follows_the_params(weights):
    """generate without a pool takes the one serial_pool keeps for the
    params' LM head: the same pool for the same tree, another for its
    int8 copy (same embedding), none kept once the head is gone."""
    _, params = weights
    pool = programs.serial_pool(params, _TINY)
    assert programs.serial_pool(params, _TINY) is pool
    q = tfm.quantize_params(params)
    assert programs.serial_pool(q, _TINY) is not pool
    key = id(next(programs._leaves(q["lm_head"])))
    assert key in programs._POOLS
    del q
    assert key not in programs._POOLS
