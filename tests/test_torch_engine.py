"""client_tpu_torch's continuous-batching LM engine held against
client_tpu's.

Mirrors of tests/test_lm.py and tests/test_continuous.py at their tiny
float32 config; each test names the JAX test it mirrors.  The JAX params
(tfm.init_params from one PRNG key) are carried across with
client_tpu_torch.convert.params_from_numpy, and every greedy stream the
port's LmEngine delivers must equal, token for token, both

- the JAX LmEngine's stream for the same prompt on the same weights (run
  once, for every prompt the tests use, in the module fixture
  ``jax_streams``), and
- the port's serial ``generate`` (readback depth 0).

Float32 throughout, so the comparison is exact (no tolerance).  Seeded
temperature streams cannot match JAX's threefry stream; they are held for
repeatability within the port and for seeds that differ giving streams
that differ.  Everything runs on the CPU: every paged attention takes the
kernel's plain version.
"""

import dataclasses
import queue
import threading
import time
from collections import deque

import numpy as np
import pytest
import torch

import jax

from client_tpu.serve.lm import LmEngine as JaxLmEngine
from client_tpu.serve.models import transformer as jtfm
from client_tpu_torch import convert, ops
from client_tpu_torch.serve.lm import KvBlockPool, LmEngine, PrefixCache
from client_tpu_torch.serve.lm import engine as lm_engine
from client_tpu_torch.serve.lm.policy import (
    LaneAutoscaler,
    bucket_for,
    chunk_plan,
    geometric_buckets,
    pad_prompt,
    verify_widths,
)
from client_tpu_torch.serve.metrics import Registry
from client_tpu_torch.serve.models import transformer as tfm

CLOSE = LmEngine.CLOSE

_JCFG = jtfm.TransformerConfig(
    vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq=96, dtype="float32",
)
CFG = tfm.TransformerConfig(**dataclasses.asdict(_JCFG))

# the small-engine settings of tests/test_lm.py
SMALL = dict(block_size=8, prefill_chunk=16, min_bucket=4, device="cpu")

_SHARED24 = list(range(1, 25))  # 3 full blocks of 8
_SHARED40 = list(range(1, 41))  # 3 prefill chunks of 16
# every (prompt, tokens) pair a test compares against the JAX engine; a
# shorter request for the same prompt is a prefix of the longest stream
_REFERENCE = (
    [([1, 2, 3], 60), ([7, 9], 9), (_SHARED40, 5), ([11, 3, 2, 8], 7),
     (list(range(1, 49)), 4), ([9, 4], 40), ([5, 6], 40), ([4, 5], 3),
     ([3, 1], 5), ([5], 4), (list(range(1, 33)), 8), ([90] * 40, 40),
     ([7, 9, 11] * 5, 40), ([1, 2] * 7, 40), ([3, 1, 4, 1, 5, 9, 2, 6], 40),
     ([1, 2, 3, 4], 80), ([3, 4], 20), ([1, 2], 20)]
    + [(_SHARED24 + [30 + i], 5) for i in range(3)]
    + [(_SHARED40 + [60 + i], 4) for i in range(6)]
    + [([i + 1, i + 2], 25) for i in range(5)]
)


@pytest.fixture(scope="module")
def weights():
    """(JAX params, the port's params on the CPU) from one JAX init."""
    jparams = jtfm.init_params(jax.random.PRNGKey(0), _JCFG)
    port = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jparams, port


@pytest.fixture(scope="module")
def params(weights):
    return weights[1]


def _collect(q, timeout=120):
    out = []
    while True:
        tok = q.get(timeout=timeout)
        if tok is CLOSE or tok is JaxLmEngine.CLOSE:
            return out
        out.append(tok)


@pytest.fixture(scope="module")
def jax_streams(weights):
    """The JAX LmEngine's greedy stream for every reference prompt, from
    one engine with every prompt in flight."""
    longest = {}
    for prompt, n in _REFERENCE:
        key = tuple(prompt)
        longest[key] = max(longest.get(key, 0), n)
    eng = JaxLmEngine(weights[0], _JCFG, max_slots=4, lane_counts=(4,),
                      block_size=8, prefill_chunk=16, min_bucket=4)
    try:
        qs = {key: eng.submit(list(key), n)[0] for key, n in longest.items()}
        return {key: _collect(q) for key, q in qs.items()}
    finally:
        eng.close()


def _serial(params, prompt, n):
    """The port's serial greedy generate (readback depth 0)."""
    return list(tfm.generate(params, CFG, prompt, n, readback_depth=0))


@pytest.fixture
def check(params, jax_streams):
    """check(prompt, n, got): the port engine's stream equals the JAX
    engine's and the port's serial generate, token for token."""

    def hold(prompt, n, got):
        want = jax_streams[tuple(prompt)][:n]
        assert len(want) == n, "prompt missing from _REFERENCE"
        assert got == want, (prompt, n, got, want)
        assert got == _serial(params, prompt, n), (prompt, n)

    return hold


def _engine(params, **kw):
    return LmEngine(params, CFG, **{**SMALL, **kw})


# -- policy units (mirror tests/test_lm.py's) -------------------------------

def test_geometric_buckets_and_lookup():
    """Mirrors test_lm.py::test_geometric_buckets_and_lookup."""
    assert geometric_buckets(16, 64) == (16, 32, 64)
    assert geometric_buckets(16, 48) == (16, 32, 48)
    assert geometric_buckets(64, 64) == (64,)
    assert bucket_for(1, (16, 32)) == 16
    assert bucket_for(17, (16, 32)) == 32
    assert bucket_for(999, (16, 32)) == 32


def test_chunk_plan_widths_are_bucket_members():
    """Mirrors test_lm.py::test_chunk_plan_widths_are_bucket_members."""
    buckets = geometric_buckets(4, 16)
    for n in range(1, 60):
        plan = chunk_plan(n, buckets)
        assert all(width in buckets for _, width in plan), (n, plan)
        assert sum(width for _, width in plan) >= n
        assert [s for s, _ in plan] == [
            i * buckets[-1] for i in range(len(plan))
        ] or len(plan) == 1


def test_pad_prompt_rejects_overflow():
    """Mirrors test_lm.py::test_pad_prompt_rejects_overflow."""
    with pytest.raises(ValueError):
        pad_prompt(np.zeros((1, 8), np.int32), 4)
    assert pad_prompt([[1, 2]], 4).tolist() == [[1, 2, 0, 0]]


def test_lane_autoscaler_hysteresis():
    """Mirrors test_lm.py::test_lane_autoscaler_hysteresis."""
    sc = LaneAutoscaler((2, 4, 8), up_after=2, down_after=3)
    assert sc.n_lanes == 2
    assert not sc.note_starved()
    assert sc.note_starved()
    assert sc.n_lanes == 4
    for _ in range(2):
        assert not sc.note_ok(False, 0)
    assert sc.note_ok(False, 0)
    assert sc.n_lanes == 2


# -- the paged KV pool ------------------------------------------------------

def test_kv_pool_alloc_release_and_gauges():
    """Mirrors test_lm.py::test_kv_pool_alloc_release_and_gauges, plus the
    port's pool layout: per-layer [n_blocks+1, bs, n_kv, hd] tensors in
    cfg.tdtype with block 0 as trash."""
    reg = Registry()
    pool = KvBlockPool(CFG, n_blocks=8, block_size=16, registry=reg,
                       device="cpu")
    assert len(pool.pools["k"]) == len(pool.pools["v"]) == CFG.n_layers
    for p in pool.pools["k"] + pool.pools["v"]:
        assert p.shape == (9, 16, CFG.n_kv_heads, CFG.head_dim)
        assert p.dtype == CFG.tdtype and p.device.type == "cpu"
    assert pool.blocks_for(1) == 1 and pool.blocks_for(17) == 2
    a = pool.alloc(3)
    assert len(a) == 3 and KvBlockPool.TRASH not in a
    assert pool.used_blocks == 3 and pool.free_blocks == 5
    assert reg.get("ctpu_lm_kv_blocks_used") == 3
    assert reg.get("ctpu_lm_kv_blocks_free") == 5
    assert pool.alloc(6) is None
    pool.release(a)
    assert pool.free_blocks == 8
    assert reg.get("ctpu_lm_kv_blocks_used") == 0


def test_kv_pool_refcounts_share_and_release():
    """Mirrors test_lm.py::test_kv_pool_refcounts_share_and_release."""
    pool = KvBlockPool(CFG, n_blocks=8, block_size=16, device="cpu")
    blocks = pool.alloc(2)
    pool.retain(blocks)
    assert [pool.ref_count(b) for b in blocks] == [2, 2]
    pool.release(blocks)
    assert pool.free_blocks == 6
    pool.release(blocks)
    assert pool.free_blocks == 8 and pool.ref_counts() == {}


def test_prefix_cache_match_adopt_give_back_evict():
    """Mirrors test_lm.py::test_prefix_cache_match_adopt_give_back_evict."""
    pool = KvBlockPool(CFG, n_blocks=8, block_size=4, device="cpu")
    cache = PrefixCache(pool)
    prompt = np.arange(1, 13, dtype=np.int32)
    blocks = pool.alloc(3)
    cache.give_back(prompt, 3, blocks)
    assert cache.cached_blocks == 3 and pool.used_blocks == 3
    matched, nodes = cache.match(prompt, 3)
    assert matched == blocks
    cache.adopt(nodes)
    assert [pool.ref_count(b) for b in blocks] == [2, 2, 2]
    assert cache.evict(3) == 0
    pool.release(matched)
    other = prompt.copy()
    other[4:] = 99
    assert cache.match(other, 3)[0] == blocks[:1]
    assert cache.evict(2) == 2
    assert cache.cached_blocks == 1 and pool.used_blocks == 1
    cache.clear()
    assert pool.used_blocks == 0


def test_prefix_cache_min_blocks_hint():
    """Mirrors test_lm.py::test_prefix_cache_min_blocks_hint."""
    pool = KvBlockPool(CFG, n_blocks=8, block_size=4, device="cpu")
    cache = PrefixCache(pool, min_prefix_blocks=2)
    prompt = np.arange(1, 9, dtype=np.int32)
    cache.give_back(prompt, 1, pool.alloc(2))
    assert cache.match(prompt, 2) == ([], [])
    cache.clear()


# -- speculative decoding units ---------------------------------------------

def test_spec_policy_and_drafter_units():
    """Mirrors test_lm.py::test_spec_policy_and_drafter_units."""
    from client_tpu_torch.serve.lm.spec import (
        BigramDrafter,
        Drafter,
        NgramDrafter,
        SpecConfig,
    )

    assert verify_widths(4) == (2, 4, 5)
    assert verify_widths(1) == (2,)
    with pytest.raises(ValueError):
        verify_widths(0)
    assert SpecConfig.parse(None) is None
    assert SpecConfig.parse(True).k == 4
    cfg = SpecConfig.parse({"k": 3, "drafter": "bigram", "window": 4})
    assert cfg.k == 3 and cfg.drafter.name == "bigram" and cfg.window == 4
    assert SpecConfig.parse({"k": 1, "drafter": Drafter()}).drafter.propose(
        None, [1, 2], 1) == []
    with pytest.raises(ValueError):
        SpecConfig.parse({"k": 2, "bogus": 1})
    ng = NgramDrafter(n=3)
    assert ng.propose(None, [1, 2, 3, 9, 1, 2, 3, 7, 8, 1, 2, 3], 2) == [7, 8]
    assert ng.propose(None, [5, 6], 4) == []
    bg = BigramDrafter()
    state = bg.begin([1, 2, 1, 2, 1, 3])
    assert bg.propose(state, [9, 1], 3) == [2, 1, 2]


def test_spec_lane_backoff_reprobe_and_growth_units():
    """Mirrors test_lm.py::test_spec_lane_backoff_reprobe_and_growth_units."""
    from client_tpu_torch.serve.lm.spec import LaneSpec, SpecConfig

    lane = LaneSpec(SpecConfig.parse({"k": 4, "window": 2,
                                      "retry_after": 5}), [1, 2, 3])
    lane.note(4, 0)
    lane.note(4, 0)
    assert lane.k == 0
    for _ in range(5):
        lane.note_plain()
    assert lane.k == 1
    lane.note(1, 1)
    lane.note(1, 1)
    assert lane.k == 2


# -- per-lane random numbers --------------------------------------------------

def test_lane_uniforms_depend_only_on_seed_and_counter():
    """A lane's draws are a function of its (seed, counter): the slot and
    the lanes batched beside it do not change them; each draw lies in
    (0, 1) and another counter gives other numbers."""
    index = torch.arange(200)
    rows = torch.tensor([[5, 0], [7, 3], [5, 1], [2**32 - 1, 9]])
    alone = torch.cat([lm_engine._uniforms(rows[i:i + 1], index)
                       for i in range(4)])
    batched = lm_engine._uniforms(rows, index)
    flipped = lm_engine._uniforms(rows.flip(0), index).flip(0)
    assert torch.equal(alone, batched) and torch.equal(alone, flipped)
    assert bool((batched > 0).all() and (batched < 1).all())
    assert not torch.equal(batched[0], batched[2])
    assert abs(float(batched.mean()) - 0.5) < 0.05
    assert lm_engine._seed32(-1) == lm_engine._seed32(2**64 - 1)


def test_select_token_greedy_is_first_argmax_and_top1_is_greedy():
    """_select_token: temperature 0 is torch.argmax (the first maximal
    index, as jnp.argmax), and top_k = 1 at any temperature is greedy."""
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [2.0, -1.0, 2.0, 2.0]])
    rng = torch.tensor([[1, 0], [2, 0]])
    zero = torch.zeros(2)
    got = lm_engine._select_token(logits, rng, zero, torch.zeros(2,
                                  dtype=torch.int32))
    assert got.tolist() == [1, 0]
    hot = lm_engine._select_token(logits + torch.tensor([0, 0, 1e-3, 0]),
                                  rng, torch.full((2,), 5.0),
                                  torch.ones(2, dtype=torch.int32))
    assert hot.tolist() == [2, 2]


# -- the engine: streams through the paged/chunked path ----------------------

def test_streams_match_jax_and_serial_including_multi_chunk_prefill(params,
                                                                    check):
    """Mirrors test_lm.py::test_streams_match_serial_including_multi_chunk_prefill."""
    eng = _engine(params, max_slots=4, lane_counts=(4,))
    try:
        prompts = [[1, 2, 3], [7, 9], _SHARED40, [11, 3, 2, 8]]
        lengths = [6, 9, 5, 7]
        qs = [eng.submit(p, n)[0] for p, n in zip(prompts, lengths)]
        for p, n, q in zip(prompts, lengths, qs):
            check(p, n, _collect(q))
    finally:
        eng.close()
    assert eng.kv.used_blocks == 0


def test_bounded_shapes_over_distinct_lengths(params):
    """Mirrors test_lm.py::test_bounded_prefill_compile_over_distinct_lengths:
    17 distinct prompt lengths dispatch at most len(buckets) prefill
    widths and one decode lane count."""
    eng = _engine(params, max_slots=2, lane_counts=(2,))
    try:
        for n in list(range(1, 15)) + [20, 27, 40]:
            _collect(eng.submit(list(range(1, n + 1)), 2)[0])
        assert 1 <= eng.prefill_executables() <= len(eng.buckets)
        assert eng.decode_executables() <= len(eng.lane_counts)
    finally:
        eng.close()


def test_chunked_prefill_interleaves_with_decode(params, check):
    """Mirrors test_lm.py::test_chunked_prefill_interleaves_with_decode
    (the structural half: >= 1 decode tick between consecutive chunks)."""
    eng = _engine(params, max_slots=4, lane_counts=(4,))
    try:
        s1, _ = eng.submit([1, 2, 3], 60)
        s2, _ = eng.submit([9, 4], 40)
        first = [s1.get(timeout=60), s2.get(timeout=60)]
        t_submit = time.monotonic()
        long_q, _ = eng.submit(list(range(1, 49)), 4)
        check(list(range(1, 49)), 4, _collect(long_q))
        check([1, 2, 3], 60, [first[0]] + _collect(s1))
        check([9, 4], 40, [first[1]] + _collect(s2))
        trace = eng.tick_trace()
        chunks = [r for r in trace
                  if r["kind"] == "prefill_chunk" and r["t0"] >= t_submit]
        assert len(chunks) == 3, chunks
        decodes = [r for r in trace if r["kind"] == "decode"]
        for a, b in zip(chunks, chunks[1:]):
            assert [r for r in decodes if a["t1"] <= r["t0"] <= b["t0"]]
    finally:
        eng.close()


def test_lane_autoscaling_up_on_queue_depth_then_down(params, check):
    """Mirrors test_lm.py::test_lane_autoscaling_up_on_queue_depth_then_down."""
    eng = _engine(params, max_slots=4, lane_counts=(1, 2, 4),
                  scale_up_after=2, scale_down_after=3)
    try:
        qs = [eng.submit([i + 1, i + 2], 25)[0] for i in range(4)]
        for i, q in enumerate(qs):
            check([i + 1, i + 2], 25, _collect(q))
        assert max(r["n_lanes"] for r in eng.tick_trace()) == 4
        assert eng.decode_executables() <= len(eng.lane_counts)
        deadline = time.monotonic() + 10
        while eng._scaler.n_lanes != 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert eng._scaler.n_lanes == 1
    finally:
        eng.close()


def test_kv_pool_exhaustion_backpressures_admission(params, check):
    """Mirrors test_lm.py::test_kv_pool_exhaustion_backpressures_admission."""
    reg = Registry()
    eng = _engine(params, max_slots=2, lane_counts=(2,), block_size=16,
                  pool_tokens=96, registry=reg)
    try:
        q1, _ = eng.submit([1, 2, 3, 4], 60)
        first = q1.get(timeout=60)
        assert reg.get("ctpu_lm_kv_blocks_used") == 4
        q2, _ = eng.submit([5, 6], 40)
        check([5, 6], 40, _collect(q2))
        check([1, 2, 3, 4], 60, [first] + _collect(q1))
        assert reg.get("ctpu_lm_kv_blocks_used") == 0
    finally:
        eng.close()


def test_tenant_lane_quota_admission_policy(params):
    """Mirrors test_lm.py::test_tenant_lane_quota_admission_policy."""
    eng = _engine(params, max_slots=4, lane_counts=(4,),
                  tenant_lane_share=0.5)

    def handle(tenant):
        return lm_engine._Handle(np.zeros((1, 2), np.int32), 4,
                                 queue.Queue(), tenant, 0.0, 0, 0)

    ha, hb = handle("a"), handle("b")
    with eng._cv:
        for i in range(2):
            eng._lanes[i].active = True
            eng._lanes[i].tenant = "a"
        eng._pending["a"] = deque([ha])
        eng._pending["b"] = deque([hb])
        assert eng._tenant_quota_locked("a", 4, others_pending=True) == 2
        assert eng._tenant_quota_locked("a", 4, others_pending=False) == 4
        assert eng._pick_pending_locked(4) is hb
        assert eng._pick_pending_locked(4) is ha
        for i in range(2):
            eng._lanes[i].active = False


def test_pick_order_prefers_priority_class_over_rr_head(params):
    """Mirrors test_lm.py::test_pick_order_prefers_priority_class_over_rr_head."""
    eng = _engine(params, max_slots=4, lane_counts=(4,),
                  tenant_priority={"hi": 10.0})

    def handle(tenant):
        return lm_engine._Handle(np.zeros((1, 2), np.int32), 4,
                                 queue.Queue(), tenant, 0.0, 0, 0)

    h_lo, h_hi = handle("lo"), handle("hi")
    with eng._cv:
        eng._pending["lo"] = deque([h_lo])
        eng._pending["hi"] = deque([h_hi])
        eng._rr = 0
        assert eng._pick_pending_locked(4) is h_hi
        assert eng._pick_pending_locked(4) is h_lo


def test_uncontended_tenant_uses_all_lanes(params, check):
    """Mirrors test_lm.py::test_uncontended_tenant_uses_all_lanes."""
    eng = _engine(params, max_slots=2, lane_counts=(2,),
                  tenant_lane_share=0.5)
    try:
        q1, _ = eng.submit([1, 2], 20, tenant="a")
        q2, _ = eng.submit([3, 4], 20, tenant="a")
        check([1, 2], 20, _collect(q1))
        check([3, 4], 20, _collect(q2))
        assert any(len(r["lanes"]) == 2 for r in eng.tick_trace()
                   if r["kind"] == "decode")
    finally:
        eng.close()


# -- per-lane sampling ---------------------------------------------------------

def test_sampling_seed_deterministic_and_varied(params, check):
    """Mirrors test_lm.py::test_sampling_seed_deterministic_and_varied,
    within the port: the same seed repeats its stream, another seed
    gives another stream, and greedy stays exact beside them."""
    eng = _engine(params, max_slots=2, lane_counts=(2,))
    try:
        kw = dict(temperature=0.8, top_k=8)
        s1 = _collect(eng.submit([1, 2, 3], 10, seed=42, **kw)[0])
        s2 = _collect(eng.submit([1, 2, 3], 10, seed=42, **kw)[0])
        s3 = _collect(eng.submit([1, 2, 3], 10, seed=7, **kw)[0])
        check([1, 2, 3], 10, _collect(eng.submit([1, 2, 3], 10)[0]))
        assert s1 == s2
        assert s1 != s3
    finally:
        eng.close()


def test_seeded_stream_independent_of_slot_and_neighbours(params):
    """A temperature lane's stream depends only on its seed and its own
    step count: alone on a 1-lane engine, or beside other streams on a
    4-lane one (another slot, other neighbours), it is the same."""
    kw = dict(temperature=0.9, top_k=0, seed=123)
    eng = _engine(params, max_slots=1, lane_counts=(1,))
    try:
        alone = _collect(eng.submit([4, 5, 6], 12, **kw)[0])
    finally:
        eng.close()
    eng = _engine(params, max_slots=4, lane_counts=(4,))
    try:
        others = [eng.submit([9, i], 12, temperature=1.0, seed=i)[0]
                  for i in range(2)]
        q, _ = eng.submit([4, 5, 6], 12, **kw)
        got = _collect(q)
        for o in others:
            _collect(o)
    finally:
        eng.close()
    assert got == alone


def test_mixed_greedy_and_sampled_lanes_share_one_tick(params, check):
    """Mirrors test_lm.py::test_mixed_greedy_and_sampled_lanes_share_one_tick."""
    eng = _engine(params, max_slots=2, lane_counts=(2,))
    try:
        qg, _ = eng.submit([3, 1], 5)
        qs, _ = eng.submit([4, 5], 15, temperature=1.2, top_k=4, seed=9)
        check([3, 1], 5, _collect(qg))
        assert len(_collect(qs)) == 15
        assert eng.decode_executables() <= len(eng.lane_counts)
    finally:
        eng.close()


def test_top_k_above_static_cap_rejected(params):
    """Mirrors test_lm.py::test_top_k_above_static_cap_rejected: 400."""
    from client_tpu_torch.serve.models.continuous import BatchedLmRunner
    from client_tpu_torch.utils import InferenceServerException

    runner = BatchedLmRunner(params, CFG, max_slots=1, lane_counts=(1,),
                             **SMALL)
    try:
        with pytest.raises(InferenceServerException) as exc:
            next(runner.stream([1, 2], 4, temperature=1.0,
                               top_k=lm_engine._TOPK_CAP + 1))
        assert exc.value.status() == "400"
        assert len(list(runner.stream([1, 2], 4, temperature=1.0,
                                      top_k=lm_engine._TOPK_CAP))) == 4
    finally:
        runner.scheduler.close()


def test_top_k_restricts_support(params, check):
    """Mirrors test_lm.py::test_top_k_restricts_support: top_k = 1 is
    greedy at any temperature."""
    eng = _engine(params, max_slots=1, lane_counts=(1,))
    try:
        check([1, 2, 3], 12, _collect(
            eng.submit([1, 2, 3], 12, temperature=5.0, top_k=1, seed=3)[0]))
    finally:
        eng.close()


# -- prefix cache through the engine ----------------------------------------

def test_prefix_adoption_shares_blocks_and_skips_prefill(params, check):
    """Mirrors test_lm.py::test_prefix_adoption_shares_blocks_and_skips_prefill."""
    reg = Registry()
    eng = _engine(params, max_slots=2, lane_counts=(2,), registry=reg)
    prompts = [_SHARED24 + [30 + i] for i in range(3)]
    try:
        check(prompts[0], 5, _collect(eng.submit(prompts[0], 5)[0]))
        computed_cold = reg.get("ctpu_lm_prefill_tokens_total")
        for p in prompts[1:]:
            check(p, 5, _collect(eng.submit(p, 5)[0]))
        stats = eng.prefix_stats()
        assert stats["hits"] == 6 and stats["cached_blocks"] >= 3
        assert reg.get("ctpu_lm_prefill_tokens_total") - computed_cold == 2
        assert reg.get("ctpu_lm_prefill_tokens_saved_total") == 48
    finally:
        eng.close()
    assert eng.kv.used_blocks == 0, eng.kv.ref_counts()


def test_prefix_cache_disabled_knob(params, check):
    """Mirrors test_lm.py::test_prefix_cache_disabled_knob."""
    eng = _engine(params, max_slots=2, lane_counts=(2,), prefix_cache=False)
    try:
        check(_SHARED24 + [30], 4, _collect(eng.submit(_SHARED24 + [30], 4)[0]))
        assert eng.prefix is None and eng.prefix_stats() == {}
    finally:
        eng.close()
    assert eng.kv.used_blocks == 0


def test_prefix_eviction_under_pool_pressure(params, check):
    """Mirrors test_lm.py::test_prefix_eviction_under_pool_pressure."""
    reg = Registry()
    eng = _engine(params, max_slots=2, lane_counts=(2,), block_size=16,
                  pool_tokens=96, registry=reg)
    try:
        p1 = list(range(1, 33))
        check(p1, 8, _collect(eng.submit(p1, 8, seed=1)[0]))
        assert eng.prefix_stats()["cached_blocks"] == 2
        check([90] * 40, 40, _collect(eng.submit([90] * 40, 40)[0]))
        assert eng.prefix_stats()["evictions"] >= 1
        assert reg.get("ctpu_lm_prefix_evictions_total") >= 1
    finally:
        eng.close()
    assert eng.kv.used_blocks == 0, eng.kv.ref_counts()


def test_prefix_cancel_mid_prefill_keeps_refcounts_balanced(params, check):
    """Mirrors test_lm.py::test_prefix_cancel_mid_prefill_keeps_refcounts_balanced."""
    eng = _engine(params, max_slots=2, lane_counts=(2,))
    try:
        for i in range(6):
            prompt = _SHARED40 + [60 + i]
            q, handle = eng.submit(prompt, 4)
            if i % 2 == 0:
                eng.cancel(handle)
                got = _collect(q)
                assert got == _serial(params, prompt, 4)[:len(got)]
            else:
                check(prompt, 4, _collect(q))
        refs = eng.kv.ref_counts()
        assert all(v == 1 for v in refs.values()), refs
        assert len(refs) == eng.prefix_stats()["cached_blocks"]
    finally:
        eng.close()
    assert eng.kv.used_blocks == 0, eng.kv.ref_counts()


# -- preemption: swap and recompute --------------------------------------------

def _preempt_scenario(params, check, swap_block_limit):
    """Mirrors test_lm.py::_preempt_scenario: 'hi' cannot fit beside 'lo';
    'lo' is swapped out (or dropped for recompute), 'hi' runs, 'lo'
    resumes — both streams equal the JAX engine's and serial generate."""
    reg = Registry()
    eng = _engine(params, max_slots=2, lane_counts=(2,), pool_tokens=80,
                  registry=reg, tenant_priority={"hi": 10.0},
                  swap_block_limit=swap_block_limit)
    pa, pb = [1, 2, 3], [9, 4]
    try:
        qa, _ = eng.submit(pa, 60, tenant="lo")
        first = qa.get(timeout=120)
        assert first is not CLOSE
        qb, _ = eng.submit(pb, 40, tenant="hi")
        got = {}
        threads = [threading.Thread(
            target=lambda k=k, q=q: got.__setitem__(k, _collect(q)),
            daemon=True) for k, q in (("a", qa), ("b", qb))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive(), "stream wedged across preemption"
        check(pa, 60, [first] + got["a"])
        check(pb, 40, got["b"])
        ps = eng.preempt_stats()
        assert ps["preemptions"] >= 1 and ps["resumes"] == ps["preemptions"]
        assert ps["swapped_streams"] == 0
        assert reg.get("ctpu_lm_preemptions_total") == ps["preemptions"]
        assert (reg.get("ctpu_lm_swapped_blocks") or 0) == 0
    finally:
        eng.close()
    assert eng.kv.used_blocks == 0, eng.kv.ref_counts()


def test_preemption_swap_path_byte_exact(params, check):
    """Mirrors test_lm.py::test_preemption_swap_path_byte_exact."""
    _preempt_scenario(params, check, swap_block_limit=None)


def test_preemption_recompute_fallback_byte_exact(params, check):
    """Mirrors test_lm.py::test_preemption_recompute_fallback_byte_exact."""
    _preempt_scenario(params, check, swap_block_limit=0)


def test_cancel_while_swapped_closes_cleanly(params, check):
    """Mirrors test_lm.py::test_cancel_while_swapped_closes_cleanly."""
    eng = _engine(params, max_slots=2, lane_counts=(2,), pool_tokens=80,
                  tenant_priority={"hi": 10.0})
    try:
        qa, ha = eng.submit([1, 2, 3], 60, tenant="lo")
        assert qa.get(timeout=120) is not CLOSE
        qb, _ = eng.submit([9, 4], 40, tenant="hi")
        deadline = time.monotonic() + 60
        while (eng.preempt_stats()["swapped_streams"] == 0
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert eng.preempt_stats()["swapped_streams"] == 1
        eng.cancel(ha)
        _collect(qa)
        check([9, 4], 40, _collect(qb))
        ps = eng.preempt_stats()
        assert ps["swapped_streams"] == 0 and ps["resumes"] == 0
    finally:
        eng.close()
    assert eng.kv.used_blocks == 0, eng.kv.ref_counts()


def test_drain_with_parked_stream_never_leaks_swap_blocks(params):
    """Mirrors test_lm.py::test_retire_with_parked_stream_never_leaks_swap_blocks
    (no fleet tier attached: drain() closes and migrates 0)."""
    eng = _engine(params, max_slots=2, lane_counts=(2,), pool_tokens=80,
                  tenant_priority={"hi": 10.0})
    q_lo, _ = eng.submit([1, 2, 3], 60, tenant="lo")
    delivered = [q_lo.get(timeout=120)]
    q_hi, _ = eng.submit([9, 4], 40, tenant="hi")
    deadline = time.monotonic() + 60
    while (eng.preempt_stats()["swapped_streams"] == 0
           and time.monotonic() < deadline):
        time.sleep(0.005)
    assert eng.drain() == 0
    delivered += _collect(q_lo, timeout=60)
    _collect(q_hi, timeout=60)
    ps = eng.preempt_stats()
    assert ps["swapped_streams"] == 0 and ps["swapped_blocks"] == 0
    assert eng.kv.used_blocks == 0, eng.kv.ref_counts()
    assert delivered == _serial(params, [1, 2, 3], 60)[:len(delivered)]


@pytest.mark.parametrize("bind", ["constructor", "set_fleet"])
def test_fleet_tier_accepted_like_jax(weights, bind):
    """``LmEngine(fleet=)`` and ``set_fleet`` take a port FleetTier, as the
    JAX engine takes a JAX one (client_tpu/serve/lm/engine.py set_fleet,
    fleet_stats, _export_prefix): the same prompt on both engines streams
    the same tokens, exports the same chain (digests and block count) into
    its tier, and reports the same fleet counters (a lookup, nothing
    installed: the peerless tier misses); exact, float32."""
    from client_tpu.serve.fleet import FleetTier as JaxFleetTier
    from client_tpu_torch.serve.fleet import FleetTier

    prompt, n = list(range(1, 33)), 8
    results = []
    for engine_cls, p, cfg, tier_cls, extra in (
            (JaxLmEngine, weights[0], _JCFG, JaxFleetTier, {}),
            (LmEngine, weights[1], CFG, FleetTier, {"device": "cpu"})):
        tier = tier_cls(gossip_interval_s=0).start()
        kw = dict(max_slots=2, lane_counts=(2,), block_size=8,
                  prefill_chunk=16, min_bucket=4, **extra)
        if bind == "constructor":
            eng = engine_cls(p, cfg, fleet=tier, **kw)
        else:
            eng = engine_cls(p, cfg, **kw)
            eng.set_fleet(tier)
        try:
            got = _collect(eng.submit(prompt, n)[0])
            results.append((got, eng.fleet_stats(), tier.store.blocks,
                            tier.store.digests()))
        finally:
            eng.close()
            tier.close()
    assert results[0] == results[1]
    assert results[1][1] == {"remote_lookups": 1, "remote_blocks": 0}
    assert results[1][2] == 4


# -- speculative decoding through the engine ---------------------------------

def test_spec_greedy_byte_exact_across_bucket_boundaries(params, check):
    """Mirrors test_lm.py::test_spec_greedy_byte_exact_across_bucket_boundaries."""
    reg = Registry()
    eng = _engine(params, max_slots=2, lane_counts=(2,),
                  speculative={"k": 4}, registry=reg)
    prompts = [[7, 9, 11] * 5, [1, 2] * 7, [3, 1, 4, 1, 5, 9, 2, 6]]
    try:
        qs = [eng.submit(p, 40)[0] for p in prompts]
        for p, q in zip(prompts, qs):
            check(p, 40, _collect(q))
        stats = eng.spec_stats()
        assert stats["accepted"] > 0
        assert 0.0 <= stats["acceptance_rate"] <= 1.0
        assert 1 <= eng.verify_executables() <= (
            len(verify_widths(4)) * len(eng.lane_counts))
        proposed = reg.get("ctpu_lm_spec_proposed_tokens_total")
        assert proposed == stats["proposed"] == (
            (reg.get("ctpu_lm_spec_accepted_tokens_total") or 0)
            + (reg.get("ctpu_lm_spec_rejected_tokens_total") or 0))
        assert reg.get("ctpu_lm_tokens_total") == 120
    finally:
        eng.close()
    assert eng.kv.used_blocks == 0


def test_spec_temperature_lane_seed_deterministic(params, check):
    """Mirrors test_lm.py::test_spec_temperature_lane_seed_deterministic."""
    kw = dict(temperature=0.8, top_k=8)
    prompt = [1, 2] * 7
    eng = _engine(params, max_slots=2, lane_counts=(2,),
                  speculative={"k": 4})
    try:
        s1 = _collect(eng.submit(prompt, 20, seed=42, **kw)[0])
        s2 = _collect(eng.submit(prompt, 20, seed=42, **kw)[0])
        s3 = _collect(eng.submit(prompt, 20, seed=7, **kw)[0])
        check(prompt, 20, _collect(eng.submit(prompt, 20)[0]))
        assert s1 == s2 and s1 != s3
    finally:
        eng.close()


# -- the compat surface (mirror tests/test_continuous.py) --------------------

def test_concurrent_streams_match_serial(params, check):
    """Mirrors test_continuous.py::test_concurrent_streams_match_serial."""
    from client_tpu_torch.serve.models.continuous import (
        ContinuousLmScheduler,
    )

    sched = ContinuousLmScheduler(params, CFG, max_slots=4, device="cpu")
    try:
        prompts = [[1, 2, 3], [7, 9], [5], [11, 3, 2, 8]]
        lengths = [6, 9, 4, 7]
        qs = [sched.submit(p, n)[0] for p, n in zip(prompts, lengths)]
        for p, n, q in zip(prompts, lengths, qs):
            check(p, n, _collect(q))
    finally:
        sched.close()


def test_moe_streams_match_jax_engine_and_serial():
    """An MoE config (4 experts, top-2) through the engine: four
    concurrent greedy float32 streams equal the port's serial generate
    and the JAX LmEngine's streams on the same weights, token for token
    (every tick runs the dense MoE FFN without its aux loss)."""
    jcfg = dataclasses.replace(_JCFG, n_experts=4, top_k=2)
    cfg = tfm.TransformerConfig(**dataclasses.asdict(jcfg))
    jparams = jtfm.init_params(jax.random.PRNGKey(2), jcfg)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    prompts = [[1, 2, 3], [7, 9], list(range(1, 21)), [11, 3, 2, 8]]
    lengths = [12, 9, 6, 10]
    jeng = JaxLmEngine(jparams, jcfg, max_slots=4, lane_counts=(4,),
                       block_size=8, prefill_chunk=16, min_bucket=4)
    try:
        qs = [jeng.submit(p, n)[0] for p, n in zip(prompts, lengths)]
        want = [_collect(q) for q in qs]
    finally:
        jeng.close()
    eng = LmEngine(params, cfg, max_slots=4, lane_counts=(2, 4), **SMALL)
    try:
        qs = [eng.submit(p, n)[0] for p, n in zip(prompts, lengths)]
        got = [_collect(q) for q in qs]
    finally:
        eng.close()
    assert eng.kv.used_blocks == 0
    for p, n, g, w in zip(prompts, lengths, got, want):
        assert len(g) == n
        assert g == w, (p, g, w)
        assert g == list(tfm.generate(params, cfg, p, n, readback_depth=0))


class _GatedPrefill:
    """Holds the engine's prefill dispatch open (test_continuous.py's)."""

    def __init__(self, real):
        self.real = real
        self.entered = threading.Event()
        self.release = threading.Event()

    def __call__(self, *args, **kwargs):
        self.entered.set()
        assert self.release.wait(timeout=60)
        return self.real(*args, **kwargs)


def test_cancel_during_prefill_closes_stream(params, check):
    """Mirrors test_continuous.py::test_cancel_during_prefill_closes_stream."""
    eng = _engine(params, max_slots=1, lane_counts=(1,))
    gate = _GatedPrefill(eng._prefill)
    eng._prefill = gate
    try:
        q1, h1 = eng.submit([1, 2, 3], 8)
        assert gate.entered.wait(timeout=60)
        t0 = time.monotonic()
        q2, _ = eng.submit([4, 5], 3)  # the lock is free meanwhile
        assert time.monotonic() - t0 < 1.0
        eng.cancel(h1)
        eng.cancel(h1)  # idempotent
        gate.release.set()
        assert _collect(q1) == []
        check([4, 5], 3, _collect(q2))
    finally:
        gate.release.set()
        eng.close()
    assert eng.kv.used_blocks == 0


def test_failing_prefill_does_not_strand_reader(params):
    """Mirrors test_continuous.py::test_failing_prefill_does_not_strand_reader."""
    eng = _engine(params, max_slots=1, lane_counts=(1,))

    def exploding_prefill(*a, **kw):
        raise RuntimeError("prefill failed")

    eng._prefill = exploding_prefill
    try:
        assert _collect(eng.submit([1, 2, 3], 4)[0]) == []
    finally:
        eng.close()


def test_eos_stops_stream(params):
    """Mirrors test_continuous.py::test_eos_stops_stream."""
    serial = _serial(params, [1, 2, 3], 10)
    eos = serial[1]
    eng = _engine(params, max_slots=1, lane_counts=(1,), eos_id=eos)
    try:
        got = _collect(eng.submit([1, 2, 3], 10)[0])
        assert got == serial[: serial.index(eos) + 1]
    finally:
        eng.close()


def test_batched_runner_stream(params, check):
    """Mirrors test_continuous.py::test_batched_runner_stream."""
    from client_tpu_torch.serve.models.continuous import BatchedLmRunner

    runner = BatchedLmRunner(params, CFG, max_slots=2, **SMALL)
    try:
        check([3, 1], 5, list(runner.stream([3, 1], 5)))
        gen = runner.stream([2, 2], 20)
        next(gen)
        gen.close()  # abandoning a stream must not wedge the lane
        check([3, 1], 5, list(runner.stream([3, 1], 5)))
    finally:
        runner.scheduler.close()


def test_engine_metrics_and_tick_log(params):
    """Mirrors test_lm.py::test_engine_metrics_and_tick_spans (the
    registry half; the port has no tracer yet)."""
    reg = Registry()
    eng = _engine(params, max_slots=2, lane_counts=(2,), registry=reg)
    try:
        _collect(eng.submit([1, 2, 3], 6)[0])
        assert reg.get("ctpu_lm_tokens_total") == 6
        assert reg.get("ctpu_lm_prefill_chunks_total") >= 1
        assert reg.get("ctpu_lm_lanes") == 2
        kinds = {r["kind"] for r in eng.tick_trace()}
        assert {"decode", "prefill_chunk"} <= kinds
        roll = eng.prof.rollup(window_s=0)
        assert roll["ticks"] >= 1 and "decode" in roll["kinds"]
    finally:
        eng.close()


def test_close_releases_everything(params):
    """Mirrors test_lm.py::test_close_releases_everything."""
    eng = _engine(params, max_slots=2, lane_counts=(2,))
    q1, _ = eng.submit([1, 2], 50)
    assert q1.get(timeout=60) is not CLOSE
    q2, _ = eng.submit([3, 4], 50)
    q3, _ = eng.submit([5, 6], 50)
    eng.close()
    for q in (q1, q2, q3):
        _collect(q, timeout=10)
    assert eng.kv.used_blocks == 0 and eng.kv.ref_counts() == {}
    assert not eng._thread.is_alive()
    q4, h4 = eng.submit([1], 4)
    assert h4 is None and q4.get(timeout=10) is CLOSE


def test_cpu_engine_launches_no_kernel(params):
    """On the CPU every paged attention and int8 projection takes its
    plain version: no kernel launch is counted."""
    before = dict(ops.LAUNCHES)
    eng = _engine(params, max_slots=2, lane_counts=(2,))
    try:
        _collect(eng.submit([1, 2, 3], 4)[0])
    finally:
        eng.close()
    assert ops.LAUNCHES == before


# -- served: lm_streaming_batched over the port's HTTP server -----------------

_SERVE_JCFG = jtfm.TransformerConfig(
    vocab_size=258, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq=64, dtype="float32",
)


def test_served_batched_model_streams_the_jax_tokens():
    """lm_streaming_batched behind the port's Server: a MAX_TOKENS=1 HTTP
    request and an engine.execute stream of 8 tokens give the JAX serial
    runner's tokens on the same weights, and Server.stop closes the
    engine (its scheduler thread ends)."""
    import json
    import urllib.request

    from client_tpu.serve.models import language as jlanguage
    from client_tpu_torch.serve import Server
    from client_tpu_torch.serve.models import language

    jparams = jtfm.init_params(jax.random.PRNGKey(0), _SERVE_JCFG)
    prompt = jlanguage.encode_text("hello, engine")
    want = list(jlanguage._LmRunner(cfg=_SERVE_JCFG, params=jparams)
                .stream(prompt, 8))
    runner = language._LmRunner(
        cfg=tfm.TransformerConfig(**dataclasses.asdict(_SERVE_JCFG)),
        params=convert.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), "cpu"),
        device="cpu")
    model = language.lm_streaming_batched_model(runner=runner, max_slots=2,
                                                lane_counts=(2,))
    body = {"inputs": [
        {"name": "TOKENS", "shape": [len(prompt)], "datatype": "INT32",
         "data": prompt.tolist()},
        {"name": "MAX_TOKENS", "shape": [1], "datatype": "INT32",
         "data": [1]}]}
    with Server(models=[model], http_port=0,
                with_default_models=False) as server:
        req = urllib.request.Request(
            f"http://{server.http_address}/v2/models/lm_streaming_batched/"
            "infer", data=json.dumps(body).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            first = json.loads(resp.read())["outputs"][0]["data"][0]
        body["inputs"][1]["data"] = [8]
        streamed = [r[0]["outputs"][0]["data"][0] for r in
                    server.engine.execute("lm_streaming_batched", "", body,
                                          b"")]
        assert server.engine.metrics.get("ctpu_lm_tokens_total") == 9
        sched = model.closer.__self__
    assert first == want[0] and streamed == want
    assert sched._closed and not sched._thread.is_alive()


# -- soak (slow tier, as the reference's) ------------------------------------

@pytest.mark.slow
def test_soak_128_streams_submit_cancel_churn(params):
    """Mirrors test_lm.py::test_soak_128_streams_submit_cancel_churn."""
    n_streams, max_tokens = 128, 6
    eng = _engine(params, max_slots=8, lane_counts=(2, 4, 8),
                  scale_up_after=2, registry=Registry())
    shared = [((j * 11) % 120) + 1 for j in range(40)]
    prompts = [
        (shared + [((i * 13) % 120) + 1, ((i * 5) % 120) + 1]
         if i % 3 == 0
         else [((i * 7 + j) % 120) + 1 for j in range((2, 3, 5)[i % 3])])
        for i in range(n_streams)
    ]
    results = [None] * n_streams

    def run(i):
        q, handle = eng.submit(prompts[i], max_tokens)
        if i % 6 == 3:
            eng.cancel(handle)
        toks = []
        while True:
            tok = q.get(timeout=300)
            if tok is CLOSE:
                break
            toks.append(tok)
            if i % 9 == 0 and len(toks) == 2:
                eng.cancel(handle)
        results[i] = toks

    try:
        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(n_streams)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
            assert not t.is_alive()
        for i, toks in enumerate(results):
            want = _serial(params, prompts[i], max_tokens)
            if i % 9 == 0 or i % 6 == 3:
                assert toks == want[:len(toks)]
            else:
                assert toks == want
        assert eng.prefill_executables() <= len(eng.buckets)
        assert eng.decode_executables() <= len(eng.lane_counts)
        refs = eng.kv.ref_counts()
        assert all(v == 1 for v in refs.values())
    finally:
        eng.close()
    assert eng.kv.ref_counts() == {} and eng.kv.used_blocks == 0
