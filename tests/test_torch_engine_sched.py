"""client_tpu_torch's continuous-batching engine: the scheduler tests of
tests/test_lm.py and tests/test_continuous.py that tests/test_torch_engine.py
does not mirror, the engine's prefill program against the JAX package's,
and the device programs' static-input plumbing and replay accounting.

Each engine test names the JAX test it mirrors and holds the port's engine
to the same assertion, on the JAX test's config and the JAX init's weights
(carried across with client_tpu_torch.convert), float32 on the CPU, where
every program runs eagerly through the buffers a CUDA graph replays from
on the card.  Greedy streams are held against the port's serial
``generate`` (readback depth 0), exactly: tests/test_torch_engine.py holds
that one against the JAX engine.
"""

import dataclasses
import functools
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from client_tpu.serve.lm import engine as jengine
from client_tpu.serve.models import transformer as jtfm
from client_tpu_torch import convert, ops
from client_tpu_torch.serve.lm import LmEngine
from client_tpu_torch.serve.lm import engine as lm_engine
from client_tpu_torch.serve.lm.policy import verify_widths
from client_tpu_torch.serve.lm.spec import Drafter
from client_tpu_torch.serve.metrics import Registry
from client_tpu_torch.serve.models import transformer as tfm
from client_tpu_torch.serve.models.continuous import ContinuousLmScheduler

CLOSE = LmEngine.CLOSE

# tests/test_lm.py's config, and tests/test_continuous.py's (max_seq 48)
_JCFG = jtfm.TransformerConfig(
    vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq=96, dtype="float32",
)
CFG = tfm.TransformerConfig(**dataclasses.asdict(_JCFG))
CFG48 = dataclasses.replace(CFG, max_seq=48)
SMALL = dict(block_size=8, prefill_chunk=16, min_bucket=4, device="cpu")
# the JAX engine's prefill program, as its engine jits it
_JAX_PREFILL = jax.jit(functools.partial(
    jengine._prefill_chunk, cfg=_JCFG, block_size=8))


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


def _serial(params, prompt, n, cfg=CFG):
    return list(tfm.generate(params, cfg, prompt, n, readback_depth=0))


def _collect(q, timeout=120):
    out = []
    while True:
        tok = q.get(timeout=timeout)
        if tok is CLOSE:
            return out
        out.append(tok)


def _engine(params, **kw):
    return LmEngine(params, CFG, **{**SMALL, **kw})


def _scheduler(params, **kw):
    """test_continuous.py's ContinuousLmScheduler(params, CFG, ...): the
    engine at its defaults on the max_seq-48 config."""
    return ContinuousLmScheduler(params, CFG48, device="cpu", **kw)


class _GatedPrefill:
    """Holds the engine's prefill dispatch (``_prefill``) open, as
    test_continuous.py's does."""

    def __init__(self, real):
        self.real = real
        self.entered = threading.Event()
        self.release = threading.Event()

    def __call__(self, *args, **kwargs):
        self.entered.set()
        assert self.release.wait(timeout=60)
        return self.real(*args, **kwargs)


# -- the programs' static shapes ---------------------------------------------

def test_spec_verify_executable_bound(params):
    """Mirrors test_lm.py::test_spec_verify_executable_bound: the verify
    programs (one graph each on the card) stay within len(verify_widths)
    x len(lane_counts), and so do decode and prefill within theirs."""
    eng = _engine(params, max_slots=2, lane_counts=(2,),
                  speculative={"k": 4})
    try:
        for p in ([5, 6] * 6, [8, 8, 8, 8, 8], [2, 4, 6, 8, 2, 4, 6, 8]):
            _collect(eng.submit(p, 24)[0])
        bound = len(verify_widths(4)) * len(eng.lane_counts)
        assert 1 <= eng.verify_executables() <= bound
        assert 1 <= eng.decode_executables() <= len(eng.lane_counts)
        assert 1 <= eng.prefill_executables() <= len(eng.buckets)
        assert eng.graph_stats() == {}  # the CPU captures nothing
    finally:
        eng.close()
    assert eng.kv.used_blocks == 0


class _TickRecorder:
    """The engine's tracer hook (``tick_span(kind, t0, t1)``); the port has
    no Tracer yet, so this records the kinds the JAX test reads from
    ``Tracer.tick_completed``."""

    def __init__(self):
        self.kinds = set()

    def tick_span(self, kind, t0, t1):
        assert t1 >= t0
        self.kinds.add(kind)


def test_spec_tick_kinds_metrics_and_gauge(params):
    """Mirrors test_lm.py::test_spec_tick_kinds_metrics_and_gauge."""
    reg = Registry()
    tracer = _TickRecorder()
    eng = _engine(params, max_slots=2, lane_counts=(2,),
                  speculative={"k": 4}, registry=reg, tracer=tracer)
    try:
        _collect(eng.submit([5, 6] * 6, 24)[0])
        assert {"verify", "draft", "prefill_chunk"} <= tracer.kinds
        proposed = reg.get("ctpu_lm_spec_proposed_tokens_total")
        accepted = reg.get("ctpu_lm_spec_accepted_tokens_total") or 0
        rejected = reg.get("ctpu_lm_spec_rejected_tokens_total") or 0
        assert proposed and proposed == accepted + rejected
        rate = reg.get("ctpu_lm_spec_acceptance_rate")
        assert rate is not None and 0.0 <= rate <= 1.0
        # delivered token accounting includes spec-delivered tokens
        assert reg.get("ctpu_lm_tokens_total") == 24
    finally:
        eng.close()


def test_spec_adversarial_drafter_backs_off_and_never_slower(params):
    """Mirrors test_lm.py::test_spec_adversarial_drafter_backs_off_and_never_slower:
    a drafter that always proposes the wrong token; the stream stays
    byte-exact, the lane disables after one fully rejected window, and
    the run keeps >= 0.95x plain decode's throughput (with the JAX
    test's 0.25 s allowance)."""
    prompt = [1, 2, 3, 4]
    n_tok = 80
    serial = _serial(params, prompt, n_tok)
    full = prompt + serial

    class Adversary(Drafter):
        name = "adversary"

        def propose(self, state, history, k):
            nxt = full[len(history)] if len(history) < len(full) else 0
            return [(nxt + 1) % CFG.vocab_size] * k

    def timed(speculative):
        eng = _engine(params, max_slots=1, lane_counts=(1,),
                      speculative=speculative)
        try:
            _collect(eng.submit(prompt, n_tok)[0])  # warm
            t0 = time.perf_counter()
            got = _collect(eng.submit(prompt, n_tok)[0])
            elapsed = time.perf_counter() - t0
            stats = eng.spec_stats()
        finally:
            eng.close()
        assert got == serial  # byte-exact under total rejection
        return elapsed, stats

    plain_s, _ = timed(None)
    spec_s, stats = timed({"k": 4, "drafter": Adversary()})
    assert stats["proposed"] > 0 and stats["accepted"] == 0
    assert stats["proposed"] <= 2 * 8 * 4
    assert spec_s <= plain_s / 0.95 + 0.25, (spec_s, plain_s)


# -- admission, priorities, tenants -------------------------------------------

def test_no_preemption_between_equal_priorities(params):
    """Mirrors test_lm.py::test_no_preemption_between_equal_priorities."""
    eng = _engine(params, max_slots=2, lane_counts=(2,), pool_tokens=80,
                  tenant_priority={})
    try:
        qa, _ = eng.submit([1, 2, 3], 60, tenant="x")
        assert qa.get(timeout=120) is not CLOSE
        qb, _ = eng.submit([9, 4], 40, tenant="y")
        assert _collect(qb) == _serial(params, [9, 4], 40)
        _collect(qa)
        assert eng.preempt_stats()["preemptions"] == 0
    finally:
        eng.close()
    assert eng.kv.used_blocks == 0


def test_high_priority_preempts_past_backpressured_low_head(params):
    """Mirrors test_lm.py::test_high_priority_preempts_past_backpressured_low_head."""
    eng = _engine(params, max_slots=3, lane_counts=(3,), pool_tokens=80,
                  tenant_priority={"hi": 10.0})
    pa = [1, 2, 3]
    try:
        q_a, _ = eng.submit(pa, 90, tenant="lo")
        assert q_a.get(timeout=120) is not CLOSE
        q_b, _ = eng.submit([5, 6], 40, tenant="lo2")  # stuck rr head
        q_c, _ = eng.submit([9, 4], 40, tenant="hi")
        assert _collect(q_c) == _serial(params, [9, 4], 40)
        assert eng.preempt_stats()["preemptions"] >= 1
        assert _collect(q_b) == _serial(params, [5, 6], 40)
        got_a = [_serial(params, pa, 90)[0]] + _collect(q_a)
        assert got_a == _serial(params, pa, 90)
    finally:
        eng.close()
    assert eng.kv.used_blocks == 0, eng.kv.ref_counts()


def test_pending_map_evicts_drained_tenants(params):
    """Mirrors test_lm.py::test_pending_map_evicts_drained_tenants."""
    eng = _engine(params, max_slots=2, lane_counts=(2,))
    try:
        qs = [eng.submit([i + 1, 2], 3, tenant=f"t{i}")[0]
              for i in range(6)]
        for q in qs:
            _collect(q)
        busy1, _ = eng.submit([5, 6], 30, tenant="busy")
        busy2, _ = eng.submit([6, 7], 30, tenant="busy")
        assert busy1.get(timeout=60) is not CLOSE
        assert busy2.get(timeout=60) is not CLOSE
        q7, h7 = eng.submit([1, 2], 3, tenant="t-cancel")
        eng.cancel(h7)
        assert _collect(q7) == []
        _collect(busy1)
        _collect(busy2)
        with eng._cv:
            assert not eng._pending, dict(eng._pending)
    finally:
        eng.close()


# -- tests/test_continuous.py: slots, cancels, close --------------------------

def test_slot_reuse_more_requests_than_lanes(params):
    """Mirrors test_continuous.py::test_slot_reuse_more_requests_than_lanes."""
    sched = _scheduler(params, max_slots=2)
    try:
        prompts = [[i + 1, i + 2] for i in range(5)]
        queues = [sched.submit(p, 5)[0] for p in prompts]
        for p, q in zip(prompts, queues):
            assert _collect(q) == _serial(params, p, 5, CFG48)
    finally:
        sched.close()


def test_cancel_frees_lane(params):
    """Mirrors test_continuous.py::test_cancel_frees_lane."""
    sched = _scheduler(params, max_slots=1)
    try:
        q1, h1 = sched.submit([1, 2, 3], 30)
        assert q1.get(timeout=60) is not CLOSE
        sched.cancel(h1)
        q2, _ = sched.submit([4, 5], 4)
        assert _collect(q2) == _serial(params, [4, 5], 4, CFG48)
    finally:
        sched.close()


def test_cancel_with_pending_queue(params):
    """Mirrors test_continuous.py::test_cancel_with_pending_queue."""
    sched = _scheduler(params, max_slots=1)
    try:
        q1, h1 = sched.submit([1, 2, 3], 20)
        q2, h2 = sched.submit([1, 2, 3], 6)  # same-shape prompt, queued
        q3, h3 = sched.submit([9], 6)        # different-shape prompt, queued
        assert q1.get(timeout=60) is not CLOSE
        sched.cancel(h1)   # active lane, pending entries present
        sched.cancel(h3)   # pending entry, removed by identity
        assert _collect(q2) == _serial(params, [1, 2, 3], 6, CFG48)
    finally:
        sched.close()


def test_cancel_active_slot_closes_queue(params):
    """Mirrors test_continuous.py::test_cancel_active_slot_closes_queue."""
    sched = _scheduler(params, max_slots=1)
    try:
        q, h = sched.submit([1, 2, 3], 30)
        assert q.get(timeout=60) is not CLOSE
        sched.cancel(h)
        while q.get(timeout=10) is not CLOSE:
            pass  # the stream must terminate
        sched.cancel(h)  # idempotent: double-cancel of a released lane
    finally:
        sched.close()


def test_submit_not_blocked_by_slow_prefill(params):
    """Mirrors test_continuous.py::test_submit_not_blocked_by_slow_prefill:
    the prefill dispatch (``_prefill``) runs outside ``_cv``."""
    sched = _scheduler(params, max_slots=2)
    gate = _GatedPrefill(sched._prefill)
    sched._prefill = gate
    try:
        q1, _ = sched.submit([1, 2, 3], 4)
        assert gate.entered.wait(timeout=60)
        t0 = time.monotonic()
        q2, h2 = sched.submit([4, 5], 3)
        sched.cancel(None)
        submit_latency = time.monotonic() - t0
        gate.release.set()
        assert submit_latency < 1.0, submit_latency
        assert _collect(q1) == _serial(params, [1, 2, 3], 4, CFG48)
        assert _collect(q2) == _serial(params, [4, 5], 3, CFG48)
    finally:
        gate.release.set()
        sched.close()


def test_cancel_twice_during_prefill_is_idempotent(params):
    """Mirrors test_continuous.py::test_cancel_twice_during_prefill_is_idempotent."""
    sched = _scheduler(params, max_slots=1)
    gate = _GatedPrefill(sched._prefill)
    sched._prefill = gate
    try:
        q1, h1 = sched.submit([1, 2, 3], 8)
        assert gate.entered.wait(timeout=60)
        sched.cancel(h1)  # entry popped, not yet placed: marks it
        sched.cancel(h1)  # the second sees the marker: a no-op
        gate.release.set()
        assert _collect(q1) == []
        sched.cancel(h1)
        q2, _ = sched.submit([4, 5], 3)
        assert _collect(q2) == _serial(params, [4, 5], 3, CFG48)
    finally:
        gate.release.set()
        sched.close()


def test_submit_after_close_returns_closed_stream(params):
    """Mirrors test_continuous.py::test_submit_after_close_returns_closed_stream."""
    sched = _scheduler(params, max_slots=1)
    sched.close()
    q, handle = sched.submit([1, 2, 3], 4)
    assert handle is None
    assert q.get(timeout=10) is CLOSE
    sched.cancel(handle)  # cancel of a rejected submit: no-op


# -- the prefill program against the JAX package's ---------------------------

@pytest.mark.parametrize("start,prompt_len,width", [
    (0, 40, 16),    # a full first chunk
    (16, 40, 16),   # a middle chunk
    (32, 40, 16),   # the last chunk, ending inside the bucket padding
    (8, 3, 16),     # prompt_len below start + 1: no row is written
    (40, 43, 4),    # a narrow last chunk, its last block half written
])
def test_prefill_chunk_matches_jax(weights, start, prompt_len, width):
    """The port's _prefill_chunk, with start and prompt_len as 0-d int32
    tensors and the last row picked on the device, against JAX's
    _prefill_chunk on the same chunk, table and pools: the greedy token
    equal and every pool within 1e-5 (float32)."""
    jparams, params = weights
    bs, n_blocks = 8, 16  # _JAX_PREFILL's block size
    rng = np.random.default_rng(start * 100 + prompt_len)
    shape = (n_blocks + 1, bs, CFG.n_kv_heads, CFG.head_dim)
    pk = [rng.standard_normal(shape).astype(np.float32)
          for _ in range(CFG.n_layers)]
    pv = [rng.standard_normal(shape).astype(np.float32)
          for _ in range(CFG.n_layers)]
    table = np.zeros((CFG.max_seq // bs,), np.int32)
    table[:7] = rng.permutation(np.arange(1, n_blocks + 1))[:7]
    chunk = rng.integers(0, CFG.vocab_size, (1, width)).astype(np.int32)

    tok_j, jk, jv, _ = _JAX_PREFILL(
        jparams, jnp.asarray(chunk), [jnp.asarray(p) for p in pk],
        [jnp.asarray(p) for p in pv], jnp.asarray(table), jnp.int32(start),
        jnp.int32(prompt_len), jax.random.PRNGKey(0), jnp.float32(0.0),
        jnp.int32(0),
    )
    pools = {"k": [torch.from_numpy(p.copy()) for p in pk],
             "v": [torch.from_numpy(p.copy()) for p in pv]}
    tok, carry = lm_engine._prefill_chunk(
        params, torch.from_numpy(chunk), pools, torch.from_numpy(table),
        torch.tensor(start, dtype=torch.int32),
        torch.tensor(prompt_len, dtype=torch.int32),
        torch.tensor([7, 3], dtype=torch.int64),
        torch.zeros((1,), dtype=torch.float32),
        torch.zeros((1,), dtype=torch.int32), cfg=CFG, block_size=bs,
    )
    assert int(tok[0]) == int(tok_j)
    assert carry.tolist() == [7, 4]
    for kind, want in (("k", jk), ("v", jv)):
        for got, ref in zip(pools[kind], want):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-5)


# -- the programs' plumbing ---------------------------------------------------

def test_program_feeds_pack_into_one_buffer():
    """A _Program's host-fed inputs are views of one buffer: a feed lands
    in each view with its shape and dtype (0-d int32 start, int64 key, f32
    temperature), and on the CPU the program runs its body eagerly."""
    seen = []
    prog = lm_engine._Program(
        lambda feeds, state: seen.append(
            {k: v.clone() for k, v in feeds.items()}),
        lm_engine._prefill_feeds(4, 6), {}, torch.device("cpu"),
    )
    values = {"chunk": [[1, 2, 3, 4]], "table": [5, 6, 0, 0, 0, 0],
              "start": 12, "prompt_len": 14, "key": (2 ** 32 - 1, 9),
              "temperature": 0.5, "top_k": 3}
    prog(values)
    got = seen[0]
    assert got["chunk"].dtype == torch.int32 and got["chunk"].shape == (1, 4)
    assert got["start"].shape == () and int(got["start"]) == 12
    assert int(got["prompt_len"]) == 14
    assert got["key"].dtype == torch.int64
    assert got["key"].tolist() == [2 ** 32 - 1, 9]
    assert got["temperature"].tolist() == [0.5]
    assert got["top_k"].tolist() == [3] and got["table"].tolist()[:2] == [5, 6]
    bufs = {v.untyped_storage().data_ptr() for v in prog.feeds.values()}
    assert len(bufs) == 1  # one buffer, so one copy a tick on the card
    assert prog.graph is None


def test_capture_pauses_garbage_collection(monkeypatch):
    """ops.capture_graph pauses automatic garbage collection from
    capture_begin to capture_end (a collection there could destroy a dead
    CUDA graph on the capturing thread, which invalidates the capture),
    not in the warm-up, and restores the collector after, also when the
    body raises; a collector paused before stays paused.  The CUDA
    stream, stream context and graph are stand-ins."""
    import contextlib
    import gc

    seen = []

    class Stream:
        device = "cuda:0"
        cuda_stream = 0x5EED

        def wait_stream(self, other):
            pass

    class Graph:
        def capture_begin(self, pool, capture_error_mode):
            seen.append(("begin", gc.isenabled()))

        def capture_end(self):
            seen.append(("end", gc.isenabled()))

    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    assert gc.isenabled()
    ops.capture_graph(lambda: seen.append(("body", gc.isenabled())),
                      lambda: seen.append(("warm_up", gc.isenabled())),
                      None, Stream())
    assert seen == [("warm_up", True), ("begin", False), ("body", False),
                    ("end", False)]
    assert gc.isenabled()

    def refused():
        raise ValueError("refused inside the capture")

    with pytest.raises(ValueError, match="refused"):
        ops.capture_graph(refused, None, None, Stream())
    assert gc.isenabled()
    gc.disable()
    try:
        ops.capture_graph(lambda: None, None, None, Stream())
        assert not gc.isenabled()
    finally:
        gc.enable()


def test_replay_accounting():
    """ops.recording() diverts this thread's launch counts into a record
    (a capture); ops.count_replay adds the record once a replay, launches
    and routes alike; another thread counts as usual meanwhile."""
    before = dict(ops.LAUNCHES)
    routes = {k: dict(v) for k, v in ops.ROUTES.items()}
    with ops.recording() as rec:
        for _ in range(6):
            ops.count_launch("int8_matmul", "mma")
        ops.count_launch("paged_attention", "split")
        other = threading.Thread(
            target=ops.count_launch, args=("flash_fwd",))
        other.start()
        other.join(timeout=10)
        with pytest.raises(RuntimeError, match="nest"):
            with ops.recording():
                pass
    assert rec == {("int8_matmul", "mma"): 6,
                   ("paged_attention", "split"): 1}
    assert ops.LAUNCHES["int8_matmul"] == before["int8_matmul"]
    assert ops.LAUNCHES["flash_fwd"] == before["flash_fwd"] + 1
    for _ in range(3):
        ops.count_replay(rec)
    assert ops.LAUNCHES["int8_matmul"] == before["int8_matmul"] + 18
    assert ops.LAUNCHES["paged_attention"] == before["paged_attention"] + 3
    assert (ops.ROUTES["int8_matmul"]["mma"]
            == routes["int8_matmul"]["mma"] + 18)
    assert (ops.ROUTES["paged_attention"]["split"]
            == routes["paged_attention"]["split"] + 3)
    ops.count_launch("paged_attention", "mma")  # counted again
    assert (ops.ROUTES["paged_attention"]["mma"]
            == routes["paged_attention"]["mma"] + 1)


def test_concurrent_first_submits_start_the_engine_once(params):
    """The port's first submit builds the programs outside ``_cv``
    (``_ensure_started``): many submits at once start one scheduler
    thread over one build, no reader of the engine waits through that
    build, and every stream equals the serial generate.  No reference
    counterpart (the JAX engine builds under ``_cv``)."""
    eng = _engine(params)
    builds, started = [], threading.Event()
    build = eng._build_programs

    def slow_build():
        builds.append(threading.current_thread().name)
        started.set()
        time.sleep(0.3)  # widen the window other submits arrive in
        build()

    eng._build_programs = slow_build
    prompts = [[3, 1, 4, 1, 5][:i + 1] for i in range(5)] * 2
    got = [None] * len(prompts)
    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [
            threading.Thread(target=lambda i=i, p=p: got.__setitem__(
                i, _collect(eng.submit(p, 6)[0])))
            for i, p in enumerate(prompts)]
        for th in threads:
            th.start()
        assert started.wait(timeout=60)
        t0 = time.monotonic()
        assert eng.prefill_executables() == 0  # not built yet, no wait
        assert time.monotonic() - t0 < 0.2
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(was)
        eng.close()
    assert len(builds) == 1
    assert got == [_serial(params, p, 6) for p in prompts]
    assert eng.kv.used_blocks == 0


def test_submits_waiting_for_the_start_keep_their_arrival_order(params):
    """Submits that arrive while the first one starts the engine are
    served in arrival order, as the JAX engine serves them (it enqueues
    each submit under ``_cv`` as it comes): with one lane the streams
    finish in the order they were submitted.  The port's waiting submits
    wake in any order, so they enqueue by their arrival, not their
    wake-up."""
    eng = _engine(params, max_slots=1, lane_counts=(1,))
    release = threading.Event()
    build = eng._build_programs

    def held_build():
        assert release.wait(timeout=60)
        build()

    eng._build_programs = held_build
    order, lock = [], threading.Lock()

    def run(i):
        _collect(eng.submit([5, i + 1], 4)[0])
        with lock:
            order.append(i)

    threads = []
    try:
        for i in range(6):
            threads.append(threading.Thread(target=run, args=(i,)))
            threads[-1].start()
            time.sleep(0.05)  # each submit waits before the next arrives
        release.set()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        eng.close()
    assert order == list(range(6))


# -- windowed streams (the served runner's flow control) ----------------------

def _until(cond, timeout=60):
    t_end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < t_end, "timed out"
        time.sleep(0.005)


def _sitting_out(eng, handle):
    """True once *handle*'s lane holds tokens and nothing is in flight:
    the engine has stopped decoding it."""
    slot, gen = handle.placed
    lane = eng._lanes[slot]
    return lane.gen == gen and bool(lane.held) and not eng._inflight


@pytest.mark.parametrize("temperature,speculative", [
    (0.0, None), (0.8, None), (0.0, {"k": 4})],
    ids=["greedy", "sampled", "speculative"])
def test_windowed_stream_sits_out_and_streams_the_same_tokens(
        params, temperature, speculative):
    """A stream submitted with ``window=2`` that nobody reads stops at 2
    tokens in its queue and at most the window plus the readback depth
    decoded, while a second lane decodes on beside it (each tick of that
    lane overwrites the first lane's token and RNG slot, so its parked
    values must come back); read on, it gives exactly the tokens of the
    same request unwindowed.  No reference counterpart (the JAX engine
    streams every token at once)."""
    prompt, other, n = [3, 1, 4, 1, 5], [2, 7, 1, 8], 40
    kw = dict(temperature=temperature, seed=11)
    reg = Registry()
    eng = _engine(params, max_slots=2, lane_counts=(2,),
                  speculative=speculative, registry=reg)
    try:
        want = _collect(eng.submit(prompt, n, **kw)[0])
        base = reg.get("ctpu_lm_tokens_total")
        q, h = eng.submit(prompt, n, window=2, **kw)
        _until(lambda: h.placed is not None and _sitting_out(eng, h))
        slot = h.placed[0]
        assert q.qsize() == 2
        # the window, the token that found it full, the readbacks in
        # flight then, and a verify tick's drafts beyond its one token
        extra = speculative["k"] if speculative else 0
        assert eng._lanes[slot].produced <= 2 + 1 + eng.depth + extra
        assert reg.get("ctpu_lm_tokens_total") - base == 2
        # the other lane ticks on while the first sits out
        assert _collect(eng.submit(other, n, **kw)[0]) == _collect(
            eng.submit(other, n, **kw)[0])
        got = _collect(q)
        assert got == want
        if temperature == 0.0:
            assert got == _serial(params, prompt, n)
        assert reg.get("ctpu_lm_tokens_total") - base == 3 * n
    finally:
        eng.close()
    assert eng.kv.used_blocks == 0


def test_cancelled_windowed_stream_drops_what_it_held(params):
    """Cancelling a stream that sits out: what its lane held is dropped
    (never counted as streamed), its queue closes, its KV blocks come
    back and the lane serves the next stream exactly.  No reference
    counterpart."""
    reg = Registry()
    eng = _engine(params, max_slots=1, lane_counts=(1,), registry=reg)
    try:
        q, h = eng.submit([1, 2, 3], 60, window=2)
        _until(lambda: h.placed is not None and _sitting_out(eng, h))
        held = len(eng._lanes[h.placed[0]].held)
        assert held >= 1
        eng.cancel(h)
        assert [q.get(timeout=10) for _ in range(3)][-1] is CLOSE
        assert reg.get("ctpu_lm_tokens_total") == 2
        assert eng.kv.used_blocks == 0  # a prompt under one block
        assert _collect(eng.submit([4, 5], 6, window=2)[0]) == _serial(
            params, [4, 5], 6)
    finally:
        eng.close()
    assert eng.kv.used_blocks == 0
