"""client_tpu_torch's fleet tier (serve/fleet.py, the engine's and the
runtime's fleet halves, serve/autoscale.py) held against client_tpu's.

Mirrors of tests/test_fleet.py (its 15 non-chaos tests and the
three-replica chaos acceptance), tests/test_lm.py's parked-stream
migration, and the durable-sequence tests of tests/test_chaos.py, each
naming the JAX test it mirrors, on the port's tiers, engines and
servers.  Then the two packages against each other: a port tier and a
JAX tier exchange prefix blocks and sequence snapshots bit for bit, a
port engine that installs a JAX-exported prefix streams JAX serial
``generate``'s tokens (and the reverse), and the two autoscalers take
the same decisions on the same signals.

Float32 weights from one JAX init, carried across with
client_tpu_torch.convert.params_from_numpy: every greedy stream compared
here is exact (no tolerance).  Everything runs on the CPU.
"""

import dataclasses
import socket
import threading
import time
import types

import numpy as np
import pytest
import torch

import jax

from client_tpu.balance.policy import PrefixAware, make_policy
from client_tpu.balance.pool import Endpoint, EndpointPool
from client_tpu.serve import autoscale as jax_autoscale
from client_tpu.serve import fleet as jax_fleet
from client_tpu.serve import model_runtime as jax_runtime
from client_tpu.serve.lm import LmEngine as JaxLmEngine
from client_tpu.serve.models import transformer as jtfm
from client_tpu.testing.chaos import StepLedger
from client_tpu.utils import SERVER_READY
from test_chaos import _out_value, _seq_request
from client_tpu_torch import convert
from client_tpu_torch.serve import InferenceEngine, Model, Server, TensorSpec
from client_tpu_torch.serve import autoscale
from client_tpu_torch.serve import model_runtime as runtime
from client_tpu_torch.serve.fleet import FleetTier, chain_digests, fetch_summary
from client_tpu_torch.serve.frontdoor import ResponseCache, TenantQoS
from client_tpu_torch.serve.lm import LmEngine
from client_tpu_torch.serve.metrics import Registry
from client_tpu_torch.serve.models import transformer as tfm
from client_tpu_torch.utils import InferenceServerException

CLOSE = LmEngine.CLOSE

# tests/test_fleet.py's config
_JCFG = jtfm.TransformerConfig(
    vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq=96, dtype="float32",
)
CFG = tfm.TransformerConfig(**dataclasses.asdict(_JCFG))


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


def _serial(params, prompt, n):
    return list(tfm.generate(params, CFG, prompt, n, readback_depth=0))


def _collect(q, timeout=120):
    out = []
    while True:
        tok = q.get(timeout=timeout)
        if tok is CLOSE or tok is JaxLmEngine.CLOSE:
            return out
        out.append(tok)


def _tier(**kwargs):
    kwargs.setdefault("gossip_interval_s", 0)  # tests gossip explicitly
    return FleetTier(**kwargs).start()


def _jax_tier(**kwargs):
    kwargs.setdefault("gossip_interval_s", 0)
    return jax_fleet.FleetTier(**kwargs).start()


def _peer_up(tiers):
    for tier in tiers:
        tier.set_peers([t.address for t in tiers if t is not tier])


def _engine(params, fleet=None, registry=None, **kwargs):
    kwargs.setdefault("max_slots", 2)
    kwargs.setdefault("lane_counts", (2,))
    kwargs.setdefault("block_size", 8)
    kwargs.setdefault("prefill_chunk", 16)
    kwargs.setdefault("min_bucket", 4)
    return LmEngine(params, CFG, registry=registry or Registry(),
                    fleet=fleet, device="cpu", **kwargs)


def _blocks(n, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.rand((n, 8, 2, 4), generator=gen).to(dtype)
            for _ in range(CFG.n_layers)]


# -- units: digests, store, transport --------------------------------------

def test_chain_digests_cumulative_and_block_aligned():
    """Mirrors test_fleet.py::test_chain_digests_cumulative_and_block_aligned;
    every digest equals client_tpu.serve.fleet.chain_digests' (exact)."""
    row = list(range(40))
    digs = chain_digests(row, 8)
    assert digs == jax_fleet.chain_digests(row, 8)
    assert len(digs) == 5  # full blocks only
    assert chain_digests(row, 8, max_blocks=2) == digs[:2]
    other = [99] + row[1:]
    assert chain_digests(other, 8)[0] != digs[0]
    assert chain_digests(other, 8)[4] != digs[4]
    assert chain_digests(row[:16] + [7] * 24, 8)[:2] == digs[:2]
    assert len(chain_digests(row[:7], 8)) == 0
    # a tensor row digests as its list does
    assert chain_digests(torch.arange(40), 8) == digs


def test_prefix_store_roundtrip_and_lru_bound():
    """Mirrors test_fleet.py::test_prefix_store_roundtrip_and_lru_bound
    (the store holds CPU tensors; exact)."""
    tier = FleetTier(max_store_blocks=4, gossip_interval_s=0)
    row = np.arange(32)
    host_k, host_v = _blocks(4, seed=1), _blocks(4, seed=2)
    tier.export_prefix(row, 4, 8, host_k, host_v)
    got = tier.store.lookup(row, 8, 4)
    assert got is not None and got[0] == 4
    assert torch.equal(got[1][0], host_k[0])
    assert torch.equal(got[2][1], host_v[1])
    assert tier.store.lookup(np.arange(16), 8, 2)[0] == 2
    assert tier.store.lookup(np.concatenate([np.arange(8), [99] * 8]),
                             8, 2)[0] == 1
    tier.export_prefix(np.arange(100, 132), 4, 8, host_k, host_v)
    assert tier.store.blocks == 4
    assert tier.store.lookup(np.arange(100, 132), 8, 4)[0] == 4


def test_peer_prefix_and_summary_roundtrip():
    """Mirrors test_fleet.py::test_peer_prefix_and_summary_roundtrip."""
    a, b = _tier(), _tier()
    try:
        _peer_up([a, b])
        row = np.arange(24)
        host_k, host_v = _blocks(3, seed=3), _blocks(3, seed=4)
        b.export_prefix(row, 3, 8, host_k, host_v)
        got = a.prefix_lookup(row, 8, 3)
        assert got is not None and got[0] == 3
        assert torch.equal(got[1][0], host_k[0])
        assert a.stats()["peer_hits"] == 1
        deadline = time.monotonic() + 5
        while b.stats()["served"] < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert b.stats()["served"] >= 1
        summary = fetch_summary(b.address)
        assert summary["prefix_digests"] == chain_digests(row, 8, 3)
        assert a.prefix_lookup(np.arange(50, 74), 8, 3) is None
        assert a.stats()["peer_misses"] == 1
    finally:
        a.close()
        b.close()


def test_prefix_lookup_start_offset_transfers_only_the_tail():
    """Mirrors test_fleet.py::test_prefix_lookup_start_offset_transfers_only_the_tail."""
    a, b = _tier(), _tier()
    try:
        _peer_up([a, b])
        row = np.arange(32)
        host_k, host_v = _blocks(4, seed=5), _blocks(4, seed=6)
        b.export_prefix(row, 4, 8, host_k, host_v)
        got = a.prefix_lookup(row, 8, 4, start_blocks=1)
        assert got is not None
        covered, k_layers, _v_layers, start = got
        assert (covered, start) == (4, 1)
        assert k_layers[0].shape[0] == 3  # blocks [1, 4): the tail only
        assert torch.equal(k_layers[0], host_k[0][1:])
        assert a.prefix_lookup(row, 8, 4, start_blocks=4) is None
    finally:
        a.close()
        b.close()


def test_partial_local_match_fetches_and_installs_the_remote_tail(params):
    """Mirrors test_fleet.py::test_partial_local_match_fetches_and_installs_the_remote_tail
    on port engines (streams equal the port's serial generate, exact)."""
    tier_a, tier_b = _tier(), _tier()
    eng_a = eng_b = None
    try:
        _peer_up([tier_a, tier_b])
        eng_a = _engine(params, fleet=tier_a)
        eng_b = _engine(params, fleet=tier_b)
        long_prompt = list(range(1, 30))
        short_prompt = long_prompt[:9]
        assert _collect(eng_a.submit(long_prompt, 6)[0]) == \
            _serial(params, long_prompt, 6)
        assert tier_a.stats()["store_blocks"] >= 3
        _collect(eng_b.submit(short_prompt, 2)[0])
        assert eng_b.prefix_stats()["cached_blocks"] >= 1
        before = eng_b.fleet_stats()["remote_blocks"]
        got = _collect(eng_b.submit(long_prompt, 6)[0])
        assert got == _serial(params, long_prompt, 6)
        assert eng_b.fleet_stats()["remote_blocks"] - before == 2
        assert eng_b.prefix_stats()["hits"] >= 1
    finally:
        for engine in (eng_a, eng_b):
            if engine is not None:
                engine.close()
        tier_a.close()
        tier_b.close()
    assert eng_b.kv.used_blocks == 0, eng_b.kv.ref_counts()


# -- the degraded-tier guarantee -------------------------------------------

def test_degraded_tier_is_never_slower_than_no_tier(params):
    """Mirrors test_fleet.py::test_degraded_tier_is_never_slower_than_no_tier,
    with its bounds: 0.05 s for a breaker-open lookup, 1.0 s for one
    blackhole timeout, 2.5x + 0.5 s end to end."""
    row = np.arange(33)

    tier = FleetTier(peers=["127.0.0.1:9", "127.0.0.1:11"], fan_out=2,
                     lookup_timeout_s=0.2, failure_threshold=2,
                     gossip_interval_s=0)
    try:
        for _ in range(4):
            tier.prefix_lookup(row, 8, 4)
        t0 = time.monotonic()
        assert tier.prefix_lookup(row, 8, 4) is None
        assert time.monotonic() - t0 < 0.05
        stats = tier.stats()
        assert stats["peer_errors"] >= 2 and stats["peer_skips"] >= 2
    finally:
        tier.close()

    blackhole = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    blackhole.bind(("127.0.0.1", 0))
    blackhole.listen(8)
    addr = "%s:%d" % blackhole.getsockname()[:2]
    tier = FleetTier(peers=[addr], lookup_timeout_s=0.15,
                     failure_threshold=1, gossip_interval_s=0)
    try:
        t0 = time.monotonic()
        assert tier.prefix_lookup(row, 8, 4) is None
        assert time.monotonic() - t0 < 1.0
        t0 = time.monotonic()
        assert tier.prefix_lookup(row, 8, 4) is None
        assert time.monotonic() - t0 < 0.05
    finally:
        tier.close()
        blackhole.close()

    def run(fleet):
        eng = _engine(params, fleet=fleet)
        lat = []
        try:
            _collect(eng.submit([5, 6, 7], 2)[0])
            t_start = time.monotonic()
            for i in range(6):
                prompt = [i + 1] * 17
                t0 = time.monotonic()
                _collect(eng.submit(prompt, 4)[0])
                lat.append(time.monotonic() - t0)
            total = time.monotonic() - t_start
        finally:
            eng.close()
        return total, max(lat)

    base_total, base_p99 = run(None)
    dead_tier = FleetTier(peers=["127.0.0.1:9"], lookup_timeout_s=0.1,
                          failure_threshold=1, gossip_interval_s=0,
                          hot_hits=1).start()
    try:
        assert dead_tier._repl_thread is not None
        degraded_total, degraded_p99 = run(dead_tier)
        assert dead_tier.stats()["peer_skips"] >= 1
    finally:
        dead_tier.close()
    assert degraded_total < base_total * 2.5 + 0.5, (
        degraded_total, base_total
    )
    assert degraded_p99 < base_p99 * 2.5 + 0.5, (degraded_p99, base_p99)


# -- prefix-aware routing on the port's summaries ----------------------------

def test_prefix_aware_policy_picks_longest_cached_prefix():
    """Mirrors test_fleet.py::test_prefix_aware_policy_picks_longest_cached_prefix:
    the JAX balance layer's policy routes on the summaries port tiers
    serve (fetch_summary), longest cached prefix first."""
    tiers = [_tier() for _ in range(3)]
    try:
        row = np.arange(32)
        for tier, n in zip(tiers, (1, 3, 0)):
            if n:
                tier.export_prefix(row, n, 8, _blocks(n), _blocks(n))
        a, b, c = (Endpoint(t.address) for t in tiers)
        for endpoint, tier in zip((a, b, c), tiers):
            endpoint.summary = frozenset(
                fetch_summary(tier.address)["prefix_digests"])
        policy = PrefixAware(fallback="least-inflight")
        ctx = {"prefix_digests": chain_digests(row, 8)}
        assert policy.pick([a, b, c], ctx) is b
        a.summary = b.summary
        a.inflight, b.inflight = 5, 1
        assert policy.pick([a, b, c], ctx) is b
        c.inflight = 0
        assert policy.pick([a, b, c], {}) is c
        a.summary = b.summary = frozenset()
        assert policy.pick([a, b, c], ctx) is c
        assert make_policy("prefix-aware").name == "prefix-aware"
    finally:
        for tier in tiers:
            tier.close()


def test_probe_piggybacks_summary_into_pool_routing():
    """Mirrors test_fleet.py::test_probe_piggybacks_summary_into_pool_routing
    with the probe reading each port tier's summary over its peer port."""
    a, b = _tier(), _tier()
    try:
        row = np.arange(16)
        a.export_prefix(row, 1, 8, _blocks(1), _blocks(1))
        b.export_prefix(row, 2, 8, _blocks(2), _blocks(2))
        tiers = {"a:1": a, "b:1": b}
        pool = EndpointPool(["a:1", "b:1"], policy="prefix-aware")
        pool.start_probes(
            lambda url: (SERVER_READY, fetch_summary(
                tiers[url].address)["prefix_digests"]),
            interval_s=0.05)
        try:
            deadline = time.monotonic() + 10
            while (set(map(len, pool.summaries().values())) != {1, 2}
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            assert pool.summaries()["b:1"] == frozenset(
                chain_digests(row, 8))
            lease = pool.lease(
                request_ctx={"prefix_digests": chain_digests(row, 8)})
            assert lease.url == "b:1"
            lease.release()
        finally:
            pool.close()
    finally:
        a.close()
        b.close()


def test_probe_piggybacks_pressure_into_pool_introspection():
    """Mirrors test_fleet.py::test_probe_piggybacks_pressure_into_pool_introspection:
    the pool's pressures() carry what the port tiers' pressure() reports."""
    from client_tpu.serve.metrics import BalancerMetricsObserver
    from client_tpu.serve.metrics import Registry as JaxRegistry

    depths = {"a:1": 7, "b:1": 1}
    tiers = {}
    for url, depth in depths.items():
        tier = _tier()
        tier.attach(types.SimpleNamespace(
            qos=None, metrics=None, response_cache=None,
            pressure=lambda depth=depth: {"queue_depth": depth}))
        tiers[url] = tier
    registry = JaxRegistry()
    pool = EndpointPool(
        list(depths), policy="least-inflight",
        observer=BalancerMetricsObserver(registry),
    )
    pool.start_probes(
        lambda url: (SERVER_READY, [], tiers[url].pressure()),
        interval_s=0.05,
    )
    try:
        deadline = time.monotonic() + 10
        while (any(not p for p in pool.pressures().values())
               and time.monotonic() < deadline):
            time.sleep(0.01)
        for url, depth in depths.items():
            assert pool.pressures()[url]["queue_depth"] == depth
            assert pool.pressures()[url] == tiers[url].pressure()
        assert registry.get(
            "ctpu_fleet_pressure_queue_depth", {"endpoint": "a:1"}) == 7
        assert registry.get(
            "ctpu_fleet_pressure_prefix", {"endpoint": "a:1"}) == 0
    finally:
        pool.close()
        for tier in tiers.values():
            tier.close()


def test_fetch_summary_carries_pressure():
    """Mirrors test_fleet.py::test_fetch_summary_carries_pressure; the
    JAX package's fetch_summary reads the port tier's the same."""
    tier = _tier()
    try:
        tier.attach(types.SimpleNamespace(
            qos=None, metrics=None, response_cache=None,
            pressure=lambda: {"queue_depth": 5, "inflight": 2},
        ))
        summary = fetch_summary(tier.address)
        assert summary["pressure"]["queue_depth"] == 5
        assert "prefix_hot" in summary["pressure"]
        assert jax_fleet.fetch_summary(tier.address) == summary
    finally:
        tier.close()


def test_pressure_entries_age_out_behind_a_dead_replica():
    """Mirrors test_fleet.py::test_pressure_entries_age_out_behind_a_dead_replica
    with the entries a port tier's pressure() reports."""
    busy, idle = _tier(), _tier()
    for tier, depth in ((busy, 9), (idle, 1)):
        tier.attach(types.SimpleNamespace(
            qos=None, metrics=None, response_cache=None,
            pressure=lambda depth=depth: {"queue_depth": depth}))
    pool = EndpointPool(["a:1", "b:1"], policy="least-inflight")
    try:
        pool._probe_interval_s = 0.05
        pool.set_pressure("a:1", busy.pressure())
        pool.set_pressure("b:1", idle.pressure())
        assert pool.pressures()["a:1"]["queue_depth"] == 9
        horizon = pool.PRESSURE_FRESH_INTERVALS * 0.05
        with pool._lock:
            for endpoint in pool._endpoints:
                if endpoint.url == "a:1":
                    endpoint.pressure_at -= horizon + 0.01
        got = pool.pressures()
        assert got["a:1"] == {}
        assert got["b:1"]["queue_depth"] == 1
        pool._probe_interval_s = 0.0
        assert pool.pressures()["a:1"]["queue_depth"] == 9
    finally:
        pool.close()
        busy.close()
        idle.close()


def test_pressure_carries_kv_occupancy_fraction(params):
    """Mirrors test_fleet.py::test_pressure_carries_kv_occupancy_fraction,
    then reads the gauges a port engine's KV pool publishes."""
    registry = Registry()
    tier = _tier(registry=registry)
    try:
        assert tier.pressure()["kv_used_fraction"] == 0.0
        registry.set("ctpu_lm_kv_blocks_used", None, 3,
                     help_="KV blocks in use")
        registry.set("ctpu_lm_kv_blocks_free", None, 1,
                     help_="KV blocks free")
        assert tier.pressure()["kv_used_fraction"] == 0.75
        assert tier.local_summary()["pressure"]["kv_used_fraction"] == 0.75
        eng = _engine(params, registry=registry)
        try:
            q, _ = eng.submit(list(range(1, 20)), 40)
            q.get(timeout=120)  # streaming: its reservation is held
            frac = tier.pressure()["kv_used_fraction"]
            assert 0.0 < frac < 1.0
        finally:
            eng.close()
        assert tier.pressure()["kv_used_fraction"] == 0.0
    finally:
        tier.close()


def test_replicated_client_stamps_prefix_digests_from_tokens():
    """Mirrors test_fleet.py::test_replicated_client_stamps_prefix_digests_from_tokens:
    the JAX ReplicatedClient over two port Servers, routing on the port's
    chain digests."""
    from client_tpu.balance.replicated import ReplicatedClient
    from client_tpu.http import InferInput

    tokens = list(range(32))
    server_a = Server(device="cpu").start()
    server_b = Server(device="cpu").start()
    seen = []

    class _SpyPolicy(PrefixAware):
        def pick(self, candidates, request_ctx=None):
            seen.append(dict(request_ctx or {}))
            return super().pick(candidates, request_ctx)

    pool = EndpointPool(
        [server_a.http_address, server_b.http_address],
        policy=_SpyPolicy(),
    )
    pool.set_summary(server_b.http_address, chain_digests(tokens, 16))
    client = ReplicatedClient(
        pool, transport="http", probe_interval_s=None,
        prefix_fn=lambda model, inputs: tokens, prefix_block_size=16,
    )
    try:
        def infer(**kwargs):
            inputs = [InferInput("INPUT0", [1, 16], "INT32"),
                      InferInput("INPUT1", [1, 16], "INT32")]
            inputs[0].set_data_from_numpy(
                np.arange(16, dtype=np.int32).reshape(1, 16))
            inputs[1].set_data_from_numpy(np.ones((1, 16), dtype=np.int32))
            return client.infer("simple", inputs, **kwargs)

        infer()
        assert seen[-1]["prefix_digests"] == chain_digests(tokens, 16)
        infer()
        infer(prefix_tokens=tokens[:16])
        assert seen[-1]["prefix_digests"] == chain_digests(tokens[:16], 16)
        infer(prefix_digests=["d0", "d1"])
        assert seen[-1]["prefix_digests"] == ["d0", "d1"]
    finally:
        client.close()
        server_a.stop()
        server_b.stop()


# -- fleet-wide tenant accounting ------------------------------------------

def test_tenant_quota_accounts_fleet_wide_via_gossip():
    """Mirrors test_fleet.py::test_tenant_quota_accounts_fleet_wide_via_gossip."""
    def make_qos():
        return TenantQoS(tenants={"flood": {"rate_per_s": 0.001,
                                            "burst": 10.0}})

    qos_a, qos_b = make_qos(), make_qos()
    admitted_a = admitted_b = 0
    for _ in range(10):
        try:
            qos_a.admit("flood")()
            admitted_a += 1
        except Exception:  # noqa: BLE001
            break
    assert admitted_a == 10

    tier_a, tier_b = _tier(), _tier()
    try:
        _peer_up([tier_a, tier_b])
        tier_a.attach(types.SimpleNamespace(qos=qos_a, metrics=None,
                                            response_cache=None))
        tier_b.attach(types.SimpleNamespace(qos=qos_b, metrics=None,
                                            response_cache=None))
        assert tier_a.gossip_now() == 1
        shed = None
        for i in range(12):
            try:
                qos_b.admit("flood")()
                admitted_b += 1
            except Exception:  # noqa: BLE001
                shed = i
                break
        assert shed == 0 and admitted_b == 0, (shed, admitted_b)
        assert qos_b.snapshot()["flood"]["shed"] >= 1
        qos_b.absorb_remote({"martian": 999})
        assert "martian" not in qos_b.snapshot()
    finally:
        tier_a.close()
        tier_b.close()


# -- response-cache tier over real servers ---------------------------------

def test_response_cache_spans_replicas_over_http():
    """Mirrors test_fleet.py::test_response_cache_spans_replicas_over_http
    on two port Servers (the JAX package's HTTP client drives them)."""
    from client_tpu.http import InferenceServerClient, InferInput

    def make_server():
        fleet = _tier()
        server = Server(response_cache=ResponseCache(), coalescing=True,
                        fleet=fleet, device="cpu")
        server.start()
        return server, fleet

    server_a, fleet_a = make_server()
    server_b, fleet_b = make_server()
    try:
        _peer_up([fleet_a, fleet_b])

        def infer(server):
            with InferenceServerClient(server.http_address) as client:
                inputs = [InferInput("INPUT0", [1, 16], "INT32"),
                          InferInput("INPUT1", [1, 16], "INT32")]
                inputs[0].set_data_from_numpy(
                    np.arange(16, dtype=np.int32).reshape(1, 16))
                inputs[1].set_data_from_numpy(
                    np.ones((1, 16), dtype=np.int32))
                return client.infer("simple", inputs).as_numpy("OUTPUT0")

        out_a = infer(server_a)
        out_b = infer(server_b)
        np.testing.assert_array_equal(out_a, out_b)
        assert server_b.engine.metrics.get(
            "ctpu_fleet_cache_hits_total") == 1
        infer(server_b)
        assert server_b.engine.response_cache.stats()["hits"] == 1
        assert fleet_b.stats()["peer_hits"] == 1
    finally:
        server_a.stop()
        server_b.stop()
        fleet_a.close()
        fleet_b.close()


# -- parked-stream migration -----------------------------------------------

def test_parked_stream_migrates_through_fleet_tier(params):
    """Mirrors test_lm.py::test_parked_stream_migrates_through_fleet_tier:
    drain() exports the parked stream's swapped KV chain into the tier,
    and a surviving port engine resumes prompt + delivered tokens
    byte-exact against the serial stream, its prefill from fetched
    blocks."""
    tier_a, tier_b = _tier(), _tier()
    eng_b = None
    try:
        _peer_up([tier_a, tier_b])
        reg = Registry()
        eng = _engine(params, fleet=tier_a, registry=reg, pool_tokens=80,
                      tenant_priority={"hi": 10.0})
        prompt = [1, 2, 3]
        q_lo, _ = eng.submit(prompt, 60, tenant="lo")
        first = q_lo.get(timeout=120)
        assert first is not CLOSE
        eng.submit([9, 4], 40, tenant="hi")
        deadline = time.monotonic() + 60
        while (eng.preempt_stats()["swapped_streams"] == 0
               and time.monotonic() < deadline):
            time.sleep(0.005)
        assert eng.preempt_stats()["swapped_streams"] == 1
        assert eng.drain() == 1
        assert reg.get("ctpu_fleet_sessions_migrated_total") == 1
        delivered = [first] + _collect(q_lo, timeout=60)
        assert eng.kv.used_blocks == 0, eng.kv.ref_counts()
        assert eng.preempt_stats()["swapped_blocks"] == 0
        eng_b = _engine(params, fleet=tier_b)
        q_r, _ = eng_b.submit(prompt + delivered, 60 - len(delivered))
        rest = _collect(q_r)
        assert delivered + rest == _serial(params, prompt, 60)
        fs = eng_b.fleet_stats()
        assert fs["remote_lookups"] >= 1
        assert fs["remote_blocks"] >= 1
    finally:
        if eng_b is not None:
            eng_b.close()
        tier_a.close()
        tier_b.close()
    assert eng_b.kv.used_blocks == 0, eng_b.kv.ref_counts()


def test_install_failure_raises_on_the_scheduler_thread(params):
    """No fallback: a fetched block that does not fit the pool (here a
    peer's blocks of another head dim) fails the install on the
    scheduler thread, which closes every stream, never a silent
    recompute; the engine's own lookup path still marks the fetch."""
    tier_a, tier_b = _tier(), _tier()
    eng = None
    try:
        _peer_up([tier_a, tier_b])
        row = list(range(1, 20))
        bad = [torch.zeros((2, 8, 2, 5)) for _ in range(CFG.n_layers)]
        tier_a.export_prefix(row, 2, 8, bad, bad)
        raised = []
        hook, threading.excepthook = threading.excepthook, raised.append
        try:
            eng = _engine(params, fleet=tier_b)
            q, _ = eng.submit(row, 4)
            assert _collect(q, timeout=60) == []
            eng._thread.join(timeout=30)
            assert not eng._thread.is_alive()
        finally:
            threading.excepthook = hook
        assert [type(r.exc_value) for r in raised] == [RuntimeError]
        assert "shape mismatch" in str(raised[0].exc_value)
        assert eng.fleet_stats() == {"remote_lookups": 1,
                                     "remote_blocks": 2}
        assert eng.kv.used_blocks == 0, eng.kv.ref_counts()
    finally:
        if eng is not None:
            eng.close()
        tier_a.close()
        tier_b.close()


# -- the three-replica chaos acceptance ------------------------------------

class _LmSession:
    """tests/test_fleet.py's resumable client session."""

    def __init__(self, prompt, budget, tenant=""):
        self.prompt = list(prompt)
        self.budget = int(budget)
        self.tenant = tenant
        self.delivered = []
        self.hops = 0

    def run_on(self, engine):
        remaining = self.budget - len(self.delivered)
        if remaining <= 0:
            return True
        q, _ = engine.submit(self.prompt + self.delivered, remaining,
                             tenant=self.tenant)
        self.delivered.extend(_collect(q))
        self.hops += 1
        return len(self.delivered) >= self.budget


def test_three_replica_kill_mid_stream_chaos(params):
    """Mirrors test_fleet.py::test_three_replica_kill_mid_stream_chaos on
    three port engines with port tiers: replica 0 is killed mid-stream,
    every session completes byte-exact against the serial stream with
    zero errors, and the tier adds hits a single replica would not have
    had.  The schedule runs on the JAX package's chaos harness."""
    from client_tpu.testing.chaos import (
        ChaosScenario,
        FaultSpec,
        run_scenario,
    )

    shared = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3]
    tiers = [_tier() for _ in range(3)]
    _peer_up(tiers)
    engines = [
        _engine(params, fleet=tier, max_slots=4, lane_counts=(4,))
        for tier in tiers
    ]
    _collect(engines[1].submit(shared + [99], 2)[0])
    assert tiers[1].stats()["store_blocks"] >= 2
    sessions = [
        _LmSession(shared + [10 + i] * 3, 24,
                   tenant="gold" if i % 2 else "bronze")
        for i in range(4)
    ]
    killed = threading.Event()

    def kill(_target):
        killed.set()
        engines[0].close()

    def drive(i, session):
        order = [engines[i % 3], engines[(i + 1) % 3], engines[(i + 2) % 3]]
        for _attempt in range(8):
            engine = next(
                e for e in order
                if not (e is engines[0] and killed.is_set())
            )
            if session.run_on(engine):
                return
        raise AssertionError("budget never met")

    scenario = ChaosScenario(
        "fleet-kill-mid-stream",
        [FaultSpec("kill_replica", at_s=0.3, target=0)],
    )
    try:
        result = run_scenario(
            scenario, lambda fault: kill(fault.target),
            [(lambda i=i, s=s: drive(i, s))
             for i, s in enumerate(sessions)],
            join_timeout_s=600,
        )
        result.assert_clean()
        assert sum(s.hops for s in sessions) >= 4
        for session in sessions:
            assert session.delivered == _serial(
                params, session.prompt, session.budget), (
                session.prompt, session.hops)
        local_hits = local_misses = remote_blocks = 0
        for engine in engines:
            stats = engine.prefix_stats()
            local_hits += stats.get("hits", 0)
            local_misses += stats.get("misses", 0)
            remote_blocks += engine.fleet_stats()["remote_blocks"]
        looked = local_hits + local_misses
        assert looked > 0 and remote_blocks > 0
        single_pct = 100.0 * local_hits / looked
        fleet_pct = 100.0 * min(local_hits + remote_blocks, looked) / looked
        assert fleet_pct > single_pct, (fleet_pct, single_pct)
    finally:
        for engine in engines:
            engine.close()
        for tier in tiers:
            tier.close()
        for engine in engines[1:]:
            assert engine.kv.used_blocks == 0, engine.kv.ref_counts()


# -- durable sequences (mirrors of tests/test_chaos.py) ----------------------

def _seq_model(ledger, replica, name="chaos_sequence"):
    """tests/test_chaos.py's ledger-recording accumulator."""
    def fn(inputs, params, ctx):
        value = inputs["INPUT"]
        if ctx is None:
            return {"OUTPUT": value}
        if params.get("sequence_start") or "acc" not in ctx.state:
            ctx.state["acc"] = np.zeros_like(value)
        ctx.state["acc"] = ctx.state["acc"] + value
        ledger.record(ctx.sequence_id, ctx.step + 1, replica)
        return {"OUTPUT": ctx.state["acc"].copy()}

    return Model(
        name,
        inputs=[TensorSpec("INPUT", "INT32", [1])],
        outputs=[TensorSpec("OUTPUT", "INT32", [1])],
        fn=fn,
        stateful=True,
    )


def test_durable_sequence_resumes_on_survivor_engine():
    """Mirrors test_chaos.py::test_durable_sequence_resumes_on_survivor_engine."""
    ledger = StepLedger()
    tier_a, tier_b = _tier(replicate_k=1), _tier(replicate_k=1)
    _peer_up([tier_a, tier_b])
    eng_a = InferenceEngine(models=[_seq_model(ledger, "rA")], fleet=tier_a)
    eng_b = InferenceEngine(models=[_seq_model(ledger, "rB")], fleet=tier_b)
    try:
        sid, total = 31, 0
        for step, value in enumerate((3, 1, 4), start=1):
            total += value
            response, _ = eng_a.execute(
                "chaos_sequence", "",
                _seq_request(value, sid, step, start=(step == 1)), b"",
            )
            assert _out_value(response) == total
        assert tier_a.stats()["seq_pushes"] == 3
        snap = tier_b.seq_store.get(sid)
        assert snap is not None and snap["step"] == 3
        tier_a.close()
        response, _ = eng_b.execute(
            "chaos_sequence", "", _seq_request(5, sid, 4), b"",
        )
        assert _out_value(response) == total + 5
        assert eng_b.metrics.get("ctpu_fleet_seq_resumes_total") == 1
        replay, _ = eng_b.execute(
            "chaos_sequence", "", _seq_request(5, sid, 4), b"",
        )
        assert _out_value(replay) == total + 5
        ledger.assert_exactly_once()
        assert ledger.steps_for(sid) == [1, 2, 3, 4]
        with pytest.raises(InferenceServerException) as exc:
            eng_b.execute(
                "chaos_sequence", "", _seq_request(9, sid, 7), b"",
            )
        assert exc.value.status() == "409"
    finally:
        eng_a.close()
        eng_b.close()
        tier_a.close()
        tier_b.close()


def test_sequence_snapshots_reject_stale_and_fork_failed_lookup():
    """Mirrors test_chaos.py::test_sequence_snapshots_reject_stale_and_fork_failed_lookup."""
    ledger = StepLedger()
    tier = _tier()
    engine = InferenceEngine(models=[_seq_model(ledger, "r")], fleet=tier)
    try:
        engine.execute(
            "chaos_sequence", "", _seq_request(2, 5, 1, start=True), b"",
        )
        engine.execute("chaos_sequence", "", _seq_request(3, 5, 2), b"")
        newer = engine.export_sequence(5)
        assert newer["step"] == 2
        older = dict(newer)
        older["step"] = 1
        assert tier.seq_store.put(newer) is True
        assert tier.seq_store.put(older) is False
        assert tier.seq_store.get(5)["step"] == 2
        assert tier.stats()["seq_stale_rejected"] == 1
        response, _ = engine.execute(
            "chaos_sequence", "",
            _seq_request(7, 404, 1, durable=False), b"",
        )
        assert _out_value(response) == 7
    finally:
        engine.close()
        tier.close()


def test_restarted_sequence_epoch_beats_stale_incarnation():
    """Mirrors test_chaos.py::test_restarted_sequence_epoch_beats_stale_incarnation."""
    ledger = StepLedger()
    tier_a, tier_b = _tier(replicate_k=1), _tier(replicate_k=1)
    _peer_up([tier_a, tier_b])
    eng_a = InferenceEngine(models=[_seq_model(ledger, "rA")], fleet=tier_a)
    eng_b = InferenceEngine(models=[_seq_model(ledger, "rB")], fleet=tier_b)
    try:
        sid = 77
        for step in range(1, 4):
            eng_a.execute(
                "chaos_sequence", "",
                _seq_request(step, sid, step, start=(step == 1)), b"",
            )
        old = tier_b.seq_store.get(sid)
        assert old is not None and old["step"] == 3
        response, _ = eng_b.execute(
            "chaos_sequence", "", _seq_request(9, sid, 1, start=True), b"",
        )
        assert _out_value(response) == 9
        fresh = eng_b.export_sequence(sid)
        assert fresh["epoch"] > old["epoch"]
        assert tier_b.seq_store.put(dict(fresh)) is True
        stored = tier_b.seq_store.get(sid)
        assert stored["step"] == 1 and stored["epoch"] == fresh["epoch"]
        assert tier_b.seq_store.put(dict(old)) is False
        assert tier_a.publish_sequence(dict(old)) == 0
        assert tier_b.seq_store.get(sid)["epoch"] == fresh["epoch"]
    finally:
        eng_a.close()
        eng_b.close()
        tier_a.close()
        tier_b.close()


def test_drain_exports_sequences_to_the_tier():
    """Mirrors test_chaos.py::test_drain_exports_sequences_to_the_tier."""
    ledger = StepLedger()
    tier_a, tier_b = _tier(), _tier()
    _peer_up([tier_a, tier_b])
    engine = InferenceEngine(models=[_seq_model(ledger, "rA")], fleet=tier_a)
    try:
        engine.execute(
            "chaos_sequence", "",
            _seq_request(4, 11, 1, start=True, durable=False), b"",
        )
        assert tier_b.seq_store.get(11) is None
        assert engine.drain(timeout_s=5) is True
        snap = tier_b.seq_store.get(11)
        assert snap is not None and snap["step"] == 1
    finally:
        engine.close()
        tier_a.close()
        tier_b.close()


def test_seq_quorum_arithmetic():
    """Mirrors test_chaos.py::test_seq_quorum_arithmetic; each count also
    equals the JAX tier's."""
    with pytest.raises(ValueError):
        FleetTier(quorum="all")
    tier = _tier()
    try:
        assert tier.quorum == "any"
        assert tier.seq_quorum_required() == 0
    finally:
        tier.close()
    for k, need in ((1, 1), (2, 2), (3, 2), (4, 3), (5, 3)):
        port = FleetTier(replicate_k=k, quorum="majority")
        ref = jax_fleet.FleetTier(replicate_k=k, quorum="majority")
        assert port.seq_quorum_required() == need, (k, need)
        assert ref.seq_quorum_required() == need


def test_quorum_refusal_is_retryable_and_never_reapplies():
    """Mirrors test_chaos.py::test_quorum_refusal_is_retryable_and_never_reapplies."""
    ledger = StepLedger()
    tier_a = _tier(replicate_k=1, quorum="majority")
    tier_b = _tier(replicate_k=1)
    eng_a = InferenceEngine(models=[_seq_model(ledger, "rA")], fleet=tier_a)
    try:
        with pytest.raises(InferenceServerException) as exc:
            eng_a.execute(
                "chaos_sequence", "",
                _seq_request(3, 21, 1, start=True), b"",
            )
        assert exc.value.status() == "503"
        msg = str(exc.value)
        assert "quorum" in msg and "0/1" in msg
        assert ledger.steps_for(21) == [1]
        assert tier_a.stats()["seq_quorum_refusals"] == 1
        tier_a.set_peers([tier_b.address])
        response, _ = eng_a.execute(
            "chaos_sequence", "", _seq_request(3, 21, 1), b"",
        )
        assert _out_value(response) == 3
        assert ledger.steps_for(21) == [1]  # replayed, never re-applied
        ledger.assert_exactly_once()
        assert tier_a.stats()["seq_quorum_acks"] >= 1
        assert tier_b.seq_store.get(21)["step"] == 1
        response, _ = eng_a.execute(
            "chaos_sequence", "", _seq_request(4, 21, 2), b"",
        )
        assert _out_value(response) == 7
        assert tier_b.seq_store.get(21)["step"] == 2
    finally:
        eng_a.close()
        tier_a.close()
        tier_b.close()


# -- the two packages against each other -------------------------------------

@pytest.mark.parametrize("exporter", ["jax", "port"])
def test_prefix_installed_across_packages_streams_jax_serial(weights,
                                                              exporter):
    """A port engine on a port tier installs the blocks a JAX engine
    exported into a JAX tier (and the reverse): the installing engine's
    float32 stream equals JAX serial ``generate`` (exact), and every
    covered block came over the wire."""
    jparams, port = weights
    prompt = list(range(1, 30))  # 3 full blocks of 8 + 5
    want = list(jtfm.generate(jparams, _JCFG, prompt, 6, readback_depth=0))
    jtier, ptier = _jax_tier(), _tier()
    jtier.set_peers([ptier.address])
    ptier.set_peers([jtier.address])
    kw = dict(max_slots=2, lane_counts=(2,), block_size=8, prefill_chunk=16,
              min_bucket=4)
    jeng = JaxLmEngine(jparams, _JCFG, fleet=jtier, **kw)
    peng = LmEngine(port, CFG, fleet=ptier, device="cpu", **kw)
    first, second = (jeng, peng) if exporter == "jax" else (peng, jeng)
    try:
        assert _collect(first.submit(prompt, 6)[0]) == want
        got = _collect(second.submit(prompt, 6)[0])
        assert got == want
        assert second.fleet_stats() == {"remote_lookups": 1,
                                        "remote_blocks": 3}
        assert first.fleet_stats()["remote_blocks"] == 0
    finally:
        jeng.close()
        peng.close()
        jtier.close()
        ptier.close()
    assert peng.kv.used_blocks == 0, peng.kv.ref_counts()


def test_moe_engine_installs_a_jax_moe_prefix():
    """The MoE engine takes the same hooks: a port MoE engine (4 experts,
    top 2) installs the prefix a JAX MoE engine exported and streams JAX
    serial ``generate``'s float32 tokens (exact)."""
    jcfg = dataclasses.replace(_JCFG, n_experts=4, top_k=2)
    cfg = tfm.TransformerConfig(**dataclasses.asdict(jcfg))
    jparams = jtfm.init_params(jax.random.PRNGKey(2), jcfg)
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    prompt = list(range(3, 30))
    want = list(jtfm.generate(jparams, jcfg, prompt, 6, readback_depth=0))
    jtier, ptier = _jax_tier(), _tier()
    _peer_up([jtier, ptier])
    kw = dict(max_slots=2, lane_counts=(2,), block_size=8, prefill_chunk=16,
              min_bucket=4)
    jeng = JaxLmEngine(jparams, jcfg, fleet=jtier, **kw)
    peng = LmEngine(params, cfg, fleet=ptier, device="cpu", **kw)
    try:
        assert _collect(jeng.submit(prompt, 6)[0]) == want
        assert _collect(peng.submit(prompt, 6)[0]) == want
        assert peng.fleet_stats()["remote_blocks"] == 3
    finally:
        jeng.close()
        peng.close()
        jtier.close()
        ptier.close()
    assert peng.kv.used_blocks == 0, peng.kv.ref_counts()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("exporter", ["jax", "port"])
def test_prefix_blocks_cross_the_wire_bit_for_bit(exporter, dtype):
    """A JAX tier's blocks (ml_dtypes bf16 or float32 numpy) decode in a
    port tier bit for bit, and a port tier's (torch bf16 or float32)
    decode in a JAX tier bit for bit: the same dtype names, the same raw
    bytes."""
    torch_dtype = getattr(torch, dtype)
    blocks = [(torch.randn((4, 8, 2, 4), generator=torch.Generator()
                           .manual_seed(i)) * 3).to(torch_dtype)
              for i in range(CFG.n_layers)]
    bits = [b.view(torch.int16) if dtype == "bfloat16" else b.view(torch.int32)
            for b in blocks]
    jtier, ptier = _jax_tier(), _tier()
    jtier.set_peers([ptier.address])
    ptier.set_peers([jtier.address])
    row = np.arange(40)
    try:
        if exporter == "jax":
            import ml_dtypes

            npdt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
            host = [b.numpy().view(npdt) for b in bits]
            jtier.export_prefix(row, 4, 8, host, host)
            got = ptier.prefix_lookup(row, 8, 4, start_blocks=1)
            assert got[0] == 4 and got[3] == 1
            for layer in range(CFG.n_layers):
                assert got[1][layer].dtype == torch_dtype
                assert torch.equal(got[1][layer].view(bits[layer].dtype),
                                   bits[layer][1:])
                assert torch.equal(got[2][layer].view(bits[layer].dtype),
                                   bits[layer][1:])
        else:
            ptier.export_prefix(row, 4, 8, blocks, blocks)
            got = jtier.prefix_lookup(row, 8, 4, start_blocks=1)
            assert got[0] == 4 and got[3] == 1
            for layer in range(CFG.n_layers):
                assert str(got[1][layer].dtype) == dtype
                np.testing.assert_array_equal(
                    got[1][layer].view(bits[layer].numpy().dtype),
                    bits[layer][1:].numpy())
    finally:
        jtier.close()
        ptier.close()


def test_sequence_snapshots_cross_packages_bit_for_bit():
    """``__nd__`` state encoded by one package decodes bit for bit in the
    other (JAX ``_seq_encode``/``_seq_decode``): numpy arrays stay numpy
    on a host context, a port context puts tensors on its device, bf16
    travels as its 16-bit words; and a snapshot a port replica serves
    over its peer port resumes in a JAX tier's lookup."""
    import ml_dtypes

    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    i32 = rng.integers(-9, 9, (4,)).astype(np.int32)
    b16 = rng.standard_normal((2, 3)).astype(ml_dtypes.bfloat16)
    state = {"f": f32, "i": [i32, {"b": b16}], "s": np.int64(7),
             "raw": b"\x00\x01"}
    # JAX -> port, on a host context and on a device context
    enc = jax_runtime._seq_encode(state)
    host = runtime._seq_decode(enc)
    np.testing.assert_array_equal(host["f"], f32)
    np.testing.assert_array_equal(host["i"][0], i32)
    assert host["i"][1]["b"].dtype == torch.bfloat16
    assert np.array_equal(host["i"][1]["b"].view(torch.int16).numpy(),
                          b16.view(np.int16))
    assert host["s"] == 7 and host["raw"] == b"\x00\x01"
    dev = runtime._seq_decode(enc, torch.device("cpu"))
    assert isinstance(dev["f"], torch.Tensor)
    assert torch.equal(dev["f"], torch.from_numpy(f32))
    # port tensors -> JAX numpy, bit for bit
    tens = {"f": torch.from_numpy(f32), "b": torch.from_numpy(
        b16.view(np.int16)).view(torch.bfloat16), "l": torch.arange(6)}
    back = jax_runtime._seq_decode(runtime._seq_encode(tens))
    np.testing.assert_array_equal(back["f"], f32)
    assert str(back["b"].dtype) == "bfloat16"
    np.testing.assert_array_equal(back["b"].view(np.int16),
                                  b16.view(np.int16))
    np.testing.assert_array_equal(back["l"], np.arange(6))
    # a whole context: port export -> JAX restore -> port restore
    ctx = runtime.SequenceContext(9, durable=True)
    ctx.state = {"acc": torch.tensor([3, 4], dtype=torch.int32)}
    ctx.step = 2
    ctx.last_response = (2, {"outputs": []}, [b"ab"])
    jctx = jax_runtime.SequenceContext.restore(ctx.export())
    assert (jctx.step, jctx.epoch) == (2, ctx.epoch)
    np.testing.assert_array_equal(jctx.state["acc"], [3, 4])
    again = runtime.SequenceContext.restore(jctx.export(),
                                            torch.device("cpu"))
    assert torch.equal(again.state["acc"], ctx.state["acc"])
    assert again.last_response == (2, {"outputs": []}, [b"ab"])
    # over the wire: a JAX tier's lookup resumes the port tier's snapshot
    ptier, jtier = _tier(), _jax_tier()
    try:
        jtier.set_peers([ptier.address])
        assert ptier.seq_store.put(ctx.export())
        snap = jtier.sequence_lookup(9)
        assert snap["step"] == 2 and snap["epoch"] == ctx.epoch
        np.testing.assert_array_equal(
            jax_runtime.SequenceContext.restore(snap).state["acc"], [3, 4])
    finally:
        ptier.close()
        jtier.close()


class _FakePool:
    """The two calls the autoscaler makes on a balance pool, fed a
    scripted pressure signal."""

    def __init__(self):
        self.signal = {}
        self.membership = []

    def pressures(self):
        return {url: dict(p) for url, p in self.signal.items()}

    def update_endpoints(self, urls):
        self.membership.append(list(urls))


class _FakeLauncher:
    def __init__(self, handle_cls):
        self.handle_cls = handle_cls
        self.spawned = 0
        self.retired = []

    def spawn(self):
        self.spawned += 1
        return self.handle_cls(f"r{self.spawned}:1")

    def retire(self, handle):
        self.retired.append(handle.url)


def test_autoscaler_decisions_match_jax():
    """The same pressure signals fed to client_tpu's and the port's
    Autoscaler (a fake pool and launcher, one clock) give the same
    decision at every tick, the same membership and the same counters."""
    signals = ([{"queue_depth": 10}] * 4
               + [{"queue_depth": 0, "kv_used_fraction": 0.9}] * 2
               + [{"queue_depth": 3}] * 2 + [{"queue_depth": 0}] * 8
               + [{}] * 2)
    runs = []
    for mod, registry in ((jax_autoscale, None), (autoscale, Registry())):
        pool = _FakePool()
        launcher = _FakeLauncher(mod.ReplicaHandle)
        scaler = mod.Autoscaler(pool, launcher, mod.AutoscalePolicy(
            min_replicas=1, max_replicas=3, up_after=2, down_after=3,
            cooldown_s=2.5), registry=registry)
        scaler.adopt([mod.ReplicaHandle("r0:1")])
        decisions = []
        for t, sig in enumerate(signals):
            pool.signal = {h.url: sig for h in scaler.replicas()}
            decisions.append((scaler.tick(now=float(t)), scaler.status()))
        runs.append((decisions, pool.membership, launcher.retired))
    assert runs[0] == runs[1]
    actions = [d[0] for d in runs[0][0]]
    assert actions.count("up") == 2 and "suppressed" in actions
    assert actions.count("down") == 2


def test_fleet_peer_spans_join_one_trace_across_packages():
    """A traced request's peer lookup from a port tier records a
    ``__peer_prefix_get__`` child span (client_tpu.serve.tracing
    Tracer.peer_span), and the JAX peer it asked records the serve span
    under the same trace id (serve_span) from the traceparent in the
    frame; the reverse too."""
    settings = {"trace_level": ["TIMESTAMPS"], "trace_rate": "1",
                "trace_count": "-1", "trace_file": "",
                "log_frequency": "0"}
    from client_tpu.serve.tracing import Tracer as JaxTracer
    from client_tpu.serve.tracing import push_trace as jax_push
    from client_tpu_torch.serve.tracing import Tracer, push_trace

    ptracer, jtracer = Tracer(dict(settings)), JaxTracer(dict(settings))
    ptier, jtier = _tier(), _jax_tier()
    for tier, tracer in ((ptier, ptracer), (jtier, jtracer)):
        tier.attach(types.SimpleNamespace(qos=None, metrics=None,
                                          response_cache=None,
                                          tracer=tracer))
    _peer_up([ptier, jtier])
    try:
        for asker, tracer, push, server_tracer in (
                (ptier, ptracer, push_trace, jtracer),
                (jtier, jtracer, jax_push, ptracer)):
            tracer.peer_completed.clear()
            server_tracer.peer_completed.clear()
            request = tracer.sample(model_name="m")
            with push(request):
                assert asker.prefix_lookup(np.arange(16), 8, 2) is None
            child = tracer.peer_completed[-1]
            assert child.model_name == "__peer_prefix_get__"
            assert child.trace_id == request.trace_id
            assert child.parent_span_id == request.span_id
            deadline = time.monotonic() + 5
            while (not server_tracer.peer_completed
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            served = server_tracer.peer_completed[-1]
            assert served.trace_id == request.trace_id
            assert served.tags["side"] == "serve"
        assert ptracer.resume_span(child.traceparent(), 5).trace_id == \
            child.trace_id
    finally:
        ptier.close()
        jtier.close()


def _launch(module, *args):
    """Start ``python -m <module> --http-port 0 ...``; returns the process
    and its startup lines once the fleet line is out."""
    import os
    import subprocess
    import sys

    proc = subprocess.Popen(
        [sys.executable, "-m", module, "--http-port", "0", *args],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    lines = []
    for line in proc.stdout:
        lines.append(line.strip())
        if "fleet peer port" in line:
            break
    return proc, lines


@pytest.mark.parametrize("flags", [
    [], ["--replicate-k", "2", "--seq-quorum", "majority"]])
def test_cli_fleet_flags_behave_as_jax(flags):
    """``--fleet-bind``, ``--fleet-peers``, ``--replicate-k`` and
    ``--seq-quorum`` (client_tpu/serve/__main__.py): the same defaults
    and the same startup line as the JAX CLI's, and a port server whose
    ``--fleet-peers`` names a JAX server's fleet port pushes a durable
    step's snapshot there: acked with the default best-effort quorum,
    refused with a retryable 503 under a majority of K = 2 that its one
    peer cannot meet (the step stays applied and replicated)."""
    import json
    import re
    import urllib.error
    import urllib.request

    from client_tpu_torch.perf.rendezvous import recv_frame, send_frame

    jax_proc, jax_lines = _launch(
        "client_tpu.serve", "--models", "builtin",
        "--fleet-bind", "127.0.0.1:0", *flags)
    port_proc = None
    try:
        jax_fleet_line = jax_lines[-1]
        jax_addr = re.search(r"fleet peer port on (\S+)",
                             jax_fleet_line).group(1)
        port_proc, port_lines = _launch(
            "client_tpu_torch.serve", "--models", "builtin",
            "--device", "cpu", "--fleet-bind", "127.0.0.1:0",
            "--fleet-peers", jax_addr, *flags)
        shape = re.compile(r"^(\S+)\.serve: fleet peer port on \S+ "
                           r"(\(quorum=\w+, replicate_k=\d+\))$")
        want = shape.match(jax_fleet_line)
        got = shape.match(port_lines[-1])
        assert want.group(1) == "client_tpu"
        assert got.group(1) == "client_tpu_torch"
        assert got.group(2) == want.group(2)
        http_addr = re.search(r"HTTP on (\S+)", port_lines[0]).group(1)
        body = {"inputs": [{"name": "INPUT", "shape": [1],
                            "datatype": "INT32", "data": [6]}],
                "parameters": {"sequence_id": 12, "sequence_start": True,
                               "sequence_durable": True,
                               "sequence_step": 1}}
        req = urllib.request.Request(
            f"http://{http_addr}/v2/models/simple_sequence/infer",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                answer = resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            answer = e.code, json.loads(e.read())
        if flags:
            assert answer[0] == 503 and "quorum" in answer[1]["error"]
        else:
            assert answer == (200, answer[1])
            assert answer[1]["outputs"][0]["data"] == [6]
        host, _, port = jax_addr.rpartition(":")
        with socket.create_connection((host, int(port)), timeout=5) as sock:
            send_frame(sock, {"op": "seq_get", "sequence_id": 12})
            reply = recv_frame(sock)
        assert reply["hit"] and reply["snapshot"]["step"] == 1
    finally:
        for proc in (jax_proc, port_proc):
            if proc is not None:
                proc.terminate()
                proc.wait(timeout=30)


def test_server_replica_launcher_spawns_and_retires_port_replicas():
    """client_tpu/serve/autoscale.py ServerReplicaLauncher on the port:
    each spawn is a port Server on a started port FleetTier with the
    launcher's device passed to the models factory; the Autoscaler wires
    the peer mesh; retiring a replica drains it, which publishes its live
    sequence into the survivor's tier, and closes its tier."""
    from client_tpu_torch.serve.builtins import sequence_model

    devices = []

    def models(device):
        devices.append(device)
        return [sequence_model()]

    launcher = autoscale.ServerReplicaLauncher(
        models, fleet_kwargs={"gossip_interval_s": 0},
        drain_timeout_s=5, device="cpu")
    pool = _FakePool()
    scaler = autoscale.Autoscaler(pool, launcher)
    floor, extra = launcher.spawn(), launcher.spawn()
    try:
        scaler.adopt([floor, extra])
        assert devices == ["cpu", "cpu"]
        assert extra.tier.peers() == [floor.fleet_address]
        assert pool.membership[-1] == [floor.url, extra.url]
        response, _ = extra.server.engine.execute(
            "simple_sequence", "",
            {"inputs": [{"name": "INPUT", "shape": [1],
                         "datatype": "INT32", "data": [4]}],
             "parameters": {"sequence_id": 3, "sequence_start": True}}, b"")
        assert _out_value(response) == 4
        launcher.retire(extra)
        snap = floor.tier.seq_store.get(3)
        assert snap is not None and snap["step"] == 1
        assert extra.tier.address is not None and extra.tier._server is None
    finally:
        for handle in (floor, extra):
            handle.server.stop()
            handle.tier.close()
