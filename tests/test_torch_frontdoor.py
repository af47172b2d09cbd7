"""The port's multi-tenant front door (client_tpu_torch.serve.frontdoor)
held against client_tpu.serve.frontdoor.

The same requests give the same ``request_digest`` hex digest in both
packages; ``ResponseCache``, ``Coalescer`` and ``TenantQoS`` give equal
results, counters and metric lines on the same call sequences, each
module's clock injected (a fake ``time`` whose ``monotonic`` the test
advances).  These mirror tests/test_frontdoor.py's unit classes
(TestRequestDigest, TestResponseCache, TestCoalescer, TestTenantQoS).
Then the port's server itself: identical wire requests hit the cache and
coalesce, a request whose tensors are in a shared-memory region never
does (its ``cache_hit`` count does not move).  Exact equality throughout:
nothing here is a float computed two ways.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

from client_tpu.serve import frontdoor as jfd
from client_tpu.serve.metrics import Registry as JRegistry
from client_tpu.utils import to_wire_bytes as j_to_wire_bytes
from client_tpu_torch.serve import Model, Server, TensorSpec
from client_tpu_torch.serve import frontdoor as tfd
from client_tpu_torch.serve.metrics import Registry
from client_tpu_torch.utils import InferenceServerException, to_wire_bytes
from client_tpu_torch.utils import shared_memory as shm

PACKAGES = {"jax": (jfd, JRegistry), "torch": (tfd, Registry)}


class _Clock:
    """A module's ``time`` with a hand-driven ``monotonic``."""

    def __init__(self, t=100.0):
        self.t = t

    def monotonic(self):
        return self.t


@pytest.fixture
def clocks(monkeypatch):
    """One fake clock per package, injected as the module's ``time``."""
    out = {}
    for name, (module, _) in PACKAGES.items():
        out[name] = _Clock()
        monkeypatch.setattr(module, "time", out[name])
    return out


def _lines(registry):
    lines = []
    registry.render_into(lines)
    return lines


# -- request digest (TestRequestDigest) -------------------------------------


def _req(value, req_id="", extra_params=None, data=False):
    arr = np.full((1, 4), value, dtype=np.float32)
    raw = to_wire_bytes(arr, "FP32")
    assert raw == j_to_wire_bytes(arr, "FP32")
    entry = {"name": "IN", "datatype": "FP32", "shape": [1, 4]}
    if data:
        entry["data"] = arr.ravel().tolist()
        raw = b""
    else:
        entry["parameters"] = {"binary_data_size": len(raw)}
    req = {
        "id": req_id,
        "parameters": dict(extra_params or {}),
        "inputs": [entry],
        "outputs": [{"name": "OUT", "parameters": {"binary_data": True}}],
    }
    return req, raw


def _shm_in():
    req, _ = _req(1.0)
    req["inputs"][0]["parameters"] = {
        "shared_memory_region": "r", "shared_memory_byte_size": 16}
    return req, b""


def _shm_out():
    req, raw = _req(1.0)
    req["outputs"][0]["parameters"] = {
        "shared_memory_region": "r", "shared_memory_byte_size": 16}
    return req, raw


DIGEST_CASES = {
    "binary": lambda: _req(1.0),
    "binary_other_value": lambda: _req(2.0),
    "with_id": lambda: _req(1.0, req_id="client-7"),
    "json_data": lambda: _req(3.5, data=True),
    "params": lambda: _req(1.0, extra_params={"binary_data_output": True}),
    "sequence": lambda: _req(1.0, extra_params={"sequence_id": 7}),
    "shm_input": _shm_in,
    "shm_output": _shm_out,
    "binary_parts": lambda: ({"inputs": [], "parameters": {}},
                             [b"ab", b"c"]),
}


@pytest.mark.parametrize("case", sorted(DIGEST_CASES))
@pytest.mark.parametrize("model,version", [("m", ""), ("m", "1"),
                                           ("other", "")])
def test_request_digest_equals_jax(case, model, version):
    """TestRequestDigest: the same request gives the same hex digest in
    both packages (None for the uncacheable shapes: sequence, shared
    memory in or out)."""
    request, raw = DIGEST_CASES[case]()
    got = tfd.request_digest(model, version, request, raw)
    want = jfd.request_digest(model, version, request, raw)
    assert got == want
    assert (got is None) == (case in ("sequence", "shm_input", "shm_output"))


def test_request_digest_ignores_id_and_keys_content():
    a, raw_a = _req(1.0, req_id="client-1")
    b, raw_b = _req(1.0, req_id="client-2")
    c, raw_c = _req(2.0)
    assert tfd.request_digest("m", "1", a, raw_a) == tfd.request_digest(
        "m", "1", b, raw_b)
    assert tfd.request_digest("m", "", a, raw_a) != tfd.request_digest(
        "m", "", c, raw_c)


# -- response cache (TestResponseCache) -------------------------------------


def _cache_lru(pkg, clock):
    module, reg_cls = PACKAGES[pkg]
    reg = reg_cls()
    cache = module.ResponseCache(max_entries=2, registry=reg)
    cache.put("a", {"outputs": []}, [b"a"])
    cache.put("b", {"outputs": []}, [b"b"])
    out = [cache.get("a")]
    cache.put("c", {"outputs": []}, [b"c"])  # evicts b (LRU)
    out += [cache.get("b"), cache.get("a"), cache.get("c"), cache.stats()]
    return out, _lines(reg)


def _cache_bytes(pkg, clock):
    module, reg_cls = PACKAGES[pkg]
    reg = reg_cls()
    cache = module.ResponseCache(max_entries=100, max_bytes=3000,
                                 registry=reg)
    cache.put("big", {"outputs": []}, [b"x" * 4000])  # alone > bound
    out = [cache.get("big")]
    cache.put("a", {"outputs": []}, [b"x" * 1500])
    cache.put("b", {"outputs": []}, [b"y" * 1500])  # evicts a by bytes
    out += [cache.get("a"), cache.get("b"), cache.stats(), len(cache)]
    return out, _lines(reg)


def _cache_ttl(pkg, clock):
    module, reg_cls = PACKAGES[pkg]
    reg = reg_cls()
    cache = module.ResponseCache(max_entries=4, ttl_s=0.05, registry=reg)
    cache.put("k", {"outputs": []}, [b"v"])
    out = [cache.get("k")]
    clock.t += 0.08
    out += [cache.get("k"), cache.stats()]  # expired at read time
    return out, _lines(reg)


def _cache_entry_ttl(pkg, clock):
    module, reg_cls = PACKAGES[pkg]
    reg = reg_cls()
    cache = module.ResponseCache(max_entries=4, ttl_s=30.0, registry=reg)
    cache.put("fresh", {"outputs": []}, [b"v"], ttl_s=0.05)
    cache.put("stable", {"outputs": []}, [b"v"])
    clock.t += 0.08
    out = [cache.get("fresh"), cache.get("stable")]
    cache.clear()
    out += [cache.stats()]
    return out, _lines(reg)


def _cache_peek_keys(pkg, clock):
    """The fleet tier's reads: peek touches no counter and no LRU order
    (the next eviction still takes the peeked key), honors the TTL
    without expiring; keys lists the digests in LRU order."""
    module, reg_cls = PACKAGES[pkg]
    reg = reg_cls()
    cache = module.ResponseCache(max_entries=2, ttl_s=0.05, registry=reg)
    cache.put("a", {"outputs": [], "id": "1"}, [b"1"])
    cache.put("b", {"outputs": [], "id": "2"}, [b"2"])
    out = [cache.peek("a"), cache.peek("zz"), cache.keys(), cache.stats()]
    cache.put("c", {"outputs": [], "id": "3"}, [b"3"])  # evicts a: peek kept no LRU
    out += [cache.keys(), cache.peek("a")]
    clock.t += 0.08
    out += [cache.peek("b"), len(cache), cache.stats()]
    return out, _lines(reg)


CACHE_CASES = {"lru": _cache_lru, "byte_bound": _cache_bytes,
               "ttl": _cache_ttl, "per_entry_ttl": _cache_entry_ttl,
               "peek_keys": _cache_peek_keys}


@pytest.mark.parametrize("case", sorted(CACHE_CASES))
def test_response_cache_equals_jax(case, clocks):
    """TestResponseCache: equal hits, misses, evictions, stats and metric
    lines on the same call sequence."""
    got = CACHE_CASES[case]("torch", clocks["torch"])
    want = CACHE_CASES[case]("jax", clocks["jax"])
    assert got == want
    assert any("ctpu_cache_" in line for line in got[1])


# -- coalescer (TestCoalescer) -----------------------------------------------


def _flight(f):
    return (f.event.is_set(), f.result, f.error, f.retry, f.followers)


def _coalesce_publish(pkg):
    module, reg_cls = PACKAGES[pkg]
    reg = reg_cls()
    c = module.Coalescer(registry=reg)
    lead, flight = c.join("k")
    joins = [c.join("k") for _ in range(3)]
    out = [lead, [j[0] for j in joins], all(j[1] is flight for j in joins)]
    c.publish("k", flight, ("resp", []))
    out += [_flight(flight), c.coalesced, c.depth_max, c.join("k")[0]]
    return out, _lines(reg)


def _coalesce_fail(pkg):
    module, _ = PACKAGES[pkg]
    c = module.Coalescer()
    _, flight = c.join("k")
    _, f2 = c.join("k")
    c.fail("k", flight, "boom")
    return [_flight(f2), c.join("k")[0]], []


def _coalesce_retry(pkg):
    module, _ = PACKAGES[pkg]
    c = module.Coalescer()
    _, flight = c.join("k")
    _, f2 = c.join("k")
    c.retry_followers("k", flight)
    return [_flight(f2), c.join("k")[0], c.join("k")[0]], []


COALESCE_CASES = {"publish": _coalesce_publish, "fail": _coalesce_fail,
                  "retry_followers": _coalesce_retry}


@pytest.mark.parametrize("case", sorted(COALESCE_CASES))
def test_coalescer_equals_jax(case):
    """TestCoalescer: leader/follower roles, the published result or
    error, the retry flag and the counters agree on the same joins."""
    assert COALESCE_CASES[case]("torch") == COALESCE_CASES[case]("jax")


def test_coalescer_followers_wait_for_the_leader():
    c = tfd.Coalescer(registry=Registry())
    _, flight = c.join("k")
    results = []

    def follow():
        lead, f = c.join("k")
        assert not lead
        f.event.wait(timeout=10)
        results.append(f.result)

    threads = [threading.Thread(target=follow) for _ in range(3)]
    for t in threads:
        t.start()
    while c.coalesced < 3:
        threading.Event().wait(0.001)
    c.publish("k", flight, ("resp", []))
    for t in threads:
        t.join(timeout=10)
    assert results == [("resp", [])] * 3 and c.depth_max == 4


# -- tenant QoS (TestTenantQoS) ----------------------------------------------


def _admit(qos, tenant):
    """('ok', release) or ('429', retry_after_s, message)."""
    try:
        return ("ok", qos.admit(tenant))
    except Exception as e:  # both packages' InferenceServerException
        return (e.status(), e.retry_after_s, e.message())


def _qos_inflight(pkg, clock):
    module, reg_cls = PACKAGES[pkg]
    reg = reg_cls()
    qos = module.TenantQoS(tenants={"t": {"max_inflight": 1}}, registry=reg)
    first = _admit(qos, "t")
    out = [first[0], _admit(qos, "t")]
    first[1]()
    first[1]()  # idempotent
    again = _admit(qos, "t")
    again[1]()
    out += [again[0], qos.snapshot()]
    return out, _lines(reg)


def _qos_bucket(pkg, clock):
    module, reg_cls = PACKAGES[pkg]
    reg = reg_cls()
    qos = module.TenantQoS(tenants={"t": {"rate_per_s": 10.0, "burst": 2.0}},
                           registry=reg)
    out = [_admit(qos, "t")[0], _admit(qos, "t")[0]]  # burst exhausted
    out.append(_admit(qos, "t"))  # the hint: when a token will exist
    clock.t += 0.12  # one token refills at 10/s
    out += [_admit(qos, "t")[0], _admit(qos, "t")]
    out.append(qos.snapshot())
    return out, _lines(reg)


def _qos_classes(pkg, clock):
    module, _ = PACKAGES[pkg]
    qos = module.TenantQoS(
        default_weight=1.0,
        tenants={"gold": {"weight": 8.0, "priority": 10,
                          "lane_share": 0.25},
                 "zero": {"weight": 0.0}, "free": {"lane_share": None}})
    out = []
    for tenant in ("gold", "anyone", "zero", "free"):
        out.append((qos.weight(tenant), qos.priority(tenant),
                    qos.lane_share(tenant)))
    out.append(module.TenantQoS(default_priority=2.5).priority("x"))
    return out, []


def _qos_note(pkg, clock):
    module, reg_cls = PACKAGES[pkg]
    reg = reg_cls()
    qos = module.TenantQoS(tenants={"t": {"max_inflight": 1}}, registry=reg)
    hold = qos.admit("t")
    qos.note("t")  # cache-hit path: counted, never shed
    hold()
    return [qos.snapshot()], _lines(reg)


def _qos_gossip(pkg, clock):
    """Fleet-wide accounting: delta_counts hands out (and resets) the
    admissions since the last call; absorb_remote drains the buckets by a
    peer's, floored at zero, materializing configured tenants and
    ignoring unknown ones."""
    module, reg_cls = PACKAGES[pkg]
    reg = reg_cls()
    qos = module.TenantQoS(
        tenants={"t": {"rate_per_s": 1.0, "burst": 4.0},
                 "idle": {"rate_per_s": 1.0, "burst": 2.0}},
        default_max_inflight=8, registry=reg)
    for _ in range(3):
        _admit(qos, "t")[1]()
    _admit(qos, "u")[1]()
    out = [qos.delta_counts(), qos.delta_counts()]
    qos.absorb_remote({"t": 0.5, "idle": 5, "martian": 3})
    out += [_admit(qos, "t"), _admit(qos, "idle"), qos.snapshot()]
    out.append(qos.delta_counts())
    return out, _lines(reg)


QOS_CASES = {"inflight_cap": _qos_inflight, "token_bucket": _qos_bucket,
             "weights_priority_lane_share": _qos_classes,
             "note": _qos_note, "fleet_gossip": _qos_gossip}


@pytest.mark.parametrize("case", sorted(QOS_CASES))
def test_tenant_qos_equals_jax(case, clocks):
    """TestTenantQoS: admissions, 429s with their Retry-After hints,
    weights, priorities, lane shares, snapshots and the per-tenant metric
    lines agree on the same call sequence and clock."""
    got = QOS_CASES[case]("torch", clocks["torch"])
    want = QOS_CASES[case]("jax", clocks["jax"])
    assert got == want


def test_tenant_qos_rejection_is_a_retryable_429(clocks):
    qos = tfd.TenantQoS(tenants={"t": {"max_inflight": 1}})
    qos.admit("t")
    with pytest.raises(InferenceServerException) as e:
        qos.admit("t")
    assert e.value.status() == "429" and e.value.retry_after_s >= 0.05


# -- the front door in the port's server ---------------------------------------


def _double_model(calls):
    def fn(inputs, params, ctx):
        calls.append(1)
        return {"OUT": np.asarray(inputs["IN"]) * 2}

    return Model("double", inputs=[TensorSpec("IN", "FP32", [4])],
                 outputs=[TensorSpec("OUT", "FP32", [4])], fn=fn)


def _post(addr, path, obj):
    req = urllib.request.Request(f"http://{addr}{path}",
                                 data=json.dumps(obj).encode())
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _cache_hits(addr):
    with urllib.request.urlopen(
            f"http://{addr}/v2/models/double/stats", timeout=30) as resp:
        stats = json.loads(resp.read())["model_stats"][0]
    return stats["inference_stats"]["cache_hit"]["count"], stats


def test_shared_memory_request_bypasses_the_cache():
    """Identical wire requests are answered from the cache; a request
    whose input is in a system shared-memory region always executes and
    leaves ``cache_hit`` where it was, and so does one whose output is
    bound for a region."""
    calls = []
    x = np.arange(4, dtype=np.float32)
    wire = {"inputs": [{"name": "IN", "shape": [4], "datatype": "FP32",
                        "data": x.tolist()}]}
    with Server(models=[_double_model(calls)], with_default_models=False,
                response_cache=tfd.ResponseCache(), coalescing=True) as s:
        addr = s.http_address
        for _ in range(3):
            out = _post(addr, "/v2/models/double/infer", wire)
            assert out["outputs"][0]["data"] == (2 * x).tolist()
        hits, _ = _cache_hits(addr)
        assert hits == 2 and len(calls) == 1
        region = shm.create_shared_memory_region("fd_in", "/fd_in", 32)
        try:
            shm.set_shared_memory_region(region, [x])
            _post(addr, "/v2/systemsharedmemory/region/fd_in/register",
                  {"key": "/fd_in", "offset": 0, "byte_size": 32})
            from_region = {"inputs": [{
                "name": "IN", "shape": [4], "datatype": "FP32",
                "parameters": {"shared_memory_region": "fd_in",
                               "shared_memory_byte_size": 16}}]}
            into_region = dict(wire, outputs=[{
                "name": "OUT", "parameters": {
                    "shared_memory_region": "fd_in",
                    "shared_memory_offset": 16,
                    "shared_memory_byte_size": 16}}])
            for body in (from_region, from_region, into_region, into_region):
                _post(addr, "/v2/models/double/infer", body)
            hits_after, stats = _cache_hits(addr)
            got = shm.get_contents_as_numpy(region, np.float32, [4],
                                            offset=16)
        finally:
            s.engine.shm.unregister_system()
            shm.destroy_shared_memory_region(region)
    assert hits_after == hits and len(calls) == 5
    assert got.tolist() == (2 * x).tolist()
    assert stats["inference_stats"]["cache_miss"]["count"] == 1


def test_tenant_qos_and_coalescer_under_thread_stress():
    """More threads than cores, a short switch interval: the in-flight cap
    is never exceeded, every admission is released, the counters
    reconcile, and every follower gets its leader's result."""
    import sys

    cap, threads_n, rounds = 3, 16, 200
    qos = tfd.TenantQoS(default_max_inflight=cap, registry=Registry())
    coal = tfd.Coalescer()
    peak, lock, admitted, shed, wrong = [0], threading.Lock(), [0], [0], []

    def worker(w):
        for r in range(rounds):
            try:
                release = qos.admit("t")
            except InferenceServerException:
                with lock:
                    shed[0] += 1
                continue
            with lock:
                admitted[0] += 1
                peak[0] = max(peak[0], qos.snapshot()["t"]["inflight"])
            release()
            key = f"k{r % 7}"
            lead, flight = coal.join(key)
            if lead:
                coal.publish(key, flight, key)
            elif not flight.event.wait(timeout=10) or flight.result != key:
                wrong.append((w, r))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    snap = qos.snapshot()["t"]
    assert peak[0] <= cap and snap["inflight"] == 0
    assert snap["requests"] == admitted[0] + shed[0] == threads_n * rounds
    assert snap["shed"] == shed[0] and not wrong
