"""The port's discovery, membership, sticky sequences and resilient
streams (client_tpu_torch.balance) held against the JAX package's, on
the CPU.

- Side by side: the same seeded scripts drive both packages' resolvers
  (``StaticResolver``, ``CallableResolver``, ``ConfigFileResolver`` over
  the same files, ``SrvResolver`` on one fake clock each: TTL caching,
  the TTL floor, last-known-good on a failed lookup) and
  ``DiscoveryLoop.refresh_now`` over a pool (refused lists, resolver
  errors, probation with a prober armed): the answers, counters, update
  summaries, pool phases and observer calls are equal, exactly.
  Reference functions: ``client_tpu.balance.discovery``'s resolvers,
  ``make_resolver`` and ``DiscoveryLoop``.
- One ``ResilientStream`` reconnect script over gRPC, run by each
  package against its own two servers with the first behind
  ``client_tpu.testing.FaultProxy`` (killed with requests in flight):
  the replies, their order of request ids, the dedupe (every id
  answered once) and the reconnect and replay counts are the
  reference's.
- The cases of tests/test_discovery.py run with every name of the
  reference package swapped for the port's (see
  tests/test_torch_balance.py): resolvers, the loop, membership,
  probation ramp-up, probe jitter, the sticky policy end to end, the
  sync and aio resilient streams, and the churn-under-load acceptance
  on three port servers.  Its ``@pytest.mark.slow`` soak is not copied.

Every wait is bounded by a join or deadline timeout.
"""

import json
import random
import threading
import time

import numpy as np
import pytest

import client_tpu.balance as jbalance
import test_discovery as jd
from client_tpu.testing.faults import FaultProxy
import client_tpu_torch.balance as tbalance
from test_torch_balance import JAX, PORT, Recorder, _plain, swap_to_port


@pytest.fixture
def port(monkeypatch):
    return swap_to_port(monkeypatch, jd)


def test_the_swap_covers_every_reference_name(port):
    assert {"CallableResolver", "ConfigFileResolver", "DiscoveryLoop",
            "EndpointPool", "ReplicatedClient", "AsyncReplicatedClient",
            "SequenceRestartError", "SrvResolver", "StaticResolver",
            "Sticky", "make_policy", "make_resolver", "Endpoint",
            "NoHealthyEndpointError", "RetryPolicy", "Server",
            "BalancerMetricsObserver", "grpcclient"} <= set(port)
    assert jd.SrvResolver is tbalance.SrvResolver
    assert jd._val_inputs(3)[0].__module__.startswith("client_tpu_torch")


@pytest.mark.usefixtures("port")
class TestResolversPort(jd.TestResolvers):
    """tests/test_discovery.py::TestResolvers."""


@pytest.mark.usefixtures("port")
class TestSrvResolverPort(jd.TestSrvResolver):
    """tests/test_discovery.py::TestSrvResolver."""


@pytest.mark.usefixtures("port")
class TestDiscoveryLoopPort(jd.TestDiscoveryLoop):
    """tests/test_discovery.py::TestDiscoveryLoop."""


@pytest.mark.usefixtures("port")
class TestMembershipPort(jd.TestMembership):
    """tests/test_discovery.py::TestMembership: probation, retire after
    in-flight work, unretire, the last-healthy safety valve, weights,
    the membership series."""


@pytest.mark.usefixtures("port")
class TestProbationRampupPort(jd.TestProbationRampup):
    """tests/test_discovery.py::TestProbationRampup."""


@pytest.mark.usefixtures("port")
class TestProbeJitterPort(jd.TestProbeJitter):
    """tests/test_discovery.py::TestProbeJitter."""


@pytest.mark.usefixtures("port")
class TestStickyPolicyPort(jd.TestStickyPolicy):
    """tests/test_discovery.py::TestStickyPolicy, its end-to-end case on
    two port servers."""


@pytest.mark.usefixtures("port")
class TestResilientStreamSyncPort(jd.TestResilientStreamSync):
    """tests/test_discovery.py::TestResilientStreamSync over the port's
    gRPC client and servers."""


@pytest.mark.usefixtures("port")
class TestResilientStreamAioPort(jd.TestResilientStreamAio):
    """tests/test_discovery.py::TestResilientStreamAio over the port's
    grpc.aio client."""


def test_churn_under_load_port(port):
    """tests/test_discovery.py::TestChurnChaos::test_churn_under_load on
    three port servers: add, retire, kill the stream-pinned replica and
    flap the resolver under load, with zero client-visible errors."""
    jd._run_churn_scenario()


# -- side by side: resolvers -------------------------------------------------


def _srv_script(pkg, seed):
    """An SrvResolver on a fake clock: lookups that answer records with
    and without TTLs (zero and garbage TTLs among them) or fail."""
    rng = random.Random(seed)
    now = [100.0]
    answers = []
    for _ in range(60):
        roll = rng.random()
        if roll < 0.2:
            answers.append(RuntimeError(f"registry down {len(answers)}"))
            continue
        records = []
        for i in range(rng.randint(1, 4)):
            url = f"h{rng.randint(0, 6)}:8001"
            shape = rng.random()
            if shape < 0.3:
                records.append(url)
            elif shape < 0.5:
                records.append((url, rng.choice([1.0, 2.0])))
            else:
                records.append((url, 1.0, rng.choice([None, 0.0, 0.5, 2.0,
                                                      7.0])))
        answers.append(records)
    calls = []

    def lookup():
        answer = answers[len(calls) % len(answers)]
        calls.append(now[0])
        if isinstance(answer, Exception):
            raise answer
        return answer

    resolver = pkg.balance.SrvResolver(
        lookup, default_ttl_s=rng.choice([3.0, 30.0]),
        min_ttl_s=rng.choice([0.5, 1.0]), time_fn=lambda: now[0])
    out = []
    for _ in range(120):
        now[0] += rng.choice([0.0, 0.3, 1.0, 2.5, 8.0])
        try:
            got = resolver.resolve()
        except Exception as exc:  # noqa: BLE001 - the error is the record
            got = _plain(exc)
        out.append((got, resolver.resolutions, resolver.errors,
                    _plain(resolver.last_error), len(calls)))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_srv_resolver_script_equals_jax(seed):
    """SrvResolver: cached until the smallest TTL, TTLs floored,
    stale-on-error re-armed after the floor, an initial failure raised."""
    want = _srv_script(JAX, seed)
    assert _srv_script(PORT, seed) == want
    assert any(r[2] for r in want)  # the script met failed lookups


CONF_TEXTS = [
    "# the fleet\nhost1:8001\nhost2:8001 2.5\n\nhost3:8001  # canary\n",
    "host9:8001\n",
    '["h1:8001", ["h2:8001", 3]]',
    '{"endpoints": ["h1:8001", ["h4:8001", 0.5]]}',
    "   \n# nothing\n",
    '{"endpoints": "not a list"',
]


@pytest.mark.parametrize("text", CONF_TEXTS)
def test_config_file_resolver_equals_jax(tmp_path, text):
    path = tmp_path / "fleet.conf"
    path.write_text(text)
    out = []
    for pkg in (JAX, PORT):
        try:
            out.append(pkg.balance.ConfigFileResolver(str(path)).resolve())
        except Exception as exc:  # noqa: BLE001
            out.append(_plain(exc))
    assert out[1] == out[0]


def test_static_callable_and_make_resolver_equal_jax(tmp_path):
    for spec in (["a", ("b", 2.0)], lambda: ["x"], str(tmp_path / "f"),
                 ("a",)):
        kinds = [type(pkg.balance.make_resolver(spec)).__name__
                 for pkg in (JAX, PORT)]
        assert kinds[1] == kinds[0]
    for pkg in (JAX, PORT):
        r = pkg.balance.StaticResolver(["a"])
        assert pkg.balance.make_resolver(r) is r
    assert (tbalance.StaticResolver(["a", ("b", 2.0)]).resolve()
            == jbalance.StaticResolver(["a", ("b", 2.0)]).resolve())
    assert (tbalance.CallableResolver(lambda: ("a", "b")).resolve()
            == jbalance.CallableResolver(lambda: ("a", "b")).resolve())


# -- side by side: the discovery loop over a pool ----------------------------


def _loop_script(pkg, seed, armed):
    rng = random.Random(seed)
    universe = ["a", "b", "c", "d", "e"]
    observer = Recorder()
    pool = pkg.pool.EndpointPool(["a", "b"], observer=observer)
    if armed:
        # a prober's presence (new members enter probation), no thread
        pool._probe = lambda url: "READY"
    answers = []
    updates = []
    loop = pkg.balance.DiscoveryLoop(
        pool, lambda: answers.pop(0)(), interval_s=3600,
        on_update=lambda summary: updates.append(summary))
    leases = []
    out = []
    for _ in range(80):
        roll = rng.random()
        if roll < 0.1:
            answers.append(lambda: (_ for _ in ()).throw(
                RuntimeError("outage")))
        elif roll < 0.15:
            answers.append(lambda: [])
        elif roll < 0.2:
            answers.append(lambda: ["a", "a"])
        else:
            members = [u if rng.random() < 0.8 else (u, 2.0)
                       for u in universe if rng.random() < 0.5]
            answers.append(lambda m=members or ["c"]: list(m))
        summary = loop.refresh_now()
        step = rng.random()
        if step < 0.3:
            try:
                leases.append(pool.lease())
            except Exception as exc:  # noqa: BLE001
                out.append(_plain(exc))
        elif step < 0.55 and leases:
            leases.pop(rng.randrange(len(leases))).success()
        elif step < 0.75:
            url = rng.choice(universe)
            pool.set_state(url, rng.choice(["READY", "NOT_READY"]))
        out.append((summary, loop.updates, loop.errors,
                    _plain(loop.last_error), pool.phases(), pool.states(),
                    [s["inflight"] for s in pool.snapshot()]))
    return out, updates, observer.calls


@pytest.mark.parametrize("armed", [False, True], ids=["no-prober", "prober"])
@pytest.mark.parametrize("seed", range(4))
def test_discovery_loop_script_equals_jax(seed, armed):
    """DiscoveryLoop.refresh_now: applied updates (adds, retires,
    unretires, retains, evictions after in-flight leases), resolver
    errors and refused lists keeping last-known-good, the counters and
    the on_update hook, as the reference's."""
    want = _loop_script(JAX, seed, armed)
    got = _loop_script(PORT, seed, armed)
    for i, (w, g) in enumerate(zip(want[0], got[0])):
        assert g == w, f"step {i}"
    assert got[1:] == want[1:]


def test_discovery_loop_thread_polls_and_closes():
    """start() polls in the background until close(), on both."""
    for pkg in (JAX, PORT):
        pool = pkg.pool.EndpointPool(["a"])
        members = [["a"]]
        loop = pkg.balance.DiscoveryLoop(pool, lambda: members[0],
                                         interval_s=0.02).start()
        members[0] = ["a", "b"]
        deadline = time.monotonic() + 5
        while "b" not in pool.urls() and time.monotonic() < deadline:
            time.sleep(0.01)
        loop.close()
        assert "b" in pool.urls()
        assert loop._thread is None


# -- side by side: one resilient stream reconnect ----------------------------


def _stream_script(monkeypatch, use_port):
    """Two servers, the first behind a proxy; a resilient stream pinned
    there sends one request, then three held in flight, the proxy dies,
    then one more.  Returns the script's record."""
    if use_port:
        swap_to_port(monkeypatch, jd)
    servers, logs = jd._start_servers(2)
    proxy = FaultProxy(servers[0].grpc_address)
    url_a, url_b = proxy.address, servers[1].grpc_address
    registry = jd.Registry()
    pool = jd.EndpointPool([url_a, url_b],
                           observer=jd.BalancerMetricsObserver(registry))
    client = jd.ReplicatedClient(
        pool, transport="grpc", probe_interval_s=None,
        retry_policy=jd._fast_policy(jitter=False),
        channel_args=jd._FAST_RECONNECT)
    events = []
    lock = threading.Lock()

    def callback(result, error):
        with lock:
            events.append((result, error))

    pool.set_state(url_b, "NOT_READY")
    stream = client.resilient_stream(callback)
    try:
        pinned = stream.url
        pool.set_state(url_b, "READY")
        rids = [stream.async_stream_infer("echo", jd._val_inputs(0),
                                          request_id="r0")]
        assert jd._wait_for(lambda: len(events) == 1, timeout_s=10)
        rids += [stream.async_stream_infer(
            "echo", jd._val_inputs(jd._SLEEPY + i), request_id=f"r{i + 1}")
            for i in range(3)]
        time.sleep(0.05)
        proxy.refuse_connections(True)
        proxy.kill_active()
        assert jd._wait_for(lambda: len(events) == 4, timeout_s=15)
        rids.append(stream.async_stream_infer("echo", jd._val_inputs(7),
                                              request_id="r4"))
        assert jd._wait_for(lambda: len(events) == 5, timeout_s=10)
        with lock:
            replies = sorted(
                (r.get_response().id,
                 np.asarray(r.as_numpy("OUT")).tolist(), err)
                for r, err in events)
        record = {
            "rids": rids,
            "replies": replies,
            "pinned_first": pinned == url_a,
            "ends_on_survivor": stream.url == url_b,
            "reconnects": stream.reconnects,
            "replayed": stream.replayed,
            "pending": stream.pending,
            "reconnect_series": registry.get(
                "ctpu_client_stream_reconnects_total", {"endpoint": url_a}),
            "replay_series": registry.get(
                "ctpu_client_stream_replayed_requests_total",
                {"endpoint": url_b}),
        }
    finally:
        stream.close()
        client.close()
        proxy.close()
        for s in servers:
            s.stop()
    record["inflight_after_close"] = [s["inflight"] for s in pool.snapshot()]
    record["survivor_applied"] = sorted(v for _, v in logs[1])
    return record


def test_resilient_stream_reconnect_equals_jax(monkeypatch):
    """ResilientStream over each package's gRPC client and servers: the
    same replies by request id (each once: the dedupe), the hop to the
    survivor, one reconnect, the replay of the requests held in flight,
    the stream series, and no lease left open."""
    want = _stream_script(monkeypatch, use_port=False)
    got = _stream_script(monkeypatch, use_port=True)
    for record in (want, got):
        # how many of the held requests were still unanswered at the kill
        # is timing: each run replays exactly those, once, to the survivor
        replayed = record.pop("replayed")
        assert replayed >= 1
        assert record.pop("replay_series") == replayed
        applied = record.pop("survivor_applied")
        assert len(applied) == replayed + 1 and 7 in applied
        assert set(applied) <= {jd._SLEEPY, jd._SLEEPY + 1, jd._SLEEPY + 2, 7}
    assert got == want
    assert want["reconnects"] == 1 and want["reconnect_series"] == 1
    assert [r[0] for r in want["replies"]] == ["r0", "r1", "r2", "r3", "r4"]
    assert json.dumps(want["inflight_after_close"]) == "[0, 0]"
