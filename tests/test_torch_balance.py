"""The port's replica set (client_tpu_torch.balance, the failover half of
client_tpu_torch.resilience and the balancer's metrics observers) held
against the JAX package's, on the CPU.

- Side by side: the same seeded script of operations (leases, outcomes,
  probe results, ``update_endpoints``, breaker trips, sticky sequences,
  clock steps) drives both packages' objects, each with its own
  ``random.Random`` from the same seed and ``time`` replaced in both
  packages' modules by one fake clock each.  The recorded picks, lease
  flags, states, phases, membership summaries, observer calls, rendered
  ``BalancerMetricsObserver``/``ResilienceMetricsObserver`` series,
  backoff sleeps and raised errors are equal: exact, this is logic.
  Reference functions: ``client_tpu.balance.policy`` (every policy and
  ``make_policy``), ``client_tpu.balance.pool.EndpointPool`` (the health
  state machine, breakers, probation, ramp, retire, evict, the safety
  valve, the probe pass), ``client_tpu.resilience.call_with_failover`` /
  ``acall_with_failover`` and ``client_tpu.serve.metrics``'s observers.
- The cases of tests/test_balance.py run with every name of the
  reference package swapped for the port's (balance, resilience,
  clients, ``Server(device="cpu")``, ``Model``, tracing, metrics), each
  case the JAX test's own body: policies, pool routing, the failover
  loop, the replicated clients over in-process port servers on both
  transports, sync and aio, timeouts, stream leases, the three server
  states, and the kill-one-drain-one chaos acceptance behind
  ``client_tpu.testing.FaultProxy``.

Every wait is bounded by a join or deadline timeout.
"""

import asyncio
import functools
import importlib
import random
import sys
import types

import pytest

import client_tpu.balance as jbalance
import client_tpu.balance.pool as jpool_mod
import client_tpu.grpc
import client_tpu.grpc.aio  # noqa: F401  (swapped for the port's below)
import client_tpu.http
import client_tpu.http.aio  # noqa: F401
import client_tpu.resilience as jres
import client_tpu.serve.metrics as jmetrics
import client_tpu.utils as jutils
import test_balance as jb
import client_tpu_torch.balance as tbalance
import client_tpu_torch.balance.pool as tpool_mod
import client_tpu_torch.grpc.aio as tgrpc_aio
import client_tpu_torch.http.aio as thttp_aio
import client_tpu_torch.resilience as tres
import client_tpu_torch.serve as tserve
import client_tpu_torch.serve.metrics as tmetrics
import client_tpu_torch.utils as tutils

JAX = types.SimpleNamespace(balance=jbalance, pool=jpool_mod, res=jres,
                            metrics=jmetrics, utils=jutils)
PORT = types.SimpleNamespace(balance=tbalance, pool=tpool_mod, res=tres,
                             metrics=tmetrics, utils=tutils)

STATES = ("READY", "NOT_READY", "UNREACHABLE")


# -- the swap: reference test bodies over the port ---------------------------


def port_counterpart(obj):
    """The port's object of the same name in the module that mirrors
    ``obj``'s (``client_tpu.x.y`` -> ``client_tpu_torch.x.y``); a module
    maps to its mirror module."""
    if isinstance(obj, types.ModuleType):
        return importlib.import_module(
            "client_tpu_torch" + obj.__name__[len("client_tpu"):])
    mod = importlib.import_module(
        "client_tpu_torch" + obj.__module__[len("client_tpu"):])
    return getattr(mod, obj.__name__)


def swap_to_port(monkeypatch, module):
    """Point every name ``module`` took from client_tpu (bar its testing
    helpers) at the port's counterpart, ``Server`` on the CPU, and the
    ``client_tpu.{grpc,http}.aio`` imports inside test bodies at the
    port's aio clients.  Returns the names swapped."""
    swapped = []
    for name, obj in list(vars(module).items()):
        origin = (obj.__name__ if isinstance(obj, types.ModuleType)
                  else getattr(obj, "__module__", None))
        if (not isinstance(origin, str)
                or not origin.startswith("client_tpu.")
                or origin.startswith("client_tpu.testing")):
            continue
        monkeypatch.setattr(module, name, port_counterpart(obj))
        swapped.append(name)
    if "Server" in swapped:
        monkeypatch.setattr(module, "Server",
                            functools.partial(tserve.Server, device="cpu"))
    for parent, child in ((client_tpu.grpc, tgrpc_aio),
                          (client_tpu.http, thttp_aio)):
        monkeypatch.setitem(sys.modules, parent.__name__ + ".aio", child)
        monkeypatch.setattr(parent, "aio", child)
    return swapped


@pytest.fixture
def port(monkeypatch):
    return swap_to_port(monkeypatch, jb)


def test_the_swap_covers_every_reference_name(port):
    """Every client_tpu name tests/test_balance.py uses has a port
    counterpart, and the test bodies now see the port's."""
    assert {"EndpointPool", "ReplicatedClient", "AsyncReplicatedClient",
            "call_with_failover", "NoHealthyEndpointError", "RetryPolicy",
            "BalancerMetricsObserver", "Registry", "ClientTracer",
            "grpcclient", "httpclient", "Model", "Server",
            "InferenceServerException"} <= set(port)
    assert jb.EndpointPool is tbalance.EndpointPool
    assert jb.grpcclient.__name__ == "client_tpu_torch.grpc"
    assert jb.FaultProxy.__module__.startswith("client_tpu.testing")


@pytest.mark.usefixtures("port")
class TestPoliciesPort(jb.TestPolicies):
    """tests/test_balance.py::TestPolicies."""


@pytest.mark.usefixtures("port")
class TestEndpointPoolPort(jb.TestEndpointPool):
    """tests/test_balance.py::TestEndpointPool."""


@pytest.mark.usefixtures("port")
class TestFailoverLoopPort(jb.TestFailoverLoop):
    """tests/test_balance.py::TestFailoverLoop."""


@pytest.mark.usefixtures("port")
class TestReplicatedClientPort(jb.TestReplicatedClient):
    """tests/test_balance.py::TestReplicatedClient over port servers:
    round-robin over HTTP, a gRPC failover hop on one trace, a pinned
    stream, aio HTTP failover."""


@pytest.mark.usefixtures("port")
class TestTimeoutsAndOwnershipPort(jb.TestTimeoutsAndOwnership):
    """tests/test_balance.py::TestTimeoutsAndOwnership: the port HTTP
    client's ``client_timeout_s`` bounds an attempt."""


@pytest.mark.usefixtures("port")
class TestStreamLeaseLifecyclePort(jb.TestStreamLeaseLifecycle):
    """tests/test_balance.py::TestStreamLeaseLifecycle."""


@pytest.mark.usefixtures("port")
class TestServerStateVerbPort(jb.TestServerStateVerb):
    """tests/test_balance.py::TestServerStateVerb: the port's four
    clients' ``server_state``."""


@pytest.mark.usefixtures("port")
class TestChaosReplicaSetPort(jb.TestChaosReplicaSet):
    """tests/test_balance.py::TestChaosReplicaSet: three port servers,
    one killed behind FaultProxy and one drained under load; zero
    errors, convergence, a routed delta of 0 on the dead url."""


def test_http_clients_take_client_timeout_s_on_infer():
    """The vocabulary replicated.py caps each attempt in: both of the
    port's HTTP clients take ``client_timeout_s`` on ``infer``, the gRPC
    ones ``client_timeout``, as the reference's do."""
    import inspect

    import client_tpu_torch.grpc as tgrpc
    import client_tpu_torch.http as thttp

    for mod, key in ((thttp, "client_timeout_s"), (thttp_aio,
                                                   "client_timeout_s"),
                     (tgrpc, "client_timeout"), (tgrpc_aio,
                                                 "client_timeout")):
        params = inspect.signature(
            mod.InferenceServerClient.infer).parameters
        assert key in params, mod.__name__


# -- side by side: seeded scripts through both packages ----------------------


class FakeClock:
    """``time`` for a package's balance and resilience modules: a
    monotonic clock only the script advances; ``sleep`` advances it."""

    def __init__(self):
        self.now = 1000.0
        self.sleeps = []

    def monotonic(self):
        return self.now

    def time(self):
        return self.now

    def sleep(self, s):
        self.sleeps.append(s)
        self.now += s


@pytest.fixture
def clocks(monkeypatch):
    """One fake clock per package, installed in its pool, resilience and
    discovery modules."""
    out = {}
    for name, pkg in (("jax", JAX), ("torch", PORT)):
        clock = FakeClock()
        for mod in (pkg.pool, pkg.res, pkg.balance.discovery):
            monkeypatch.setattr(mod, "time", clock)
        out[name] = clock
    return out


def _plain(value):
    """A comparable form of an observer argument or an error."""
    if isinstance(value, BaseException):
        return (type(value).__name__, str(value))
    if isinstance(value, frozenset):
        return sorted(value)
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in sorted(value.items())}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    return value


class Recorder:
    """An observer that records every hook call in order, and forwards
    it to ``also`` (a metrics observer) where given."""

    def __init__(self, also=None):
        self.calls = []
        self.also = also

    def __getattr__(self, name):
        if not name.startswith("on_"):
            raise AttributeError(name)

        def hook(*args):
            self.calls.append((name,) + tuple(_plain(a) for a in args))
            if self.also is not None:
                getattr(self.also, name)(*args)

        return hook


def _rendered(registry):
    lines = []
    registry.render_into(lines)
    return lines


class _Stop:
    """The probe pass's stop event: never set, its waits recorded."""

    def __init__(self):
        self.waits = []

    def is_set(self):
        return False

    def wait(self, timeout):
        self.waits.append(timeout)
        return False


URLS = ("a", "b", "c")
EXTRA = ("d", "e")


class PoolWorld:
    """One package's pool under a script: the pool, its observer, the
    leases still open, the probe pass's schedule."""

    def __init__(self, pkg, clock, seed, policy, **pool_kw):
        self.pkg = pkg
        self.clock = clock
        self.metrics = pkg.metrics.Registry()
        self.observer = Recorder(pkg.metrics.BalancerMetricsObserver(
            self.metrics))
        self.breaker_metrics = pkg.metrics.Registry()
        breakers = pkg.res.CircuitBreakerRegistry(
            failure_threshold=pool_kw.pop("failure_threshold", 2),
            reset_timeout_s=pool_kw.pop("reset_timeout_s", 3.0),
            observer_factory=lambda ep: pkg.metrics.ResilienceMetricsObserver(
                ep, registry=self.breaker_metrics))
        self.pool = pkg.pool.EndpointPool(
            list(URLS), policy=self._policy(policy, seed), breakers=breakers,
            observer=self.observer, rng=random.Random(seed + 1), **pool_kw)
        self.leases = []
        self.next_due = {}
        self.probe_rng = random.Random(seed + 2)
        self.stop = _Stop()
        self.probe_results = {}

    def _policy(self, name, seed):
        policy = self.pkg.balance.policy
        rng = random.Random(seed + 3)
        if name == "power-of-two":
            return policy.PowerOfTwoChoices(rng=rng)
        if name == "weighted":
            return policy.Weighted(rng=rng)
        if name == "prefix-aware-p2c":
            return policy.PrefixAware(
                fallback=policy.PowerOfTwoChoices(rng=rng))
        if name == "sticky-weighted":
            return policy.Sticky(fallback=policy.Weighted(rng=rng),
                                 max_sequences=3)
        return name

    def error(self, kind):
        exc_cls = self.pkg.utils.InferenceServerException
        if kind == "reset":
            return ConnectionResetError("connection reset")
        if kind == "refused":
            return exc_cls("connection refused", status="503",
                           debug_details=ConnectionRefusedError("refused"))
        if kind == "shed":
            return exc_cls("server overloaded", status="503")
        return exc_cls("bad input", status="400")

    def probe(self, url):
        result = self.probe_results.get(url, "READY")
        if result == "raise":
            raise ConnectionRefusedError(url)
        return result

    def apply(self, op):
        """Run one op; returns what it answered."""
        kind = op[0]
        pool = self.pool
        try:
            if kind == "lease":
                _, excluded, ctx = op
                lease = pool.lease(excluded, ctx)
                self.leases.append(lease)
                return ("lease", lease.url, lease.key, lease.last_candidate)
            if kind == "pick":
                return ("pick", pool.pick(op[1]).url)
            if kind == "outcome":
                _, k, how, err = op
                if not self.leases:
                    return ("outcome", None)
                lease = self.leases.pop(k % len(self.leases))
                if how == "success":
                    lease.success()
                elif how == "release":
                    lease.release()
                else:
                    exc = self.error(err)
                    lease.failure(exc, retryable=err != "bad")
                return ("outcome", lease.url, how, err)
            if kind == "set_state":
                pool.set_state(op[1], op[2])
                return ("set_state",)
            if kind == "update":
                return ("update", pool.update_endpoints(op[1]))
            if kind == "arm":
                # the prober's state as start_probes leaves it, without its
                # thread: the script runs the probe passes itself
                pool._probe = self.probe
                pool._probe_interval_s = op[1]
                return ("arm",)
            if kind == "probe_pass":
                _, interval, results = op
                self.probe_results = dict(results)
                pool._probe_pass(self.probe, self.stop, interval,
                                 self.probe_rng, self.next_due)
                return ("probe_pass", sorted(self.next_due.items()),
                        self.stop.waits[-1])
            if kind == "advance":
                self.clock.now += op[1]
                return ("advance",)
            if kind == "weight":
                pool.set_weight(op[1], op[2])
                return ("weight",)
            if kind == "pressure":
                pool.set_pressure(op[1], op[2])
                return ("pressure", pool.pressures())
            if kind == "summary":
                pool.set_summary(op[1], op[2])
                return ("summary", _plain(pool.summaries()))
            raise AssertionError(kind)
        except Exception as exc:  # noqa: BLE001 - the error is the record
            return ("raised", type(exc).__name__, str(exc))

    def view(self):
        snap = self.pool.snapshot()
        ramps = [round(e.ramp_fraction(), 12)
                 for e in self.pool.endpoints()]
        return snap, self.pool.phases(), self.pool.states(), ramps


def _random_ctx(rng):
    roll = rng.random()
    if roll < 0.45:
        return None
    if roll < 0.75:
        return {"model_name": "m", "sequence_id": rng.randint(1, 5),
                "sequence_start": rng.random() < 0.2,
                "sequence_end": rng.random() < 0.2,
                "sequence_durable": rng.random() < 0.3}
    chain = [f"h{i}" for i in range(rng.randint(1, 4))]
    return {"model_name": "m", "prefix_digests": chain}


def _random_op(rng):
    """One op of a pool script; its indices and values come from *rng*
    only, so both packages get the same op whatever their state."""
    urls = URLS + EXTRA
    roll = rng.random()
    if roll < 0.30:
        excluded = tuple(u for u in urls if rng.random() < 0.25)
        return ("lease", excluded, _random_ctx(rng))
    if roll < 0.50:
        how = rng.choice(["success", "failure", "failure", "release"])
        return ("outcome", rng.randrange(1000), how,
                rng.choice(["reset", "refused", "shed", "bad"]))
    if roll < 0.56:
        return ("pick", _random_ctx(rng))
    if roll < 0.63:
        return ("set_state", rng.choice(urls), rng.choice(STATES))
    if roll < 0.71:
        roll = rng.random()
        if roll < 0.05:
            return ("update", [])
        if roll < 0.10:
            return ("update", ["a", "a"])
        members = [u for u in urls if rng.random() < 0.6] or [rng.choice(
            urls)]
        return ("update", [(u, rng.choice([0.5, 1.0, 2.0]))
                           if rng.random() < 0.2 else u for u in members])
    if roll < 0.80:
        results = {}
        for u in urls:
            r = rng.random()
            if r < 0.55:
                results[u] = "READY"
            elif r < 0.65:
                results[u] = "NOT_READY"
            elif r < 0.72:
                results[u] = "raise"
            elif r < 0.80:
                results[u] = ("READY", [f"h{i}" for i in range(
                    rng.randint(0, 3))])
            elif r < 0.88:
                results[u] = ("READY", ["h0"], {"queue_depth": rng.randint(
                    0, 9), "prefix_hot": rng.randint(0, 3)})
            elif r < 0.94:
                results[u] = "BOGUS"
            else:
                results[u] = ("READY", [], {}, "extra")
        return ("probe_pass", 1.0, results)
    if roll < 0.92:
        return ("advance", rng.choice([0.05, 0.4, 1.0, 2.5, 4.0]))
    if roll < 0.95:
        return ("weight", rng.choice(urls), rng.choice([0.0, 1.0, 3.0]))
    if roll < 0.98:
        return ("pressure", rng.choice(urls),
                {"queue_depth": rng.randint(0, 9)})
    return ("summary", rng.choice(urls), [f"h{i}" for i in range(
        rng.randint(0, 3))])


def _run_script(clocks, seed, policy, n_ops, armed, **pool_kw):
    worlds = {name: PoolWorld(pkg, clocks[name], seed, policy,
                              **dict(pool_kw))
              for name, pkg in (("jax", JAX), ("torch", PORT))}
    rng = random.Random(seed)
    ops = [("arm", 1.0)] if armed else []
    ops += [_random_op(rng) for _ in range(n_ops)]
    records = {name: [] for name in worlds}
    for op in ops:
        for name, world in worlds.items():
            records[name].append((op[0], world.apply(op), world.view()))
    return worlds, records


def _assert_same_worlds(worlds, records):
    jax_w, port_w = worlds["jax"], worlds["torch"]
    for i, (want, got) in enumerate(zip(records["jax"], records["torch"])):
        assert got == want, f"op {i}: {want[0]}"
    assert port_w.observer.calls == jax_w.observer.calls
    assert _rendered(port_w.metrics) == _rendered(jax_w.metrics)
    assert (_rendered(port_w.breaker_metrics)
            == _rendered(jax_w.breaker_metrics))


POLICIES = ["round-robin", "least-inflight", "power-of-two", "weighted",
            "sticky", "prefix-aware", "prefix-aware-p2c", "sticky-weighted"]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_script_equals_jax(clocks, policy, seed):
    """EndpointPool under every policy with the prober armed: leases,
    picks, outcomes of every class (connection-level, answered 503, 400),
    probe passes (states, digests, pressure, raising and malformed
    probes), membership updates (probation, promote, retire, unretire,
    evict, the safety valve, refused lists), weights and clock steps
    give the reference's records, observer calls and series, exactly."""
    worlds, records = _run_script(clocks, seed, policy, n_ops=260,
                                  armed=True)
    _assert_same_worlds(worlds, records)
    ops = {r[0] for r in records["jax"]}
    assert {"lease", "outcome", "probe_pass", "update"} <= ops


@pytest.mark.parametrize("seed", [3, 4])
def test_pool_script_without_prober_equals_jax(clocks, seed):
    """No prober: new members join ACTIVE, the breaker alone gates a
    failing endpoint (no UNREACHABLE from outcomes)."""
    worlds, records = _run_script(clocks, seed, "round-robin", n_ops=200,
                                  armed=False)
    _assert_same_worlds(worlds, records)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_pool_ramp_script_equals_jax(clocks, seed):
    """Probation ramp-up: promoted members thinned by their ramp
    fraction on the pool's own seeded rng, as the reference's."""
    worlds, records = _run_script(clocks, seed, "least-inflight", n_ops=220,
                                  armed=True, rampup_s=3.0,
                                  rampup_floor=0.2)
    _assert_same_worlds(worlds, records)


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "torch"])
def test_safety_valve_and_evict_drop_gauges(clocks, pkg):
    """The last healthy endpoint is retained, a retiring endpoint with a
    lease in flight is evicted at its release, and eviction removes its
    per-endpoint gauges (counters stay): the same on both packages,
    checked by the side-by-side scripts above and spelled out here."""
    registry = pkg.metrics.Registry()
    pool = pkg.pool.EndpointPool(
        ["a", "b"], observer=pkg.metrics.BalancerMetricsObserver(registry))
    pool._probe = lambda url: "READY"
    pool.set_state("a", "NOT_READY")
    pool.set_pressure("b", {"queue_depth": 3})
    assert pool.update_endpoints(["a"])["retained"] == ["b"]
    lease = pool.lease()
    assert lease.url == "b"
    pool.set_state("a", "READY")
    summary = pool.update_endpoints(["a"])
    assert summary["retired"] == ["b"] and summary["evicted"] == []
    assert registry.get("ctpu_client_endpoint_phase", {"endpoint": "b"}) == 2
    lease.success()
    assert pool.urls() == ["a"]
    for gauge in ("ctpu_client_endpoint_phase", "ctpu_fleet_pressure_queue_"
                  "depth", "ctpu_fleet_pressure_prefix"):
        assert registry.get(gauge, {"endpoint": "b"}) is None
    assert registry.get("ctpu_client_routed_total", {"endpoint": "b"}) == 1
    assert registry.get("ctpu_client_membership_changes_total",
                        {"op": "evict", "endpoint": "b"}) == 1


# -- policies alone ----------------------------------------------------------


def _endpoints(pkg, n, rng):
    eps = [pkg.pool.Endpoint(f"ep{i}") for i in range(n)]
    for e in eps:
        e.inflight = rng.randint(0, 4)
        e.weight = rng.choice([0.0, 0.5, 1.0, 2.0])
        e.summary = frozenset(f"h{j}" for j in range(rng.randint(0, 3)))
    return eps


@pytest.mark.parametrize("name", POLICIES)
def test_policy_picks_equal_jax(name):
    """Each policy's picks over candidate sets of every size, with the
    same inflight counts, weights, summaries and contexts."""
    picks = {}
    for label, pkg in (("jax", JAX), ("torch", PORT)):
        world = types.SimpleNamespace(pkg=pkg)
        policy = PoolWorld._policy(world, name, 11)
        if isinstance(policy, str):
            policy = pkg.balance.make_policy(policy)
        rng = random.Random(11)
        out = []
        for _ in range(300):
            eps = _endpoints(pkg, rng.randint(1, 5), rng)
            cands = [e for e in eps if rng.random() < 0.8] or eps
            ctx = _random_ctx(rng)
            try:
                out.append(policy.pick(cands, ctx).url)
            except Exception as exc:  # noqa: BLE001 - recorded
                out.append(_plain(exc))
            if hasattr(policy, "sequences"):
                out.append(sorted(policy.sequences().items()))
        picks[label] = out
    assert picks["torch"] == picks["jax"]


def test_make_policy_equals_jax():
    for spec in ("round-robin", "least-inflight", "power-of-two",
                 "weighted", "sticky", "prefix-aware", "fastest-wins", 7):
        got = want = None
        try:
            want = type(jbalance.make_policy(spec)).__name__
        except Exception as exc:  # noqa: BLE001
            want = _plain(exc)
        try:
            got = type(tbalance.make_policy(spec)).__name__
        except Exception as exc:  # noqa: BLE001
            got = _plain(exc)
        assert got == want, spec
    rr = tbalance.RoundRobin()
    assert tbalance.make_policy(rr) is rr
    assert isinstance(tbalance.SequenceRestartError(1, "a", "b"),
                      tutils.InferenceServerException)


def test_sticky_lifecycle_equals_jax(clocks):
    """A sequence pinned, its replica killed (SequenceRestartError with
    the remap installed), restarted there, a durable sequence remapped
    silently, sequence_end dropping the map, and the LRU bound."""
    out = {}
    for label, pkg in (("jax", JAX), ("torch", PORT)):
        pool = pkg.pool.EndpointPool(
            ["a", "b", "c"],
            policy=pkg.balance.Sticky(max_sequences=2))
        rec = []

        def lease(ctx):
            try:
                lz = pool.lease((), ctx)
                lz.success()
                return lz.url
            except Exception as exc:  # noqa: BLE001
                return _plain(exc)

        rec.append([lease({"sequence_id": s, "sequence_start": True})
                    for s in (1, 2, 3)])
        rec.append(lease({"sequence_id": 3}))
        pinned = lease({"sequence_id": 3})
        pool.set_state(pinned, "UNREACHABLE")
        rec.append(lease({"sequence_id": 3}))
        rec.append(lease({"sequence_id": 3, "sequence_start": True}))
        rec.append(lease({"sequence_id": 4, "sequence_start": True}))
        pool.set_state(lease({"sequence_id": 4}), "NOT_READY")
        rec.append(lease({"sequence_id": 4, "sequence_durable": True}))
        rec.append(lease({"sequence_id": 4, "sequence_end": True}))
        rec.append(sorted(pool._policy.sequences().items()))
        out[label] = rec
    assert out["torch"] == out["jax"]
    assert out["jax"][2][0] == "SequenceRestartError"


# -- the failover loop -------------------------------------------------------


def _failover_script(pkg, clock, seed, aio):
    """One logical request per round over a real pool: each attempt's
    outcome scripted from *seed*; records results, errors, sleeps,
    retry-observer calls and the pool's view."""
    rng = random.Random(seed)
    retry_obs = Recorder(pkg.metrics.ResilienceMetricsObserver(
        "pool", registry=pkg.metrics.Registry()))
    pool_obs = Recorder()
    pool = pkg.pool.EndpointPool(["a", "b", "c"], observer=pool_obs,
                                 failure_threshold=3, reset_timeout_s=2.0)
    exc_cls = pkg.utils.InferenceServerException
    records = []
    for round_ in range(40):
        policy = pkg.res.RetryPolicy(
            max_attempts=rng.choice([1, 2, 4, 6]),
            initial_backoff_s=0.05, max_backoff_s=0.4,
            jitter=rng.random() < 0.5,
            deadline_s=rng.choice([None, 0.3, 2.0]),
            rng=random.Random(seed * 100 + round_), observer=retry_obs)
        plan = [rng.choice(["ok", "reset", "refused", "shed", "bad",
                            "drain"]) for _ in range(8)]
        seen = []

        def outcome(lease, timeout_s):
            step = plan[min(len(seen), len(plan) - 1)]
            seen.append((lease.url, lease.last_candidate,
                         None if timeout_s is None else round(timeout_s, 9)))
            clock.now += 0.01
            if step == "ok":
                return f"{lease.url}:{len(seen)}"
            if step == "reset":
                raise ConnectionResetError("reset")
            if step == "refused":
                raise exc_cls("refused", status="503",
                              debug_details=ConnectionRefusedError("x"))
            if step == "shed":
                raise exc_cls("overloaded", status="503")
            if step == "drain":
                for url in pool.urls():
                    pool.set_state(url, "NOT_READY")
                raise exc_cls("draining", status="503")
            raise exc_cls("bad input", status="400")

        def route(excluded):
            return pool.lease(excluded)

        before = len(clock.sleeps)
        try:
            if aio:
                async def fn(lease, timeout_s):
                    return outcome(lease, timeout_s)

                result = asyncio.run(
                    pkg.res.acall_with_failover(fn, policy, route))
            else:
                result = pkg.res.call_with_failover(outcome, policy, route)
        except Exception as exc:  # noqa: BLE001
            result = ("raised",) + tuple(_plain(exc)) + (
                _plain(exc.__cause__),)
        records.append((result, seen, clock.sleeps[before:],
                        pool.snapshot()))
        for url in pool.urls():
            pool.set_state(url, "READY")
        clock.now += rng.choice([0.0, 1.0, 3.0])
    return records, retry_obs.calls, pool_obs.calls


@pytest.mark.parametrize("aio", [False, True], ids=["sync", "aio"])
@pytest.mark.parametrize("seed", [0, 1])
def test_failover_loop_equals_jax(clocks, monkeypatch, aio, seed):
    """call_with_failover / acall_with_failover: a fresh replica is
    tried at once, a wrapped rotation backs off on the policy's seeded
    jitter, non-retryable errors never rotate, NoHealthyEndpointError is
    retried on the schedule, and the deadline bounds the storm — the
    same attempts, timeouts, sleeps and observer calls as the
    reference."""
    if aio:
        runs = {}
        for name, pkg in (("jax", JAX), ("torch", PORT)):
            box = {"clock": clocks[name]}

            async def sleep(s, box=box):
                box["clock"].sleep(s)

            monkeypatch.setattr(pkg.res, "asyncio", types.SimpleNamespace(
                sleep=sleep))
            runs[name] = _failover_script(pkg, clocks[name], seed, aio)
    else:
        runs = {name: _failover_script(pkg, clocks[name], seed, aio)
                for name, pkg in (("jax", JAX), ("torch", PORT))}
    for i, (want, got) in enumerate(zip(runs["jax"][0], runs["torch"][0])):
        assert got == want, f"round {i}"
    assert runs["torch"][1:] == runs["jax"][1:]
    outcomes = {r[0][0] if isinstance(r[0], tuple) else "ok"
                for r in runs["jax"][0]}
    assert {"ok", "raised"} <= outcomes


def test_no_healthy_endpoint_error_is_a_retryable_503():
    for pkg in (JAX, PORT):
        exc = pkg.res.NoHealthyEndpointError("none")
        assert exc.status() == "503"
        assert pkg.res.RetryPolicy().retryable(exc)
    assert tres.NoHealthyEndpointError.__mro__[1] is (
        tutils.InferenceServerException)


def test_metrics_constants_equal_jax():
    for name in ("CIRCUIT_STATE_VALUES", "ENDPOINT_STATE_VALUES",
                 "ENDPOINT_PHASE_VALUES"):
        assert getattr(tmetrics, name) == getattr(jmetrics, name)
    assert isinstance(tmetrics.RESILIENCE, tmetrics.Registry)
