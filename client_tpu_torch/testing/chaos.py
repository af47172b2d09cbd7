"""Deterministic chaos matrix: declarative fault schedules + invariant
checkers, replacing per-test chaos boilerplate.

The port's copy of client_tpu/testing/chaos.py, over the port's
objects: :func:`partition_fleet` severs the port's
:class:`~client_tpu_torch.serve.fleet.FleetTier`, :func:`assert_kv_clean`
reads the port's engine and KV pool, :class:`StepLedger` is witnessed by
the port's :class:`~client_tpu_torch.analysis.witness.RaceWitness`, and
:class:`ChaosMatrix` dumps the port's flight recorders (which write
under ``$TPU_FLIGHT_DIR`` when it is set).  Schedules are the
reference's: the same seed gives the same schedule in both packages.

Every chaos scenario in this repo used to be hand-rolled: spawn driver
threads, sleep, kill something, join with a timeout, collect errors,
assert a scenario-specific pile of invariants.  This module factors that
into three reusable pieces:

- :class:`FaultSpec` / :class:`ChaosScenario` — a *declarative* schedule:
  fault kind x injection point x timing.  Timings may be literal offsets
  or seeded ``("uniform", lo, hi)`` draws, resolved once per scenario
  from ``ChaosScenario.seed`` — the same seed always yields the same
  schedule, so a failing matrix entry reproduces exactly.
- :func:`run_scenario` — drives caller-provided *driver* callables on
  threads while firing the schedule through an ``apply_fault`` hook
  (:func:`dispatch_fault` covers the standard
  :class:`~client_tpu_torch.testing.faults.FaultProxy`-fronted shapes: SIGKILL,
  mid-stream connection kill, refuse/restore, delay, truncation, drain).
  Driver exceptions are collected, never raised mid-run, and a driver
  that outlives the join timeout is reported as *wedged* — the
  hang-across-the-kill failure mode chaos tests exist to catch.
- invariant checkers, run after every scenario: :class:`StepLedger`
  (no ``(sequence, step)`` applied twice — with the resumed-after-kill
  carve-out for applies orphaned on a dead replica),
  :func:`assert_byte_exact` (stream/sequence resume produced the exact
  reference bytes), :func:`assert_kv_clean` (the LM engine's paged pool
  is fully free and its refcount ledger balanced),
  :func:`assert_lock_witness_acyclic` (the dynamic lock-order witness
  saw a DAG, no cycles).

:class:`ChaosMatrix` strings scenarios into a suite: one fixture per
scenario, invariants checked after each, teardown guaranteed.  Adding a
scenario to an existing matrix is one :class:`ChaosScenario` line.

This module is stdlib-only (numpy excepted) and import-safe anywhere the
clients are.
"""

import random
import threading
import time

from client_tpu_torch.analysis.witness import witness_shared

__all__ = [
    "FaultSpec",
    "ChaosScenario",
    "ScenarioResult",
    "StepLedger",
    "ChaosMatrix",
    "run_scenario",
    "dispatch_fault",
    "assert_byte_exact",
    "assert_kv_clean",
    "assert_lock_witness_acyclic",
    "assert_race_witness_clean",
    "assert_no_leaked_resources",
]


class FaultSpec:
    """One scheduled fault: ``kind`` x injection point (``target``) x
    timing (``at_s``).

    ``at_s`` is a float offset from scenario start, or a seeded draw
    ``("uniform", lo, hi)`` resolved by :meth:`ChaosScenario.schedule`.
    ``target`` is the injection point in the fixture's vocabulary
    (usually a replica index).  Kind-specific extras ride in ``params``
    (e.g. ``FaultSpec("delay", at_s=0.1, target=1, seconds=0.5)``).

    Standard kinds (:func:`dispatch_fault`): ``kill_replica`` (SIGKILL —
    connections RST, new ones refused, no drain), ``kill_connections``
    (mid-stream disconnect only), ``refuse`` / ``restore``,
    ``reset_next`` (RST the next ``n`` connections), ``delay``
    (``seconds``), ``truncate`` (``nbytes``/``times``), ``drain``
    (planned retire), ``custom`` (``fn`` called with the fixture's
    dispatch kwargs).
    """

    def __init__(self, kind, at_s=0.0, target=0, **params):
        self.kind = str(kind)
        self.at_s = at_s
        self.target = target
        self.params = params

    def __repr__(self):
        return (
            f"FaultSpec({self.kind!r}, at_s={self.at_s!r}, "
            f"target={self.target!r}"
            + ("".join(f", {k}={v!r}" for k, v in self.params.items()))
            + ")"
        )


class ChaosScenario:
    """A named, seeded fault schedule.

    ``seed`` makes randomized timings (and anything else the fixture
    draws from :meth:`rng`) deterministic: the matrix is reproducible
    run to run, and a red scenario replays bit-identically.
    """

    def __init__(self, name, faults=(), seed=0, **params):
        self.name = str(name)
        self.faults = list(faults)
        self.seed = int(seed)
        self.params = params  # fixture-specific knobs (session count...)

    def rng(self):
        """A fresh seeded RNG — fixtures draw workload shapes from this
        so the whole scenario, not just fault timing, is deterministic."""
        return random.Random(self.seed)

    def schedule(self):
        """``[(at_s, FaultSpec)]`` sorted by time, timings resolved with
        the scenario seed (same seed -> same schedule, always)."""
        rng = self.rng()
        out = []
        for fault in self.faults:
            at = fault.at_s
            if isinstance(at, (tuple, list)):
                dist, lo, hi = at
                if dist != "uniform":
                    raise ValueError(f"unknown timing draw {dist!r}")
                at = rng.uniform(float(lo), float(hi))
            out.append((float(at), fault))
        out.sort(key=lambda pair: pair[0])
        return out

    def __repr__(self):
        return (
            f"ChaosScenario({self.name!r}, seed={self.seed}, "
            f"faults={self.faults!r})"
        )


class ScenarioResult:
    """One scenario run's outcome: collected driver errors, the faults
    actually fired (with real offsets), wedged-driver count, duration."""

    def __init__(self, name, errors, fired, duration_s, wedged=0):
        self.name = name
        self.errors = list(errors)
        self.fired = list(fired)
        self.duration_s = float(duration_s)
        self.wedged = int(wedged)

    def assert_clean(self):
        """Zero client-visible errors AND no driver wedged across a
        fault — the baseline invariant of every resilience scenario."""
        assert self.wedged == 0, (
            f"{self.name}: {self.wedged} driver(s) wedged past the join "
            "timeout (hung across a fault)"
        )
        assert not self.errors, f"{self.name}: driver errors: {self.errors}"

    def __repr__(self):
        return (
            f"ScenarioResult({self.name!r}, errors={len(self.errors)}, "
            f"wedged={self.wedged}, fired={len(self.fired)}, "
            f"duration_s={self.duration_s:.2f})"
        )


def partition_fleet(tiers, groups):
    """Sever the peer transport between replica *groups*.

    *tiers* is the fixture's ordered FleetTier list; *groups* is a list
    of index lists (e.g. ``[[0], [1, 2]]``) — tiers in different groups
    can no longer reach each other (symmetric), tiers in the same group
    still can.  An index in no group is isolated from everyone.  The
    severing installs a transport filter on each tier
    (:meth:`FleetTier.set_transport_filter`), so outbound peer calls
    fail with OSError exactly where a dropped network would and the
    per-peer breakers accumulate real evidence.  ``heal_fleet`` undoes
    it."""
    group_of = {}
    for gi, members in enumerate(groups):
        for idx in members:
            group_of[int(idx)] = gi
    addr_group = {}
    for ti, tier in enumerate(tiers):
        addr = tier.address
        if addr is not None:
            addr_group[addr] = group_of.get(ti)
    for ti, tier in enumerate(tiers):
        mine = group_of.get(ti)

        def allow(addr, _mine=mine):
            their = addr_group.get(addr)
            if their is None and addr not in addr_group:
                return True  # not a partitioned tier: unaffected
            return _mine is not None and their == _mine

        tier.set_transport_filter(allow)


def heal_fleet(tiers):
    """Clear every partition filter installed by ``partition_fleet`` —
    the network is whole again; convergence (anti-entropy, gossip
    retry, quorum retries) is the code under test, not the harness."""
    for tier in tiers:
        tier.set_transport_filter(None)


def dispatch_fault(fault, proxies=(), kill=None, drain=None, tiers=()):
    """Standard fault dispatch for FaultProxy-fronted replica sets.

    *proxies* maps ``fault.target`` to a
    :class:`~client_tpu_torch.testing.faults.FaultProxy`; *kill*/*drain* are
    optional ``fn(target)`` hooks for the replica-lifecycle kinds (a
    SIGKILL is proxy ``sigkill`` + the *kill* hook stopping the server
    WITHOUT drain; a ``drain`` is the planned-retire path).  *tiers* is
    the ordered FleetTier list for the network-severing kinds:
    ``FaultSpec("partition", groups=[[0], [1, 2]])`` severs the peer
    transport between the index groups, ``FaultSpec("heal")`` restores
    it.  Fixtures with non-standard kinds use
    ``FaultSpec("custom", fn=...)``.
    """
    kind = fault.kind
    proxy = None
    if proxies:
        try:
            proxy = proxies[fault.target]
        except (KeyError, IndexError, TypeError):
            proxy = None
    if kind == "kill_replica":
        if proxy is not None:
            proxy.sigkill()
        if kill is not None:
            kill(fault.target)
        return
    if kind == "kill_connections":
        proxy.kill_active()
        return
    if kind == "refuse":
        proxy.refuse_connections(True)
        return
    if kind == "restore":
        proxy.refuse_connections(False)
        return
    if kind == "reset_next":
        proxy.reset_next_connections(int(fault.params.get("n", 1)))
        return
    if kind == "delay":
        proxy.set_delay(float(fault.params.get("seconds", 0.0)))
        return
    if kind == "truncate":
        proxy.cut_responses_after(
            int(fault.params["nbytes"]), int(fault.params.get("times", 1))
        )
        return
    if kind == "drain":
        if drain is None:
            raise ValueError("scenario uses 'drain' but no drain hook given")
        drain(fault.target)
        return
    if kind == "partition":
        partition_fleet(tiers, fault.params["groups"])
        return
    if kind == "heal":
        heal_fleet(tiers)
        return
    if kind == "custom":
        fault.params["fn"]()
        return
    raise ValueError(f"unknown fault kind {fault.kind!r}")


def run_scenario(scenario, apply_fault, drivers, join_timeout_s=600.0):
    """Run *drivers* (callables) on threads while firing *scenario*'s
    fault schedule through ``apply_fault(fault)``.

    Driver exceptions are collected into the result (a chaos driver
    failing must not abort the matrix mid-scenario — the invariant pass
    decides what counts).  Fault-application errors are collected under
    a ``"fault:<kind>"`` pseudo-driver key.  Returns
    :class:`ScenarioResult`.
    """
    errors = []
    threads = []

    def _wrap(index, fn):
        def run():
            try:
                fn()
            except Exception as exc:  # noqa: BLE001 - collected, checked
                errors.append((index, exc))

        return run

    for i, fn in enumerate(drivers):
        threads.append(threading.Thread(
            target=_wrap(i, fn), name=f"chaos-driver-{i}", daemon=True,
        ))
    fired = []
    t0 = time.monotonic()
    for thread in threads:
        thread.start()
    for at_s, fault in scenario.schedule():
        delay = t0 + at_s - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        try:
            apply_fault(fault)
        except Exception as exc:  # noqa: BLE001 - collected, checked
            errors.append((f"fault:{fault.kind}", exc))
        fired.append((time.monotonic() - t0, fault))
    deadline = time.monotonic() + float(join_timeout_s)
    for thread in threads:
        thread.join(timeout=max(deadline - time.monotonic(), 0.001))
    wedged = sum(1 for thread in threads if thread.is_alive())
    return ScenarioResult(
        scenario.name, errors, fired, time.monotonic() - t0, wedged=wedged
    )


@witness_shared("_lock")
class StepLedger:
    """Cross-replica ``(sequence, step)`` application ledger.

    Model functions (or fixtures) call :meth:`record` when a step is
    actually APPLIED to sequence state — idempotent replays served from
    the retained rendering never touch the model, so they never record.
    :meth:`assert_exactly_once` is the exactly-once invariant checker.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._applies = []  # (seq_id, step, replica, t)

    def record(self, seq_id, step, replica):
        with self._lock:
            self._applies.append(
                (seq_id, int(step), replica, time.monotonic())
            )

    def applies(self):
        with self._lock:
            return list(self._applies)

    def assert_exactly_once(self, orphans=()):
        """No ``(sequence, step)`` applied twice.

        *orphans* names replicas that were KILLED unplanned: an apply on
        an orphan that was never acknowledged dies with the replica, and
        the survivor legitimately re-applies the step on the replicated
        snapshot — so a pair whose earlier applies all sit on orphans is
        a resume, not a duplicate.  Duplicates on one replica, or any
        re-apply whose predecessor ran on a SURVIVOR, always fail.
        """
        orphans = set(orphans)
        by_step = {}
        for seq_id, step, replica, t in self.applies():
            by_step.setdefault((seq_id, step), []).append((t, replica))
        bad = []
        for key, entries in sorted(by_step.items()):
            if len(entries) == 1:
                continue
            entries.sort()
            replicas = [replica for _t, replica in entries]
            if len(set(replicas)) != len(replicas):
                bad.append((key, replicas, "same replica applied it twice"))
            elif any(replica not in orphans for replica in replicas[:-1]):
                bad.append((
                    key, replicas,
                    "an earlier apply ran on a SURVIVING replica",
                ))
        assert not bad, f"(sequence, step) applied twice: {bad}"

    def steps_for(self, seq_id):
        """Sorted distinct applied steps of one sequence."""
        return sorted({
            step for sid, step, _r, _t in self.applies() if sid == seq_id
        })


def assert_byte_exact(got, want, label=""):
    """Resumed output must be byte-exact vs the unbroken reference —
    duplicated or dropped positions fail loudly with a position diff."""
    got = list(got)
    want = list(want)
    if got == want:
        return
    at = next(
        (i for i, (a, b) in enumerate(zip(got, want)) if a != b),
        min(len(got), len(want)),
    )
    raise AssertionError(
        f"{label or 'stream'}: not byte-exact: first divergence at "
        f"position {at} (got {len(got)} values, want {len(want)}): "
        f"got[{at}:{at + 4}]={got[at:at + 4]} "
        f"want[{at}:{at + 4}]={want[at:at + 4]}"
    )


def assert_kv_clean(engine):
    """The LM engine's paged KV pool must end fully free with a balanced
    refcount ledger (call after ``engine.close()``)."""
    kv = getattr(engine, "kv", None)
    if kv is None:
        return  # engine never started: nothing to leak
    assert kv.used_blocks == 0, (
        f"KV pool not fully free after close: {kv.used_blocks} blocks "
        f"held, refcounts {kv.ref_counts()}"
    )


def assert_lock_witness_acyclic(witness):
    """The dynamic lock-order witness observed an acyclic acquisition
    graph (no-op witness=None so matrices run unarmed too)."""
    if witness is None:
        return 0
    return witness.assert_acyclic()


def assert_race_witness_clean(witness):
    """The dynamic race witness recorded no unguarded shared writes —
    covering violations a driver's own try/except swallowed
    mid-scenario.  No-op for None or a plain LockWitness so matrices run
    unarmed (or lock-order-only) too."""
    check = getattr(witness, "assert_race_free", None)
    if check is None:
        return 0
    return check()


def assert_no_leaked_resources(witness):
    """The dynamic resource witness holds no live handles — every KV
    block reservation, endpoint lease and tracer span acquired during
    the scenario was released, even on the fault paths the schedule
    injected.  No-op for None so matrices run unarmed too."""
    check = getattr(witness, "assert_clean", None)
    if check is None:
        return 0
    return check()


def _fixture_recorders(fixture):
    """Every flight recorder reachable from *fixture*: an explicit
    ``flight_recorders()`` hook wins; otherwise the standard shapes —
    ``fixture.servers`` (Server objects) and ``fixture.engines`` — are
    scanned for ``engine.flight``."""
    hook = getattr(fixture, "flight_recorders", None)
    if callable(hook):
        try:
            return list(hook())
        except Exception:
            return []
    recorders = []
    for server in getattr(fixture, "servers", None) or ():
        flight = getattr(getattr(server, "engine", None), "flight", None)
        if flight is not None:
            recorders.append(flight)
    for engine in getattr(fixture, "engines", None) or ():
        flight = getattr(engine, "flight", None)
        if flight is not None:
            recorders.append(flight)
    return recorders


class ChaosMatrix:
    """A suite of scenarios over one fixture family.

    ``run(make_fixture)`` builds a FRESH fixture per scenario via
    ``make_fixture(scenario)`` — an object (or namespace) providing:

    - ``apply_fault(fault)`` — usually a :func:`dispatch_fault` closure;
    - ``drivers()`` — the workload callables to run on threads;
    - ``check(result)`` — the scenario's invariant pass (raise to fail);
    - ``close()`` (optional) — teardown, always called;
    - ``flight_recorders()`` (optional) — recorders to dump when an
      invariant fails (default: every ``server.engine.flight`` /
      ``engine.flight`` on the fixture).

    Invariants passed to the constructor run after EVERY scenario's own
    ``check`` — the cross-cutting floor (exactly-once, pool-free, lock
    witness) that no scenario may opt out of.

    A failed ``check``/invariant DUMPS every reachable flight recorder
    before the failure propagates: the red matrix entry ships its own
    postmortem (recent spans, tick timings, preemptions, faults) instead
    of asking for a re-run with tracing on.  Point ``TPU_FLIGHT_DIR``
    at a directory that outlives the run to keep the dumps.
    """

    def __init__(self, scenarios, invariants=()):
        self.scenarios = list(scenarios)
        self.invariants = list(invariants)

    def _dump_on_failure(self, fixture, scenario, exc):
        for recorder in _fixture_recorders(fixture):
            try:
                recorder.note(
                    "chaos_invariant_failure", scenario=scenario.name,
                    error=repr(exc),
                )
                recorder.dump(f"chaos-{scenario.name}")
            except Exception:
                pass  # the invariant failure is the story, not the dump

    def run(self, make_fixture, join_timeout_s=600.0):
        results = []
        for scenario in self.scenarios:
            fixture = make_fixture(scenario)
            try:
                result = run_scenario(
                    scenario, fixture.apply_fault, fixture.drivers(),
                    join_timeout_s=join_timeout_s,
                )
                try:
                    fixture.check(result)
                    for invariant in self.invariants:
                        invariant(fixture, result)
                except BaseException as exc:
                    self._dump_on_failure(fixture, scenario, exc)
                    raise
            finally:
                close = getattr(fixture, "close", None)
                if close is not None:
                    close()
            results.append(result)
        return results
