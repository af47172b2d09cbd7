"""The port's dynamic witnesses (client_tpu_torch.analysis.witness) held
against the JAX package's (client_tpu.analysis.witness).

- The same scripted programs run once per package, each package's
  witness over that package's own objects: a two-thread lock-order
  inversion between the profiler's lock (serve/prof.py) and the step
  ledger's (testing/chaos.py), an unguarded second-thread write to the
  ledger's witnessed field, and one leaked KV block, endpoint lease and
  client span.  Both packages report the same violation class, the same
  cycle (its nodes named by package-relative file; each node's line is
  the lock's construction), the same class and field, and the same
  leaked kinds and counts: exact, this is logic.
- What each witness arms: the port's ``RaceWitness`` instruments the
  port's ``@witness_shared`` classes (``PhaseProfiler``,
  ``_SequenceStore``, ``MetricsManager``, ``StepLedger``) and none of
  the reference's, its ``LockWitness`` wraps the locks built under
  client_tpu_torch/ and leaves the reference's raw, and its
  ``ResourceWitness`` patches the five classes of the port's
  ``DYNAMIC_SPECS`` and raises, naming it, on a spec that does not
  import.
- The port twins of tests/test_prof.py::TestRing::
  test_commits_are_race_free_under_witness and
  tests/test_frontdoor.py::test_chaos_lock_order_witness: the JAX test
  bodies with every client_tpu name swapped for the port's.
"""

import ast
import pathlib
import subprocess
import sys
import threading

import pytest

import client_tpu.analysis.witness as jwitness
import client_tpu.balance.pool as jpool
import client_tpu.perf.metrics_manager as jmm
import client_tpu.serve.fleet as jfleet
import client_tpu.serve.lm.kv as jkv
import client_tpu.serve.prof as jprof
import client_tpu.testing.chaos as jchaos
import client_tpu.tracing as jtracing
import test_frontdoor as jfrontdoor
import test_prof as jtest_prof
from client_tpu.serve.models import transformer as jtfm
from test_torch_chaos import swap_to_port
import client_tpu_torch.analysis.resources as tresources
import client_tpu_torch.analysis.witness as twitness
import client_tpu_torch.balance.pool as tpool
import client_tpu_torch.perf.metrics_manager as tmm
import client_tpu_torch.serve.fleet as tfleet
import client_tpu_torch.serve.lm.kv as tkv
import client_tpu_torch.serve.prof as tprof
import client_tpu_torch.serve.tracing as tserve_tracing
import client_tpu_torch.testing.chaos as tchaos
import client_tpu_torch.tracing as ttracing
from client_tpu_torch.serve.models import transformer as ttfm

ROOT = pathlib.Path(__file__).resolve().parent.parent

JAX = dict(root="client_tpu", witness=jwitness, prof=jprof, chaos=jchaos,
           kv=jkv, pool=jpool, tracing=jtracing, tfm=jtfm, kw={})
PORT = dict(root="client_tpu_torch", witness=twitness, prof=tprof,
            chaos=tchaos, kv=tkv, pool=tpool, tracing=ttracing, tfm=ttfm,
            kw={"device": "cpu"})

_CFG = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
            n_kv_heads=2, d_ff=128, max_seq=96, dtype="float32")


def _in_thread(fn):
    """Run *fn* on its own thread; returns what it raised (or None)."""
    raised = []

    def run():
        try:
            fn()
        except BaseException as exc:  # noqa: BLE001 - returned, checked
            raised.append(exc)

    thread = threading.Thread(target=run)
    thread.start()
    thread.join(timeout=30)
    assert not thread.is_alive()
    return raised[0] if raised else None


def _node(name, root):
    """(package-relative file, source line) of a witness node
    ``<root>/<file>:<line>``."""
    path, _, line = name.rpartition(":")
    assert path.startswith(root + "/"), name
    source = (ROOT / path).read_text().splitlines()[int(line) - 1]
    return path[len(root) + 1:], source.strip()


# -- the scripted programs, once per package ---------------------------------

def _inversion(pkg):
    """Thread 1 takes the profiler's lock then the ledger's; thread 2 the
    ledger's then the profiler's (one after the other: the order, not a
    deadlock, is what the witness records)."""
    w = pkg["witness"].LockWitness()
    with w.installed():
        prof = pkg["prof"].PhaseProfiler(name="t")
        ledger = pkg["chaos"].StepLedger()

        def nest(outer, inner):
            def run():
                with outer:
                    with inner:
                        pass
            return run

        assert _in_thread(nest(prof._lock, ledger._lock)) is None
        assert _in_thread(nest(ledger._lock, prof._lock)) is None
    with pytest.raises(pkg["witness"].LockOrderViolation) as exc:
        w.assert_acyclic()
    [(cycle, _how)] = w.cycles()
    return exc.value, sorted(_node(n, pkg["root"]) for n in cycle)


def _unguarded_write(pkg):
    """The main thread records into a ledger; a second thread replaces
    its witnessed ``_applies`` without the ledger's lock."""
    w = pkg["witness"].RaceWitness()
    with w.installed():
        ledger = pkg["chaos"].StepLedger()
        ledger.record(1, 1, "r0")

        def unguarded():
            ledger._applies = []

        raised = _in_thread(unguarded)
    assert isinstance(raised, pkg["witness"].RaceViolation), raised
    with pytest.raises(pkg["witness"].RaceViolation):
        w.assert_race_free()
    return type(raised).__name__, [(c, f) for c, f, _r in w.race_violations]


def _leaks(pkg):
    """One KV block, one endpoint lease and one client span acquired
    under the witness and not given back before its checkpoint (they are
    given back after it)."""
    w = pkg["witness"].ResourceWitness()
    cfg = pkg["tfm"].TransformerConfig(**_CFG)
    held = {}
    with w.installed():
        kv = pkg["kv"].KvBlockPool(cfg, n_blocks=8, block_size=4,
                                   **pkg["kw"])
        held["blocks"] = kv.alloc(2)
        kv.release(held["blocks"][:1])  # one of two comes back
        endpoints = pkg["pool"].EndpointPool(["127.0.0.1:1"])
        held["lease"] = endpoints.lease()
        endpoints.lease().release()
        tracer = pkg["tracing"].ClientTracer(trace_rate=1)
        held["span"] = tracer.sample("m")
        tracer.complete(tracer.sample("m"))
    with pytest.raises(pkg["witness"].ResourceLeakError) as exc:
        w.assert_clean()
    live = sorted((e["kind"], e["count"]) for e in w.live().values())
    kv.release(held["blocks"][1:])
    held["lease"].release()
    tracer.complete(held["span"])
    assert kv.used_blocks == 0
    endpoints.close()
    return type(exc.value).__name__, live


def test_lock_order_inversion_equals_jax():
    """Both witnesses close the same two-node cycle, at each package's
    two lock constructions."""
    jexc, jnodes = _inversion(JAX)
    texc, tnodes = _inversion(PORT)
    assert type(texc).__name__ == type(jexc).__name__ == "LockOrderViolation"
    # the reported cycle, held lock first and last: the same in both
    assert tnodes == jnodes
    assert sorted({f for f, _ in tnodes}) == [
        "serve/prof.py", "testing/chaos.py"]
    for _f, source in tnodes + jnodes:
        assert "threading.Lock()" in source, source
    assert "lock-order cycle" in str(texc)


def test_unguarded_write_equals_jax():
    assert _unguarded_write(PORT) == _unguarded_write(JAX) == (
        "RaceViolation", [("StepLedger", "_applies")])


def test_leaks_equal_jax():
    assert _leaks(PORT) == _leaks(JAX) == (
        "ResourceLeakError",
        [("kv-blocks", 1), ("lease", 1), ("span", 1)])


# -- what each witness arms ----------------------------------------------------

WITNESSED = ("PhaseProfiler", "_SequenceStore", "MetricsManager",
             "StepLedger")


def _witnessed_classes(pkg):
    return [pkg["prof"].PhaseProfiler, pkg["fleet"]._SequenceStore,
            pkg["mm"].MetricsManager, pkg["chaos"].StepLedger]


@pytest.mark.parametrize("mine, other", [
    (dict(PORT, fleet=tfleet, mm=tmm), dict(JAX, fleet=jfleet, mm=jmm)),
    (dict(JAX, fleet=jfleet, mm=jmm), dict(PORT, fleet=tfleet, mm=tmm)),
])
def test_race_witness_instruments_its_own_package(mine, other):
    """The port's decorator is the real one: its RaceWitness instruments
    the four port classes (and restores them), and leaves the
    reference's alone; the reference's does the mirror image."""
    classes = _witnessed_classes(mine)
    others = _witnessed_classes(other)
    assert [c.__name__ for c in classes] == list(WITNESSED)
    for cls in classes:
        assert cls._tpulint_witness_shared["guards"] == {"_lock"}
    w = mine["witness"].RaceWitness()
    with w.installed():
        armed = {id(c) for c, _spec in w._armed_classes()}
        for cls in classes:
            assert id(cls) in armed
            assert cls.__dict__["__setattr__"].__name__ == (
                "instrumented_setattr")
        for cls in others:
            assert id(cls) not in armed
            assert "__setattr__" not in cls.__dict__
    for cls in classes:
        assert "__setattr__" not in cls.__dict__
        assert "__getattribute__" not in cls.__dict__


def test_lock_witness_wraps_the_locks_built_in_its_package():
    port, ref = twitness.LockWitness(), jwitness.LockWitness()
    with port.installed():
        prof = tprof.PhaseProfiler(name="t")
        jprofiler = jprof.PhaseProfiler(name="t")
    assert isinstance(prof._lock, twitness.WitnessLock)
    assert _node(prof._lock._name, "client_tpu_torch")[0] == "serve/prof.py"
    assert not isinstance(jprofiler._lock, (twitness.WitnessLock,
                                            jwitness.WitnessLock))
    with ref.installed():
        raw = tprof.PhaseProfiler(name="t")
    assert not isinstance(raw._lock, (twitness.WitnessLock,
                                      jwitness.WitnessLock))
    with prof._lock:
        pass
    assert port.acquisitions == 1


def test_resource_witness_patches_the_five_port_classes():
    specs = tresources.DYNAMIC_SPECS
    classes = {(s["module"], s["cls"]) for s in specs}
    assert classes == {
        ("client_tpu_torch.serve.lm.kv", "KvBlockPool"),
        ("client_tpu_torch.balance.pool", "EndpointPool"),
        ("client_tpu_torch.balance.pool", "Lease"),
        ("client_tpu_torch.tracing", "ClientTracer"),
        ("client_tpu_torch.serve.tracing", "Tracer"),
    }
    # the reference's modes, kind by kind
    jspecs = {(s["cls"], s["kind"]): (s["acquire"], s["release"])
              for s in __import__(
                  "client_tpu.analysis.resources",
                  fromlist=["DYNAMIC_SPECS"]).DYNAMIC_SPECS}
    assert {(s["cls"], s["kind"]): (s["acquire"], s["release"])
            for s in specs} == jspecs
    owners = {"KvBlockPool": tkv.KvBlockPool,
              "EndpointPool": tpool.EndpointPool, "Lease": tpool.Lease,
              "ClientTracer": ttracing.ClientTracer,
              "Tracer": tserve_tracing.Tracer}
    methods = [(owners[s["cls"]], m) for s in specs
               for m in (*s["acquire"], *s["release"])]
    before = {(c, m): getattr(c, m) for c, m in methods}
    with twitness.ResourceWitness().installed():
        for (cls, method), orig in before.items():
            assert getattr(cls, method) is not orig, (cls, method)
    assert {(c, m): getattr(c, m) for c, m in methods} == before


def test_resource_witness_raises_on_a_spec_it_cannot_import(monkeypatch):
    """Where the reference skips a spec whose module or class does not
    import, the port's raises, names the spec, and patches nothing."""
    before = tkv.KvBlockPool.alloc
    specs = tresources.DYNAMIC_SPECS
    for module, cls in (("client_tpu_torch.no_such_module", "X"),
                        ("client_tpu_torch.serve.lm.kv", "NoSuchPool")):
        monkeypatch.setattr(tresources, "DYNAMIC_SPECS", (
            *specs,
            {"kind": "ghost", "module": module, "cls": cls,
             "acquire": {"alloc": "ret"}, "release": {}},
        ))
        with pytest.raises(ImportError, match=rf"'ghost' names {module}"):
            with twitness.ResourceWitness().installed():
                pass
        assert tkv.KvBlockPool.alloc is before
    # the reference's skips the same kind of spec silently
    monkeypatch.setattr(
        sys.modules["client_tpu.analysis.resources"], "DYNAMIC_SPECS",
        ({"kind": "ghost", "module": "client_tpu.no_such_module",
          "cls": "X", "acquire": {}, "release": {}},))
    with jwitness.ResourceWitness().installed():
        pass


def test_witness_import_is_a_stdlib_leaf():
    """serve/prof.py, serve/fleet.py and perf/metrics_manager.py import
    the real decorator; the witness module imports the standard library
    only, and importing it loads no rule table and no resource specs."""
    tree = ast.parse((ROOT / "client_tpu_torch/analysis/witness.py")
                     .read_text())
    top = {alias.name.split(".")[0] for node in ast.walk(tree)
           if isinstance(node, ast.Import) for alias in node.names}
    top |= {node.module.split(".")[0] for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) and node.level == 0
            and node.col_offset == 0}
    assert top <= set(sys.stdlib_module_names), top
    for mod in (tprof, tfleet, tmm):
        assert mod.witness_shared is twitness.witness_shared
    code = ("import sys; import client_tpu_torch.analysis.witness; "
            "print(sorted(m for m in sys.modules if 'analysis' in m))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.strip() == ("['client_tpu_torch.analysis', "
                           "'client_tpu_torch.analysis.witness']")


# -- the port twins of the reference's witness tests ---------------------------

def test_prof_commits_race_free_under_port_witness(monkeypatch):
    """tests/test_prof.py::TestRing::test_commits_are_race_free_under_witness
    on the port's PhaseProfiler under the port's RaceWitness."""
    swapped = swap_to_port(monkeypatch, jtest_prof,
                           inner=("client_tpu.analysis.witness",))
    assert jtest_prof.PhaseProfiler is tprof.PhaseProfiler
    assert "PhaseProfiler" in swapped
    jtest_prof.TestRing().test_commits_are_race_free_under_witness()


def test_frontdoor_chaos_under_port_lock_witness(monkeypatch):
    """tests/test_frontdoor.py::test_chaos_lock_order_witness on a port
    server (tenant QoS, response cache, coalescing, tracing) driven by
    the port's HTTP clients: the port's LockWitness records a non-empty,
    acyclic acquisition graph."""
    swapped = swap_to_port(monkeypatch, jfrontdoor,
                           inner=("client_tpu.analysis.witness",))
    assert {"Server", "TenantQoS", "ResponseCache", "httpclient",
            "render_metrics", "run_scenario"} <= set(swapped)
    jfrontdoor.test_chaos_lock_order_witness()
