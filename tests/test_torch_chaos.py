"""The port's chaos harness (client_tpu_torch.testing) and the chaos
scenarios of tests/test_chaos.py that tests/test_torch_fleet.py does not
already hold, run on the port's engines, tiers, servers and clients on
the CPU under the port's three witnesses.

- Each scenario is the JAX test's own body (tests/test_chaos.py) with
  every name it takes from client_tpu swapped for the port's
  counterpart: the module's globals, and the ``from client_tpu... import``
  lines inside its test bodies and fixtures (``sys.modules`` entries for
  the duration of the test).  ``Server`` and ``LmEngine`` run on the
  CPU; the LM weights are the JAX init carried across with
  ``client_tpu_torch.convert``, and the serial stream a survivor is held
  to byte for byte is the JAX package's ``generate`` (float32, exact).
- Every scenario runs inside the port's ``RaceWitness`` (the lock-order
  duty included) and ``ResourceWitness``, armed before anything is
  built.  After the scenario the lock graph must be acyclic, no
  witnessed field written unguarded by two threads, and no KV block,
  lease or span left live.
- Every ``ChaosScenario`` of tests/test_chaos.py, soak ones included,
  gives the same ``schedule()`` in both packages for its seed.

The soak twins are marked ``slow``, as the reference's are.
"""

import dataclasses
import functools
import importlib
import sys
import types

import numpy as np
import pytest

import jax

import client_tpu.testing.chaos as jchaos
import test_chaos as jc
from client_tpu.serve.models import transformer as jtfm
from test_torch_balance import port_counterpart
from client_tpu_torch import convert
from client_tpu_torch.analysis.witness import RaceWitness, ResourceWitness
from client_tpu_torch.serve import Server
from client_tpu_torch.serve.flight import FlightRecorder
from client_tpu_torch.serve.lm import LmEngine
from client_tpu_torch.serve.models import transformer as tfm
from client_tpu_torch.testing import chaos

JCFG = jc.CFG  # tests/test_chaos.py's config, before any swap
CFG = tfm.TransformerConfig(**dataclasses.asdict(JCFG))

# the client_tpu modules the reference's test bodies import inside
# functions; each is swapped for its port mirror while a test runs
INNER_IMPORTS = (
    "client_tpu.analysis.witness",
    "client_tpu.balance.pool",
    "client_tpu.http",
    "client_tpu.serve.autoscale",
    "client_tpu.serve.fleet",
    "client_tpu.serve.lm.kv",
    "client_tpu.testing.chaos",
    "client_tpu.testing.faults",
    "client_tpu.utils",
)


def swap_to_port(monkeypatch, module, inner=INNER_IMPORTS):
    """Point every module, class and function ``module`` took from
    client_tpu at the port's counterpart, ``Server`` and ``LmEngine`` on
    the CPU, and the *inner* imports of its function bodies at the port's
    modules.  Returns the names swapped."""
    swapped = []
    for name, obj in list(vars(module).items()):
        if not isinstance(obj, (types.ModuleType, type, types.FunctionType)):
            continue
        origin = (obj.__name__ if isinstance(obj, types.ModuleType)
                  else obj.__module__)
        if not origin.startswith("client_tpu."):
            continue
        monkeypatch.setattr(module, name, port_counterpart(obj))
        swapped.append(name)
    for name, cls in (("Server", Server), ("LmEngine", LmEngine)):
        if name in swapped:
            monkeypatch.setattr(module, name,
                                functools.partial(cls, device="cpu"))
    for name in inner:
        monkeypatch.setitem(sys.modules, name, port_counterpart(
            importlib.import_module(name)))
    return swapped


@pytest.fixture(scope="module")
def weights():
    """(JAX params, the port's params on the CPU) from one JAX init."""
    jparams = jtfm.init_params(jax.random.PRNGKey(0), JCFG)
    port = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jparams, port


@pytest.fixture
def port(monkeypatch, weights):
    """tests/test_chaos.py over the port: the swap, the port's config and
    close sentinel, and the JAX serial stream as the byte-exact
    reference."""
    swapped = swap_to_port(monkeypatch, jc)
    monkeypatch.setattr(jc, "CFG", CFG)
    monkeypatch.setattr(jc, "CLOSE", LmEngine.CLOSE)
    jparams = weights[0]

    def jax_serial(_params, prompt, n):
        return list(jtfm.generate(jparams, JCFG, prompt, n,
                                  readback_depth=0))

    monkeypatch.setattr(jc, "_serial", jax_serial)
    return swapped


def witnessed(tmp_path, body, *args, saw=""):
    """Run ``body(*args)`` inside the port's race (lock order included)
    and resource witnesses, armed before the body builds anything, then
    hold the run to the three invariants.  *saw* names the traffic the
    witnesses must have seen: ``l`` acquisitions of port locks, ``f``
    accesses to witnessed fields, ``r`` acquired KV blocks, leases or
    spans."""
    flight = FlightRecorder(dump_dir=str(tmp_path / "witness"),
                            name="chaos-witness")
    race = RaceWitness(flight=flight)
    resources = ResourceWitness(flight=flight)
    with race.installed(), resources.installed():
        body(*args)
    race.assert_acyclic()
    seen = {"l": race.acquisitions, "f": race.assert_race_free(),
            "r": resources.assert_clean()}
    assert all(seen[k] > 0 for k in saw), (saw, seen)


def test_the_swap_covers_every_reference_name(port):
    """Every client_tpu name tests/test_chaos.py uses has a port
    counterpart, and its bodies now see the port's."""
    assert {"traceview", "ReplicatedClient", "InferenceEngine", "Model",
            "Server", "TensorSpec", "FleetTier", "FlightRecorder",
            "ClientTracer", "LmEngine", "Registry", "tfm", "ChaosMatrix",
            "ChaosScenario", "FaultSpec", "StepLedger",
            "assert_byte_exact", "assert_kv_clean", "dispatch_fault",
            "run_scenario", "FaultProxy"} <= set(port)
    assert jc.StepLedger is chaos.StepLedger
    assert jc.traceview.__name__ == "client_tpu_torch.traceview"
    assert sys.modules["client_tpu.utils"].__name__ == "client_tpu_torch.utils"
    from client_tpu.testing.chaos import heal_fleet

    assert heal_fleet is chaos.heal_fleet


# -- the harness: seeded schedules equal the reference's ---------------------

def _scenarios(pkg):
    """Every ChaosScenario tests/test_chaos.py builds, soak ones included,
    built with *pkg*'s harness."""
    spec, scen = pkg.FaultSpec, pkg.ChaosScenario
    kill = functools.partial(spec, "kill_replica", target=0)
    out = [
        scen("s", [kill(at_s=("uniform", 0.1, 0.9)),
                   spec("refuse", at_s=0.05, target=1)], seed=42),
        scen("s", [kill(at_s=("uniform", 0.1, 0.9)),
                   spec("refuse", at_s=0.05, target=1)], seed=43),
        scen("seq-sigkill", [kill(at_s=0.35)], seed=7),
        scen("anti-entropy", [kill(at_s=0.1)], seed=3),
        scen("anti-entropy-soak", [kill(at_s=("uniform", 0.05, 0.5))],
             seed=17),
        scen("spec-cancel-preempt", seed=5),
        scen("quorum-partition",
             [spec("partition", at_s=0.25, groups=[[0], [1, 2]]),
              spec("heal", at_s=0.7)], seed=13),
        scen("autoscale-ramp", [], seed=31),
    ]
    out += [scen(f"seq-sigkill-{s}", [kill(at_s=("uniform", 0.3, 0.9))],
                 seed=s) for s in (11, 23)]
    out += [scen(f"quorum-partition-{s}",
                 [spec("partition", at_s=("uniform", 0.1, 0.4),
                       groups=[[0], [1, 2]]),
                  spec("heal", at_s=("uniform", 0.6, 1.1))], seed=s)
            for s in (5, 29)]
    out += [scen(f"autoscale-ramp-{s}", [], seed=s) for s in (7, 19)]
    return out


def _schedule(scenario):
    return [(at, f.kind, f.target, sorted(f.params.items()))
            for at, f in scenario.schedule()]


@pytest.mark.parametrize("index", range(len(_scenarios(chaos))))
def test_schedule_equals_jax(index):
    """ChaosScenario.schedule() against client_tpu.testing.chaos's for the
    same faults and seed: the same offsets (exact), kinds, targets and
    parameters, and the same seeded workload draws (``rng()``)."""
    mine, ref = _scenarios(chaos)[index], _scenarios(jchaos)[index]
    assert _schedule(mine) == _schedule(ref)
    assert ([mine.rng().randrange(1, 9) for _ in range(16)]
            == [ref.rng().randrange(1, 9) for _ in range(16)])


# -- the reference's scenarios on the port, under the witnesses --------------

@pytest.mark.usefixtures("port")
@pytest.mark.parametrize("case, saw", [
    ("test_scenario_schedule_is_seed_deterministic", ""),
    ("test_step_ledger_exactly_once_semantics", "lf"),
    ("test_run_scenario_collects_errors_and_wedges", ""),
    ("test_dispatch_fault_drives_a_fault_proxy", "l"),
    ("test_stale_peer_reply_is_not_a_quorum_ack", "lf"),
    ("test_dispatch_partition_and_heal_fleet_tiers", "lf"),
    ("test_best_effort_acks_without_quorum_and_loss_is_visible", "lf"),
    ("test_sigkill_with_active_durable_sequences", "lfr"),
    ("test_partitioned_quorum_never_acks_then_loses", "lf"),
    ("test_autoscale_absorbs_diurnal_ramp", "lfr"),
])
def test_scenario_on_the_port(case, saw, tmp_path):
    """tests/test_chaos.py::<case> on the port's objects."""
    witnessed(tmp_path, getattr(jc, case), saw=saw)


@pytest.mark.usefixtures("port")
@pytest.mark.parametrize("case, saw", [
    ("test_chaos_matrix_round_under_race_witness", "lf"),
    ("test_chaos_matrix_round_under_resource_witness", "lr"),
    ("test_invariant_failure_dumps_flight_recorders", "l"),
])
def test_witness_round_on_the_port(case, saw, tmp_path):
    """tests/test_chaos.py::<case>: the port's matrix with the port's
    witnesses (their seeded race and leak go red inside the round; the
    outer witnesses see only the clean part, since the round drains its
    seeded leak)."""
    (tmp_path / "round").mkdir()
    witnessed(tmp_path, getattr(jc, case), tmp_path / "round", saw=saw)


@pytest.mark.usefixtures("port")
def test_sigkill_failover_joins_one_trace(tmp_path, capsys):
    """tests/test_chaos.py::test_sigkill_failover_joins_one_trace: four
    trace files (three port servers, the port's client) joined by the
    port's traceview into one timeline across the kill."""
    (tmp_path / "traces").mkdir()
    witnessed(tmp_path, jc.test_sigkill_failover_joins_one_trace,
              tmp_path / "traces", capsys, saw="lfr")


@pytest.mark.usefixtures("port")
def test_anti_entropy_survives_sigkill(tmp_path, weights):
    """tests/test_chaos.py::test_anti_entropy_survives_sigkill on three
    port LM engines; survivors byte-exact to the JAX serial stream."""
    witnessed(tmp_path, jc.test_anti_entropy_survives_sigkill, weights[1],
              saw="lfr")


@pytest.mark.usefixtures("port")
def test_spec_cancel_preempt_round_never_leaks(tmp_path, weights):
    """tests/test_chaos.py::test_spec_cancel_preempt_round_never_leaks:
    speculative k = 4, a cancel with drafts in flight and a gold
    preemption, on the port's engine; the round's own ResourceWitness
    saw KV reservations and none is left."""
    witnessed(tmp_path, jc.test_spec_cancel_preempt_round_never_leaks,
              weights[1], saw="lfr")


# -- the soak twins ---------------------------------------------------------

@pytest.mark.slow
@pytest.mark.usefixtures("port")
@pytest.mark.parametrize("case", [
    "test_sigkill_durable_sequences_soak",
    "test_partitioned_quorum_soak",
    "test_autoscale_diurnal_ramp_soak",
])
def test_soak_on_the_port(case, tmp_path):
    """tests/test_chaos.py::<case> on the port's objects."""
    witnessed(tmp_path, getattr(jc, case), saw="lf")


@pytest.mark.slow
@pytest.mark.usefixtures("port")
def test_anti_entropy_sigkill_soak(tmp_path, weights):
    """tests/test_chaos.py::test_anti_entropy_sigkill_soak on the port."""
    witnessed(tmp_path, jc.test_anti_entropy_sigkill_soak, weights[1],
              saw="lfr")
