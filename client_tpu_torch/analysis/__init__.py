"""tpu-lint for the port: the static analyser and the dynamic witnesses
over client_tpu_torch.

The port's copy of client_tpu/analysis: the per-file AST rules, the
whole-program rules over the call graph (lock order, blocking under a
lock, callbacks and peer calls under a lock, locksets across thread
roots, resource lifecycles) and the witnesses that check the same
properties at run time.  The rules are the reference's, JAX keys
included (they read source text and import nothing they analyse), with
torch keys beside them: a CUDA-graph capture, a compile or extension
build and a host sync count as device dispatch under a lock; names
bound from ``torch.compile`` / ``make_graphed_callables`` as compiled
callables; torch tensor producers in truth positions; host syncs in
``async def`` bodies.  It reads the same ``# tpulint: disable=RULE --
why`` waivers, so one waiver serves both analysers.

Run ``python -m client_tpu_torch.analysis [paths]`` (default
``client_tpu_torch``; exit 0 clean, 1 findings, 2 an analyser error).

Importing the package loads the witnesses only (the standard library,
no tensor work): the rule catalogue (core, rules, resources,
callgraph, concurrency, locksets) loads on first use of one of its
names.  :mod:`~client_tpu_torch.analysis.resources` is also imported
when a :class:`ResourceWitness` is armed.
"""

from client_tpu_torch.analysis.witness import (
    LockOrderViolation,
    LockWitness,
    RaceViolation,
    RaceWitness,
    ResourceLeakError,
    ResourceWitness,
    WitnessCondition,
    WitnessLock,
    witness_shared,
)

_CORE_NAMES = [
    "Finding",
    "PROGRAM_REGISTRY",
    "ProgramRule",
    "REGISTRY",
    "Rule",
    "all_rules",
    "scan_paths",
    "scan_source",
]

__all__ = [
    "LockOrderViolation",
    "LockWitness",
    "RaceViolation",
    "RaceWitness",
    "ResourceLeakError",
    "ResourceWitness",
    "WitnessCondition",
    "WitnessLock",
    "witness_shared",
    *_CORE_NAMES,
]


def _load_core():
    """Import the analyser on first use (PEP 562 lazy init).

    Production modules import the witnesses for ``@witness_shared``; an
    eager init would drag the whole rule catalogue into every serving
    process to attach an inert class attribute."""
    from client_tpu_torch.analysis import core
    from client_tpu_torch.analysis import resources  # noqa: F401  (registers)
    from client_tpu_torch.analysis import rules  # noqa: F401  (registers)
    from client_tpu_torch.analysis import (  # noqa: F401  (registers)
        concurrency,
    )
    return core


def __getattr__(name):
    if name in _CORE_NAMES:
        return getattr(_load_core(), name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}"
    )
