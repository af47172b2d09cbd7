"""The port's dynamic witnesses: lock order, data races and resource
leaks over client_tpu_torch's own objects.

A leaf that exports the witnesses of :mod:`client_tpu_torch.analysis.
witness` and nothing of the rule catalogue.  The static pass (the AST
rules, the call graph, the locksets and the resource rules) stays
``client_tpu.analysis``, which reads source text and runs on this
package as it is: ``python -m client_tpu.analysis client_tpu_torch``.

Importing it is as cheap as the reference's leaf: the standard library
only, no tensor work.  :mod:`~client_tpu_torch.analysis.resources` (the
table of live classes the resource witness patches) is imported when a
:class:`ResourceWitness` is armed.
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
]
