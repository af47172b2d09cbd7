"""The live classes the port's :class:`~client_tpu_torch.analysis.
witness.ResourceWitness` patches.

The port's copy of ``DYNAMIC_SPECS`` from client_tpu/analysis/
resources.py, naming the port's modules.  The static resource rules
(RESOURCE-LEAK, DOUBLE-RELEASE, USE-AFTER-RELEASE) stay the reference's,
which reads this package's source as it is.

Modes: how the handle rides the call —
  ret       the return value is the handle (None = not acquired)
  ret-each  the return value is a list of handles (each tracked)
  arg-each  the first positional argument is a list of handles
  arg       the first positional argument is the handle
  self      the receiver is the handle
Threads, sockets and files stay static-only: patching them class-wide
would flag every fire-and-forget daemon and stdlib-internal fd.
"""

__all__ = ["DYNAMIC_SPECS"]

DYNAMIC_SPECS = (
    {"kind": "kv-blocks", "module": "client_tpu_torch.serve.lm.kv",
     "cls": "KvBlockPool",
     "acquire": {"alloc": "ret-each", "retain": "arg-each"},
     "release": {"release": "arg-each"}},
    {"kind": "lease", "module": "client_tpu_torch.balance.pool",
     "cls": "EndpointPool", "acquire": {"lease": "ret"}, "release": {}},
    {"kind": "lease", "module": "client_tpu_torch.balance.pool",
     "cls": "Lease", "acquire": {},
     "release": {"release": "self", "success": "self", "failure": "self"}},
    {"kind": "span", "module": "client_tpu_torch.tracing",
     "cls": "ClientTracer",
     "acquire": {"sample": "ret"}, "release": {"complete": "arg"}},
    {"kind": "span", "module": "client_tpu_torch.serve.tracing",
     "cls": "Tracer",
     "acquire": {"sample": "ret"}, "release": {"complete": "arg"}},
)
