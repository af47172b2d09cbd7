"""Client-side replica set: self-healing, health/circuit-aware balancing.

Counterpart of client_tpu/balance/__init__.py: the same ``__all__``,
over the port's four clients and its own resilience layer.

Turns N independent KServe-v2 endpoints into one logical service for all
four clients (sync/aio × HTTP/gRPC):

- :class:`EndpointPool` — endpoint registry with per-endpoint circuit
  breaker, health state machine (fed by jittered background readiness
  probes and per-request outcomes), live membership
  (``update_endpoints``: probation for new replicas, graceful retire for
  removed ones, a safety valve for the last healthy endpoint), routing
  weight, and live inflight count.
- Discovery (:mod:`client_tpu_torch.balance.discovery`) — pluggable
  :class:`Resolver` sources (static list, config-file watcher,
  DNS-style callable, TTL-honoring :class:`SrvResolver`) polled by a
  :class:`DiscoveryLoop` that feeds the pool; resolver errors keep
  last-known-good membership.
- Policies (:mod:`client_tpu_torch.balance.policy`) — round-robin,
  least-inflight, power-of-two-choices, weighted, sticky (sequence-
  affine, with the :class:`SequenceRestartError` restart contract), and
  prefix-aware (cache-affinity over gossiped digest summaries) — behind
  one ``pick(candidates, request_ctx)`` interface.
- :class:`ReplicatedClient` / :class:`AsyncReplicatedClient` — the
  existing client API over a pool: every request (and every retry
  attempt, which excludes the failed endpoint) routes to a different
  healthy replica, respecting drain, probation/retire, and open circuits.
- :class:`ResilientStream` / ``resilient_stream_infer`` — replica-aware
  streaming reconnect: a mid-stream replica death hops the stream to a
  fresh replica, replaying only unacknowledged requests and deduping
  duplicate responses by request id.

Built on the resilience layer (`client_tpu_torch.resilience`:
``call_with_failover``, ``CircuitBreakerRegistry``) and observable
through the metrics (`serve.metrics.BalancerMetricsObserver`) and tracing
(endpoint-stamped CLIENT_ATTEMPT spans) surfaces.  See README
"Replication & load balancing" and "Self-healing & discovery".
"""

from client_tpu_torch.balance.discovery import (
    CallableResolver,
    ConfigFileResolver,
    DiscoveryLoop,
    Resolver,
    SrvResolver,
    StaticResolver,
    make_resolver,
)
from client_tpu_torch.balance.policy import (
    LeastInflight,
    Policy,
    PowerOfTwoChoices,
    PrefixAware,
    RoundRobin,
    SequenceRestartError,
    Sticky,
    Weighted,
    make_policy,
)
from client_tpu_torch.balance.pool import (
    PHASE_ACTIVE,
    PHASE_PROBATION,
    PHASE_RETIRING,
    Endpoint,
    EndpointPool,
    Lease,
)
from client_tpu_torch.balance.replicated import (
    AsyncReplicatedClient,
    ReplicatedClient,
)
from client_tpu_torch.balance.stream import ResilientStream, aio_resilient_stream

__all__ = [
    "Endpoint",
    "EndpointPool",
    "Lease",
    "PHASE_ACTIVE",
    "PHASE_PROBATION",
    "PHASE_RETIRING",
    "Policy",
    "RoundRobin",
    "LeastInflight",
    "PowerOfTwoChoices",
    "Weighted",
    "Sticky",
    "PrefixAware",
    "SequenceRestartError",
    "make_policy",
    "Resolver",
    "StaticResolver",
    "CallableResolver",
    "ConfigFileResolver",
    "SrvResolver",
    "make_resolver",
    "DiscoveryLoop",
    "ReplicatedClient",
    "AsyncReplicatedClient",
    "ResilientStream",
    "aio_resilient_stream",
]
