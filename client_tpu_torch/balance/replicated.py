"""Replicated clients: the existing client API over an EndpointPool.

Counterpart of client_tpu/balance/replicated.py over the port's four
clients (``client_tpu_torch.{http,grpc}`` and their ``aio`` modules).

:class:`ReplicatedClient` (sync, HTTP or gRPC) and
:class:`AsyncReplicatedClient` (asyncio, HTTP or gRPC) present the familiar
``InferenceServerClient`` surface — ``infer``, the health and metadata
verbs, the gRPC streaming entry points — but take a pool of endpoints in
place of one URL and route every request through it:

- each request (and each retry attempt) goes to a healthy replica picked
  by the pool's policy; a failed attempt's endpoint is excluded so the
  retry lands on a *different* replica (the failover hop is immediate
  while an untried healthy replica exists — see
  :func:`client_tpu_torch.resilience.call_with_failover`);
- drained replicas (ServerReady→false, observed by the background
  readiness probes) stop receiving new work while their in-flight
  requests finish;
- open circuits are skipped until their half-open probe admits one
  attempt;
- with a ``resolver`` (see :mod:`client_tpu_torch.balance.discovery`), pool
  membership tracks the live fleet: added replicas enter probation and
  take traffic once probed ready, removed ones retire gracefully;
- sequence workloads ride the ``sticky`` policy: the ``sequence_id`` /
  ``sequence_start`` / ``sequence_end`` kwargs flow to the policy as the
  request context, so every request of a sequence lands on one replica
  (and a dead replica surfaces
  :class:`~client_tpu_torch.balance.policy.SequenceRestartError`);
- with a ``tracer``, the whole request is one client span: every attempt
  records its endpoint (the failover hop is visible as consecutive
  CLIENT_ATTEMPT_START events with different endpoints) and the W3C
  ``traceparent`` is propagated to whichever server serves each attempt,
  so client and server spans join under one trace id.

Streams are pinned: ``start_stream``/``stream_infer`` lease one healthy
endpoint for the stream's lifetime.  The *resilient* variants
(:meth:`ReplicatedClient.resilient_stream`,
:meth:`AsyncReplicatedClient.resilient_stream_infer`) survive mid-stream
replica death by reconnecting to a fresh replica and replaying only the
unacknowledged requests — see :mod:`client_tpu_torch.balance.stream`.
"""

import asyncio
import threading

from client_tpu_torch import resilience as _resilience
from client_tpu_torch import tracing as _tracing
from client_tpu_torch.balance.discovery import DiscoveryLoop, make_resolver
from client_tpu_torch.balance.pool import EndpointPool
from client_tpu_torch.balance.stream import ResilientStream, aio_resilient_stream
from client_tpu_torch.utils import SERVER_READY, raise_error

__all__ = ["ReplicatedClient", "AsyncReplicatedClient"]

_DEFAULT_PROBE_INTERVAL_S = 2.0
_DEFAULT_DISCOVERY_INTERVAL_S = 30.0
# Background probes must be bounded: one black-holed endpoint would
# otherwise wedge the pool's serial prober thread forever.
_PROBE_TIMEOUT_S = 5.0


def _default_factory(transport, aio):
    if transport == "http":
        if aio:
            from client_tpu_torch.http import aio as mod
        else:
            from client_tpu_torch import http as mod
    elif transport == "grpc":
        if aio:
            from client_tpu_torch.grpc import aio as mod
        else:
            from client_tpu_torch import grpc as mod
    else:
        raise_error(
            f"unknown transport '{transport}' (choose 'http' or 'grpc')"
        )
    return mod.InferenceServerClient


def _as_pool(pool_or_urls, policy):
    if isinstance(pool_or_urls, EndpointPool):
        return pool_or_urls, False
    return EndpointPool(pool_or_urls, policy=policy), True


def _attempt_timeout_kwargs(transport, kwargs, timeout_s):
    """Cap the caller's per-request client timeout by the deadline-derived
    per-attempt budget, in each transport's vocabulary (gRPC:
    ``client_timeout``; HTTP: ``client_timeout_s``)."""
    if timeout_s is None:
        return kwargs
    key = "client_timeout" if transport == "grpc" else "client_timeout_s"
    combined = _resilience.combine_timeouts(kwargs.get(key), timeout_s)
    # floor: an expired budget must not become a zero/negative transport
    # timeout (all three transports reject those); the failover loop's
    # deadline check raises right after the fast-failing attempt
    kwargs[key] = max(combined, 1e-3)
    return kwargs


def _request_ctx(model_name, kwargs):
    """The routing context content-aware policies (sticky) key on."""
    params = kwargs.get("parameters") or {}
    return {
        "model_name": model_name,
        "sequence_id": kwargs.get("sequence_id", 0),
        "sequence_start": bool(kwargs.get("sequence_start", False)),
        "sequence_end": bool(kwargs.get("sequence_end", False)),
        # durable sequences replicate server-side state through the fleet
        # tier: the sticky policy remaps them SILENTLY on replica death
        # instead of raising SequenceRestartError
        "sequence_durable": bool(params.get("sequence_durable", False)),
    }


def _sequence_params(kwargs):
    """Fold the ``sequence_durable``/``sequence_step`` convenience kwargs
    into the request ``parameters`` dict (the transport clients pass
    parameters through verbatim; these two are engine-level sequence
    semantics, not transport kwargs)."""
    durable = kwargs.pop("sequence_durable", None)
    step = kwargs.pop("sequence_step", None)
    if durable is None and step is None:
        return kwargs
    params = dict(kwargs.get("parameters") or {})
    if durable is not None:
        params["sequence_durable"] = bool(durable)
    if step is not None:
        params["sequence_step"] = int(step)
    kwargs["parameters"] = params
    return kwargs


def _prefix_digests(model_name, inputs, kwargs, prefix_fn, block_size):
    """The ``prefix_digests`` routing hint for the prefix-aware policy.

    Priority: an explicit ``prefix_digests=`` kwarg, then a
    ``prefix_tokens=`` kwarg (token ids the caller already has), then
    the client's ``prefix_fn(model_name, inputs)`` tokenizer hook.
    Returns a digest list or None; tokens digest through
    ``client_tpu_torch.serve.fleet.chain_digests`` (imported lazily — plain
    transport clients never pay for the serving stack)."""
    digests = kwargs.pop("prefix_digests", None)
    tokens = kwargs.pop("prefix_tokens", None)
    if digests is not None:
        return list(digests)
    if tokens is None and prefix_fn is not None:
        tokens = prefix_fn(model_name, inputs)
    if tokens is None:
        return None
    from client_tpu_torch.serve.fleet import chain_digests

    return chain_digests(tokens, block_size)


def _probe_fn(transport, client_for):
    """A bounded ``probe(url)`` callable for EndpointPool.start_probes."""
    if transport == "grpc":
        return lambda url: client_for(url).server_state(
            client_timeout=_PROBE_TIMEOUT_S
        )
    return lambda url: client_for(url).server_state(
        timeout_s=_PROBE_TIMEOUT_S
    )


class ReplicatedClient:
    """Synchronous replica-set client (HTTP or gRPC transport).

    Parameters
    ----------
    pool : EndpointPool, or an iterable of endpoint URLs (a pool with
        *policy* is built around it and owned/closed by this client).
    transport : 'http' or 'grpc' — which client speaks to each replica.
    policy : balancing policy for a URL-built pool (ignored when an
        EndpointPool is passed; configure the pool directly then).
        ``"sticky"`` routes sequence workloads (see the module docstring).
    retry_policy : RetryPolicy governing attempts/backoff/deadline across
        the failover loop.  Default: one attempt per replica plus one
        (every replica gets a shot, then one wrapped retry).  The policy's
        own ``circuit_breaker`` is unused — breakers are per-endpoint,
        owned by the pool.
    tracer : optional ClientTracer; see the module docstring.
    probe_interval_s : readiness-probe period (None disables probing —
        drain then goes unnoticed until requests fail, and discovery
        additions skip probation).
    resolver : optional endpoint-discovery source — anything
        :func:`client_tpu_torch.balance.discovery.make_resolver` accepts
        (a Resolver, a callable, a config-file path, or a static list).
        A DiscoveryLoop polling it every *discovery_interval_s* keeps the
        pool's membership live; resolver errors keep last-known-good.
    client_factory : ``factory(url, **client_kwargs) -> client`` override.
    client_kwargs : passed to every per-endpoint client constructor.
    """

    def __init__(self, pool, transport="http", policy="round-robin",
                 retry_policy=None, tracer=None,
                 probe_interval_s=_DEFAULT_PROBE_INTERVAL_S,
                 resolver=None,
                 discovery_interval_s=_DEFAULT_DISCOVERY_INTERVAL_S,
                 client_factory=None, prefix_fn=None, prefix_block_size=16,
                 **client_kwargs):
        self._pool, self._owns_pool = _as_pool(pool, policy)
        self._transport = transport
        self._factory = client_factory or _default_factory(transport, False)
        self._client_kwargs = client_kwargs
        # tokenizer-aware prefix routing: prefix_fn(model_name, inputs)
        # returns the request's prompt token ids; infer() digests them
        # into the prefix_digests routing ctx the prefix-aware policy
        # keys on (explicit prefix_digests=/prefix_tokens= kwargs win)
        self._prefix_fn = prefix_fn
        self._prefix_block_size = int(prefix_block_size)
        # Per-endpoint clients are created lazily: with live discovery the
        # membership outgrows whatever existed at construction.
        self._clients = {}
        self._clients_lock = threading.Lock()
        self._retry_policy = retry_policy or _resilience.RetryPolicy(
            max_attempts=len(self._pool) + 1
        )
        self._tracer = tracer
        self._stream_lease = None
        self._discovery = None
        # Whether close() must stop the pool's prober: always for a pool
        # we built; for a caller-provided pool only when WE armed probes
        # on it (they run through our clients, which close() closes).
        self._stop_pool = self._owns_pool
        if probe_interval_s:
            armed = self._pool.start_probes(
                _probe_fn(transport, self.client_for),
                interval_s=probe_interval_s,
            )
            self._stop_pool = self._stop_pool or armed
        if resolver is not None:
            self._discovery = DiscoveryLoop(
                self._pool, make_resolver(resolver),
                interval_s=discovery_interval_s,
            ).start()

    # -- lifecycle -----------------------------------------------------------

    @property
    def pool(self):
        return self._pool

    @property
    def discovery(self):
        """The DiscoveryLoop when a resolver was given (None otherwise)."""
        return self._discovery

    def close(self):
        if self._discovery is not None:
            self._discovery.close()
        if self._stream_lease is not None:
            self.stop_stream()
        if self._stop_pool:
            # stops the prober; a shared pool stays usable (its owner can
            # re-arm probes with start_probes)
            self._pool.close()
        with self._clients_lock:
            clients = list(self._clients.values())
            self._clients.clear()
        for client in clients:
            try:
                client.close()
            except Exception:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- routing core --------------------------------------------------------

    def _route(self, excluded, request_ctx=None):
        return self._pool.lease(excluded, request_ctx)

    def _routed(self, verb, *args, **kwargs):
        """One management/metadata call, routed with failover.  On gRPC
        the deadline-derived per-attempt timeout caps each verb's
        ``client_timeout`` (every gRPC verb takes it); the HTTP verbs ride
        their client's pool-level timeouts, which bound them too."""

        def attempt(lease, timeout_s):
            call_kwargs = dict(kwargs)
            if self._transport == "grpc":
                _attempt_timeout_kwargs("grpc", call_kwargs, timeout_s)
            return getattr(self.client_for(lease.url), verb)(
                *args, **call_kwargs
            )

        return _resilience.call_with_failover(
            attempt, self._retry_policy, self._route
        )

    # -- inference -----------------------------------------------------------

    def infer(self, model_name, inputs, **kwargs):
        """One inference, routed across the replica set with failover.

        Accepts the underlying transport client's ``infer`` kwargs plus
        four replica-set extras: ``sequence_durable=``/``sequence_step=``
        (folded into the request parameters — durable sequences survive
        replica death through the fleet tier) and
        ``prefix_digests=``/``prefix_tokens=`` (the prefix-aware
        routing hint; a ``prefix_fn`` client hook computes it from the
        inputs when neither is given).  The sequence kwargs double as
        the routing context for the sticky policy (see the module
        docstring).

        Sequence requests trace under ONE pinned trace id per sequence
        (``ClientTracer`` context pinning): every step — including the
        failover retries after a replica death — joins a single trace,
        which is what lets traceview show a kill-mid-stream failover as
        one timeline spanning client and both replicas."""
        seq_id = kwargs.get("sequence_id", 0)
        context_key = ("sequence", seq_id) if seq_id else None
        with _tracing.client_span(
            self._tracer, model_name, context_key=context_key
        ) as trace:
            headers = dict(kwargs.pop("headers", None) or {})
            if trace is not None:
                headers["traceparent"] = trace.traceparent()
            kwargs = _sequence_params(kwargs)
            ctx = _request_ctx(model_name, kwargs)
            digests = _prefix_digests(
                model_name, inputs, kwargs, self._prefix_fn,
                self._prefix_block_size,
            )
            if digests:
                ctx["prefix_digests"] = digests

            def route(excluded):
                return self._route(excluded, ctx)

            def attempt(lease, timeout_s):
                call_kwargs = dict(kwargs)
                if headers:
                    call_kwargs["headers"] = headers
                _attempt_timeout_kwargs(self._transport, call_kwargs,
                                        timeout_s)
                with _tracing.attempt_span(trace, endpoint=lease.url):
                    return self.client_for(lease.url).infer(
                        model_name, inputs, **call_kwargs
                    )

            result = _resilience.call_with_failover(
                attempt, self._retry_policy, route
            )
            if (context_key is not None and kwargs.get("sequence_end")
                    and self._tracer is not None):
                # the sequence is over: a restarted id starts fresh
                self._tracer.release_context(context_key)
            return result

    # -- health --------------------------------------------------------------
    # "The service" is live/ready when ANY replica is; per-replica detail
    # comes from server_states() (direct probes) / states() (pool view).

    def is_server_live(self, **kwargs):
        return any(
            self._safe(self.client_for(url).is_server_live, **kwargs)
            for url in self._pool.urls()
        )

    def is_server_ready(self, **kwargs):
        return any(
            state == SERVER_READY
            for state in self.server_states(**kwargs).values()
        )

    def is_model_ready(self, model_name, **kwargs):
        return any(
            self._safe(self.client_for(url).is_model_ready, model_name,
                       **kwargs)
            for url in self._pool.urls()
        )

    def server_states(self, **kwargs):
        """{url: READY/NOT_READY/UNREACHABLE} — one live probe per replica,
        each bounded by the default probe timeout unless the caller passes
        their own (a black-holed replica must not hang the sweep)."""
        if not kwargs:
            key = (
                "client_timeout" if self._transport == "grpc" else "timeout_s"
            )
            kwargs = {key: _PROBE_TIMEOUT_S}
        return {
            url: self.client_for(url).server_state(**kwargs)
            for url in self._pool.urls()
        }

    def states(self):
        """The pool's current (probe/outcome-fed) health view."""
        return self._pool.states()

    @staticmethod
    def _safe(fn, *args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception:
            return False

    # -- metadata / management (routed with failover) ------------------------

    def get_server_metadata(self, *args, **kwargs):
        return self._routed("get_server_metadata", *args, **kwargs)

    def get_model_metadata(self, *args, **kwargs):
        return self._routed("get_model_metadata", *args, **kwargs)

    def get_model_config(self, *args, **kwargs):
        return self._routed("get_model_config", *args, **kwargs)

    def get_model_repository_index(self, *args, **kwargs):
        return self._routed("get_model_repository_index", *args, **kwargs)

    def get_inference_statistics(self, *args, **kwargs):
        return self._routed("get_inference_statistics", *args, **kwargs)

    def call(self, verb, *args, **kwargs):
        """Escape hatch: route any other client verb with failover.  For
        verbs with side effects on ONE replica (model load/unload, shm
        registration) address the per-endpoint client directly instead:
        ``client_for(url).load_model(...)``."""
        return self._routed(verb, *args, **kwargs)

    def client_for(self, url):
        """The underlying per-endpoint client (created on first use —
        discovery can add endpoints long after construction)."""
        with self._clients_lock:
            client = self._clients.get(url)
            if client is None:
                client = self._factory(url, **self._client_kwargs)
                self._clients[url] = client
            return client

    # -- streaming (gRPC): pinned to one healthy replica ---------------------

    def start_stream(self, callback, **kwargs):
        if self._transport != "grpc":
            raise_error("streaming requires the grpc transport")
        if self._stream_lease is not None:
            raise_error("cannot start another stream with one already active")
        lease = self._pool.lease()
        try:
            self.client_for(lease.url).start_stream(callback, **kwargs)
        except BaseException as exc:
            # the lease must never leak, whatever start_stream raised
            # (an Exception feeds the health/breaker machinery; anything
            # else releases outcome-free)
            if isinstance(exc, Exception):
                lease.failure(exc, self._retry_policy.retryable(exc))
            else:
                lease.release()
            raise
        self._stream_lease = lease

    def resilient_stream(self, callback, max_unacked=256, **kwargs):
        """A self-healing stream over the replica set: reconnects to a
        fresh healthy replica on connection-level stream death, replaying
        unacknowledged requests (see balance/stream.py).  Independent of
        the pinned ``start_stream`` slot; close the returned
        :class:`~client_tpu_torch.balance.stream.ResilientStream` when done."""
        if self._transport != "grpc":
            raise_error("streaming requires the grpc transport")
        return ResilientStream(
            self, callback, max_unacked=max_unacked, **kwargs
        )

    def async_stream_infer(self, *args, **kwargs):
        if self._stream_lease is None:
            raise_error("stream not available, call start_stream() first")
        self.client_for(self._stream_lease.url).async_stream_infer(
            *args, **kwargs
        )

    def stop_stream(self, cancel_requests=False):
        lease = self._stream_lease
        if lease is None:
            return
        self._stream_lease = None
        try:
            self.client_for(lease.url).stop_stream(cancel_requests)
        finally:
            # outcome-free: a stream may end BECAUSE the endpoint died, so
            # releasing must not assert health (success would flip a
            # drained/unreachable endpoint back to READY)
            lease.release()


class _PinnedStream:
    """The aio pinned response stream, with a leak-proof lease.

    A bare ``async def`` generator with ``finally: lease.release()`` only
    releases once the body RUNS — a generator that is created, never
    iterated, and then ``aclose()``d (or abandoned) never enters its body
    and leaks the inflight slot forever.  This wrapper releases on
    exhaustion, on terminal error, and on ``aclose()`` regardless of
    whether iteration ever started."""

    def __init__(self, stream, lease):
        self._stream = stream
        self._lease = lease
        self._released = False

    def _release(self):
        if not self._released:
            self._released = True
            # outcome-free (see ReplicatedClient.stop_stream): the stream
            # may have ended because the endpoint died
            self._lease.release()

    def __aiter__(self):
        return self

    async def __anext__(self):
        try:
            return await self._stream.__anext__()
        except BaseException:
            # StopAsyncIteration (exhausted), a stream error, or a
            # cancellation: the pin is over either way
            self._release()
            raise

    async def aclose(self):
        self._release()
        aclose = getattr(self._stream, "aclose", None)
        if aclose is not None:
            await aclose()


class AsyncReplicatedClient:
    """asyncio replica-set client (HTTP or gRPC transport).

    Same routing semantics as :class:`ReplicatedClient`; per-endpoint
    clients are created lazily inside the running event loop, and health
    probing is on-demand (`await refresh_states()`) rather than a
    background thread — outcome-driven state still routes around dead
    replicas between refreshes.  Live membership comes from calling
    ``pool.update_endpoints()`` (or sharing a pool that a sync client's
    resolver keeps current): this client never spawns threads itself.
    """

    def __init__(self, pool, transport="http", policy="round-robin",
                 retry_policy=None, tracer=None, client_factory=None,
                 prefix_fn=None, prefix_block_size=16, **client_kwargs):
        self._pool, self._owns_pool = _as_pool(pool, policy)
        self._transport = transport
        self._factory = client_factory or _default_factory(transport, True)
        self._client_kwargs = client_kwargs
        self._prefix_fn = prefix_fn
        self._prefix_block_size = int(prefix_block_size)
        self._clients = {}
        self._retry_policy = retry_policy or _resilience.RetryPolicy(
            max_attempts=len(self._pool) + 1
        )
        self._tracer = tracer

    @property
    def pool(self):
        return self._pool

    def _client_for(self, url):
        client = self._clients.get(url)
        if client is None:
            client = self._factory(url, **self._client_kwargs)
            self._clients[url] = client
        return client

    async def close(self):
        if self._owns_pool:
            self._pool.close()
        for client in self._clients.values():
            try:
                await client.close()
            except Exception:
                pass

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.close()

    # -- routing core --------------------------------------------------------

    def _route(self, excluded, request_ctx=None):
        return self._pool.lease(excluded, request_ctx)

    async def _routed(self, verb, *args, **kwargs):
        # same per-attempt timeout handling as the sync client's _routed
        async def attempt(lease, timeout_s):
            call_kwargs = dict(kwargs)
            if self._transport == "grpc":
                _attempt_timeout_kwargs("grpc", call_kwargs, timeout_s)
            return await getattr(self._client_for(lease.url), verb)(
                *args, **call_kwargs
            )

        return await _resilience.acall_with_failover(
            attempt, self._retry_policy, self._route
        )

    # -- inference -----------------------------------------------------------

    async def infer(self, model_name, inputs, **kwargs):
        # sequence requests pin one trace id per sequence id (see the
        # sync client's infer for the rationale)
        seq_id = kwargs.get("sequence_id", 0)
        context_key = ("sequence", seq_id) if seq_id else None
        with _tracing.client_span(
            self._tracer, model_name, context_key=context_key
        ) as trace:
            headers = dict(kwargs.pop("headers", None) or {})
            if trace is not None:
                headers["traceparent"] = trace.traceparent()
            kwargs = _sequence_params(kwargs)
            ctx = _request_ctx(model_name, kwargs)
            digests = _prefix_digests(
                model_name, inputs, kwargs, self._prefix_fn,
                self._prefix_block_size,
            )
            if digests:
                ctx["prefix_digests"] = digests

            def route(excluded):
                return self._route(excluded, ctx)

            async def attempt(lease, timeout_s):
                call_kwargs = dict(kwargs)
                if headers:
                    call_kwargs["headers"] = headers
                _attempt_timeout_kwargs(self._transport, call_kwargs,
                                        timeout_s)
                with _tracing.attempt_span(trace, endpoint=lease.url):
                    return await self._client_for(lease.url).infer(
                        model_name, inputs, **call_kwargs
                    )

            result = await _resilience.acall_with_failover(
                attempt, self._retry_policy, route
            )
            if (context_key is not None and kwargs.get("sequence_end")
                    and self._tracer is not None):
                self._tracer.release_context(context_key)
            return result

    # -- health --------------------------------------------------------------

    async def server_states(self, **kwargs):
        """{url: state} — all replicas probed CONCURRENTLY, each bounded
        by the default probe timeout unless the caller passes their own."""
        if not kwargs:
            key = (
                "client_timeout" if self._transport == "grpc" else "timeout_s"
            )
            kwargs = {key: _PROBE_TIMEOUT_S}
        urls = self._pool.urls()
        states = await asyncio.gather(
            *(self._client_for(url).server_state(**kwargs) for url in urls)
        )
        return dict(zip(urls, states))

    async def refresh_states(self, **kwargs):
        """Probe every replica once and feed the results into the pool
        (the async analog of the sync client's background prober)."""
        states = await self.server_states(**kwargs)
        for url, state in states.items():
            self._pool.set_state(url, state)
        return states

    async def is_server_live(self, **kwargs):
        for url in self._pool.urls():
            try:
                if await self._client_for(url).is_server_live(**kwargs):
                    return True
            except Exception:
                pass
        return False

    async def is_server_ready(self, **kwargs):
        states = await self.server_states(**kwargs)
        return any(state == SERVER_READY for state in states.values())

    async def is_model_ready(self, model_name, **kwargs):
        for url in self._pool.urls():
            try:
                if await self._client_for(url).is_model_ready(
                    model_name, **kwargs
                ):
                    return True
            except Exception:
                pass
        return False

    def states(self):
        return self._pool.states()

    # -- metadata / management -----------------------------------------------

    async def get_server_metadata(self, *args, **kwargs):
        return await self._routed("get_server_metadata", *args, **kwargs)

    async def get_model_metadata(self, *args, **kwargs):
        return await self._routed("get_model_metadata", *args, **kwargs)

    async def get_model_config(self, *args, **kwargs):
        return await self._routed("get_model_config", *args, **kwargs)

    async def get_model_repository_index(self, *args, **kwargs):
        return await self._routed(
            "get_model_repository_index", *args, **kwargs
        )

    async def get_inference_statistics(self, *args, **kwargs):
        return await self._routed("get_inference_statistics", *args, **kwargs)

    async def call(self, verb, *args, **kwargs):
        return await self._routed(verb, *args, **kwargs)

    def client_for(self, url):
        return self._client_for(url)

    # -- streaming (gRPC aio): pinned to one healthy replica -----------------

    def stream_infer(self, inputs_iterator, **kwargs):
        """Bidirectional stream over ONE leased healthy replica; the lease
        is released when the response stream finishes or the caller
        ``aclose()``s the returned stream — including an un-iterated one
        (a bare generator's ``finally`` never runs for a body that never
        started, which used to leak the inflight slot)."""
        if self._transport != "grpc":
            raise_error("streaming requires the grpc transport")
        lease = self._pool.lease()
        try:
            stream = self._client_for(lease.url).stream_infer(
                inputs_iterator, **kwargs
            )
        except BaseException as exc:
            if isinstance(exc, Exception):
                lease.failure(exc, self._retry_policy.retryable(exc))
            else:
                lease.release()
            raise
        return _PinnedStream(stream, lease)

    def resilient_stream_infer(self, inputs_iterator, max_unacked=256,
                               **kwargs):
        """Self-healing twin of :meth:`stream_infer`: reconnects to a
        fresh healthy replica on connection-level stream death, replays
        unacknowledged requests, and dedupes duplicate responses by
        request id (see balance/stream.py)."""
        if self._transport != "grpc":
            raise_error("streaming requires the grpc transport")
        return aio_resilient_stream(
            self, inputs_iterator, max_unacked=max_unacked, **kwargs
        )
