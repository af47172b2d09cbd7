"""Replica-aware streaming reconnect over the pinned gRPC stream.

Counterpart of client_tpu/balance/stream.py, over the port's gRPC
streaming verbs.  ``ReplicatedClient.start_stream`` pins a gRPC stream
to one replica for life: a mid-stream replica death is a client-visible
stream error.  This module makes streams *self-healing*:

- :class:`ResilientStream` (sync) wraps the pinned
  ``start_stream``/``async_stream_infer`` surface.  Every request is
  tracked by request id in a bounded replay buffer until its response
  arrives; on a **connection-level** stream death
  (:func:`client_tpu_torch.resilience.is_connection_level` — the replica died
  or vanished, as opposed to answering an application error) the stream
  leases a fresh healthy replica from the pool, replays only the
  unacknowledged requests, and dedupes any duplicate responses by request
  id.  Application errors mid-stream (the server answered, with an error)
  still propagate to the user callback untouched.
- :func:`aio_resilient_stream` is the asyncio twin over
  ``stream_infer``'s async-iterator shape, yielding the familiar
  ``(result, error)`` pairs across reconnects.

Observability: with a tracer, the whole stream is ONE client span — each
connection is an endpoint-tagged CLIENT_ATTEMPT_START/END pair, so a
reconnect hop reads as consecutive attempts on different endpoints under
a single trace id (exactly how unary failover renders).  The pool
observer's ``on_stream_reconnect(url)`` / ``on_stream_replayed(url, n)``
hooks feed ``serve.metrics.BalancerMetricsObserver``'s reconnect and
replayed-request counters.

Delivery semantics: at-least-once to the *fleet* (a request the dead
replica processed without answering is replayed to the new one), exactly
once to the *callback* (duplicates deduped by request id).  Sequence
workloads should pair this with the sticky policy's restart contract —
replayed sequence state lives on the new replica only.
"""

import asyncio
import collections
import itertools
import os
import threading

from client_tpu_torch.resilience import (
    NoHealthyEndpointError,
    _notify,
    is_connection_level,
)
from client_tpu_torch.utils import InferenceServerException, raise_error

__all__ = ["ResilientStream", "aio_resilient_stream"]

# Acked-id memory, as a multiple of the replay-buffer bound: duplicates
# can only arise from replaying the still-unacked window, so a bounded
# multiple of it is enough dedupe history.
_ACK_MEMORY_FACTOR = 4


class ResilientStream:
    """Self-healing bidirectional stream over a replica set (sync gRPC).

    Built by :meth:`client_tpu_torch.balance.ReplicatedClient.resilient_stream`;
    not constructed directly in normal use.

    Parameters
    ----------
    client : the owning ReplicatedClient (grpc transport).
    callback : ``callback(result, error)`` — the user's response callback,
        invoked exactly once per request id (duplicates after a replay are
        dropped) plus once per non-retryable terminal stream error.
    max_unacked : replay-buffer bound; :meth:`async_stream_infer` blocks
        (up to *send_timeout_s*) while this many requests are in flight
        unacknowledged.
    send_timeout_s : how long a send may wait for replay-buffer space.
    stream_kwargs : passed to every underlying ``start_stream`` call
        (stream_timeout, headers, compression_algorithm).
    """

    def __init__(self, client, callback, max_unacked=256,
                 send_timeout_s=30.0, **stream_kwargs):
        self._client = client
        self._user_callback = callback
        self._stream_kwargs = stream_kwargs
        self._pool = client.pool
        self._policy = client._retry_policy
        self._max_unacked = max(int(max_unacked), 1)
        self._send_timeout_s = float(send_timeout_s)
        self._cond = threading.Condition()
        # Dedicated per-connection transport client: the shared
        # per-endpoint clients host at most ONE stream each, so borrowing
        # them would collide with the pinned start_stream slot (and with
        # other ResilientStreams) — "independent" means its own channel.
        self._endpoint_client = None
        self._pending = collections.OrderedDict()  # rid -> (model, inputs, kw)
        self._acked = set()
        self._acked_order = collections.deque()
        self._generation = 0
        self._lease = None
        self._url = None
        self._closed = False
        self._failed = None
        self._rid_prefix = os.urandom(4).hex()
        self._rid_counter = itertools.count()
        self.reconnects = 0
        self.replayed = 0
        tracer = client._tracer
        self._tracer = tracer
        self._trace = tracer.sample("<stream>") if tracer is not None else None
        if self._trace is not None:
            self._trace.event("CLIENT_REQUEST_START")
        self._connect(excluded=())

    # -- introspection -------------------------------------------------------

    @property
    def url(self):
        """The currently pinned replica (None while reconnecting)."""
        with self._cond:
            return self._url

    @property
    def pending(self):
        """Unacknowledged request ids, oldest first."""
        with self._cond:
            return list(self._pending)

    @property
    def trace(self):
        return self._trace

    # -- connection management -----------------------------------------------

    def _connect(self, excluded):
        """Lease a healthy replica and open the underlying stream on it,
        rotating through the pool on connect failures (the retry policy
        bounds attempts and paces the backoff).  Replays the pending
        buffer when this is a reconnect."""
        excluded = list(excluded)
        attempt = 0
        while True:
            try:
                lease = self._pool.lease(tuple(excluded))
            except NoHealthyEndpointError:
                attempt += 1
                if attempt >= self._policy.max_attempts:
                    raise
                if self._wait_closed(self._policy.backoff_s(attempt)):
                    raise_error("resilient stream closed during reconnect")
                excluded = []  # the pool may have recovered: retry all
                continue
            with self._cond:
                if self._closed:
                    lease.release()
                    raise_error("resilient stream is closed")
                self._generation += 1
                generation = self._generation
            endpoint_client = self._client._factory(
                lease.url, **self._client._client_kwargs
            )
            callback = self._make_callback(generation, lease)
            try:
                endpoint_client.start_stream(callback, **self._stream_kwargs)
            except Exception as exc:
                self._close_client(endpoint_client)
                retryable = self._policy.retryable(exc)
                lease.failure(exc, retryable)
                attempt += 1
                # a start failure on ONE replica says nothing about the
                # others: rotate before giving up, whatever the class
                if attempt >= self._policy.max_attempts:
                    raise
                if lease.key not in excluded:
                    excluded.append(lease.key)
                continue
            with self._cond:
                self._lease = lease
                self._url = lease.url
                self._endpoint_client = endpoint_client
                replay = list(self._pending.items())
            if self._trace is not None:
                self._trace.event("CLIENT_ATTEMPT_START", endpoint=lease.url)
            if replay:
                sent = 0
                for rid, (model_name, inputs, kwargs) in replay:
                    try:
                        endpoint_client.async_stream_infer(
                            model_name, inputs, request_id=rid, **kwargs
                        )
                    except Exception:
                        # died again mid-replay: the new stream's error
                        # callback drives the next reconnect, which will
                        # replay the (still-buffered) remainder
                        break
                    sent += 1
                if sent:
                    self.replayed += sent
                    _notify(
                        self._pool.observer, "on_stream_replayed",
                        lease.url, sent,
                    )
            return

    @staticmethod
    def _close_client(endpoint_client):
        if endpoint_client is None:
            return
        try:
            endpoint_client.close()
        except Exception:
            pass

    def _wait_closed(self, timeout_s):
        """Backoff sleep that wakes early on close; True when closed."""
        with self._cond:
            return self._cond.wait_for(lambda: self._closed, timeout=timeout_s)

    def _make_callback(self, generation, lease):
        def callback(result, error):
            self._on_event(generation, lease, result, error)

        return callback

    # -- sending -------------------------------------------------------------

    def async_stream_infer(self, model_name, inputs, request_id="",
                           **kwargs):
        """Enqueue one request (the pinned surface's signature).  Assigns
        a request id when the caller passes none — ids are the replay and
        dedupe identity, so they must be unique per stream.  Returns the
        request id.  Blocks while the replay buffer is full."""
        with self._cond:
            ok = self._cond.wait_for(
                lambda: (
                    len(self._pending) < self._max_unacked
                    or self._closed
                    or self._failed is not None
                ),
                timeout=self._send_timeout_s,
            )
            if self._closed:
                raise_error("resilient stream is closed")
            if self._failed is not None:
                raise self._failed
            if not ok:
                raise_error(
                    f"replay buffer full: {len(self._pending)} requests "
                    "unacknowledged (server not responding?)"
                )
            rid = request_id or f"{self._rid_prefix}-{next(self._rid_counter)}"
            if rid in self._pending or rid in self._acked:
                raise_error(f"duplicate request id {rid!r} on this stream")
            self._pending[rid] = (model_name, inputs, dict(kwargs))
            endpoint_client = (
                self._endpoint_client if self._url is not None else None
            )
        if endpoint_client is None:
            return rid  # reconnecting: the replay will carry it
        try:
            endpoint_client.async_stream_infer(
                model_name, inputs, request_id=rid, **kwargs
            )
        except Exception as exc:
            if self._sendable_later(exc):
                # the stream died under us: leave the request buffered —
                # the in-flight reconnect replays it
                return rid
            with self._cond:
                self._pending.pop(rid, None)
                self._cond.notify_all()
            raise
        return rid

    @staticmethod
    def _sendable_later(exc):
        """Whether a failed send is a stream-death race (buffer + replay)
        rather than a per-request error (surface to the caller)."""
        if is_connection_level(exc):
            return True
        if not isinstance(exc, InferenceServerException):
            return False
        text = str(exc)
        # the two shapes a send races a stream death into: the stream
        # object flipped inactive, or stop_stream already cleared it
        return "stream is closed" in text or "stream not available" in text

    # -- response/error handling ---------------------------------------------

    def _ack_locked(self, rid):
        """Record one answered request id; False when it is a duplicate
        (already answered before a replay re-sent it)."""
        if not rid:
            return True  # id-less response: nothing to dedupe against
        if rid in self._acked:
            return False
        self._acked.add(rid)
        self._acked_order.append(rid)
        while len(self._acked_order) > _ACK_MEMORY_FACTOR * self._max_unacked:
            self._acked.discard(self._acked_order.popleft())
        self._pending.pop(rid, None)
        self._cond.notify_all()
        return True

    def _on_event(self, generation, lease, result, error):
        rid = ""
        if result is not None:
            try:
                rid = result.get_response().id
            except Exception:
                rid = ""
        with self._cond:
            if self._closed or generation != self._generation:
                return  # a dead generation's tail: already superseded
            if error is not None and is_connection_level(error):
                # connection-level stream death: reconnect off this thread
                # (it is the dying stream's handler thread; the reconnect
                # must outlive it and may join it via stop_stream)
                threading.Thread(
                    target=self._reconnect,
                    args=(generation, lease, error),
                    name="resilient-stream-reconnect", daemon=True,
                ).start()
                return
            if not self._ack_locked(rid):
                return  # duplicate response after a replay
        # user callback outside the lock: it may send more requests
        self._user_callback(result=result, error=error)

    def _reconnect(self, generation, dead_lease, error):
        with self._cond:
            if self._closed or generation != self._generation:
                return
            self._generation += 1  # invalidate the dead stream's tail now
            self._lease = None
            dead_url = self._url
            dead_client = self._endpoint_client
            self._url = None
            self._endpoint_client = None
            self.reconnects += 1
        dead_lease.failure(error, retryable=True)
        if self._trace is not None:
            self._trace.event("CLIENT_ATTEMPT_END", endpoint=dead_url)
        _notify(self._pool.observer, "on_stream_reconnect", dead_url)
        if dead_client is not None:
            try:
                # joins the finished handler thread, then drops the channel
                dead_client.stop_stream(cancel_requests=True)
            except Exception:
                pass
            self._close_client(dead_client)
        try:
            self._connect(excluded=(dead_url,))
        except Exception as exc:  # terminal: no replica took the stream
            with self._cond:
                if self._closed:
                    return
                self._failed = exc
                self._cond.notify_all()
            self._user_callback(result=None, error=exc)

    # -- lifecycle -----------------------------------------------------------

    def close(self, cancel_requests=False):
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._generation += 1
            lease, url = self._lease, self._url
            endpoint_client = self._endpoint_client
            self._lease = None
            self._url = None
            self._endpoint_client = None
            self._cond.notify_all()
        if endpoint_client is not None:
            try:
                endpoint_client.stop_stream(cancel_requests)
            except Exception:
                pass
            self._close_client(endpoint_client)
        if lease is not None:
            # outcome-free: the stream ending says nothing about health
            lease.release()
        if self._trace is not None:
            self._trace.event("CLIENT_ATTEMPT_END", endpoint=url)
            self._trace.event("CLIENT_REQUEST_END")
            self._tracer.complete(self._trace)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def aio_resilient_stream(client, inputs_iterator, max_unacked=256,
                         **stream_kwargs):
    """Async twin of :class:`ResilientStream` over the aio
    ``stream_infer`` shape: maps an async iterator of ``infer``-kwargs
    dicts onto a replica-pinned bidirectional stream and yields
    ``(InferResult, error)`` pairs — reconnecting to a fresh healthy
    replica on connection-level stream death, replaying unacknowledged
    requests, and deduping duplicate responses by request id.

    Abandonment-safe: ``aclose()`` on the returned generator releases the
    lease and cancels the request pump even mid-reconnect.
    """
    policy = client._retry_policy
    pool = client.pool
    tracer = client._tracer
    bound = max(int(max_unacked), 1)

    async def _generator():
        pending = collections.OrderedDict()  # rid -> kwargs dict
        acked = set()
        acked_order = collections.deque()
        rid_prefix = os.urandom(4).hex()
        rid_counter = itertools.count()
        queue = asyncio.Queue(maxsize=bound)
        space = asyncio.Event()
        done_sentinel = object()
        state = {"source_done": False, "invalid": None}
        trace = tracer.sample("<stream>") if tracer is not None else None
        if trace is not None:
            trace.event("CLIENT_REQUEST_START")

        async def pump():
            async for kwargs in inputs_iterator:
                await queue.put(dict(kwargs))
            await queue.put(done_sentinel)

        pump_task = asyncio.ensure_future(pump())

        def feeder(replay):
            async def _requests():
                for kwargs in replay:
                    yield kwargs
                while not state["source_done"]:
                    while len(pending) >= bound:
                        space.clear()
                        await space.wait()  # acks free replay-buffer space
                    item = await queue.get()
                    if item is done_sentinel:
                        state["source_done"] = True
                        return
                    rid = item.get("request_id") or (
                        f"{rid_prefix}-{next(rid_counter)}"
                    )
                    if rid in pending or rid in acked:
                        # ids are the replay/dedupe identity: a reused one
                        # would silently clobber the replay buffer and eat
                        # the second response (the sync twin rejects too).
                        # Recorded before raising: grpc wraps feeder
                        # exceptions, so the response loop re-raises ours.
                        state["invalid"] = InferenceServerException(
                            f"duplicate request id {rid!r} on this stream"
                        )
                        raise state["invalid"]
                    item["request_id"] = rid
                    # record-before-yield, with no await between: a
                    # cancellation (stream death) can never lose a pulled
                    # request — it is already in the replay buffer
                    pending[rid] = item
                    yield item

            return _requests()

        lease = None
        attempt = 0
        excluded = ()
        try:
            while True:
                try:
                    lease = pool.lease(tuple(excluded))
                except NoHealthyEndpointError:
                    lease = None
                    attempt += 1
                    if attempt >= policy.max_attempts:
                        raise
                    await asyncio.sleep(policy.backoff_s(attempt))
                    excluded = ()
                    continue
                url = lease.url
                replay = list(pending.values())
                if trace is not None:
                    trace.event("CLIENT_ATTEMPT_START", endpoint=url)
                if replay:  # non-empty only on a reconnect
                    _notify(
                        pool.observer, "on_stream_replayed", url, len(replay)
                    )
                stream = client.client_for(url).stream_infer(
                    feeder(replay), **stream_kwargs
                )
                try:
                    async for result, error in stream:
                        # progress on this connection resets the reconnect
                        # budget: a long-lived stream gets a fresh attempt
                        # allowance per independent replica death
                        attempt = 0
                        rid = ""
                        if result is not None:
                            try:
                                rid = result.get_response().id
                            except Exception:
                                rid = ""
                        if rid:
                            if rid in acked:
                                continue  # duplicate after a replay
                            acked.add(rid)
                            acked_order.append(rid)
                            while len(acked_order) > (
                                _ACK_MEMORY_FACTOR * bound
                            ):
                                acked.discard(acked_order.popleft())
                            pending.pop(rid, None)
                            space.set()
                        yield result, error
                except asyncio.CancelledError:
                    # grpc.aio cancels the call locally when the request
                    # iterator raises: surface OUR validation error then;
                    # a genuine consumer cancellation propagates untouched
                    if state["invalid"] is not None:
                        lease.release()
                        lease = None
                        raise state["invalid"] from None
                    raise
                except Exception as exc:
                    if state["invalid"] is not None:
                        # caller-input validation failure, not an endpoint
                        # problem: surface OUR error, no health strike
                        lease.release()
                        lease = None
                        raise state["invalid"] from exc
                    if not (
                        is_connection_level(exc) and policy.retryable(exc)
                    ):
                        lease.failure(exc, retryable=False)
                        lease = None
                        raise
                    # connection-level stream death: hop replicas
                    lease.failure(exc, retryable=True)
                    lease = None
                    if trace is not None:
                        trace.event("CLIENT_ATTEMPT_END", endpoint=url)
                    _notify(pool.observer, "on_stream_reconnect", url)
                    attempt += 1
                    if attempt >= policy.max_attempts:
                        raise
                    excluded = (url,)
                    space.set()  # wake a feeder parked on a full buffer
                    continue
                # stream ended normally (source exhausted, server closed)
                lease.release()
                lease = None
                if trace is not None:
                    trace.event("CLIENT_ATTEMPT_END", endpoint=url)
                return
        finally:
            pump_task.cancel()
            try:
                await pump_task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
            if lease is not None:
                lease.release()
            if trace is not None:
                trace.event("CLIENT_REQUEST_END")
                tracer.complete(trace)

    return _generator()
