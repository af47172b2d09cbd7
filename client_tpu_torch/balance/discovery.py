"""Live endpoint discovery: resolvers feeding EndpointPool.update_endpoints.

Counterpart of client_tpu/balance/discovery.py.

A *resolver* answers "what replicas exist right now?" — the source of
truth a fleet actually has (a config file an operator edits, a DNS-style
lookup, a service-registry callable).  The :class:`DiscoveryLoop` polls
one and applies the answer to a live pool:

- resolved membership goes through
  :meth:`~client_tpu_torch.balance.pool.EndpointPool.update_endpoints` (new
  endpoints enter probation, removed ones retire gracefully, the last
  healthy endpoint is never evicted);
- a resolver ERROR keeps the last-known-good membership — a registry
  outage must not look like a fleet-wide scale-down (the loop records the
  error and keeps serving on what it last saw).

Resolvers return an iterable of endpoint specs in the pool's vocabulary:
url strings or ``(url, weight)`` pairs.

This module is stdlib-only and thread-safe where it needs to be; the
loop's poller is a daemon thread, and :meth:`DiscoveryLoop.refresh_now`
gives tests and CLIs a synchronous poke.
"""

import json
import threading
import time

__all__ = [
    "Resolver",
    "StaticResolver",
    "CallableResolver",
    "ConfigFileResolver",
    "SrvResolver",
    "make_resolver",
    "DiscoveryLoop",
]


class Resolver:
    """Interface: :meth:`resolve` returns the current endpoint specs
    (url strings or ``(url, weight)`` pairs).  Raise on failure — the
    discovery loop treats an exception as "keep last-known-good", never
    as an empty fleet."""

    def resolve(self):
        raise NotImplementedError


class StaticResolver(Resolver):
    """A fixed list (the no-discovery degenerate case, useful to unify
    code paths and tests)."""

    def __init__(self, endpoints):
        self._endpoints = [
            tuple(e) if isinstance(e, (tuple, list)) else str(e)
            for e in endpoints
        ]

    def resolve(self):
        return list(self._endpoints)


class CallableResolver(Resolver):
    """Wrap any ``fn() -> endpoint specs`` (a DNS lookup, a service
    registry client, a test harness mutating membership)."""

    def __init__(self, fn):
        self._fn = fn

    def resolve(self):
        return self._fn()


class ConfigFileResolver(Resolver):
    """Membership from a config file an operator (or orchestrator) edits.

    Two formats, sniffed per read:

    - JSON: a list of url strings or ``[url, weight]`` pairs, or an
      object ``{"endpoints": [...]}``;
    - plain text: one endpoint per line, ``url`` or ``url weight``,
      ``#`` comments and blank lines ignored.

    Reads the file on every :meth:`resolve` (discovery intervals are
    seconds; an mtime cache would only save a stat).  A missing or
    unparseable file raises — the loop keeps last-known-good.
    """

    def __init__(self, path):
        self.path = str(path)

    def resolve(self):
        with open(self.path, "r", encoding="utf-8") as f:
            text = f.read()
        stripped = text.lstrip()
        if stripped.startswith(("[", "{")):
            data = json.loads(stripped)
            if isinstance(data, dict):
                data = data["endpoints"]
            return [
                (str(e[0]), float(e[1]))
                if isinstance(e, (list, tuple)) else str(e)
                for e in data
            ]
        specs = []
        for line in text.splitlines():
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            if len(parts) == 1:
                specs.append(parts[0])
            else:
                specs.append((parts[0], float(parts[1])))
        return specs


class SrvResolver(Resolver):
    """DNS ``SRV``-style resolution honoring record TTLs.

    ``lookup()`` answers like an SRV query: an iterable of records, each
    a url string, a ``(url, weight)`` pair, or a ``(url, weight,
    ttl_s)`` triple (target + weight + per-record TTL).  Two behaviors a
    plain :class:`CallableResolver` cannot give a fleet:

    - **TTL caching**: :meth:`resolve` serves the cached answer until
      the SMALLEST record TTL expires (records without one use
      ``default_ttl_s``; ``min_ttl_s`` floors a zero/garbage TTL so a
      misconfigured zone cannot turn discovery into a query-per-request
      hot loop), then re-resolves;
    - **stale-on-error**: a lookup failure AFTER a successful resolution
      serves the last-known-good answer and re-arms a retry after
      ``min_ttl_s`` — a registry outage must not look like a fleet-wide
      scale-down.  Only an initial failure, with nothing cached yet,
      raises (the DiscoveryLoop then keeps ITS last-known-good).

    ``resolutions``/``errors``/``last_error`` count live behavior for
    tests and ops.
    """

    def __init__(self, lookup, default_ttl_s=30.0, min_ttl_s=1.0,
                 time_fn=time.monotonic):
        self._lookup = lookup
        self.default_ttl_s = float(default_ttl_s)
        self.min_ttl_s = float(min_ttl_s)
        self._time = time_fn
        self._lock = threading.Lock()
        self._cached = None
        self._expiry = 0.0
        self.resolutions = 0
        self.errors = 0
        self.last_error = None

    def _parse(self, records):
        specs = []
        ttls = []
        for record in records:
            if isinstance(record, (tuple, list)):
                url = str(record[0])
                weight = float(record[1]) if len(record) > 1 else 1.0
                if len(record) > 2 and record[2] is not None:
                    ttls.append(float(record[2]))
                specs.append((url, weight))
            else:
                specs.append(str(record))
        ttl = min(ttls) if ttls else self.default_ttl_s
        return specs, max(ttl, self.min_ttl_s)

    def resolve(self):
        now = self._time()
        with self._lock:
            if self._cached is not None and now < self._expiry:
                return list(self._cached)
        try:
            records = list(self._lookup())
        except Exception as exc:  # noqa: BLE001 - stale-on-error
            with self._lock:
                self.errors += 1
                self.last_error = exc
                if self._cached is not None:
                    # serve stale; retry after the floor, not the full
                    # TTL (the outage should be re-probed promptly)
                    self._expiry = now + self.min_ttl_s
                    return list(self._cached)
            raise
        specs, ttl = self._parse(records)
        with self._lock:
            self._cached = specs
            self._expiry = now + ttl
            self.resolutions += 1
        return list(specs)


def make_resolver(spec):
    """Resolver from a Resolver, a callable, a path string, or a list."""
    if isinstance(spec, Resolver):
        return spec
    if callable(spec):
        return CallableResolver(spec)
    if isinstance(spec, str):
        return ConfigFileResolver(spec)
    return StaticResolver(spec)


class DiscoveryLoop:
    """Poll a resolver and keep a pool's membership current.

    Parameters
    ----------
    pool : the live :class:`~client_tpu_torch.balance.pool.EndpointPool`.
    resolver : anything :func:`make_resolver` accepts.
    interval_s : polling period (the poller thread is a daemon).
    on_update : optional ``fn(summary)`` called after each APPLIED update
        (the dict ``update_endpoints`` returns) — logging/test hook.

    Error containment: a resolver exception (or a membership the pool
    rejects, e.g. an empty list) leaves the pool on its last-known-good
    membership; the loop counts it (:attr:`errors`, :attr:`last_error`)
    and keeps polling.
    """

    def __init__(self, pool, resolver, interval_s=30.0, on_update=None):
        self.pool = pool
        self.resolver = make_resolver(resolver)
        self.interval_s = float(interval_s)
        self.on_update = on_update
        self._lock = threading.Lock()
        self._thread = None
        self._stop = threading.Event()
        self.updates = 0
        self.errors = 0
        self.last_error = None

    def refresh_now(self):
        """One synchronous resolve+apply.  Returns the update summary, or
        None when the resolver (or the pool) rejected this round — the
        pool keeps its last-known-good membership either way."""
        try:
            specs = list(self.resolver.resolve())
            summary = self.pool.update_endpoints(specs)
        except Exception as exc:  # noqa: BLE001 - containment is the point
            with self._lock:
                self.errors += 1
                self.last_error = exc
            return None
        with self._lock:
            self.updates += 1
        if self.on_update is not None:
            try:
                self.on_update(summary)
            except Exception:
                pass
        return summary

    def start(self):
        with self._lock:
            if self._thread is not None:
                return self
            stop = threading.Event()
            self._stop = stop
            thread = threading.Thread(
                target=self._run, args=(stop,),
                name="endpoint-discovery", daemon=True,
            )
            self._thread = thread
        thread.start()
        return self

    def _run(self, stop):
        # refresh_now() contains its own errors, but the loop body still
        # sits under a guard (the BG-THREAD-CRASH shape): a poller thread
        # that dies silently freezes fleet membership forever
        while not stop.is_set():
            try:
                self.refresh_now()
            except Exception:  # pragma: no cover - defensive
                pass
            if stop.wait(self.interval_s):
                return

    def close(self):
        with self._lock:
            thread = self._thread
            self._thread = None
            stop = self._stop
        stop.set()
        if thread is not None:
            thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
