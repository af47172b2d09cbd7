"""Cross-replica cache tier: the replica set as ONE cache, not N.

Counterpart of client_tpu/serve/fleet.py, the whole module, with its
wire format: a port replica and a JAX replica peer with each other.
What differs is only where the KV blocks live: the host store holds
CPU torch tensors (as the engine's swap store does), written on the
wire under the JAX package's dtype names (``"bfloat16"``,
``"float32"``, ...) as the same raw little-endian bytes, bf16 through a
16-bit integer view (``utils.tensor_raw_bytes`` / ``tensor_from_raw``).
The module imports without torch: the response cache, sequences and
gossip need none, and a tier without torch refuses a peer's pushed KV
chain (``{"ok": false}``): it serves no LM.

Everything above the balance layer used to be N independent copies of one
server — a replica death lost its KV prefix trie and response cache, and
a prompt prefix prefilled on replica A bought replica B nothing.  This
module makes cached state span the fleet:

- **prefix tier**: each replica keeps a host-side store of the KV blocks
  its prefix cache published (token-chain keyed, LRU-bounded).  A peer
  admission whose local trie misses asks the fleet
  (:meth:`FleetTier.prefix_lookup`) and installs the fetched blocks into
  its own pool, so a prefix prefilled anywhere saves prefill everywhere —
  and a parked (preempted) stream exported at planned retire resumes on a
  surviving replica from the same store;
- **response-cache tier**: a unary local cache miss consults peers
  (:meth:`FleetTier.cache_lookup`) before dispatching — a fleet-hot key
  costs the fleet one execution, not one per replica;
- **gossip**: a background round piggybacks two compact payloads on the
  peer transport — per-tenant admission counters (so token-bucket quotas
  account fleet-wide; see ``TenantQoS.absorb_remote``) and digest-prefix
  summaries (what the balance layer's prefix-aware routing policy keys
  on; see :func:`chain_digests` and ``balance/policy.py``).

Transport: the same length-prefixed JSON frames as the perf rendezvous
(:mod:`client_tpu_torch.perf.rendezvous`), one request/response per connection
so the peer server stays stateless and a half-dead peer can only wedge
its own connection.

**The degraded-tier guarantee** — a degraded tier must never be slower
than no tier: every peer lookup is bounded by ``fan_out`` peers x a
short per-peer connect/read timeout, each peer sits behind its own
:class:`~client_tpu_torch.resilience.CircuitBreaker` (a dead peer stops being
dialed after ``failure_threshold`` strikes and is only re-probed after
``reset_timeout_s``), and every failure path falls back to local-only.
With every peer unreachable the steady state is "breaker open, lookup
returns immediately" — the serve path never blocks on the fleet.

**Locking discipline**: peer RPCs (``cache_lookup`` / ``prefix_lookup``
/ ``gossip_now`` and anything that reaches :meth:`FleetTier._peer_call`)
MUST run with no engine or pool lock held — a peer call under the LM
engine's ``_cv`` or the balance pool's lock would stall every decode
tick / route behind a slow peer's timeout.  The tpu-lint
``PEER-CALL-UNDER-LOCK`` rule enforces this shape program-wide; this
module itself only ever touches its own ``_lock`` for host-side
bookkeeping and releases it before any socket work.
"""

import base64
import hashlib
import json
import queue
import socket
import threading
import time
from collections import OrderedDict

import numpy as np

from client_tpu_torch import require_torch
from client_tpu_torch.analysis.witness import witness_shared
from client_tpu_torch.perf.rendezvous import recv_frame, send_frame
from client_tpu_torch.resilience import (
    CircuitBreakerRegistry,
    CircuitOpenError,
)
from client_tpu_torch.serve.metrics import FLEET_HELP
from client_tpu_torch.utils import tensor_from_raw, tensor_raw_bytes

__all__ = [
    "FleetTier",
    "chain_digests",
    "fetch_summary",
]


def _frame_bytes(payload):
    """Approximate payload size of one fleet frame: the base64 KV/blob
    fields dominate every heavy op, so summing their lengths (plus the
    snapshot's encoded values) is within a few percent of the wire size
    at none of json.dumps' cost.  Only computed for TRACED calls."""
    n = 0
    for key in ("k", "v"):
        for e in payload.get(key) or ():
            if isinstance(e, dict):
                n += len(e.get("data") or "")
    for b in payload.get("blobs") or ():
        n += len(b)
    n += 4 * len(payload.get("tokens") or ())
    snapshot = payload.get("snapshot")
    if isinstance(snapshot, dict):
        for value in snapshot.values():
            if isinstance(value, str):
                n += len(value)
            elif isinstance(value, dict):
                n += sum(
                    len(v) for v in value.values() if isinstance(v, str)
                )
    return n


def chain_digests(tokens, block_size, max_blocks=None):
    """Cumulative digest per FULL token block of *tokens*.

    ``digests[i]`` identifies the first ``(i + 1) * block_size`` tokens —
    the same chain identity the prefix trie keys on, compressed to 16 hex
    chars so thousands fit in a gossip frame.  Both sides of prefix-aware
    routing use this: replicas summarize their stores with it and clients
    stamp it into ``request_ctx['prefix_digests']``.
    """
    row = [int(t) for t in np.asarray(tokens).reshape(-1)]
    block_size = int(block_size)
    n = len(row) // block_size
    if max_blocks is not None:
        n = min(n, int(max_blocks))
    digest = hashlib.sha256()
    out = []
    for i in range(n):
        block = row[i * block_size:(i + 1) * block_size]
        digest.update((",".join(map(str, block)) + ";").encode("ascii"))
        out.append(digest.hexdigest()[:16])
    return out


def _torch():
    return require_torch("the fleet tier's KV blocks")


def _encode_block(arrays):
    """One block's per-layer [block_size, kv_heads, head_dim] tensors ->
    JSON-safe dict (dtype + shape + base64 payload per layer): the JAX
    package's dtype names and raw bytes."""
    torch = _torch()
    out = []
    for a in arrays:
        name, raw = tensor_raw_bytes(torch.as_tensor(a))
        out.append({
            "dtype": name,
            "shape": list(a.shape),
            "data": base64.b64encode(raw).decode("ascii"),
        })
    return out


def _decode_block(encoded):
    """Per-layer CPU tensors from :func:`_encode_block`'s (or the JAX
    tier's) dicts; ValueError on a malformed payload."""
    return [
        tensor_from_raw(base64.b64decode(e["data"]), e["dtype"], e["shape"])
        for e in encoded
    ]


class _PrefixStore:
    """Host-side store of published KV prefix blocks, token-chain keyed.

    One entry per FULL block, keyed by the flattened token prefix up to
    and including that block (exact tuple keys, like the on-device trie:
    a match is a guarantee).  Values are per-layer CPU tensors — no
    device state, so serving a peer's lookup touches no engine lock and
    no accelerator.  LRU-bounded by block count.
    """

    def __init__(self, max_blocks=4096):
        self.max_blocks = int(max_blocks)
        self._lock = threading.Lock()
        # tuple(tokens[: (i+1)*bs]) ->
        #     [digest, k_layers, v_layers, hits, pushed]
        # hits counts demand (local re-publishes + peer lookups) — the
        # anti-entropy loop pushes chains past the hot threshold; pushed
        # marks chains already replicated (cleared on push failure so a
        # later hit re-queues them)
        self._entries = OrderedDict()
        self.block_size = None  # last-seen block size (uniform per engine)

    def put(self, row, n_blocks, block_size, host_k, host_v):
        """Insert ``n_blocks`` leading full blocks of *row* (host tensors
        per layer, shaped [>=n_blocks, block_size, kv, hd])."""
        row = [int(t) for t in np.asarray(row).reshape(-1)]
        n_blocks = min(int(n_blocks), len(row) // int(block_size))
        digests = chain_digests(row, block_size, n_blocks)
        torch = _torch()
        with self._lock:
            self.block_size = int(block_size)
            for i in range(n_blocks):
                key = tuple(row[: (i + 1) * int(block_size)])
                entry = self._entries.get(key)
                if entry is None:
                    self._entries[key] = [
                        digests[i],
                        [torch.as_tensor(k[i]) for k in host_k],
                        [torch.as_tensor(v[i]) for v in host_v],
                        0,
                        False,
                    ]
                else:
                    entry[3] += 1  # re-published: local demand
                self._entries.move_to_end(key)
            while len(self._entries) > self.max_blocks:
                self._entries.popitem(last=False)

    def lookup(self, row, block_size, max_blocks, count_hits=True):
        """Longest stored chain for *row*: ``(covered, k_layers,
        v_layers)`` with per-layer tensors stacked [covered, bs, kv, hd],
        or None on a total miss."""
        row = [int(t) for t in np.asarray(row).reshape(-1)]
        block_size = int(block_size)
        hits = []
        with self._lock:
            for i in range(int(max_blocks)):
                key = tuple(row[: (i + 1) * block_size])
                entry = self._entries.get(key)
                if entry is None:
                    break
                self._entries.move_to_end(key)
                if count_hits:
                    entry[3] += 1
                hits.append(entry)
        if not hits:
            return None
        torch = _torch()
        n_layers = len(hits[0][1])
        k_layers = [
            torch.stack([h[1][layer] for h in hits])
            for layer in range(n_layers)
        ]
        v_layers = [
            torch.stack([h[2][layer] for h in hits])
            for layer in range(n_layers)
        ]
        return len(hits), k_layers, v_layers

    def digests(self, limit=512):
        """Most-recently-used chain digests (the gossip summary)."""
        with self._lock:
            keys = list(self._entries)[-int(limit):]
            return [self._entries[k][0] for k in keys]

    def hot_count(self, threshold):
        """Chains at or past the hot-hit threshold (the prefix-affinity
        pressure signal gossiped on probes)."""
        with self._lock:
            return sum(
                1 for e in self._entries.values() if e[3] >= threshold
            )

    def take_hot(self, threshold):
        """Hot, not-yet-replicated chain heads: ``[(row, n_blocks)]``.

        Longest-chain-first with proper prefixes of an already-taken
        chain skipped (one ``prefix_put`` of the longest chain carries
        every sub-chain), each marked pushed so it is taken once; a
        failed push clears the mark via :meth:`unmark_pushed`."""
        with self._lock:
            if self.block_size is None:
                return []
            hot = sorted(
                (
                    key for key, e in self._entries.items()
                    if e[3] >= threshold and not e[4]
                ),
                key=len, reverse=True,
            )
            taken = []
            for key in hot:
                covered = False
                for longer, _n in taken:
                    if tuple(longer[: len(key)]) == key:
                        covered = True
                        break
                self._entries[key][4] = True
                if not covered:
                    taken.append((list(key), len(key) // self.block_size))
            return taken

    def unmark_pushed(self, row):
        """Clear the replicated mark on the chain AND every sub-chain
        after a failed push: take_hot marked the covered prefixes pushed
        too (one prefix_put of the longest chain carries them), so a
        failed push must re-arm the whole family or an eviction of the
        head chain would leave still-hot sub-chains skipped forever."""
        row = [int(t) for t in row]
        with self._lock:
            block_size = self.block_size or len(row) or 1
            for i in range(len(row) // block_size):
                entry = self._entries.get(tuple(row[: (i + 1) * block_size]))
                if entry is not None:
                    entry[4] = False

    @property
    def blocks(self):
        with self._lock:
            return len(self._entries)

    def clear(self):
        with self._lock:
            self._entries.clear()


def _seq_version(snapshot):
    """Snapshot ordering key: ``(epoch, step)`` — the incarnation stamp
    first, so a restarted sequence id's fresh epoch beats the dead
    incarnation's higher step count."""
    return (
        float(snapshot.get("epoch", 0.0)), int(snapshot.get("step", 0))
    )


@witness_shared("_lock")
class _SequenceStore:
    """Replicated sequence-state snapshots, versioned by (epoch, step).

    One snapshot per sequence id (``SequenceContext.export()`` shape).
    ``put`` is monotonic: a snapshot whose ``(epoch, step)`` version
    does not beat the stored one is STALE and rejected — replication,
    retries, and gossip races can never move a sequence backwards, and
    a RESTARTED sequence id (fresh epoch) overwrites the previous
    incarnation's leftovers.  LRU-bounded; entries idle past ``ttl_s``
    expire at read time (mirroring the engine's own
    ``max_sequence_idle_s`` hygiene)."""

    def __init__(self, max_sequences=4096, ttl_s=120.0):
        self.max_sequences = int(max_sequences)
        self.ttl_s = float(ttl_s)
        self._lock = threading.Lock()
        self._entries = OrderedDict()  # seq_id -> (snapshot, stored_at)
        self.stale_rejected = 0

    def put(self, snapshot):
        """Install one snapshot; False when stale (version not newer)."""
        seq_id = snapshot.get("sequence_id")
        if seq_id is None:
            return False
        with self._lock:
            old = self._entries.get(seq_id)
            if old is not None and _seq_version(old[0]) >= _seq_version(
                snapshot
            ):
                self.stale_rejected += 1
                return False
            self._entries[seq_id] = (snapshot, time.monotonic())
            self._entries.move_to_end(seq_id)
            while len(self._entries) > self.max_sequences:
                self._entries.popitem(last=False)
            return True

    def get(self, seq_id):
        with self._lock:
            entry = self._entries.get(seq_id)
            if entry is None:
                return None
            if time.monotonic() - entry[1] > self.ttl_s:
                self._entries.pop(seq_id, None)
                return None
            return entry[0]

    def pop(self, seq_id):
        with self._lock:
            self._entries.pop(seq_id, None)

    @property
    def count(self):
        with self._lock:
            return len(self._entries)


def fetch_summary(addr, timeout_s=0.5):
    """One replica's routing summary ``{"prefix_digests": [...],
    "cache_digests": [...]}`` from its fleet peer port — the payload a
    pool health probe piggybacks (``EndpointPool.set_summary``).  Raises
    on transport failure (the probe loop treats that as no-summary)."""
    host, _, port = str(addr).rpartition(":")
    with socket.create_connection(
        (host or "127.0.0.1", int(port)), timeout=timeout_s
    ) as sock:
        sock.settimeout(timeout_s)
        send_frame(sock, {"op": "summary"})
        reply = recv_frame(sock)
    return {
        "prefix_digests": list(reply.get("prefix_digests") or ()),
        "cache_digests": list(reply.get("cache_digests") or ()),
        "pressure": dict(reply.get("pressure") or {}),
    }


class FleetTier:
    """One replica's membership in the cross-replica cache tier.

    Owns the peer-facing server (answers ``cache_get`` / ``prefix_get``
    / ``gossip`` / ``summary`` / ``ping``), the host-side
    :class:`_PrefixStore`, the per-peer circuit breakers, and the gossip
    loop.  Attach to a serving engine with :meth:`attach` (wires the
    response cache + TenantQoS; the LM engine binds itself through the
    model binder — see ``language.lm_streaming_batched_model``).

    Peer RPC methods must be called with NO engine/pool lock held (the
    ``PEER-CALL-UNDER-LOCK`` gate); local-store methods
    (:meth:`export_prefix`, :meth:`local_summary`) are host-side only
    and safe anywhere outside device-dispatch critical sections.
    """

    def __init__(self, bind="127.0.0.1:0", peers=(), lookup_timeout_s=0.25,
                 fan_out=2, gossip_interval_s=2.0, failure_threshold=3,
                 reset_timeout_s=5.0, max_store_blocks=4096,
                 summary_limit=512, registry=None, replicate_k=1,
                 replicate_budget_bytes_s=4 << 20, hot_hits=3,
                 replicate_interval_s=0.2, max_sequences=4096,
                 seq_ttl_s=120.0, quorum="any"):
        if quorum not in ("any", "majority"):
            raise ValueError(
                f"quorum must be 'any' or 'majority', got {quorum!r}"
            )
        host, _, port = str(bind).rpartition(":")
        self._bind_host = host or "127.0.0.1"
        self._bind_port = int(port)
        self.lookup_timeout_s = float(lookup_timeout_s)
        self.fan_out = max(int(fan_out), 1)
        self.gossip_interval_s = float(gossip_interval_s)
        self.summary_limit = int(summary_limit)
        self.registry = registry
        self.store = _PrefixStore(max_store_blocks)
        # replicated sequence-state lane (snapshots peers pushed to us,
        # plus lookups cached from peers) — the failure-domain half
        self.seq_store = _SequenceStore(max_sequences, ttl_s=seq_ttl_s)
        # proactive replication / anti-entropy: hot content pushes to K
        # peers on a bounded byte/sec budget, strictly OFF the request
        # path (a dedicated thread drains the queue)
        self.replicate_k = max(int(replicate_k), 0)
        # write-quorum mode for the durable sequence lane: "any" is the
        # historical best-effort ack (any peer count, including zero),
        # "majority" requires ceil((K+1)/2) peers to report `stored`
        # before a durable step acks to the client
        self.quorum = quorum
        self.hot_hits = max(int(hot_hits), 1)
        self.replicate_interval_s = float(replicate_interval_s)
        self._repl_rate = float(replicate_budget_bytes_s)
        self._repl_tokens = self._repl_rate
        self._repl_stamp = time.monotonic()
        self._repl_queue = queue.Queue()
        self._repl_thread = None
        # response-cache hot tracking: key -> local hit count since the
        # last push (bounded; a pushed key re-queues only on new demand)
        self._cache_hot = OrderedDict()
        self._cache_pushed = set()
        self.replicated_items = 0
        self.replicated_bytes = 0
        self.seq_pushes = 0
        self._breakers = CircuitBreakerRegistry(
            failure_threshold=failure_threshold,
            reset_timeout_s=reset_timeout_s,
        )
        self._lock = threading.Lock()  # peers list + counters only
        self._peers = [str(p) for p in peers]
        # addr -> {tenant: n}: admission deltas not yet ACKED by that
        # peer.  delta_counts() is destructive, so a failed/breaker-open
        # send must not lose its deltas — they retry next round (a long-
        # dead peer's map stays bounded by the tenant count; its counts
        # drain into the peer's bucket, floored at zero, when it revives)
        self._pending_gossip = {}
        self._engine = None      # InferenceEngine (response cache + qos)
        self._server = None
        self._accept_thread = None
        self._gossip_thread = None
        self._stop = threading.Event()
        self._address = None
        # host-side counters (mirrored into the registry when bound)
        self.peer_hits = 0
        self.peer_misses = 0
        self.peer_errors = 0
        self.peer_skips = 0
        self.gossip_rounds = 0
        self.served = 0  # peer requests this replica answered
        self.seq_quorum_acks = 0
        self.seq_quorum_refusals = 0
        # chaos seam: when set, a predicate addr -> bool consulted before
        # every outbound peer connection; False = partitioned (the
        # connection fails as if the network dropped it, so the per-peer
        # breakers accumulate real evidence).  Installed/cleared by the
        # chaos harness's partition/heal fault kinds.
        self._transport_filter = None

    # -- lifecycle ---------------------------------------------------------

    def attach(self, engine):
        """Bind to an :class:`~client_tpu_torch.serve.model_runtime.
        InferenceEngine`: the tier reads its response cache + TenantQoS
        and the engine routes front-door misses through the tier.
        (Written under the tier lock: the peer-server and gossip threads
        may already be running when a server attaches late.)"""
        with self._lock:
            self._engine = engine
            if self.registry is None and getattr(engine, "metrics", None):
                self.registry = engine.metrics
        engine.fleet = self
        return self

    def start(self):
        if self._server is not None:
            return self
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self._bind_host, self._bind_port))
        srv.listen(16)
        srv.settimeout(0.2)
        self._server = srv
        with self._lock:  # peers() filters against it from other threads
            self._address = "%s:%d" % srv.getsockname()[:2]
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(
            target=self._serve_loop, args=(srv, self._stop),
            name="fleet-peer", daemon=True,
        )
        self._accept_thread.start()
        if self.gossip_interval_s > 0:
            self._gossip_thread = threading.Thread(
                target=self._gossip_loop, args=(self._stop,),
                name="fleet-gossip", daemon=True,
            )
            self._gossip_thread.start()
        if self.replicate_k > 0:
            self._repl_thread = threading.Thread(
                target=self._replicate_loop, args=(self._stop,),
                name="fleet-replicate", daemon=True,
            )
            self._repl_thread.start()
        return self

    def close(self):
        self._stop.set()
        threads = (self._accept_thread, self._gossip_thread,
                   self._repl_thread)
        for thread in threads:
            if thread is not None:
                thread.join(timeout=5)
        self._accept_thread = self._gossip_thread = None
        self._repl_thread = None
        if self._server is not None:
            self._server.close()
            self._server = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    @property
    def address(self):
        return self._address

    def set_peers(self, addrs):
        """Install the peer set.  Membership lists can be shared
        verbatim across the fleet: the replica's own address is filtered
        at USE time (:meth:`peers`), which also covers addresses handed
        to the constructor or installed before :meth:`start` bound the
        listen port — a replica gossiping to itself would double-drain
        its own tenant quotas."""
        with self._lock:
            self._peers = [str(a) for a in addrs]

    def peers(self):
        with self._lock:
            return [a for a in self._peers if a != self._address]

    # -- peer server side --------------------------------------------------

    def _serve_loop(self, srv, stop):
        # the whole pass sits under one guard (the BG-THREAD-CRASH shape):
        # an accept-loop thread that dies silently takes the peer server —
        # and every survivor's lookups against it — down with it
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
                # one short-lived thread per connection: a half-dead peer
                # holding a partial frame wedges only ITS handler, never
                # the accept loop — healthy peers' lookups keep answering
                # inside their timeout instead of collecting breaker
                # strikes
                threading.Thread(
                    target=self._serve_one, args=(conn,),
                    name="fleet-peer-conn", daemon=True,
                ).start()
            except socket.timeout:
                continue
            except OSError:
                return
            except Exception:  # thread-spawn failure: drop the connection
                try:
                    conn.close()
                except OSError:
                    pass

    def _serve_one(self, conn):
        try:
            conn.settimeout(max(self.lookup_timeout_s * 4, 1.0))
            request = recv_frame(conn)
            send_frame(conn, self._handle_traced(request))
            with self._lock:
                self.served += 1
        except Exception:
            # a garbled/half-dead peer costs exactly one connection
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _tracer(self):
        """The attached engine's Tracer (or None) — fleet spans land in
        the same store/trace file as the replica's request spans."""
        engine = self._engine
        return getattr(engine, "tracer", None) if engine else None

    def _handle_traced(self, request):
        """Serve one peer frame, recording the peer-server span under the
        CALLING replica's trace id when the frame carried a traceparent —
        a cross-replica fetch then reads as one trace spanning both
        processes (the other half is the caller's peer_span)."""
        tracer = self._tracer()
        traceparent = request.get("traceparent")
        if tracer is None or not traceparent:
            return self._handle(request)
        op = str(request.get("op") or "?")
        with tracer.serve_span(op, traceparent=traceparent) as span:
            reply = self._handle(request)
            if span is not None:
                for key in ("hit", "stored", "ok"):
                    if key in reply:
                        span.tags[key] = bool(reply[key])
                span.tags["bytes"] = _frame_bytes(reply) or _frame_bytes(
                    request
                )
        return reply

    def _handle(self, request):
        op = request.get("op")
        if op == "ping":
            return {"ok": True}
        if op == "summary":
            return self.local_summary()
        if op == "cache_get":
            return self._handle_cache_get(request.get("key"))
        if op == "prefix_get":
            return self._handle_prefix_get(request)
        if op == "prefix_put":
            return self._handle_prefix_put(request)
        if op == "cache_put":
            return self._handle_cache_put(request)
        if op == "seq_put":
            return self._handle_seq_put(request)
        if op == "seq_get":
            return self._handle_seq_get(request.get("sequence_id"))
        if op == "gossip":
            engine = self._engine
            qos = getattr(engine, "qos", None) if engine else None
            if qos is not None:
                qos.absorb_remote(request.get("tenants") or {})
            return {"ok": True}
        return {"error": f"unknown op {op!r}"}

    def _handle_cache_get(self, key):
        engine = self._engine
        cache = getattr(engine, "response_cache", None) if engine else None
        value = cache.peek(key) if cache is not None and key else None
        if value is None:
            return {"hit": False}
        response, blobs = value
        return {
            "hit": True,
            "response": response,
            "blobs": [
                base64.b64encode(bytes(b)).decode("ascii") for b in blobs
            ],
        }

    def _handle_prefix_get(self, request):
        start = max(int(request.get("start") or 0), 0)
        got = self.store.lookup(
            request.get("tokens") or [],
            int(request.get("block_size") or 0) or 1,
            int(request.get("max_blocks") or 0),
        )
        if got is None or got[0] <= start:
            # nothing beyond what the asker already holds locally
            return {"hit": False}
        covered, k_layers, v_layers = got
        return {
            "hit": True,
            "covered": covered,
            "start": start,
            # only the tail past the asker's local match travels: the
            # first `start` blocks would be sliced off and discarded,
            # and base64-inflated KV is the expensive part of the frame
            "k": _encode_block([k[start:] for k in k_layers]),
            "v": _encode_block([v[start:] for v in v_layers]),
        }

    def _handle_prefix_put(self, request):
        """Anti-entropy receive: install a peer's pushed KV chain into
        this replica's host store (host-side only; no device state)."""
        try:
            self.store.put(
                request.get("tokens") or [],
                int(request.get("n_blocks") or 0),
                int(request.get("block_size") or 0) or 1,
                _decode_block(request.get("k") or []),
                _decode_block(request.get("v") or []),
            )
        except (KeyError, ValueError, ModuleNotFoundError):
            # malformed, or a tier without torch (no tensor to hold it)
            return {"ok": False}
        self._gauge()
        return {"ok": True}

    def _handle_cache_put(self, request):
        """Anti-entropy receive: fill a peer's pushed hot response into
        the local response cache (plain LRU insert — a remote fill
        competes for space like any local one)."""
        engine = self._engine
        cache = getattr(engine, "response_cache", None) if engine else None
        key = request.get("key")
        if cache is None or not key:
            return {"ok": False}
        blobs = [base64.b64decode(b) for b in request.get("blobs") or ()]
        cache.put(key, request.get("response") or {}, blobs)
        return {"ok": True}

    def _handle_seq_put(self, request):
        """Sequence-state lane receive: install (or, for an ended
        sequence, drop) one versioned snapshot.  Stale snapshots — step
        not beating the stored one — are rejected, never applied."""
        if request.get("ended"):
            self.seq_store.pop(request.get("sequence_id"))
            return {"ok": True, "stored": False}
        snapshot = request.get("snapshot") or {}
        stored = self.seq_store.put(snapshot)
        if not stored:
            self._count("ctpu_fleet_seq_stale_total")
        return {"ok": True, "stored": stored}

    def _handle_seq_get(self, seq_id):
        """Serve one sequence snapshot: the freshest of the replicated
        store and the attached engine's LIVE sequence (planned handoffs
        can pull state that was never pushed)."""
        if seq_id is None:
            return {"hit": False}
        snapshot = self.seq_store.get(seq_id)
        engine = self._engine
        export = getattr(engine, "export_sequence", None) if engine else None
        if export is not None:
            try:
                live = export(seq_id)
            except Exception:  # pragma: no cover - defensive
                live = None
            if live is not None and (
                snapshot is None
                or _seq_version(live) > _seq_version(snapshot)
            ):
                snapshot = live
        if snapshot is None:
            return {"hit": False}
        return {"hit": True, "snapshot": snapshot}

    # -- peer client side (NEVER call with an engine/pool lock held) -------

    def set_transport_filter(self, fn):
        """Install (or clear, with None) the chaos transport filter: a
        predicate ``addr -> bool`` consulted before every outbound peer
        connection.  ``False`` makes the call fail with OSError exactly
        where a severed network would — downstream breaker/quorum
        behavior is the real code path, not a mock."""
        with self._lock:
            self._transport_filter = fn

    def _peer_call(self, addr, payload):
        """One framed request/response against *addr* with bounded
        connect + read timeouts.  Raises OSError-family on any transport
        failure — callers feed the per-peer breaker."""
        with self._lock:  # released before any transport work
            filt = self._transport_filter
        if filt is not None and not filt(addr):
            raise OSError(f"partitioned from peer {addr}")
        host, _, port = addr.rpartition(":")
        with socket.create_connection(
            (host or "127.0.0.1", int(port)), timeout=self.lookup_timeout_s
        ) as sock:
            sock.settimeout(self.lookup_timeout_s)
            send_frame(sock, payload)
            return recv_frame(sock)

    def _traced_peer_call(self, addr, payload, breaker=None):
        """One framed peer RPC recorded as a trace span: a request-thread
        call (prefix/cache/seq lookup, the synchronous durability push)
        becomes a CHILD span under the active request trace, an
        anti-entropy-thread call a standalone subsampled span.  The
        traceparent rides the frame so the peer's serve span joins the
        same trace.  Raises exactly like :meth:`_peer_call`; tracing off
        (or unsampled) adds two attribute reads and nothing else."""
        tracer = self._tracer()
        if tracer is None:
            return self._peer_call(addr, payload)
        op = str(payload.get("op") or "?")
        with tracer.peer_span(
            op, peer=addr,
            breaker=(breaker.state if breaker is not None else ""),
        ) as span:
            if span is None:
                return self._peer_call(addr, payload)
            framed = dict(payload)
            framed["traceparent"] = span.traceparent()
            sent = _frame_bytes(payload)
            reply = self._peer_call(addr, framed)
            for key in ("hit", "stored", "ok"):
                if key in reply:
                    span.tags[key] = bool(reply[key])
            span.tags["bytes"] = sent + _frame_bytes(reply)
            return reply

    def _candidates(self, limit=None, exclude=()):
        """Breaker-admitted peer snapshot (skips counted): at most
        ``limit`` (default ``fan_out``) peers per call, so a lookup's
        worst case is ``fan_out * lookup_timeout_s`` even before
        breakers open.  ``exclude`` skips peers a caller already tried
        this round (the quorum push's widening waves)."""
        limit = self.fan_out if limit is None else int(limit)
        out = []
        for addr in self.peers():
            if addr in exclude:
                continue
            breaker = self._breakers.get(addr)
            try:
                breaker.before_attempt()
            except CircuitOpenError:
                with self._lock:
                    self.peer_skips += 1
                self._count("ctpu_fleet_peer_skips_total")
                continue
            out.append((addr, breaker))
            if len(out) >= limit:
                break
        return out

    def _ask(self, payload):
        """Fan the payload out peer-by-peer.  Yields ``(addr, reply)``
        for each answered peer; ANY peer failure is a breaker strike and
        a local-only fallback, never a caller-visible error."""
        for addr, breaker in self._candidates():
            try:
                reply = self._traced_peer_call(addr, payload, breaker)
            except Exception:  # noqa: BLE001 - containment is the point
                breaker.record_failure()
                with self._lock:
                    self.peer_errors += 1
                self._count("ctpu_fleet_peer_errors_total")
                continue
            breaker.record_success()
            yield addr, reply

    def cache_lookup(self, key):
        """Peer response-cache lookup: ``(response_json, blobs)`` or
        None.  Bounded fan-out, per-peer timeout, local-only on error."""
        for _addr, reply in self._ask({"op": "cache_get", "key": key}):
            if reply.get("hit"):
                self._note_lookup(True, "cache")
                blobs = [
                    base64.b64decode(b) for b in reply.get("blobs") or ()
                ]
                return reply["response"], blobs
        self._note_lookup(False, "cache")
        return None

    def prefix_lookup(self, tokens, block_size, max_blocks,
                      start_blocks=0):
        """Longest peer-cached KV chain for *tokens*: ``(covered,
        k_layers, v_layers, start)`` or None.  ``start_blocks`` is how
        many leading blocks the asker already holds locally — only the
        tail past it travels the wire; the returned per-layer CPU
        tensors cover blocks ``[start, covered)``.  Takes the best answer
        across the fan-out; stops early on full coverage."""
        tokens = [int(t) for t in np.asarray(tokens).reshape(-1)]
        start_blocks = max(int(start_blocks), 0)
        payload = {
            "op": "prefix_get",
            "tokens": tokens,
            "block_size": int(block_size),
            "max_blocks": int(max_blocks),
            "start": start_blocks,
        }
        best = None
        for _addr, reply in self._ask(payload):
            if not reply.get("hit"):
                continue
            covered = int(reply.get("covered") or 0)
            if best is None or covered > best[0]:
                try:
                    best = (
                        covered,
                        _decode_block(reply["k"]),
                        _decode_block(reply["v"]),
                        start_blocks,
                    )
                except (KeyError, ValueError):
                    continue  # malformed peer payload: ignore it
                if covered >= int(max_blocks):
                    break
        self._note_lookup(best is not None, "prefix")
        return best

    def gossip_now(self):
        """Push one gossip round to EVERY breaker-admitted peer: the
        local per-tenant admission deltas (fleet-wide quota accounting).
        Deltas a peer did not ACK — send failure, open breaker — are
        retained per-peer and retried next round, so a transient
        partition delays convergence instead of losing admissions.
        Returns the number of peers that acked."""
        engine = self._engine
        qos = getattr(engine, "qos", None) if engine else None
        fresh = qos.delta_counts() if qos is not None else {}
        peers = self.peers()
        with self._lock:
            for addr in peers:
                pending = self._pending_gossip.setdefault(addr, {})
                for tenant, n in fresh.items():
                    pending[tenant] = pending.get(tenant, 0) + n
            for addr in list(self._pending_gossip):
                if addr not in peers:  # departed peer: drop its backlog
                    del self._pending_gossip[addr]
        acked = 0
        for addr in peers:
            with self._lock:
                tenants = dict(self._pending_gossip.get(addr) or {})
            breaker = self._breakers.get(addr)
            try:
                breaker.before_attempt()
            except CircuitOpenError:
                continue
            try:
                self._peer_call(addr, {"op": "gossip", "tenants": tenants})
            except Exception:  # noqa: BLE001 - containment is the point
                breaker.record_failure()
                continue
            breaker.record_success()
            acked += 1
            with self._lock:
                pending = self._pending_gossip.get(addr)
                if pending is not None:
                    # subtract what was ACKED (concurrent rounds may have
                    # grown the backlog since the snapshot)
                    for tenant, n in tenants.items():
                        left = pending.get(tenant, 0) - n
                        if left > 0:
                            pending[tenant] = left
                        else:
                            pending.pop(tenant, None)
        with self._lock:
            self.gossip_rounds += 1
        self._count("ctpu_fleet_gossip_rounds_total")
        return acked

    def _gossip_loop(self, stop):
        while not stop.wait(self.gossip_interval_s):
            try:
                self.gossip_now()
            except Exception:  # pragma: no cover - defensive
                pass

    # -- replicated sequence state (the failure-domain lane) ---------------

    def _push(self, payload, nbytes=0, limit=None, stop=None, accept=None,
              candidates=None, until=None):
        """Push one payload to up to ``limit`` (default ``replicate_k``)
        breaker-admitted peers; returns the ack count.  ``nbytes`` > 0
        charges the anti-entropy byte budget FIRST (per peer) — the
        replication thread's rate bound.  ``accept(reply)``, when given,
        decides whether a peer's answer counts as an ack (a reachable
        peer that REJECTED the payload is not one; it is still breaker
        evidence of health).  ``candidates`` lets a caller that already
        admitted peers (consuming half-open probe slots) hand them in —
        an admitted candidate MUST have its outcome recorded, or the
        breaker's single-probe gate wedges.  ``until``, for calls that
        source their own candidates, keeps admitting ONE additional
        untried peer per widening wave until that many acks land (or no
        admissible peer remains): a quorum write must not refuse just
        because a first-wave candidate sits behind a partition while
        another peer is healthy.  Worst case stays bounded by
        ``len(peers) x timeout`` with per-peer breakers."""
        sourced = candidates is None
        if sourced:
            limit = self.replicate_k if limit is None else int(limit)
            candidates = self._candidates(limit=limit)
        tried = set()
        accepted = 0
        while True:
            for i, (addr, breaker) in enumerate(candidates):
                if nbytes and not self._budget_wait(nbytes, stop):
                    # shutting down mid-wait: release the remaining
                    # admitted half-open probe slots so no breaker stays
                    # wedged
                    for _addr, pending in candidates[i:]:
                        pending.record_failure()
                    return accepted
                tried.add(addr)
                try:
                    reply = self._traced_peer_call(addr, payload, breaker)
                except Exception:  # noqa: BLE001 - containment is the point
                    breaker.record_failure()
                    with self._lock:
                        self.peer_errors += 1
                    self._count("ctpu_fleet_peer_errors_total")
                    continue
                breaker.record_success()
                if accept is None or accept(reply):
                    accepted += 1
            if not sourced or until is None or accepted >= until:
                return accepted
            candidates = self._candidates(limit=1, exclude=tried)
            if not candidates:
                return accepted

    def publish_sequence(self, snapshot):
        """Replicate one durable sequence snapshot to ``replicate_k``
        peers SYNCHRONOUSLY — the engine calls this after applying a
        durable step and before the response reaches the wire, so an
        acked step survives this replica's unplanned death.  Bounded by
        k x lookup timeout with per-peer breakers: an unreachable fleet
        costs (almost) nothing and degrades to local-only durability.
        Returns the number of peers that STORED the snapshot — a peer
        that rejected it as stale is reachable but is no durability.
        Under ``quorum="majority"`` the push widens past the first-wave
        candidates until the quorum is met or every admissible peer was
        tried (see ``_push``'s ``until``)."""
        acked = self._push(
            {"op": "seq_put", "snapshot": snapshot},
            accept=lambda reply: bool(reply.get("stored")),
            until=self.seq_quorum_required() or None,
        )
        if acked:
            with self._lock:
                self.seq_pushes += 1
            self._count("ctpu_fleet_seq_snapshots_total")
        return acked

    def seq_quorum_required(self):
        """Peer-ack floor for a durable step under the configured quorum
        mode: 0 under ``"any"`` (best-effort: a partition degrades to
        local-only durability), ceil((K+1)/2) under ``"majority"`` — a
        majority of the K+1 copies (K peers + this replica) must hold
        the snapshot before the step may ack."""
        if self.quorum == "any":
            return 0
        return (self.replicate_k + 2) // 2

    def note_quorum(self, ok):
        """Record one quorum decision for a durable step (called by the
        engine at the ack/refuse site, NOT inside publish_sequence —
        drain-time exports also push snapshots but are not acks)."""
        with self._lock:
            if ok:
                self.seq_quorum_acks += 1
            else:
                self.seq_quorum_refusals += 1
        self._count(
            "ctpu_fleet_seq_quorum_acks_total" if ok
            else "ctpu_fleet_seq_quorum_refusals_total"
        )

    def quorum_evidence(self):
        """Breaker-state snapshot for the degraded-mode error message:
        which peers are open/half-open when a quorum write refuses."""
        states = self._breakers.states()
        return {
            addr: state for addr, state in states.items()
            if state != "closed"
        }

    def forget_sequence(self, seq_id):
        """A sequence ended cleanly: queue the drop so peers stop holding
        its snapshot (asynchronous — correctness never depends on it;
        stale entries also age out of the store)."""
        self.seq_store.pop(seq_id)
        if self.replicate_k > 0:
            # replicate_k=0 runs no replication thread: enqueueing onto
            # a never-drained queue would grow memory forever
            self._repl_queue.put(("seq_end", seq_id))

    def sequence_lookup(self, seq_id):
        """The freshest replicated snapshot for *seq_id*: the local
        store AND a bounded peer fan-out, newest version wins.  The
        local copy alone is never authoritative — with replicate_k
        below the fleet size each step's snapshot lands on a subset of
        peers, so a mid-sequence failover that trusted a local
        anti-entropy copy could resume steps behind the applied
        counter.  A peer hit is cached locally (stale-rejecting).
        None when nobody holds it."""
        best = local = self.seq_store.get(seq_id)
        for _addr, reply in self._ask(
            {"op": "seq_get", "sequence_id": seq_id}
        ):
            if not reply.get("hit"):
                continue
            snapshot = reply.get("snapshot") or {}
            if best is None or _seq_version(snapshot) > _seq_version(best):
                best = snapshot
        self._note_lookup(best is not None, "seq")
        if best is not None and best is not local:
            self.seq_store.put(best)
        return best

    # -- proactive replication / anti-entropy ------------------------------

    def note_cache_hit(self, key):
        """Host-side hot-entry signal from the front door's LOCAL cache
        hits (never a peer RPC): entries past ``hot_hits`` queue for the
        replication thread to push."""
        if self.replicate_k <= 0:
            return
        with self._lock:
            count = self._cache_hot.get(key, 0) + 1
            self._cache_hot[key] = count
            self._cache_hot.move_to_end(key)
            while len(self._cache_hot) > 4096:
                self._cache_hot.popitem(last=False)
            if count < self.hot_hits or key in self._cache_pushed:
                return
            self._cache_pushed.add(key)
            if len(self._cache_pushed) > 8192:
                self._cache_pushed.clear()  # bounded; worst case re-push
        self._repl_queue.put(("cache", key))

    def _budget_wait(self, nbytes, stop=None):
        """Charge *nbytes* against the byte/sec token bucket, sleeping
        (bounded, stop-aware) while the bucket is in debt.  Debt-based:
        one oversized item may overdraw, and the loop then waits the
        debt out — average push rate stays at the budget."""
        if self._repl_rate <= 0:
            return True  # unlimited
        while True:
            with self._lock:
                now = time.monotonic()
                self._repl_tokens = min(
                    self._repl_rate,
                    self._repl_tokens
                    + (now - self._repl_stamp) * self._repl_rate,
                )
                self._repl_stamp = now
                if self._repl_tokens > 0:
                    self._repl_tokens -= nbytes
                    return True
            if stop is None:
                return True  # synchronous replicate_now: no throttling
            if stop.wait(0.05):
                return False

    def _scan_hot(self):
        """Queue hot, not-yet-replicated prefix chains (store-lock only;
        the expensive encode is deferred to _replicate_one, which skips
        it while no peer is admissible)."""
        for row, n_blocks in self.store.take_hot(self.hot_hits):
            self._repl_queue.put(("prefix", row, n_blocks))

    def _replicate_one(self, item, stop=None):
        """Push one queued anti-entropy item to ``replicate_k`` peers.
        Returns the ack count (0 = nothing pushed; hot marks are cleared
        so later demand re-queues).  Peers are admitted BEFORE the
        expensive payload encode: with nobody reachable (no peers, every
        breaker open) the item is re-armed and dropped without paying
        the encode — an isolated or fully-degraded replica must not
        re-encode its hot set every scan interval forever."""
        kind = item[0]
        if kind == "seq_end":
            return self._push({"op": "seq_put", "ended": True,
                               "sequence_id": item[1]}, nbytes=256,
                              stop=stop)
        if kind == "cache":
            key = item[1]
            candidates = self._candidates(limit=self.replicate_k)
            if not candidates:
                with self._lock:
                    self._cache_pushed.discard(key)  # re-arm for later
                return 0
            engine = self._engine
            cache = (
                getattr(engine, "response_cache", None) if engine else None
            )
            value = cache.peek(key) if cache is not None else None
            if value is None:
                # evicted/expired since it ran hot: the admitted probe
                # slots must still resolve — ping keeps them honest
                self._push({"op": "ping"}, candidates=candidates)
                return 0
            response, blobs = value
            encoded = [
                base64.b64encode(bytes(b)).decode("ascii") for b in blobs
            ]
            nbytes = sum(len(b) for b in encoded) + len(
                json.dumps(response)
            ) + 256
            acked = self._push(
                {"op": "cache_put", "key": key, "response": response,
                 "blobs": encoded},
                nbytes=nbytes, stop=stop, candidates=candidates,
            )
            if not acked:
                with self._lock:
                    self._cache_pushed.discard(key)
            else:
                self._note_replicated("cache", nbytes, acked)
            return acked
        if kind == "prefix":
            row, n_blocks = item[1], item[2]
            candidates = self._candidates(limit=self.replicate_k)
            if not candidates:
                self.store.unmark_pushed(row)  # re-arm for later
                return 0
            block_size = self.store.block_size or 1
            got = self.store.lookup(row, block_size, n_blocks,
                                    count_hits=False)
            if got is None:
                self._push({"op": "ping"}, candidates=candidates)
                return 0  # evicted since the scan
            covered, k_layers, v_layers = got
            k_enc = _encode_block(k_layers)
            v_enc = _encode_block(v_layers)
            nbytes = sum(
                len(e["data"]) for e in k_enc + v_enc
            ) + 4 * len(row) + 256
            acked = self._push(
                {"op": "prefix_put", "tokens": list(row),
                 "n_blocks": covered, "block_size": block_size,
                 "k": k_enc, "v": v_enc},
                nbytes=nbytes, stop=stop, candidates=candidates,
            )
            if not acked:
                self.store.unmark_pushed(row)
            else:
                self._note_replicated("prefix", nbytes, acked)
            return acked
        return 0

    def _note_replicated(self, kind, nbytes, acked):
        with self._lock:
            self.replicated_items += 1
            self.replicated_bytes += nbytes * acked
        self._count("ctpu_fleet_replicated_items_total", {"kind": kind})
        self._count("ctpu_fleet_replicated_bytes_total",
                    value=nbytes * acked)

    def _replicate_loop(self, stop):
        """The anti-entropy thread: drains the push queue under the byte
        budget and, when idle, scans the prefix store for chains that ran
        hot.  Strictly OFF the request path — nothing here is ever
        awaited by a serving request."""
        while not stop.is_set():
            try:
                try:
                    item = self._repl_queue.get(
                        timeout=self.replicate_interval_s
                    )
                except queue.Empty:
                    self._scan_hot()
                    continue
                self._replicate_one(item, stop=stop)
            except Exception:  # a bad item must not kill anti-entropy
                pass

    def replicate_now(self):
        """Synchronously drain the anti-entropy queue (tests, benchmarks,
        pre-shutdown flushes).  Budget-exempt.  Returns items pushed."""
        self._scan_hot()
        pushed = 0
        while True:
            try:
                item = self._repl_queue.get_nowait()
            except queue.Empty:
                return pushed
            if self._replicate_one(item):
                pushed += 1

    # -- local store (host-side; no peer RPC, no device state) -------------

    def export_prefix(self, row, n_blocks, block_size, host_k, host_v):
        """Install *n_blocks* leading full blocks of the token row into
        this replica's host store (the LM engine calls this at prefill
        completion and at planned retire for parked streams — always
        OUTSIDE its condition lock; the tensors are already on the host)."""
        self.store.put(row, n_blocks, block_size, host_k, host_v)
        self._gauge()

    def local_summary(self):
        """The gossip/probe summary: most-recent chain digests, the
        response cache's digest keys (truncated to the summary limit),
        and the replica's autoscaling pressure signals."""
        engine = self._engine
        cache = getattr(engine, "response_cache", None) if engine else None
        cache_digests = (
            cache.keys()[-self.summary_limit:] if cache is not None else []
        )
        return {
            "prefix_digests": self.store.digests(self.summary_limit),
            "cache_digests": cache_digests,
            "pressure": self.pressure(),
        }

    def pressure(self):
        """Autoscaling signal bundle gossiped on probes: queued+inflight
        work on the attached engine, prefix-affinity pressure (hot
        chains held), and replicated sequences carried.  Host-side only
        — safe from the peer-server thread."""
        engine = self._engine
        queue_depth = 0
        if engine is not None:
            fn = getattr(engine, "pressure", None)
            if callable(fn):
                try:
                    queue_depth = int(fn().get("queue_depth", 0))
                except Exception:  # pragma: no cover - defensive
                    queue_depth = 0
        out = {
            "queue_depth": queue_depth,
            "prefix_hot": self.store.hot_count(self.hot_hits),
            "sequences": self.seq_store.count,
            "kv_used_fraction": self._kv_used_fraction(),
        }
        if self.registry is not None:
            self.registry.set(
                "ctpu_fleet_pressure_queue_depth", None, queue_depth,
                help_=FLEET_HELP["ctpu_fleet_pressure_queue_depth"],
            )
            self.registry.set(
                "ctpu_fleet_pressure_prefix", None, out["prefix_hot"],
                help_=FLEET_HELP["ctpu_fleet_pressure_prefix"],
            )
        return out

    def _kv_used_fraction(self):
        """Paged-KV occupancy (used / total blocks) from the registry
        gauges the KV pool publishes — block exhaustion is the earliest
        scale-up signal for LM workloads.  0.0 when no LM model is bound
        (no gauges) so the key is always present and comparable."""
        if self.registry is None:
            return 0.0
        used = self.registry.get("ctpu_lm_kv_blocks_used", None)
        free = self.registry.get("ctpu_lm_kv_blocks_free", None)
        if used is None or free is None:
            return 0.0
        total = float(used) + float(free)
        return round(float(used) / total, 4) if total > 0 else 0.0

    # -- metrics / introspection -------------------------------------------

    def _count(self, name, labels=None, value=1):
        if self.registry is not None:
            self.registry.inc(name, labels, value=value,
                              help_=FLEET_HELP[name])

    def _gauge(self):
        if self.registry is not None:
            self.registry.set(
                "ctpu_fleet_store_blocks", None, self.store.blocks,
                help_=FLEET_HELP["ctpu_fleet_store_blocks"],
            )

    def _note_lookup(self, hit, op):
        with self._lock:
            if hit:
                self.peer_hits += 1
            else:
                self.peer_misses += 1
        self._count(
            "ctpu_fleet_peer_hits_total" if hit
            else "ctpu_fleet_peer_misses_total",
            {"op": op},
        )

    def stats(self):
        store_blocks = self.store.blocks
        sequences = self.seq_store.count
        stale = self.seq_store.stale_rejected
        with self._lock:
            return {
                "peer_hits": self.peer_hits,
                "peer_misses": self.peer_misses,
                "peer_errors": self.peer_errors,
                "peer_skips": self.peer_skips,
                "gossip_rounds": self.gossip_rounds,
                "served": self.served,
                "store_blocks": store_blocks,
                "sequences": sequences,
                "seq_pushes": self.seq_pushes,
                "seq_stale_rejected": stale,
                "seq_quorum_acks": self.seq_quorum_acks,
                "seq_quorum_refusals": self.seq_quorum_refusals,
                "replicated_items": self.replicated_items,
                "replicated_bytes": self.replicated_bytes,
                "peers": list(self._peers),
            }
