"""Interprocedural concurrency rules over the whole-program call graph.

Three rules run on the :mod:`client_tpu_torch.analysis.callgraph` substrate —
each one encodes the *cross-function* generalization of a hazard this
repo actually shipped (the lexical rules in ``rules.py`` only catch the
single-function shape):

- **LOCK-INV** — lock-order inversion: the global lock-acquisition graph
  (edges ``A -> B`` whenever B is acquired — directly or through any call
  chain — while A is held) contains a cycle.  Two threads walking the
  cycle from different entry points deadlock; no single function ever
  shows both edges.
- **BLOCK-UNDER-LOCK** — the interprocedural LOCK-DISPATCH: any path from
  a ``with lock:`` body (or a ``*_locked`` caller-holds-the-lock method)
  to a blocking operation — jit/device dispatch, ``time.sleep``,
  subprocess/socket/HTTP, a timeout-less ``queue.get``/``cv.wait``/
  ``thread.join`` — through any call depth.  The prefill-under-``_cv``
  incident (ADVICE round 5) was exactly this, three frames below the
  ``with``.
- **CALLBACK-UNDER-LOCK** — user/observer callbacks (metrics observers,
  resolver callables, trace sinks, anything invoked through a parameter
  or ``getattr`` result) reached while a private lock is held.  A
  callback that looks back at the owning object re-enters the lock and
  deadlocks; one that blocks extends the critical section unboundedly.
  This is the re-entrancy vector the balance/frontdoor observer plumbing
  is one refactor away from.
- **PEER-CALL-UNDER-LOCK** — the fleet-tier generalization of
  BLOCK-UNDER-LOCK: a rendezvous/peer RPC (``fleet``/``peer``/
  ``rendezvous``-named receivers, or the frame/gather transport
  primitives) reachable while any engine or pool lock is held.  A peer
  lookup is bounded by timeouts, but "bounded" is still hundreds of
  milliseconds — under the LM engine's ``_cv`` that stalls every decode
  tick behind one slow peer; under the balance pool's lock it stalls
  every route.  The tier's whole surface (even its host-side methods)
  must stay out of critical sections: snapshot under the lock, call the
  tier outside it.

Precision choices (documented FN > noisy FP):

- deferred references (``Thread(target=...)``, lambda bodies) never
  inherit the registering frame's held locks;
- a ``cv.wait()`` under the cv's own lock is the normal condition-variable
  pattern and is exempt — only *other* locks held across the wait flag;
- a ``*_locked`` method's body runs under the pseudo lock
  ``<caller-held:Class>``; pseudo locks flag blocking/callback work but
  never enter the lock-order graph (they have no identity to invert);
- call chains are depth-limited and each call site reports at most one
  finding per rule.
"""

from client_tpu_torch.analysis import locksets
from client_tpu_torch.analysis.core import Finding, ProgramRule, register_program

_MAX_DEPTH = 12
_MAX_EFFECTS = 6  # distinct transitive effects remembered per function


def _fn_key(mod, fn):
    return (mod.module, fn.qualname)


def _chain_text(chain):
    return " -> ".join(chain)


def _effective_held(program, fn, held):
    """The lexical held set plus the *_locked pseudo lock."""
    if fn.requires_lock:
        return list(held) + [program.pseudo_required_lock(fn)]
    return list(held)


def _is_pseudo(lock):
    return lock.startswith("<caller-held:")


# Receiver segments (leading underscores stripped) that mark a call as a
# peer RPC: anything invoked on a fleet tier / peer set / rendezvous
# object.  Deliberately receiver-shaped, not op-shaped — the tier's
# host-side methods ride the same ban (a critical section should not
# even *touch* the tier's surface; snapshot and call outside).
_PEER_RECEIVERS = {"fleet", "peer", "peers", "rendezvous", "rdv"}

# Call names that ARE the fleet/peer surface, whatever the receiver:
# the frame primitives, the rendezvous collective ops, and FleetTier's
# methods.  Needed because the callgraph collapses ``self.fleet.x(...)``
# to a receiver-less ("method", "x") ref — the names carry the signal
# when the receiver text is gone.
_PEER_CALL_NAMES = {
    "all_gather", "all_ranks_stable", "peer_call", "_peer_call",
    "send_frame", "recv_frame", "_send_frame", "_recv_frame",
    "fetch_summary", "prefix_lookup", "cache_lookup", "gossip_now",
    "export_prefix", "local_summary",
}


def _peer_desc(ref):
    """Human-readable description when *ref* is a peer RPC, else None."""
    kind, value = ref
    if kind in ("name", "method", "self"):
        if value in _PEER_CALL_NAMES:
            return (f"self.{value}()" if kind == "self" else value + "()")
        return None
    parts = value.split(".")
    if parts[-1] in _PEER_CALL_NAMES:
        return value + "()"
    for part in parts[:-1]:
        if part.lstrip("_") in _PEER_RECEIVERS:
            return value + "()"
    return None


class _Effects:
    """Memoized transitive effects (blocking ops, callback invocations,
    lock acquisitions) per function."""

    def __init__(self, program):
        self.program = program
        self._blocking = {}
        self._callbacks = {}
        self._acquires = {}
        self._peers = {}

    # Each entry: (desc, kind, waits_on, chain-tuple)
    def blocking(self, mod, fn):
        return self._memo(
            self._blocking, mod, fn,
            direct=lambda f: [
                (b["desc"], b["kind"], b.get("waits_on"), (f.qualname,))
                for b in f.blocking
            ],
            extend=lambda eff, qual: [
                (d, k, w, (qual,) + chain) for d, k, w, chain in eff
            ],
        )

    # Each entry: (desc, chain-tuple)
    def callbacks(self, mod, fn):
        return self._memo(
            self._callbacks, mod, fn,
            direct=lambda f: [
                (c["desc"], (f.qualname,)) for c in f.callbacks
            ],
            extend=lambda eff, qual: [
                (d, (qual,) + chain) for d, chain in eff
            ],
        )

    # Each entry: (desc, chain-tuple) — peer RPCs reachable from fn
    def peer_calls(self, mod, fn):
        return self._memo(
            self._peers, mod, fn,
            direct=lambda f: [
                (desc, (f.qualname,))
                for call in f.calls
                if not call["deferred"]
                and (desc := _peer_desc(call["ref"])) is not None
            ],
            extend=lambda eff, qual: [
                (d, (qual,) + chain) for d, chain in eff
            ],
        )

    # Each entry: (lock, line-of-acquisition, chain-tuple)
    def acquires(self, mod, fn):
        return self._memo(
            self._acquires, mod, fn,
            direct=lambda f: [
                (a["lock"], a["line"], (f.qualname,))
                for a in f.acquisitions
            ],
            extend=lambda eff, qual: [
                (lock, line, (qual,) + chain)
                for lock, line, chain in eff
            ],
        )

    def _memo(self, table, mod, fn, direct, extend, _depth=0):
        key = _fn_key(mod, fn)
        if key in table:
            cached = table[key]
            return cached if cached is not None else []
        if _depth > _MAX_DEPTH:
            return []
        table[key] = None  # cycle guard: recursion contributes nothing new
        out = list(direct(fn))
        for call in fn.calls:
            if call["deferred"]:
                continue
            cmod, cfn = self.program.resolve(
                mod, fn, call["ref"], call["nargs"]
            )
            if cfn is None:
                continue
            sub = self._memo(table, cmod, cfn, direct, extend, _depth + 1)
            out.extend(extend(sub, fn.qualname))
        # dedupe on the effect identity (first chain wins: shortest-first
        # is not guaranteed, but one witness chain per effect is enough)
        seen, unique = set(), []
        for eff in out:
            ident = eff[:-1]
            if ident in seen:
                continue
            seen.add(ident)
            unique.append(eff)
            if len(unique) >= _MAX_EFFECTS:
                break
        table[key] = unique
        return unique


@register_program
class BlockUnderLockRule(ProgramRule):
    """BLOCK-UNDER-LOCK — a blocking operation reachable from a lock-held
    region through any call depth.

    Lexical LOCK-DISPATCH sees a dispatch in the same function as the
    ``with``; this rule follows the call graph, so the prefill dispatched
    three frames below ``with self._cv:`` (the real ADVICE round-5
    incident) is flagged at the call site that carries the lock in.
    Same-function dispatches are left to LOCK-DISPATCH (one finding per
    bug); same-function *host* blocking (sleep/subprocess/socket,
    timeout-less waits on someone else's lock) is this rule's to report.
    """

    id = "BLOCK-UNDER-LOCK"
    rationale = (
        "a blocking call reached under a lock (any call depth) extends "
        "the critical section by seconds — the prefill-under-_cv shape"
    )

    def check_program(self, program):
        effects = _Effects(program)
        findings = []
        for mod, fn in program.iter_functions():
            # direct blocking ops under a held lock (non-dispatch: the
            # lexical LOCK-DISPATCH rule owns same-function dispatches)
            for b in fn.blocking:
                held = _effective_held(program, fn, b["held"])
                if not held or b["kind"] == "dispatch":
                    continue
                offending = [
                    lock for lock in held if lock != b.get("waits_on")
                ]
                if not offending:
                    continue
                findings.append(Finding(
                    self.id, mod.path, b["line"], b["col"],
                    f"{b['desc']} blocks while holding "
                    f"{self._locks(offending)} (in {fn.qualname})", "",
                ))
            # blocking ops reached through calls made under a held lock
            for call in fn.calls:
                if call["deferred"]:
                    continue
                held = _effective_held(program, fn, call["held"])
                if not held:
                    continue
                cmod, cfn = program.resolve(
                    mod, fn, call["ref"], call["nargs"]
                )
                if cfn is None:
                    continue
                for desc, kind, waits_on, chain in effects.blocking(
                    cmod, cfn
                ):
                    offending = [
                        lock for lock in held if lock != waits_on
                    ]
                    if not offending:
                        continue
                    findings.append(Finding(
                        self.id, mod.path, call["line"], call["col"],
                        f"call chain {fn.qualname} -> "
                        f"{_chain_text(chain)} reaches blocking {desc} "
                        f"while {self._locks(offending)} is held — move "
                        "the blocking work outside the critical section",
                        "",
                    ))
                    break  # one finding per call site
        return findings

    @staticmethod
    def _locks(locks):
        return ", ".join(sorted(locks))


@register_program
class CallbackUnderLockRule(ProgramRule):
    """CALLBACK-UNDER-LOCK — observer/user callbacks invoked (at any call
    depth) while a private lock is held.

    The callback is code this module does not control: if it looks back
    at the owning object it re-enters the held lock (deadlock on a plain
    Lock, state corruption on an RLock); if it blocks, every waiter on
    the lock stalls behind third-party code.  Deliver snapshots outside
    the lock instead (the pool/breaker ``_SerialDeliverer`` pattern).
    """

    id = "CALLBACK-UNDER-LOCK"
    rationale = (
        "an observer callback under a private lock re-enters or blocks "
        "the lock from third-party code (deliver outside the lock)"
    )

    def check_program(self, program):
        effects = _Effects(program)
        findings = []
        for mod, fn in program.iter_functions():
            for cb in fn.callbacks:
                held = _effective_held(program, fn, cb["held"])
                if not held:
                    continue
                findings.append(Finding(
                    self.id, mod.path, cb["line"], cb["col"],
                    f"callback {cb['desc']} invoked while holding "
                    f"{', '.join(sorted(held))} (in {fn.qualname}) — "
                    "snapshot under the lock, call back outside it", "",
                ))
            for call in fn.calls:
                if call["deferred"]:
                    continue
                held = _effective_held(program, fn, call["held"])
                if not held:
                    continue
                cmod, cfn = program.resolve(
                    mod, fn, call["ref"], call["nargs"]
                )
                if cfn is None:
                    continue
                for desc, chain in effects.callbacks(cmod, cfn):
                    findings.append(Finding(
                        self.id, mod.path, call["line"], call["col"],
                        f"call chain {fn.qualname} -> "
                        f"{_chain_text(chain)} invokes callback {desc} "
                        f"while {', '.join(sorted(held))} is held — "
                        "deliver outside the lock", "",
                    ))
                    break  # one finding per call site
        return findings


@register_program
class PeerCallUnderLockRule(ProgramRule):
    """PEER-CALL-UNDER-LOCK — a rendezvous/peer RPC reachable (at any
    call depth) while an engine or pool lock is held.

    The fleet-tier generalization of BLOCK-UNDER-LOCK: peer lookups are
    timeout-bounded, so the blocking classifier does not see them — but
    hundreds of milliseconds under the LM engine's ``_cv`` stalls every
    decode tick, and under the balance pool's lock stalls every route.
    Detection is receiver-shaped (calls on ``fleet``/``peer``/
    ``rendezvous``-named objects) plus the transport primitives
    (``send_frame``/``recv_frame``/``all_gather``/...), so the rule works
    on fixtures and unresolvable call targets alike.  The whole tier
    surface is banned under locks — host-side methods included — because
    the correct shape is always the same: snapshot under the lock, call
    the tier after releasing it (serve/lm/engine.py's submit/export
    paths are the reference implementation).
    """

    id = "PEER-CALL-UNDER-LOCK"
    rationale = (
        "a peer/rendezvous RPC under an engine or pool lock stalls every "
        "waiter behind one slow peer's timeout — snapshot under the "
        "lock, call the peer outside it"
    )

    def check_program(self, program):
        effects = _Effects(program)
        findings = []
        for mod, fn in program.iter_functions():
            for call in fn.calls:
                if call["deferred"]:
                    continue
                held = _effective_held(program, fn, call["held"])
                if not held:
                    continue
                locks = ", ".join(sorted(held))
                desc = _peer_desc(call["ref"])
                if desc is not None:
                    findings.append(Finding(
                        self.id, mod.path, call["line"], call["col"],
                        f"peer RPC {desc} invoked while holding {locks} "
                        f"(in {fn.qualname}) — snapshot under the lock, "
                        "call the peer outside it", "",
                    ))
                    continue
                cmod, cfn = program.resolve(
                    mod, fn, call["ref"], call["nargs"]
                )
                if cfn is None:
                    continue
                for peer_desc, chain in effects.peer_calls(cmod, cfn):
                    findings.append(Finding(
                        self.id, mod.path, call["line"], call["col"],
                        f"call chain {fn.qualname} -> "
                        f"{_chain_text(chain)} reaches peer RPC "
                        f"{peer_desc} while {locks} is held — move the "
                        "peer call outside the critical section", "",
                    ))
                    break  # one finding per call site
        return findings


@register_program
class LocksetRaceRule(ProgramRule):
    """LOCKSET-RACE — Eraser-style per-field lockset inference across
    thread roots (see :mod:`client_tpu_torch.analysis.locksets`).

    SHARED-MUT is lexical and per-file: it flags an unlocked assignment
    in the same class that spawns the thread.  This rule intersects the
    *candidate guard sets* of every access to a shared field, carried
    interprocedurally: a field written under ``self._lock`` in one
    method and read lock-free from a background thread three calls away
    — or written under lock A while the loop reads under lock B — has an
    empty candidate set and is flagged with both witness sites (file:
    line, holding set, thread-root chain).  Exemptions keep the gate
    honest: ``__init__`` writes (virgin state), single-root fields,
    fields frozen after construction, event/queue/thread handle fields,
    and anything vouched for by the ``*_locked`` caller-holds-the-lock
    convention.  The dynamic twin (``RaceWitness``, armed by
    ``TPULINT_RACE_WITNESS=1``) runs the same algorithm against the real
    held-lock stack at runtime.
    """

    id = "LOCKSET-RACE"
    rationale = (
        "a shared field whose accesses share no common lock across "
        "thread roots is a data race — the Eraser lockset invariant"
    )

    def check_program(self, program):
        findings = []
        for report in locksets.analyze(program):
            findings.append(Finding(
                self.id, report.write.path, report.write.line,
                report.write.col, report.message(), "",
            ))
        return findings


@register_program
class LockInversionRule(ProgramRule):
    """LOCK-INV — lock-order inversion over the global acquisition graph.

    Edge ``A -> B``: somewhere in the program lock B is acquired (in the
    same function or through any call chain) while A is held.  A cycle
    means two threads entering from different points can each hold one
    lock and wait for the other — the textbook deadlock no per-function
    rule can see, because each edge lives in a different function (often
    a different file).  Pseudo (``*_locked``) locks are excluded: they
    have no independent identity to invert.  Re-acquiring the same lock
    is not an inversion (RLock re-entry / imprecise aliasing), so
    self-edges are dropped.
    """

    id = "LOCK-INV"
    rationale = (
        "a cycle in the program-wide lock-acquisition order means two "
        "threads can deadlock holding one lock each"
    )

    def check_program(self, program):
        effects = _Effects(program)
        # (a, b) -> (path, line, via) witness of the first sighting
        edges = {}

        def add_edge(a, b, path, line, via):
            if a == b or _is_pseudo(a) or _is_pseudo(b):
                return
            if (a, b) not in edges:
                edges[(a, b)] = (path, line, via)

        for mod, fn in program.iter_functions():
            for acq in fn.acquisitions:
                for held in acq["held"]:
                    add_edge(
                        held, acq["lock"], mod.path, acq["line"],
                        fn.qualname,
                    )
            for call in fn.calls:
                if call["deferred"] or not call["held"]:
                    continue
                cmod, cfn = program.resolve(
                    mod, fn, call["ref"], call["nargs"]
                )
                if cfn is None:
                    continue
                for lock, _line, chain in effects.acquires(cmod, cfn):
                    for held in call["held"]:
                        add_edge(
                            held, lock, mod.path, call["line"],
                            f"{fn.qualname} -> {_chain_text(chain)}",
                        )

        return [
            self._cycle_finding(cycle, edges)
            for cycle in self._cycles(edges)
        ]

    @staticmethod
    def _cycles(edges):
        """Canonicalized simple cycles in the edge graph (one per cycle
        regardless of entry point), shortest first."""
        graph = {}
        for a, b in edges:
            graph.setdefault(a, []).append(b)
        seen, cycles = set(), []

        def walk(start, node, path, visited):
            for nxt in graph.get(node, ()):
                if nxt == start and len(path) >= 2:
                    rotation = min(range(len(path)), key=path.__getitem__)
                    canon = tuple(path[rotation:] + path[:rotation])
                    if canon not in seen:
                        seen.add(canon)
                        cycles.append(list(canon))
                elif nxt not in visited and len(path) < 8:
                    walk(start, nxt, path + [nxt], visited | {nxt})

        for start in sorted(graph):
            walk(start, start, [start], {start})
        cycles.sort(key=len)
        return cycles

    def _cycle_finding(self, cycle, edges):
        parts = []
        first = None
        for i, a in enumerate(cycle):
            b = cycle[(i + 1) % len(cycle)]
            path, line, via = edges[(a, b)]
            if first is None:
                first = (path, line)
            parts.append(f"{a} -> {b} [{path}:{line} in {via}]")
        path, line = first
        order = " ; ".join(parts)
        return Finding(
            self.id, path, line, 0,
            "lock-order inversion: " + " -> ".join(cycle + [cycle[0]])
            + f" — acquisition edges: {order}; pick one global order",
            "",
        )
