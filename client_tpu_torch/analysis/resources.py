"""Interprocedural resource-lifecycle analysis: one spec table, three
whole-program rules, and the acquire/release vocabulary shared with the
dynamic :class:`~client_tpu_torch.analysis.witness.ResourceWitness`.

The reference client's hardest bug class is handle lifecycle — shared
memory regions, registered handles, connections that must be released on
every path — and this repo reproduces it in Python form: refcounted KV
blocks, endpoint leases, tracer spans, threads, sockets, files.  The
lexical rules (REFCOUNT-PAIR, SPAN-LEAK) each froze one syntactic shape;
this module is the engine behind them: a registered *spec table* names
every acquire/release pair in the repo, ``callgraph.py`` records
*resource events* into each function summary (acquisition sites, release
sites, ownership transfers: returned / yielded / stored to an attribute
/ passed to a callee whose summary takes ownership), and three rules
walk must-release over the whole program:

- **RESOURCE-LEAK** — an acquired handle can go out of scope unreleased
  and untransferred: never released at all, released only on some
  branches, or leaked on an explicit early ``return``/``raise`` path.
  ``with`` acquisition and a release inside a ``finally`` are the
  recognized exception-safe shapes.  This is the interprocedural
  generalization of SPAN-LEAK/REFCOUNT-PAIR: a handle acquired through a
  *wrapper* (``blocks = self._reserve(n)`` where ``_reserve`` returns a
  fresh ``kv.alloc``) is tracked through the callee's summary, which no
  per-file pass can see.
- **DOUBLE-RELEASE** — two release sites reachable on one path with no
  re-acquisition between them.  For a refcounted handle the second
  release decrements someone else's reference (the block is freed out
  from under its other holder); only kinds whose release is NOT
  idempotent participate (``Lease.release`` guards on ``_done``,
  ``Thread.join`` re-joins — those are exempt by spec).
- **USE-AFTER-RELEASE** — a method call / subscript / iteration on a
  handle reachable after its release on the same path: splicing freed
  block indices into a lane table, reading a closed file.

Precision choices (documented FN > noisy FP, same contract as the
concurrency pass):

- a handle that escapes — returned, yielded, stored to an attribute or
  container, or passed to ANY call we cannot resolve — transfers
  ownership and is exempt; only a resolved callee whose summary provably
  does not take ownership keeps the handle with the caller;
- path sensitivity is branch-arm bookkeeping, not a real CFG: two events
  are "on one path" only when their ``if``/``try`` arms agree (plus the
  try-body/finally and except/finally pairings), so an either-or release
  pair is never called a double release;
- an early-exit leak is only reported for an *explicit* ``return`` or
  ``raise`` between acquire and release — implicit exception edges are
  covered by requiring nothing; a release inside any ``finally`` (or a
  ``with`` acquisition) marks the handle exception-safe and ends the
  walk;
- ``if handle is None: return`` guards (the KV admission-backpressure
  idiom) are recognized: the exit on the None arm never leaks a handle
  that was never acquired.

The same table drives the dynamic half: :data:`DYNAMIC_SPECS` lists the
live classes whose acquire/release methods the ResourceWitness patches
under ``TPULINT_RESOURCE_WITNESS=1``.

The port's copy of client_tpu/analysis/resources.py: the static half as
the reference has it (its vocabulary is receiver-shaped, so it reads the
port's ``kv``/``pool``/``tracer`` traffic unchanged) and ``DYNAMIC_SPECS``
naming the port's classes.
"""

import re

from client_tpu_torch.analysis.core import Finding, ProgramRule, register_program

__all__ = [
    "SPECS",
    "DYNAMIC_SPECS",
    "classify_acquire",
    "release_api",
    "release_api_any",
    "release_by_arg_any",
    "acquire_by_arg",
    "ResourceLeakRule",
    "DoubleReleaseRule",
    "UseAfterReleaseRule",
]

# -- the spec table ----------------------------------------------------------
#
# Shared vocabulary: rules.py's lexical SPAN-LEAK/REFCOUNT-PAIR
# pre-filters, callgraph.py's resource-event scanner, and the dynamic
# ResourceWitness all read these — one registration per acquire/release
# pair in the repo, everywhere.

_TRACERISH_RE = re.compile(r"(?i)tracer")
# start_tick: the continuous profiler's tick handles (serve/prof.py)
# follow the same bracket discipline as trace spans — an unfinished
# tick is a hole in the attribution timeline.
_SPAN_START_METHODS = {"start_span", "begin_span", "start_timer",
                       "start_tick"}
_SPAN_FINISH_METHODS = {"complete", "finish", "close", "end", "stop"}
_REFCOUNT_NAME_RE = re.compile(
    r"(^|_)(refs?|ref_?counts?)$", re.IGNORECASE
)
# receivers whose alloc/retain/release traffic is KV block-pool traffic
_KV_POOLISH_RE = re.compile(r"(?i)(^|_)(kv|pools?|block_?pool)s?$")
# receivers whose lease() hands out an endpoint lease
_LEASE_POOLISH_RE = re.compile(r"(?i)(^|_)(pools?|endpoints?|balancer)s?$")


class ResourceSpec:
    """One registered acquire/release pair family."""

    __slots__ = ("kind", "noun", "acquire_methods", "recv_re",
                 "release_methods", "release_by_arg", "ctors",
                 "idempotent_release", "why")

    def __init__(self, kind, noun, acquire_methods=(), recv_re=None,
                 release_methods=(), release_by_arg=(), ctors=(),
                 idempotent_release=False, why=""):
        self.kind = kind
        self.noun = noun
        self.acquire_methods = frozenset(acquire_methods)
        self.recv_re = recv_re           # receiver gate for method acquires
        self.release_methods = frozenset(release_methods)
        # methods releasing the handle PASSED AS AN ARGUMENT
        # (kv.release(blocks), tracer.complete(trace))
        self.release_by_arg = frozenset(release_by_arg)
        self.ctors = frozenset(ctors)    # constructor callee texts
        self.idempotent_release = idempotent_release
        self.why = why                   # one-line leak consequence


SPECS = {
    "kv-blocks": ResourceSpec(
        "kv-blocks", "KV block reservation",
        acquire_methods={"alloc", "retain"}, recv_re=_KV_POOLISH_RE,
        release_by_arg={"release", "free"},
        why=("a leaked reference is a block the pool can neither free "
             "nor read — the pool shrinks until admission bricks"),
    ),
    "lease": ResourceSpec(
        "lease", "endpoint lease",
        acquire_methods={"lease"}, recv_re=_LEASE_POOLISH_RE,
        release_methods={"release", "success", "failure"},
        idempotent_release=True,  # Lease methods guard on _done
        why=("an unreleased lease pins the endpoint's inflight count — "
             "the balancer routes around a replica that is actually "
             "idle"),
    ),
    "span": ResourceSpec(
        "span", "trace span",
        acquire_methods=_SPAN_START_METHODS | {"sample"},
        recv_re=None,  # sample() additionally gated on a tracer-ish recv
        release_methods=_SPAN_FINISH_METHODS,
        release_by_arg={"complete", "finish"},
        why=("an unfinished span vanishes from the trace file and the "
             "flight recorder exactly when the timeline matters"),
    ),
    "thread": ResourceSpec(
        "thread", "thread",
        ctors={"threading.Thread", "Thread"},
        release_methods={"join", "stop"},
        idempotent_release=True,
        why=("a non-daemon thread never joined outlives its owner and "
             "blocks interpreter shutdown"),
    ),
    "socket": ResourceSpec(
        "socket", "socket",
        ctors={"socket.socket", "socket.create_connection"},
        release_methods={"close", "shutdown", "detach"},
        idempotent_release=True,
        why=("an unclosed socket leaks the fd and holds the peer's "
             "accept slot until the GC gets around to it"),
    ),
    "file": ResourceSpec(
        "file", "file handle",
        ctors={"open", "io.open"},
        release_methods={"close"},
        idempotent_release=True,
        why="an unclosed file leaks the fd and may lose buffered writes",
    ),
}

# The live classes the dynamic ResourceWitness patches
# (TPULINT_RESOURCE_WITNESS=1).  Modes: how the handle rides the call —
#   ret       the return value is the handle (None = not acquired)
#   ret-each  the return value is a list of handles (each tracked)
#   arg-each  the first positional argument is a list of handles
#   arg       the first positional argument is the handle
#   self      the receiver is the handle
# Threads/sockets/files stay static-only: patching them class-wide would
# flag every fire-and-forget daemon and stdlib-internal fd in the suite.
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


def _split_callee(text):
    """(receiver-last-segment, method) for a dotted callee text."""
    if "." not in text:
        return "", text
    recv, method = text.rsplit(".", 1)
    return recv.rsplit(".", 1)[-1], method


def classify_acquire(text):
    """(kind, api) when calling *text* acquires a registered resource,
    else None.  *text* is the dotted callee (``self.kv.alloc``,
    ``open``, ``threading.Thread``)."""
    if not text:
        return None
    recv_last, method = _split_callee(text)
    for spec in SPECS.values():
        if text in spec.ctors or (
            spec.kind == "thread" and method == "Thread"
        ):
            return spec.kind, method
    if method in ("alloc", "retain") and _KV_POOLISH_RE.search(recv_last):
        return "kv-blocks", method
    if method == "lease" and _LEASE_POOLISH_RE.search(recv_last):
        return "lease", method
    if method in _SPAN_START_METHODS:
        return "span", method
    if method == "sample" and _TRACERISH_RE.search(recv_last):
        return "span", method
    return None


def release_api(kind, method, recv_last="", by_arg=False):
    """True when *method* releases a handle of *kind* — called ON the
    handle (``by_arg=False``) or with the handle as an argument
    (``by_arg=True``, receiver-gated like the acquire side)."""
    spec = SPECS.get(kind)
    if spec is None:
        return False
    if by_arg:
        if method not in spec.release_by_arg:
            return False
        if kind == "kv-blocks":
            return bool(_KV_POOLISH_RE.search(recv_last))
        if kind == "span":
            return bool(_TRACERISH_RE.search(recv_last))
        return True
    return method in spec.release_methods


_ALL_RELEASE_METHODS = frozenset().union(
    *(spec.release_methods for spec in SPECS.values())
)


def release_api_any(method):
    """*method* called ON a handle releases SOME registered kind — the
    kind-agnostic test the scanner applies to parameters (whose kind is
    only known interprocedurally)."""
    return method in _ALL_RELEASE_METHODS


def release_by_arg_any(method, recv_last=""):
    """*method* releases a handle passed as an argument for some kind
    (receiver-gated the same way the acquire side is)."""
    return any(
        release_api(kind, method, recv_last, by_arg=True)
        for kind in SPECS
    )


def acquire_by_arg(kind, method, recv_last):
    """Calling ``pool.method(handle)`` ADDS a reference to the handle —
    a `retain` between two releases makes the second one legitimate
    (each reference gets its own release)."""
    if kind == "kv-blocks":
        return method == "retain" and bool(
            _KV_POOLISH_RE.search(recv_last or "")
        )
    return False


def _split_events(record, kind):
    """(releases, uses, passes) for one handle record.

    Ops and argument-passes are recorded kind-agnostically at scan time
    (a candidate wrapper-call record cannot know its kind until the
    callee's summary is resolved); once *kind* is known, method calls in
    the spec's release set become releases, everything else an op is a
    use, and a pass whose callee releases-by-argument (``kv.release(
    blocks)``) is a release rather than an ownership-transfer candidate.
    """
    releases, uses, passes = [], [], []
    for op in record["ops"]:
        api = op["api"]
        if not api.startswith("[") and release_api(kind, api):
            releases.append(op)
        elif not api.startswith("[attr "):
            # plain attribute reads are metadata (lease.key after
            # failure(), thread.name after join()) — never a
            # use-after-release; subscripts, iteration, calls are
            uses.append(op)
    for p in record["passed"]:
        meth = p.get("meth")
        if meth and release_api(kind, meth, p.get("recv", ""),
                                by_arg=True):
            releases.append(dict(p, api=meth))
        else:
            passes.append(p)
    return releases, uses, passes


# -- path-context algebra ----------------------------------------------------
#
# Contexts are lists of "nid:arm" tokens pushed by the callgraph scanner
# for every enclosing if/try/loop arm — branch-arm bookkeeping, not a
# CFG.  nid is "<kind><line>"; arms: t/e (if then/else), b/h{i}/o/f (try
# body/i-th handler/orelse/final), l (loop body).

# arms a release may add relative to the acquire and still run on the
# fall-through path (loop bodies may run zero times: excluded)
_FALLTHROUGH_ARMS = {"b", "o", "f"}


def _arm_conditional(arm):
    """The arm only runs on some paths through its node (if arms,
    exception handlers)."""
    return arm in ("t", "e") or arm.startswith("h")


def _arm_seq(a1, a2):
    """Two DIFFERENT arms at one try node that still lie on one
    sequential path: body→orelse→finally run in order, and any handler
    pairs with that try's finally (both run on the exception path).
    Distinct handlers — and if/else arms — are exclusive."""
    pair = {a1, a2}
    if pair <= _FALLTHROUGH_ARMS:
        return True
    if "f" in pair:
        other = (pair - {"f"}).pop()
        return other.startswith("h") or other in _FALLTHROUGH_ARMS
    return False


def _ctx_map(ctx):
    out = {}
    for token in ctx:
        nid, arm = token.rsplit(":", 1)
        out[nid] = arm
    return out


def _same_path(c1, c2):
    """Both events provably lie on one sequential path: every shared
    branch node agrees (or is a sequential try pairing), and neither
    event sits in a conditional arm the other is outside of."""
    m1, m2 = _ctx_map(c1), _ctx_map(c2)
    for nid in set(m1) | set(m2):
        a1, a2 = m1.get(nid), m2.get(nid)
        if a1 is None or a2 is None:
            if _arm_conditional(a1 or a2):
                return False
            continue
        if a1 != a2 and not _arm_seq(a1, a2):
            return False
    return True


def _reachable_from(acq_ctx, ctx):
    """The event at *ctx* is reachable on SOME path from the acquisition
    at *acq_ctx*: shared branch nodes must agree (conditional arms the
    event adds are fine — that is what makes it a path)."""
    ma, mc = _ctx_map(acq_ctx), _ctx_map(ctx)
    for nid, arm in ma.items():
        other = mc.get(nid)
        if other is not None and other != arm and not _arm_seq(
            arm, other
        ):
            return False
    return True


def _unconditional_after(acq_ctx, rel_ctx):
    """The release at *rel_ctx* runs on the fall-through continuation of
    the acquisition at *acq_ctx* (no new conditional arm, no new loop)."""
    ma, mr = _ctx_map(acq_ctx), _ctx_map(rel_ctx)
    for nid, arm in mr.items():
        if nid in ma:
            if ma[nid] != arm and not _arm_seq(ma[nid], arm):
                return False
            continue
        if arm not in _FALLTHROUGH_ARMS:
            return False
    return True


# -- interprocedural ownership flows -----------------------------------------

_MAX_DEPTH = 10


class _Flows:
    """Memoized transitive ownership queries over function summaries."""

    def __init__(self, program):
        self.program = program
        self._returns = {}
        self._owns = {}

    def returns_kind(self, mod, fn, _depth=0):
        """The resource kind *fn* returns freshly acquired, or None —
        following direct ``return pool.alloc(n)`` shapes and chains of
        ``return self._reserve(n)`` through resolvable callees."""
        key = (mod.module, fn.qualname)
        if key in self._returns:
            return self._returns[key]
        if _depth > _MAX_DEPTH:
            return None
        self._returns[key] = None  # cycle guard
        facts = fn.res_facts or {}
        kind = facts.get("returns")
        if kind is None:
            for ref_kind, ref_value, nargs in facts.get("ret_calls", ()):
                cmod, cfn = self.program.resolve(
                    mod, fn, (ref_kind, ref_value), nargs
                )
                if cfn is None or cfn is fn:
                    continue
                kind = self.returns_kind(cmod, cfn, _depth + 1)
                if kind is not None:
                    break
        self._returns[key] = kind
        return kind

    def owns_param(self, mod, fn, idx, _depth=0):
        """*fn* takes ownership of positional parameter *idx*: releases
        it, stores it, or hands it to a callee that does."""
        key = (mod.module, fn.qualname, idx)
        if key in self._owns:
            return self._owns[key]
        if _depth > _MAX_DEPTH:
            return False
        self._owns[key] = False  # cycle guard
        facts = fn.res_facts or {}
        entry = None
        for info in facts.get("params", {}).values():
            if info["idx"] == idx:
                entry = info
                break
        owned = False
        if entry is not None:
            if entry["released"] or entry["stored"]:
                owned = True
            else:
                for ref_kind, ref_value, nargs, argpos in entry["passed"]:
                    if argpos < 0:
                        owned = True  # kw pass: benefit of the doubt
                        break
                    cmod, cfn = self.program.resolve(
                        mod, fn, (ref_kind, ref_value), nargs
                    )
                    if cfn is None:
                        owned = True  # unresolvable: benefit of the doubt
                        break
                    if self.owns_param(cmod, cfn, argpos, _depth + 1):
                        owned = True
                        break
        self._owns[key] = owned
        return owned


def _record_kind(flows, program, mod, fn, record):
    """Resolve one handle record's resource kind (direct or through the
    wrapper call it was bound from), or None when it is not a resource."""
    if record["res"] is not None:
        return record["res"]
    via = record.get("via")
    if not via:
        return None
    cmod, cfn = program.resolve(mod, fn, (via[0], via[1]), via[2])
    if cfn is None:
        return None
    return flows.returns_kind(cmod, cfn)


def _transferred(flows, program, mod, fn, passes, record):
    """Ownership left the function: returned/yielded/stored, or passed
    to a callee that takes it (unresolvable callees get the benefit of
    the doubt — documented FN over noisy FP).  *passes* is the
    NON-release subset of the record's argument-passes — handing a
    handle to ``kv.release()`` is a release, not a transfer."""
    if record["escapes"]:
        return True
    for passed in passes:
        ref = passed["ref"]
        if ref is None or passed["argpos"] < 0:
            return True
        cmod, cfn = program.resolve(
            mod, fn, (ref[0], ref[1]), passed["nargs"]
        )
        if cfn is None:
            return True
        if flows.owns_param(cmod, cfn, passed["argpos"]):
            return True
    return False


def _iter_resource_records(program, flows):
    """Yield (mod, fn, record, kind, (releases, uses, passes)) for every
    resolvable handle record in the program."""
    for mod, fn in program.iter_functions():
        for record in fn.resources or ():
            kind = _record_kind(flows, program, mod, fn, record)
            if kind is None:
                continue
            yield mod, fn, record, kind, _split_events(record, kind)


def _handle_desc(record, kind):
    noun = SPECS[kind].noun
    var = record["var"]
    if var is None:
        return f"{noun} from {record['api']}()"
    return f"{noun} {var!r} (from {record['api']}())"


@register_program
class ResourceLeakRule(ProgramRule):
    """RESOURCE-LEAK — an acquired handle can go out of scope unreleased
    and untransferred.

    Every resource in the spec table (KV block reservations, endpoint
    leases, tracer spans, threads, sockets, files) must be released on
    EVERY path out of its owning function, or ownership must leave the
    function: returned/yielded to the caller, stored on an attribute, or
    passed to a callee whose summary takes it.  ``with`` acquisition and
    a release inside a ``finally`` are the exception-safe shapes; a
    release that only happens on some branches, or an explicit
    ``return``/``raise`` that exits between acquire and release, leaks
    the handle exactly when an error path runs — which is how every leak
    in this repo actually shipped (the pool shrinks, the balancer pins an
    idle replica, the trace file gets a hole).

    This is the interprocedural generalization of SPAN-LEAK and
    REFCOUNT-PAIR: a handle acquired through a WRAPPER (``blocks =
    self._reserve(n)`` where ``_reserve`` returns a fresh ``alloc``) is
    tracked through the callee's summary — invisible to any per-file
    pass.  Direct single-function span leaks stay with the lexical
    SPAN-LEAK pre-filter (one finding per bug).
    """

    id = "RESOURCE-LEAK"
    rationale = (
        "a handle not released on every path (and not transferred) "
        "leaks exactly when an error path runs — the KV pool shrinks "
        "until admission bricks, the lease pins an idle replica, the "
        "span vanishes from the timeline"
    )

    def check_program(self, program):
        flows = _Flows(program)
        findings = []
        for mod, fn, record, kind, events in _iter_resource_records(
            program, flows
        ):
            if record["in_with"]:
                continue
            if kind == "span" and record["res"] == "span":
                # direct, single-function span brackets are the lexical
                # SPAN-LEAK rule's beat; the engine owns wrapper-acquired
                # spans (record["res"] is None, kind resolved here)
                continue
            if kind == "thread" and record.get("daemon"):
                continue  # fire-and-forget daemon: dies with the process
            releases, _uses, passes = events
            if _transferred(flows, program, mod, fn, passes, record):
                continue
            spec = SPECS[kind]
            desc = _handle_desc(record, kind)
            if not releases:
                findings.append(Finding(
                    self.id, mod.path, record["line"], record["col"],
                    f"{fn.qualname}() acquires {desc} and never "
                    f"releases or transfers it — {spec.why}", "",
                ))
                continue
            covered = [
                r for r in releases
                if _unconditional_after(record["ctx"], r["ctx"])
            ]
            if not covered:
                first = min(releases, key=lambda r: r["line"])
                findings.append(Finding(
                    self.id, mod.path, record["line"], record["col"],
                    f"{fn.qualname}() releases {desc} only on some "
                    f"paths (the release at line {first['line']} sits "
                    f"in a conditional branch) — {spec.why}", "",
                ))
                continue
            if any(r["fin"] for r in releases):
                continue  # finally-protected: exception edges covered
            leak_exit = self._leaking_exit(fn, record, releases, covered)
            if leak_exit is not None:
                findings.append(Finding(
                    self.id, mod.path, record["line"], record["col"],
                    f"{fn.qualname}() leaks {desc} on the "
                    f"{leak_exit['kind']} path at line "
                    f"{leak_exit['line']} — the release at line "
                    f"{covered[0]['line']} is never reached there; "
                    "move it into a finally (or use a context "
                    f"manager) — {spec.why}", "",
                ))
        return findings

    @staticmethod
    def _leaking_exit(fn, record, releases, covered):
        """An explicit return/raise between acquire and the covering
        release with no release before it on its path, or None."""
        first_cover = min(r["line"] for r in covered)
        var = record["var"]
        exits = (fn.res_facts or {}).get("exits", ())
        for ex in exits:
            if not record["line"] < ex["line"] < first_cover:
                continue
            if var is not None and var in ex.get("guards", ()):
                continue  # `if handle is None: return` — nothing held
            if not _reachable_from(record["ctx"], ex["ctx"]):
                continue
            if any(
                r["line"] < ex["line"]
                and _same_path(r["ctx"], ex["ctx"])
                for r in releases
            ):
                continue
            return ex
        return None


@register_program
class DoubleReleaseRule(ProgramRule):
    """DOUBLE-RELEASE — two release sites reachable on one path with no
    re-acquisition between them.

    For a refcounted handle the second release decrements SOMEONE
    ELSE'S reference: the KV pool frees a block another request still
    maps, and the next alloc hands the same block to two owners — the
    corruption surfaces far from the bug.  Only kinds whose release is
    not idempotent participate (``Lease``'s methods guard on ``_done``,
    ``Thread.join``/``file.close`` re-run safely — exempt by spec);
    either-or branches (``if``/``else``, ``except`` vs the no-raise
    path) are never paired, but a release in an ``except`` arm plus one
    in the SAME try's ``finally`` does fire — both run on the exception
    path.
    """

    id = "DOUBLE-RELEASE"
    rationale = (
        "a second release on one path drops someone else's reference — "
        "the pool frees a block another holder still maps and the next "
        "alloc double-books it"
    )

    def check_program(self, program):
        flows = _Flows(program)
        findings = []
        for mod, fn, record, kind, events in _iter_resource_records(
            program, flows
        ):
            if SPECS[kind].idempotent_release:
                continue
            releases = sorted(events[0], key=lambda r: r["line"])
            reacqs = [
                p for p in events[2]
                if p.get("meth") and acquire_by_arg(
                    kind, p["meth"], p.get("recv", "")
                )
            ]
            for i, first in enumerate(releases):
                hit = None
                for second in releases[i + 1:]:
                    if second["line"] == first["line"]:
                        continue
                    if not _same_path(first["ctx"], second["ctx"]):
                        continue
                    if any(
                        p["line"] < second["line"]
                        and _same_path(p["ctx"], second["ctx"])
                        for p in reacqs
                    ):
                        # a retain before the second release added a
                        # reference of its own — the pair is the normal
                        # share-then-drain shape (FN over FP: one
                        # retain waives all later pairs on the path)
                        continue
                    hit = second
                    break
                if hit is None:
                    continue
                desc = _handle_desc(record, kind)
                findings.append(Finding(
                    self.id, mod.path, hit["line"], hit["col"],
                    f"{fn.qualname}() releases {desc} twice on one "
                    f"path ({first['api']}() at line {first['line']}, "
                    f"then {hit['api']}() at line {hit['line']} with "
                    "no re-acquisition between) — the second release "
                    "drops someone else's reference", "",
                ))
                break  # one finding per handle
        return findings


@register_program
class UseAfterReleaseRule(ProgramRule):
    """USE-AFTER-RELEASE — a handle operation reachable after its
    release on the same path.

    Released block indices spliced into a lane table scatter new KV
    writes into blocks the free list has already handed to another
    request; a closed file read raises at best.  The rule pairs each
    release with any later method call, subscript, iteration, or
    argument-pass of the same handle whose branch arms lie on the same
    sequential path; either-or branches are exempt (releasing in one arm
    and using in the other is the normal hand-off shape).
    """

    id = "USE-AFTER-RELEASE"
    rationale = (
        "touching a handle after its release operates on storage the "
        "pool already handed to another owner — corruption that "
        "surfaces far from the bug"
    )

    def check_program(self, program):
        flows = _Flows(program)
        findings = []
        for mod, fn, record, kind, events in _iter_resource_records(
            program, flows
        ):
            if kind == "thread":
                # a joined Thread object stays fully valid — is_alive()
                # after join() is the canonical did-it-finish check,
                # nothing about the handle is freed
                continue
            releases, op_uses, passes = events
            if not releases:
                continue
            uses = list(op_uses) + [
                dict(p, api="passed to " + (
                    str(p["ref"][1]) if p["ref"] else "a call"
                ) + "()")
                for p in passes
            ]
            hit = None
            for use in sorted(uses, key=lambda u: u["line"]):
                for rel in releases:
                    if use["line"] <= rel["line"]:
                        continue
                    if rel["fin"] and not use.get("fin"):
                        continue  # finally releases run last
                    if _same_path(rel["ctx"], use["ctx"]):
                        hit = (rel, use)
                        break
                if hit:
                    break
            if hit is None:
                continue
            rel, use = hit
            desc = _handle_desc(record, kind)
            findings.append(Finding(
                self.id, mod.path, use["line"], use.get("col", 0),
                f"{fn.qualname}() uses {desc} at line {use['line']} "
                f"({use['api']}) after releasing it at line "
                f"{rel['line']} — the handle may already belong to "
                "another owner", "",
            ))
        return findings
