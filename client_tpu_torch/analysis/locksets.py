"""Eraser-style whole-program lockset inference (the LOCKSET-RACE core).

The lexical SHARED-MUT rule sees one file and one shape: an unlocked
*assignment* outside the thread closure.  It cannot see a field written
under ``self._lock`` in one method and read lock-free from a background
thread three calls away, or writes guarded by one lock racing reads
guarded by a *different* one.  This module runs the classic lockset
algorithm (Eraser, Savage et al. 1997; ThreadSanitizer's hybrid follows
the same idea) statically over the :mod:`callgraph` summaries:

1. **Escape analysis** — a class is *threaded* when any of its methods
   (or their nested defs) is registered as a deferred callable
   (``threading.Thread(target=self._loop)``, a registered callback edge).
   Only threaded classes are analyzed: a class nobody hands to a thread
   has no second thread root to race with.
2. **Thread roots** — one root per deferred target, plus ``<main>``
   covering the class's public surface (non-underscore methods; the
   calling thread's side of every race this repo shipped).  Private
   helpers are attributed to whichever roots actually reach them through
   same-instance (``self.``) calls and local nested defs.
3. **Interprocedural held sets** — each root is walked with the held-lock
   set carried across call edges (lexical ``with`` sets from the
   summaries, unioned down the chain; a ``*_locked`` callee adds its
   ``<caller-held:Class>`` pseudo lock).  Every shared-field access is
   stamped with the full lexical+interprocedural set and the root chain
   that reached it.
4. **Lockset verdicts** — per field, Eraser-style: the candidate guard
   set is the intersection of held sets across accesses.  A field is a
   race when a *write* and another access from a *different* root have
   disjoint locksets.  Exemptions (documented FN > noisy FP):

   - ``__init__`` is never walked: constructor writes are the virgin /
     first-thread-exclusive phase (no second thread can exist yet for
     the fields it initializes);
   - fields only touched from one root are single-threaded;
   - fields with no write outside ``__init__`` are effectively frozen;
   - event/queue/thread-named fields hold internally synchronized (or
     handle-only) objects — flagging ``self._stop.set()`` would drown
     the gate;
   - a ``<caller-held:Class>`` pseudo lock intersects everything: the
     ``*_locked`` convention vouches for the caller;
   - a field assigned an instance of a *lock-owning analyzed class*
     (``self.seq_store = _SequenceStore(...)``) is self-synchronized:
     the delegate's own lock is its discipline (checked by its own
     analysis and, for ``@witness_shared`` classes, the dynamic
     witness); deeper paths that reach around it stay checked;
   - **safe publication**: a field whose every write is a pure
     reference rebind (``self.x = v``, never ``self.x[k] = v`` or
     ``self.x.append(...)``) under one consistent guard may be read
     lock-free — the GIL makes reference loads atomic, so readers see
     the old or the new object, never a torn one (the
     ``set_registry``/``fleet.attach`` post-fix shape).  The pre-fix
     shape (unguarded rebind) still has an empty write-lockset
     intersection and is flagged.

Each verdict carries *both* witness sites (file:line, the holding set at
each, and the thread-root chain that reached it) so the finding reads as
a race report, not a style nit.  The dynamic twin of this pass is
:class:`client_tpu_torch.analysis.witness.RaceWitness`, which runs the same
state machine against the real held-lock stack at runtime.
"""

from client_tpu_torch.analysis.callgraph import (
    _EVENTISH_RE,
    _QUEUEISH_RE,
    _THREADISH_RE,
)

_MAX_DEPTH = 10       # call-chain depth per root walk
_MAX_STATES = 4000    # (function, entry-held) states per class walk

MAIN_ROOT = "<main>"


def _is_synced_field(attr):
    """Fields whose names mark internally synchronized/handle objects
    (events, queues, thread handles) — their methods are the sanctioned
    cross-thread API, not racy data accesses.  *attr* is an access path
    (``kv.pools``): any synced segment exempts the path."""
    return any(
        _EVENTISH_RE.search(seg)
        or _QUEUEISH_RE.search(seg)
        or _THREADISH_RE.search(seg)
        for seg in attr.split(".")
    )


def _is_pseudo(lock):
    return lock.startswith("<caller-held:")


class Access:
    """One shared-field access, fully attributed."""

    __slots__ = ("attr", "kind", "deep", "path", "line", "col", "held",
                 "root", "chain")

    def __init__(self, attr, kind, deep, path, line, col, held, root,
                 chain):
        self.attr = attr
        self.kind = kind          # "read" | "write"
        self.deep = deep          # write mutates the field's object
        self.path = path
        self.line = line
        self.col = col
        self.held = held          # frozenset of lock ids
        self.root = root          # root name (qualname or <main>)
        self.chain = chain        # tuple of qualnames from the root

    def site(self):
        locks = (
            "{" + ", ".join(sorted(self.held)) + "}"
            if self.held else "no locks"
        )
        return (
            f"{self.path}:{self.line} ({self.kind} holding {locks}, "
            f"via {self.root}: {' -> '.join(self.chain)})"
        )


class RaceReport:
    """One field whose candidate lockset went empty across ≥2 roots."""

    __slots__ = ("cls", "attr", "write", "other", "roots")

    def __init__(self, cls, attr, write, other, roots):
        self.cls = cls
        self.attr = attr
        self.write = write    # the witness write Access
        self.other = other    # the second witness Access (another root)
        self.roots = roots    # all roots that touch the field

    def message(self):
        return (
            f"field {self.cls}.{self.attr} has an empty candidate "
            f"lockset across thread roots "
            f"({', '.join(sorted(self.roots))}): "
            f"written at {self.write.site()} racing "
            f"{self.other.kind} at {self.other.site()} — guard every "
            "access with one consistent lock (or confine the field to "
            "one thread)"
        )


def _nested_lookup(mod, caller, name):
    """A nested def (``Cls.method.loop``) referenced by bare name."""
    return mod.functions.get(f"{caller.qualname}.{name}")


def _deferred_targets(program, mod, cls_name):
    """(roots, spawners) for the class: ``roots`` maps each deferred
    callable's qualname (Thread targets and registered callbacks
    resolving to the class's own methods or their nested defs) to its
    (mod, fn); ``spawners`` is the set of qualnames of the methods that
    *register* them — their writes precede the thread's start in every
    shape this repo uses (``start()`` spawns last), so they share
    ``__init__``'s virgin-phase exemption."""
    roots = {}
    spawners = set()
    for fn in mod.functions.values():
        if fn.cls != cls_name:
            continue
        for call in fn.calls:
            if not call["deferred"]:
                continue
            kind, value = call["ref"]
            target = None
            if kind == "self":
                tmod, tfn = program.resolve(mod, fn, ("self", value))
                if tfn is not None:
                    target = (tmod, tfn)
            elif kind == "name":
                tfn = _nested_lookup(mod, fn, value)
                if tfn is not None:
                    target = (mod, tfn)
            if target is not None:
                roots[target[1].qualname] = target
                spawners.add(fn.qualname)
    return roots, spawners


def _self_synced_fields(program, mod, cls_name):
    """Fields assigned an instance of a lock-owning analyzed class
    (``self.seq_store = _SequenceStore(...)`` where ``_SequenceStore``
    constructs its own ``_lock``): the object synchronizes itself, so
    method calls through the field are the sanctioned pattern — its
    internal discipline is checked by its own class's analysis (and,
    for ``@witness_shared`` classes, by the dynamic witness)."""
    info = mod.classes.get(cls_name, {})
    synced = set()
    for attr, ctor in info.get("field_ctors", {}).items():
        cmod, ccls = program._resolve_class(mod, ctor)
        if ccls is None:
            continue
        if cmod.classes.get(ccls, {}).get("lock_attrs"):
            synced.add(attr)
    return synced


def _main_entries(program, mod, cls_name, deferred):
    """The class's public surface: externally callable methods that are
    not thread roots themselves (the calling thread's side)."""
    info = mod.classes.get(cls_name, {})
    entries = []
    for method in info.get("methods", []):
        if method == "__init__" or method.startswith("__"):
            continue
        if method.startswith("_"):
            continue
        qual = f"{cls_name}.{method}"
        if qual in deferred:
            continue
        hit = mod.functions.get(qual)
        if hit is not None:
            entries.append((mod, hit))
    return entries


def _walk_root(program, mod, cls_name, root_name, entries, exempt=()):
    """Collect every shared-field access reachable from *entries*, each
    stamped with the lexically+interprocedurally held lock set.  Direct
    accesses in ``__init__`` and in *exempt* (spawn) methods are the
    virgin phase and are skipped; their callees still count."""
    accesses = []
    seen = set()
    stack = []
    for emod, efn in entries:
        held = frozenset(
            [program.pseudo_required_lock(efn)]
            if efn.requires_lock else []
        )
        stack.append((emod, efn, held, (efn.qualname,)))
    while stack:
        m, fn, held, chain = stack.pop()
        key = (m.module, fn.qualname, held)
        if key in seen or len(seen) > _MAX_STATES:
            continue
        seen.add(key)
        for acc in fn.accesses:
            if fn.name == "__init__" or fn.qualname in exempt:
                continue
            eff = held | frozenset(acc["held"])
            accesses.append(Access(
                acc["attr"], acc["kind"], acc.get("deep", False),
                m.path, acc["line"], acc["col"], eff, root_name, chain,
            ))
        if len(chain) >= _MAX_DEPTH:
            continue
        for call in fn.calls:
            if call["deferred"]:
                continue
            kind, value = call["ref"]
            if kind == "self":
                cmod, cfn = program.resolve(
                    m, fn, call["ref"], call["nargs"]
                )
            elif kind == "name":
                cfn = _nested_lookup(m, fn, value)
                cmod = m if cfn is not None else None
            else:
                continue  # other instances' methods are their own class
            if cfn is None or cfn.name == "__init__":
                continue
            sub_held = held | frozenset(call["held"])
            if cfn.requires_lock:
                sub_held = sub_held | {
                    program.pseudo_required_lock(cfn)
                }
            stack.append((cmod, cfn, sub_held, chain + (cfn.qualname,)))
    return accesses


def _disjoint(a, b):
    """Locksets share nothing — and neither carries the *_locked pseudo
    lock (the caller-holds-the-lock convention vouches for the site)."""
    if a & b:
        return False
    if any(_is_pseudo(lock) for lock in a | b):
        return False
    return True


def analyze(program):
    """Run the lockset pass; returns a list of :class:`RaceReport`."""
    reports = []
    for mod in program.modules:
        for cls_name in sorted(mod.classes):
            deferred, spawners = _deferred_targets(program, mod, cls_name)
            if not deferred:
                continue  # instances never escape to another thread
            per_root = {}
            for root_name, target in sorted(deferred.items()):
                per_root[root_name] = _walk_root(
                    program, mod, cls_name, root_name, [target],
                    exempt=spawners,
                )
            mains = _main_entries(program, mod, cls_name, deferred)
            if mains:
                per_root[MAIN_ROOT] = _walk_root(
                    program, mod, cls_name, MAIN_ROOT, mains,
                    exempt=spawners,
                )
            synced = _self_synced_fields(program, mod, cls_name)
            reports.extend(_verdicts(cls_name, per_root, synced))
    return reports


def _verdicts(cls_name, per_root, self_synced=frozenset()):
    by_attr = {}
    for root_name, accesses in per_root.items():
        for acc in accesses:
            if _is_synced_field(acc.attr):
                continue
            if acc.attr in self_synced:
                # the field's object owns its own lock (see
                # _self_synced_fields); deeper paths that reach AROUND
                # that lock (self.store._entries[...]) stay checked
                continue
            by_attr.setdefault(acc.attr, []).append(acc)
    reports = []
    for attr in sorted(by_attr):
        records = by_attr[attr]
        roots = {acc.root for acc in records}
        if len(roots) < 2:
            continue  # single-threaded field
        writes = sorted(
            (a for a in records if a.kind == "write"),
            key=lambda a: (a.path, a.line, a.col),
        )
        if not writes:
            continue  # frozen after __init__: reads cannot race
        if all(not w.deep for w in writes):
            # safe publication: every write is a pure reference rebind
            # and all rebinds share a guard — readers see either the old
            # or the new reference atomically (GIL), never a torn state.
            # Interior mutation (deep writes) never qualifies.
            common = writes[0].held
            for w in writes[1:]:
                common = common & w.held
            if common:
                continue
        others = sorted(
            records,
            key=lambda a: (a.kind != "write", a.path, a.line, a.col),
        )
        witness = None
        for w in writes:
            for other in others:
                if other.root == w.root:
                    continue
                if not _disjoint(w.held, other.held):
                    continue
                if other.kind != "write" and w.deep and not other.deep:
                    # an interior mutation races interior observers
                    # (subscripts, iteration, method calls) — a bare
                    # reference load stays GIL-atomic regardless
                    continue
                witness = (w, other)
                break
            if witness:
                break
        if witness is None:
            continue  # every cross-root pair shares a guard
        reports.append(RaceReport(
            cls_name, attr, witness[0], witness[1], roots,
        ))
    return reports
