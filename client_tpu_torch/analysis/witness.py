"""Dynamic lock-order, data-race and resource-leak witnesses over the
port's own objects.

The port's copy of client_tpu/analysis/witness.py.  Two differences: the
default prefixes are ``("client_tpu_torch",)``, so the locks built in
this package are the ones wrapped, and :meth:`ResourceWitness.installed`
raises, naming the spec, where a module or class of the port's
:data:`~client_tpu_torch.analysis.resources.DYNAMIC_SPECS` does not
import (the reference skips it): a skipped spec is a witness that
quietly checks nothing.

The static LOCK-INV / LOCKSET-RACE rules reason over *names*; this
module watches the *objects*.  Two witnesses share the held-lock
machinery:

- :class:`LockWitness` wraps the repo's lock/condition objects and
  records the actual acquisition DAG a test run exercises — every edge
  ``A -> B`` where some thread acquired B while holding A, stamped with
  the acquiring source sites — and reports any cycle.
- :class:`RaceWitness` (a LockWitness) additionally runs the Eraser
  lockset state machine *at runtime* on the shared fields of classes
  opted in via :func:`witness_shared` (or armed ad hoc with
  :meth:`RaceWitness.watch_class`): while installed, the class's
  ``__setattr__``/``__getattribute__`` are instrumented so every
  witnessed-field access consults the current thread's real held-lock
  stack.  A field starts first-thread-exclusive; once a second thread
  touches it, its *write lockset* is intersected write by write — an
  empty intersection (an unguarded or inconsistently-guarded write to a
  shared field) raises :class:`RaceViolation` carrying BOTH access
  stacks and dumps to the flight recorder when one is attached.
  Lock-free *reads* are tolerated by design: CPython reference loads
  are atomic, and the static pass's safe-publication exemption makes
  the same call — the witness checks the write-side protocol.

Static analysis and the witnesses keep each other honest: a race only
one side sees is either an unexercised static path (add a test) or a
dynamic aliasing pattern the summaries cannot name (add a rule).

Usage (tests)::

    w = LockWitness()
    with w.installed():           # patches threading.Lock/RLock/Condition
        run_concurrent_scenario() # locks built in client_tpu_torch/ record
    w.assert_acyclic()            # raises LockOrderViolation on a cycle

    w = RaceWitness()
    with w.installed():           # + instruments @witness_shared classes
        run_concurrent_scenario() # unguarded shared write -> raises
    w.assert_race_free()

The ``installed()`` patch only wraps locks *constructed from files under
the configured prefixes* (default ``client_tpu_torch``): stdlib internals
(queue, threading.Event, logging) keep raw primitives, so overhead and
noise stay scoped to the code under test.  Lock identity is the
construction site (``client_tpu_torch/serve/prof.py:<line>``) — all
instances born at one line share a name, which matches how the static
pass (and a human) reasons about lock order.

The port's chaos tests (``tests/test_torch_chaos.py``) and
``chip_smoke.py`` phase 27 arm these witnesses over client_tpu_torch;
``tests/conftest.py``'s ``--lock-witness`` / ``TPULINT_*_WITNESS=1``
hooks arm the reference's over client_tpu.

A third, independent witness covers the OWNERSHIP dimension:
:class:`ResourceWitness` patches the registered acquire/release pairs
from ``analysis/resources.py``'s :data:`DYNAMIC_SPECS` (KV block
alloc/retain/release, endpoint leases, tracer spans) into a live-handle
table keyed per handle with the acquisition stack; a handle still live
at :meth:`ResourceWitness.assert_clean` — a test's teardown audit and a
chaos-matrix invariant — raises :class:`ResourceLeakError` and dumps the
table plus stacks to the flight recorder.
"""

import contextlib
import os
import sys
import threading
import weakref

__all__ = [
    "LockOrderViolation",
    "LockWitness",
    "RaceViolation",
    "RaceWitness",
    "ResourceLeakError",
    "ResourceWitness",
    "WitnessLock",
    "WitnessCondition",
    "witness_shared",
]

_HERE = os.path.abspath(os.path.dirname(__file__))


class LockOrderViolation(AssertionError):
    """A cycle exists in the observed lock-acquisition graph."""


class RaceViolation(AssertionError):
    """A witnessed shared field was written with an empty lockset."""


def _call_site(prefixes):
    """The IMMEDIATE caller frame (first one outside this module) as
    ``relpath:lineno`` when it lives under one of *prefixes*; None
    otherwise.  Deliberately no deeper walk: a lock allocated by stdlib
    internals on behalf of client code (``Condition()``'s private RLock,
    ``queue.Queue``'s mutex) must stay a raw primitive — wrapping the
    RLock inside a Condition breaks its non-reentrant ``_is_owned``
    fallback probe."""
    frame = sys._getframe(2)
    while frame is not None:
        filename = frame.f_code.co_filename
        absfile = os.path.abspath(filename)
        if absfile.startswith(_HERE):
            frame = frame.f_back
            continue
        norm = absfile.replace(os.sep, "/")
        for prefix in prefixes:
            # a prefix names a PACKAGE, not a substring: a checkout
            # directory itself called client_tpu_torch must not pull the whole
            # tree (tests included) into scope, so the matched component
            # has to be a real package root (it carries __init__.py)
            idx = 0
            needle = "/" + prefix + "/"
            while True:
                idx = norm.find(needle, idx)
                if idx < 0:
                    break
                if _is_package_dir(norm[: idx + 1 + len(prefix)]):
                    rel = norm[idx + 1:]
                    if not rel.startswith("client_tpu_torch/analysis/"):
                        return f"{rel}:{frame.f_lineno}"
                idx += 1
        return None
    return None


_PKG_DIR_CACHE = {}


def _is_package_dir(d):
    hit = _PKG_DIR_CACHE.get(d)
    if hit is None:
        hit = os.path.isfile(os.path.join(d, "__init__.py"))
        _PKG_DIR_CACHE[d] = hit
    return hit


class LockWitness:
    """Collects the acquisition DAG; detects cycles as edges close them."""

    def __init__(self, prefixes=("client_tpu_torch",)):
        self.prefixes = tuple(prefixes)
        self._mu = threading.Lock()
        # (held_name, acquired_name) -> {"held_site", "site", "count"}
        self._edges = {}
        self._tls = threading.local()
        self.violations = []  # [(cycle list, description)]
        self.acquisitions = 0

    # -- held-stack bookkeeping (per thread) --------------------------------

    def _stack(self):
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def note_acquire(self, name, site):
        stack = self._stack()
        with self._mu:
            self.acquisitions += 1
            for held_name, held_site in stack:
                if held_name == name:
                    continue  # re-entrant acquire: not an ordering edge
                edge = (held_name, name)
                entry = self._edges.get(edge)
                if entry is None:
                    self._edges[edge] = {
                        "held_site": held_site, "site": site, "count": 1,
                    }
                    # the new edge held->name closes a cycle iff a path
                    # name ~> held already existed
                    path = self._path_locked(name, held_name)
                    if path is not None:
                        cycle = [held_name] + path
                        self.violations.append(
                            (cycle, self._describe_locked(cycle))
                        )
                else:
                    entry["count"] += 1
        stack.append((name, site))

    def note_release(self, name):
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == name:
                del stack[i]
                return

    # -- graph queries -------------------------------------------------------

    def _path_locked(self, src, dst):
        """A node path src..dst over current edges, else None."""
        adjacent = {}
        for a, b in self._edges:
            adjacent.setdefault(a, []).append(b)
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in adjacent.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def _describe_locked(self, cycle):
        parts = []
        for i, a in enumerate(cycle):
            b = cycle[(i + 1) % len(cycle)]
            entry = self._edges.get((a, b))
            if entry is not None:
                parts.append(
                    f"{a} (held at {entry['held_site']}) -> "
                    f"{b} (acquired at {entry['site']})"
                )
        return " ; ".join(parts)

    def edges(self):
        """{(held, acquired): count} snapshot of the observed DAG."""
        with self._mu:
            return {e: d["count"] for e, d in self._edges.items()}

    def cycles(self):
        """Cycles recorded while the witness was armed."""
        with self._mu:
            return list(self.violations)

    def assert_acyclic(self):
        """Raise :class:`LockOrderViolation` if any acquisition cycle was
        observed; returns the edge count otherwise (so callers can assert
        the witness actually saw traffic)."""
        with self._mu:
            violations = list(self.violations)
            n_edges = len(self._edges)
        if violations:
            lines = [
                f"lock-order cycle: {' -> '.join(c + [c[0]])} ({how})"
                for c, how in violations
            ]
            raise LockOrderViolation(
                f"{len(violations)} lock-order cycle(s) observed:\n"
                + "\n".join(lines)
            )
        return n_edges

    # -- wrapping ------------------------------------------------------------

    def wrap_lock(self, lock, name):
        return WitnessLock(lock, name, self)

    def wrap_condition(self, cond, name):
        return WitnessCondition(cond, name, self)

    @contextlib.contextmanager
    def installed(self):
        """Patch ``threading.Lock/RLock/Condition`` so objects constructed
        from files under the witness prefixes are wrapped (everything else
        gets the raw primitive)."""
        real_lock = threading.Lock
        real_rlock = threading.RLock
        real_cond = threading.Condition
        witness = self

        def make_lock():
            site = _call_site(witness.prefixes)
            inner = real_lock()
            return (
                WitnessLock(inner, site, witness)
                if site is not None
                else inner
            )

        def make_rlock():
            site = _call_site(witness.prefixes)
            inner = real_rlock()
            return (
                WitnessLock(inner, site, witness)
                if site is not None
                else inner
            )

        def make_condition(lock=None):
            site = _call_site(witness.prefixes)
            if isinstance(lock, WitnessLock):
                # share the existing wrapper's identity; the condition
                # acquires through it
                inner = real_cond(lock._inner)
                return WitnessCondition(inner, lock._name, witness)
            inner = real_cond(lock)
            return (
                WitnessCondition(inner, site, witness)
                if site is not None
                else inner
            )

        threading.Lock = make_lock
        threading.RLock = make_rlock
        threading.Condition = make_condition
        try:
            yield self
        finally:
            threading.Lock = real_lock
            threading.RLock = real_rlock
            threading.Condition = real_cond


class WitnessLock:
    """Recording proxy over a Lock/RLock."""

    def __init__(self, inner, name, witness):
        self._inner = inner
        self._name = name
        self._w = witness

    def acquire(self, blocking=True, timeout=-1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._w.note_acquire(self._name, _call_site(self._w.prefixes))
        return ok

    def release(self):
        self._w.note_release(self._name)
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def _is_owned(self):
        """Condition-compatibility: delegate RLock ownership, and answer
        the non-reentrant probe without re-recording (a wrapped lock
        handed to ``threading.Condition`` must keep its semantics)."""
        inner_owned = getattr(self._inner, "_is_owned", None)
        if inner_owned is not None:
            return inner_owned()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"WitnessLock({self._name!r})"


class WitnessCondition:
    """Recording proxy over a Condition.

    ``wait``/``wait_for`` release the underlying lock for their duration:
    the witness pops the name while blocked and re-records the
    reacquisition (which IS an ordering event — waking up under other
    held locks is how wait-based inversions happen)."""

    def __init__(self, inner, name, witness):
        self._inner = inner
        self._name = name
        self._w = witness

    def acquire(self, *args, **kwargs):
        ok = self._inner.acquire(*args, **kwargs)
        if ok:
            self._w.note_acquire(self._name, _call_site(self._w.prefixes))
        return ok

    def release(self):
        self._w.note_release(self._name)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def wait(self, timeout=None):
        self._w.note_release(self._name)
        try:
            return self._inner.wait(timeout)
        finally:
            self._w.note_acquire(
                self._name, _call_site(self._w.prefixes)
            )

    def wait_for(self, predicate, timeout=None):
        self._w.note_release(self._name)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            self._w.note_acquire(
                self._name, _call_site(self._w.prefixes)
            )

    def notify(self, n=1):
        self._inner.notify(n)

    def notify_all(self):
        self._inner.notify_all()

    def __repr__(self):
        return f"WitnessCondition({self._name!r})"


# -- dynamic race witness ----------------------------------------------------

# Classes opted in via @witness_shared, with their declared guard/field
# spec.  The decorator records intent only — zero runtime cost until a
# RaceWitness is installed and patches the class.
_WITNESSED_CLASSES = []


def witness_shared(*guards, fields=None):
    """Class decorator opting a class into dynamic race witnessing.

    *guards* name the lock/condition attributes that protect the class's
    shared state (``@witness_shared("_lock")``) — they are excluded from
    witnessing themselves.  *fields* narrows witnessing to the named
    instance attributes; by default every instance attribute that is not
    a guard (and not class-level: methods, properties, class vars) is
    witnessed.  The decorator is free until a :class:`RaceWitness` is
    installed: no wrapper, no per-access cost, nothing changes on the
    class.
    """
    def decorate(cls):
        spec = {
            "guards": frozenset(guards),
            "fields": frozenset(fields) if fields is not None else None,
        }
        cls._tpulint_witness_shared = spec
        _WITNESSED_CLASSES.append(weakref.ref(cls))
        return cls
    return decorate


def _access_stack(limit=8):
    """Compact caller stack (outside this module), innermost first."""
    frame = sys._getframe(2)
    out = []
    while frame is not None and len(out) < limit:
        filename = frame.f_code.co_filename
        if not os.path.abspath(filename).startswith(_HERE):
            out.append(
                f"{filename}:{frame.f_lineno} in "
                f"{frame.f_code.co_name}"
            )
        frame = frame.f_back
    return out


class _FieldState:
    """Eraser state for one (instance, field)."""

    __slots__ = ("owner", "shared", "modified", "wlock", "last_write",
                 "last")

    def __init__(self, owner):
        self.owner = owner       # first-accessing thread ident
        self.shared = False      # a second thread has touched it
        self.modified = False    # written after becoming shared
        self.wlock = None        # candidate write lockset (None = all)
        self.last_write = None   # (thread, held, stack) of last write
        self.last = None         # same, for the last access of any kind


class RaceWitness(LockWitness):
    """LockWitness + runtime Eraser lockset checking on witnessed
    classes (see the module docstring for the algorithm and the
    read-side tolerance rationale).

    ``flight`` (optional) is a
    :class:`~client_tpu_torch.serve.flight.FlightRecorder`: every violation is
    noted and the ring dumped, so a red chaos round ships the race
    evidence alongside its other postmortem artifacts.
    """

    def __init__(self, prefixes=("client_tpu_torch",), flight=None):
        super().__init__(prefixes=prefixes)
        self.flight = flight
        self._race_mu = threading.Lock()
        self._obj_states = {}    # id(obj) -> {field: _FieldState}
        self._finalizers = {}    # id(obj) -> weakref.finalize
        self._extra_classes = []  # watch_class() registrations
        self.race_violations = []  # [(cls, field, description)]
        self.field_accesses = 0

    # -- opt-in surface ------------------------------------------------------

    def watch_class(self, cls, guards=(), fields=None):
        """Arm *cls* for this witness without the decorator — the
        programmatic hook for ad-hoc classes (seeded-race tests, classes
        named by a static LOCKSET-RACE verdict).  Call before
        ``installed()``."""
        self._extra_classes.append((cls, {
            "guards": frozenset(guards),
            "fields": frozenset(fields) if fields is not None else None,
        }))

    def _armed_classes(self):
        out = []
        seen = set()
        for ref in _WITNESSED_CLASSES:
            cls = ref()
            if cls is not None and id(cls) not in seen:
                seen.add(id(cls))
                out.append((cls, cls._tpulint_witness_shared))
        for cls, spec in self._extra_classes:
            # a decorated class passed to watch_class() again must not
            # be instrumented twice (double wrappers never fully unwind)
            if id(cls) not in seen:
                seen.add(id(cls))
                out.append((cls, spec))
        return out

    # -- the state machine ---------------------------------------------------

    def _held_names(self):
        return frozenset(name for name, _site in self._stack())

    def note_field_access(self, obj, cls, field, kind):
        """Run one access through the lockset state machine.  Raises
        :class:`RaceViolation` on an empty write lockset."""
        tid = threading.get_ident()
        held = self._held_names()
        info = (threading.current_thread().name, held, _access_stack())
        report = None
        with self._race_mu:
            self.field_accesses += 1
            key = id(obj)
            states = self._obj_states.get(key)
            if states is None:
                states = self._obj_states[key] = {}
                try:
                    self._finalizers[key] = weakref.finalize(
                        obj, self._drop_state, key
                    )
                except TypeError:
                    pass  # not weakref-able: entry lives with the witness
            state = states.get(field)
            if state is None:
                state = states[field] = _FieldState(tid)
            if tid != state.owner and not state.shared:
                state.shared = True  # first-thread-exclusive phase over
            if kind == "write":
                if state.shared:
                    state.modified = True
                    state.wlock = (
                        held if state.wlock is None
                        else state.wlock & held
                    )
                    if not state.wlock:
                        prior = state.last_write or state.last
                        report = self._describe_race(
                            cls, field, info, prior
                        )
                        self.race_violations.append(
                            (cls.__name__, field, report)
                        )
                state.last_write = info
            state.last = info
        if report is not None:
            self._dump_race(cls, field, report)
            raise RaceViolation(report)

    def _drop_state(self, key):
        # finalizers can fire inside any allocation — including while a
        # note_field_access holds _race_mu on this very thread — so a
        # blocking acquire here could self-deadlock.  Skipping the
        # cleanup just leaves an inert id-keyed entry behind.
        if self._race_mu.acquire(False):
            try:
                self._obj_states.pop(key, None)
                self._finalizers.pop(key, None)
            finally:
                self._race_mu.release()

    @staticmethod
    def _describe_race(cls, field, current, prior):
        def fmt(info):
            if info is None:
                return "  (no prior access recorded)"
            thread, held, stack = info
            locks = (
                "{" + ", ".join(sorted(held)) + "}" if held
                else "no locks"
            )
            frames = "\n".join(f"    {line}" for line in stack)
            return f"  thread {thread!r} holding {locks}:\n{frames}"

        return (
            f"unguarded shared write: {cls.__name__}.{field} written "
            "with an empty candidate lockset (no lock common to every "
            "write since the field became thread-shared)\n"
            "this access:\n" + fmt(current)
            + "\nprior conflicting access:\n" + fmt(prior)
        )

    def _dump_race(self, cls, field, report):
        flight = self.flight
        if flight is None:
            return
        try:
            flight.note(
                "race_witness_violation", cls=cls.__name__, field=field,
                report=report,
            )
            flight.dump(f"race-{cls.__name__}-{field}")
        except Exception:
            pass  # evidence is best-effort; the raise is the verdict

    def assert_race_free(self):
        """Raise :class:`RaceViolation` if any violation was recorded
        (covers violations swallowed by driver try/except); returns the
        witnessed access count otherwise."""
        with self._race_mu:
            violations = list(self.race_violations)
            n = self.field_accesses
        if violations:
            lines = [
                f"{cls}.{field}" for cls, field, _r in violations
            ]
            raise RaceViolation(
                f"{len(violations)} unguarded shared write(s) observed: "
                + ", ".join(lines) + "\n\n" + violations[0][2]
            )
        return n

    # -- class instrumentation ----------------------------------------------

    def _instrument(self, cls, spec):
        witness = self
        guards = spec["guards"]
        fields = spec["fields"]
        class_attrs = frozenset(dir(cls))
        had_set = "__setattr__" in cls.__dict__
        had_get = "__getattribute__" in cls.__dict__
        orig_set = cls.__setattr__
        orig_get = cls.__getattribute__

        def watched(name):
            if fields is not None:
                return name in fields
            return (
                not name.startswith("__")
                and name not in guards
                and name not in class_attrs
            )

        def instrumented_setattr(obj, name, value):
            if watched(name):
                witness.note_field_access(obj, cls, name, "write")
            orig_set(obj, name, value)

        def instrumented_getattribute(obj, name):
            value = orig_get(obj, name)
            if watched(name):
                witness.note_field_access(obj, cls, name, "read")
            return value

        cls.__setattr__ = instrumented_setattr
        cls.__getattribute__ = instrumented_getattribute
        return (cls, had_set, orig_set, had_get, orig_get)

    @contextlib.contextmanager
    def installed(self):
        """The LockWitness threading patch PLUS per-class
        ``__setattr__``/``__getattribute__`` instrumentation on every
        witnessed class, all restored on exit."""
        patched = []
        with super().installed():
            try:
                for cls, spec in self._armed_classes():
                    patched.append(self._instrument(cls, spec))
                yield self
            finally:
                # reversed: if a class ever carries stacked wrappers,
                # unwinding inner-first restores the true originals
                for cls, had_set, orig_set, had_get, orig_get in (
                    reversed(patched)
                ):
                    if had_set:
                        cls.__setattr__ = orig_set
                    else:
                        del cls.__setattr__
                    if had_get:
                        cls.__getattribute__ = orig_get
                    else:
                        del cls.__getattribute__


# -- dynamic resource-leak witness -------------------------------------------


class ResourceLeakError(AssertionError):
    """Handles acquired while the resource witness was armed are still
    live at a checkpoint."""


class ResourceWitness:
    """Live-handle table over the registered acquire/release pairs.

    The dynamic half of the resource-lifecycle analysis: while
    installed, every acquire/release pair in
    ``analysis/resources.py``'s :data:`~client_tpu_torch.analysis.
    resources.DYNAMIC_SPECS` is patched so each acquisition registers the handle
    (with its acquisition stack) and each release retires it.  KV block
    references are counted per ``(pool, block)`` — a retain adds a
    reference the same release must drop — leases and spans are keyed by
    object identity.  A release of a handle acquired BEFORE the witness
    armed is ignored (the table audits the armed window, not history),
    so a function-scoped witness composes with session-scoped pools.

    :meth:`assert_clean` is the verdict: anything still live raises
    :class:`ResourceLeakError` carrying every leaked handle's kind,
    label, reference count, and acquisition stack, and — when a
    ``flight`` recorder is attached — dumps the table alongside the
    round's other postmortem artifacts.  Threads, sockets, and files
    stay static-only (see the DYNAMIC_SPECS comment): patching those
    class-wide would flag every stdlib-internal fd in the suite.
    """

    def __init__(self, flight=None):
        self.flight = flight
        self._mu = threading.Lock()
        self._live = {}  # key -> {"kind","label","count","stack"}
        self.acquisitions = 0
        self.releases = 0

    # -- the table -----------------------------------------------------------

    def _acquired(self, kind, key, label):
        stack = _access_stack()
        with self._mu:
            self.acquisitions += 1
            entry = self._live.get(key)
            if entry is None:
                self._live[key] = {
                    "kind": kind, "label": label, "count": 1,
                    "stack": stack,
                }
            else:
                entry["count"] += 1

    def _released(self, key):
        with self._mu:
            entry = self._live.get(key)
            if entry is None:
                return  # acquired before arming (or idempotent re-release)
            self.releases += 1
            entry["count"] -= 1
            if entry["count"] <= 0:
                del self._live[key]

    def live(self):
        """Snapshot of the live-handle table."""
        with self._mu:
            return {k: dict(v) for k, v in self._live.items()}

    def assert_clean(self):
        """Raise :class:`ResourceLeakError` when handles acquired while
        armed are still live; returns the acquisition count otherwise
        (so callers can assert the witness actually saw traffic)."""
        with self._mu:
            leaked = {k: dict(v) for k, v in self._live.items()}
            n = self.acquisitions
        if not leaked:
            return n
        lines = []
        for key, entry in sorted(
            leaked.items(), key=lambda kv: str(kv[0])
        ):
            frames = "\n".join(
                f"    {frame}" for frame in entry["stack"]
            )
            lines.append(
                f"  {entry['kind']} {entry['label']} "
                f"x{entry['count']} acquired at:\n{frames}"
            )
        report = (
            f"{len(leaked)} leaked resource handle(s) at witness "
            "checkpoint:\n" + "\n".join(lines)
        )
        self._dump_leak(leaked, report)
        raise ResourceLeakError(report)

    def _dump_leak(self, leaked, report):
        flight = self.flight
        if flight is None:
            return
        try:
            flight.note(
                "resource_witness_leak",
                handles=[
                    {"kind": e["kind"], "label": e["label"],
                     "count": e["count"], "stack": e["stack"]}
                    for e in leaked.values()
                ],
                report=report,
            )
            flight.dump("resource-leak")
        except Exception:
            pass  # evidence is best-effort; the raise is the verdict

    # -- patching ------------------------------------------------------------

    def _wrap_acquire(self, kind, cls, method, mode):
        orig = getattr(cls, method)
        witness = self

        def wrapped(self_obj, *args, **kwargs):
            out = orig(self_obj, *args, **kwargs)
            try:
                if mode == "ret-each":
                    for item in out or ():
                        witness._acquired(
                            kind, (kind, id(self_obj), item),
                            f"{cls.__name__}.{method}() block {item}",
                        )
                elif mode == "arg-each":
                    for item in (args[0] if args else ()) or ():
                        witness._acquired(
                            kind, (kind, id(self_obj), item),
                            f"{cls.__name__}.{method}() block {item}",
                        )
                elif mode == "ret" and out is not None:
                    witness._acquired(
                        kind, (kind, id(out)),
                        f"{cls.__name__}.{method}() -> "
                        f"{type(out).__name__}",
                    )
            except Exception:
                pass  # bookkeeping must never break the product call
            return out

        setattr(cls, method, wrapped)
        return cls, method, orig

    def _wrap_release(self, kind, cls, method, mode):
        orig = getattr(cls, method)
        witness = self

        def wrapped(self_obj, *args, **kwargs):
            out = orig(self_obj, *args, **kwargs)
            try:
                if mode == "arg-each":
                    for item in (args[0] if args else ()) or ():
                        witness._released((kind, id(self_obj), item))
                elif mode == "self":
                    witness._released((kind, id(self_obj)))
                elif mode == "arg" and args and args[0] is not None:
                    witness._released((kind, id(args[0])))
            except Exception:
                pass
            return out

        setattr(cls, method, wrapped)
        return cls, method, orig

    @contextlib.contextmanager
    def installed(self):
        """Patch every DYNAMIC_SPECS acquire/release pair (modules
        imported here, on arming), all restored on exit.  A spec whose
        module or class does not import raises, naming it."""
        import importlib

        from client_tpu_torch.analysis.resources import DYNAMIC_SPECS

        classes = []
        for spec in DYNAMIC_SPECS:
            try:
                module = importlib.import_module(spec["module"])
                classes.append((spec, getattr(module, spec["cls"])))
            except (ImportError, AttributeError) as exc:
                raise ImportError(
                    f"ResourceWitness: spec {spec['kind']!r} names "
                    f"{spec['module']}.{spec['cls']}, which does not "
                    f"import: {exc}"
                ) from exc
        patched = []
        try:
            for spec, cls in classes:
                for method, mode in spec["acquire"].items():
                    patched.append(
                        self._wrap_acquire(spec["kind"], cls, method,
                                           mode)
                    )
                for method, mode in spec["release"].items():
                    patched.append(
                        self._wrap_release(spec["kind"], cls, method,
                                           mode)
                    )
            yield self
        finally:
            # reversed: stacked witnesses unwind inner-first so the
            # true originals come back
            for cls, method, orig in reversed(patched):
                setattr(cls, method, orig)
