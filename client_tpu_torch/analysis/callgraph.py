"""Whole-program concurrency model: call graph + per-function lock summaries.

The lexical rules in ``rules.py`` see one function at a time; every
cross-function concurrency hazard this repo shipped (prefill dispatched
under the scheduler ``_cv`` three frames below the ``with``, observer
callbacks fired under a delivery lock) was invisible to them.  This module
builds the interprocedural substrate the ``concurrency.py`` rules run on:

- a **module summary** per file: top-level functions, classes (methods,
  base names, lock-kind attributes, jit-bound attributes), import aliases;
- a **function summary** per function/method/nested def: the lock
  *acquisitions* it performs (each with the locks already held at that
  point), the *blocking operations* it performs (device dispatch, sleeps,
  timeout-less waits/joins/queue gets, sockets/subprocess), the *dynamic
  callback invocations* it makes (observer/callback-shaped attribute
  calls, calls through parameters or ``getattr`` results), its outgoing
  *call edges*, and its **shared-field accesses** — ``self.``-rooted
  reads/writes at up-to-two-segment path granularity (``kv`` vs
  ``kv.pools``), each classified rebind vs interior mutation (*deep*)
  and bare reference load vs interior observation, the raw material the
  lockset pass (``locksets.py``) intersects — every event stamped with
  the lock set lexically held where it happens;
- a **program** index that resolves call references class/module-aware:
  ``self.method()`` through the class and its resolvable bases, bare and
  dotted names through module scope and import aliases, constructor calls
  to ``__init__``, plus a unique-method fallback (``obj.take_first()``
  resolves when exactly one class in the program defines an
  arity-compatible ``take_first``), and callback registration points
  (``threading.Thread(target=...)``, lambda bodies) as *deferred*
  references that never inherit the registering frame's held locks.

Lock identity is ``Class.attr`` for ``self.<attr>`` locks, ``module.name``
for module-level locks, and ``module::func.name`` for function-locals —
stable across files so the lock-order graph composes program-wide.  A
``*_locked`` method (this repo's caller-holds-the-lock convention) is
summarized as *requiring* a lock on entry; rules model that as a pseudo
lock (``<caller-held:Class>``) held across its body.

Held-lock tracking is lexical: ``with lock:`` bodies extend the held set;
a bare ``.acquire()`` records the acquisition event (it feeds the
lock-order graph) but does not extend the held set for the statements
after it — the approximation the rules document.

Everything here is serializable plain data (see ``to_dict``/``from_dict``)
so the incremental cache can persist summaries keyed on file mtime and
skip re-parsing unchanged files entirely.
"""

import ast
import os
import re

from client_tpu_torch.analysis import resources as _res
from client_tpu_torch.analysis.rules import (
    _CVLIKE_RE,
    _DISPATCH_FULL,
    _DISPATCH_HINTS,
    _JIT_CTORS,
    _LOCKISH_RE,
    _expr_text,
    _jit_bound_names,
    _last_segment,
    _torch_dispatch,
)

# Lock-object constructors, by dotted callee text -> kind.
_LOCK_CTORS = {
    "threading.Lock": "lock",
    "threading.RLock": "rlock",
    "threading.Condition": "condition",
    "Lock": "lock",
    "RLock": "rlock",
    "Condition": "condition",
}
_SEM_CTORS = {"threading.Semaphore", "threading.BoundedSemaphore",
              "Semaphore", "BoundedSemaphore"}

# Blocking callees by full dotted text.
_BLOCKING_FULL = {
    "time.sleep": "time.sleep()",
    "os.system": "os.system()",
    "subprocess.run": "subprocess.run()",
    "subprocess.call": "subprocess.call()",
    "subprocess.check_output": "subprocess.check_output()",
    "subprocess.check_call": "subprocess.check_call()",
    "socket.create_connection": "socket.create_connection()",
    "urllib.request.urlopen": "urlopen()",
    # the torch host syncs: each waits for every kernel queued before it
    "torch.cuda.synchronize": "torch.cuda.synchronize()",
}
_BLOCKING_PREFIXES = ("requests.",)

# Attribute calls on receivers whose LAST segment matches these are
# callback invocations (user/observer code this module does not control).
_CALLBACKISH_RECV_RE = re.compile(
    r"(?i)(^|_)(observer|callback|listener|hook|sink)s?$"
)
_CALLBACKISH_ATTR_RE = re.compile(r"(?i)^(on_[a-z0-9_]+|callback|_callback)$")
# Parameter names whose calls count as foreign-code callbacks.  Narrow on
# purpose: a `pred`/`key` predicate parameter is an internal control knob,
# not user code — flagging it under a lock would drown the gate.
_CALLBACKISH_PARAM_RE = re.compile(
    r"(?i)(^|_)(callback|cb|observer|listener|hook|sink|handler|notify"
    r"|on_[a-z0-9_]+)s?$"
)
_EVENTISH_RE = re.compile(r"(?i)(^|_)(event|ev|done|ready|stop|closed)s?$")
_QUEUEISH_RE = re.compile(r"(?i)(^|_)(q|queue|backlog|inbox|outbox)s?$")
_THREADISH_RE = re.compile(r"(?i)(^|_)(thread|prober|worker|pump)s?$")

# In-place mutators: a method call on a self-field through one of these
# names mutates the field's object — for the lockset pass that is a
# *write* access (the discovery-membership shape), not a read.
_MUTATOR_METHODS = {
    "append", "appendleft", "extend", "extendleft", "insert", "remove",
    "pop", "popleft", "popitem", "clear", "discard", "add", "update",
    "setdefault", "sort", "reverse",
}


def module_name_for(path):
    """Dotted module name for *path*.

    Cross-module resolution joins :class:`ModuleSummary.module` against
    the names ``import`` statements use, so the identity must come out
    the same however the scan root was spelled — an absolute CI path
    (``/ci/checkout/client_tpu/...``) and a relative dev path must name
    the same module.  For files inside a package we therefore walk up
    through ``__init__.py`` markers and name the module relative to the
    package root; files outside any package keep the path-derived (but
    still unique) fallback."""
    norm = os.path.normpath(path)
    base = os.path.basename(norm)
    if base.endswith(".py"):
        base = base[:-3]
    directory = os.path.dirname(os.path.abspath(norm))
    if os.path.isfile(os.path.join(directory, "__init__.py")):
        parts = [base]
        d = directory
        while os.path.isfile(os.path.join(d, "__init__.py")):
            d, tail = os.path.split(d)
            if not tail:
                break
            parts.insert(0, tail)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)
    if norm.endswith(".py"):
        norm = norm[:-3]
    parts = [
        p for p in norm.replace(os.sep, "/").split("/") if p not in ("", ".")
    ]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) or norm


class FunctionSummary:
    """One function's concurrency-relevant behavior, as plain data."""

    __slots__ = ("qualname", "name", "cls", "line", "requires_lock",
                 "params_min", "params_max", "acquisitions", "calls",
                 "blocking", "callbacks", "accesses", "resources",
                 "res_facts",
                 # scanner scratch (never serialized)
                 "_param_names", "_getattr_locals", "_access_seen")

    def __init__(self, qualname, name, cls, line, requires_lock,
                 params_min, params_max):
        self.qualname = qualname
        self.name = name
        self.cls = cls  # enclosing class name or None
        self.line = line
        self.requires_lock = requires_lock  # the *_locked convention
        self.params_min = params_min
        self.params_max = params_max  # None = *args/**kwargs
        # [{"lock", "line", "col", "held": [...]}]
        self.acquisitions = []
        # [{"ref": (kind, value), "line", "col", "held": [...],
        #   "nargs", "deferred": bool}]
        self.calls = []
        # [{"desc", "kind", "line", "col", "held": [...], "waits_on"}]
        self.blocking = []
        # [{"desc", "line", "col", "held": [...]}]
        self.callbacks = []
        # shared-field accesses (lockset pass): one entry per distinct
        # (attr, kind, held) triple — [{"attr", "kind": "read"|"write",
        # "line", "col", "held": [...]}]
        self.accesses = []
        # resource handle records (lifecycle pass, see resources.py):
        # one entry per acquisition site / wrapper-call binding, each
        # carrying its branch-arm context, the ops/arg-passes performed
        # on the handle, and how (if at all) ownership escaped
        self.resources = []
        # function-level ownership facts: {"returns", "ret_calls",
        # "params", "exits"} — what the interprocedural transfer
        # resolution reads from the CALLEE side
        self.res_facts = {}

    def to_dict(self):
        return {
            "qualname": self.qualname, "name": self.name, "cls": self.cls,
            "line": self.line, "requires_lock": self.requires_lock,
            "params_min": self.params_min, "params_max": self.params_max,
            "acquisitions": self.acquisitions,
            "calls": [dict(c, ref=list(c["ref"])) for c in self.calls],
            "blocking": self.blocking, "callbacks": self.callbacks,
            "accesses": self.accesses,
            "resources": self.resources, "res_facts": self.res_facts,
        }

    @classmethod
    def from_dict(cls, d):
        fn = cls(d["qualname"], d["name"], d["cls"], d["line"],
                 d["requires_lock"], d["params_min"], d["params_max"])
        fn.acquisitions = d["acquisitions"]
        fn.calls = [dict(c, ref=tuple(c["ref"])) for c in d["calls"]]
        fn.blocking = d["blocking"]
        fn.callbacks = d["callbacks"]
        fn.accesses = d.get("accesses", [])
        fn.resources = d.get("resources", [])
        fn.res_facts = d.get("res_facts", {})
        return fn


class ModuleSummary:
    """One file's classes/functions/imports, as plain data."""

    __slots__ = ("path", "module", "imports", "classes", "functions",
                 "toplevel", "module_locks", "jit_names")

    def __init__(self, path, module):
        self.path = path
        self.module = module
        self.imports = {}       # alias -> "module" or "module:attr"
        self.classes = {}       # name -> {"bases": [...], "methods": [...],
        #                                  "lock_attrs": {attr: kind},
        #                                  "sem_attrs": [...],
        #                                  "jit_attrs": [...]}
        self.functions = {}     # qualname -> FunctionSummary
        self.toplevel = []      # top-level function names
        self.module_locks = {}  # module-level lock name -> kind
        self.jit_names = []     # module/self-level names bound from jax.jit

    def to_dict(self):
        return {
            "path": self.path, "module": self.module,
            "imports": self.imports, "classes": self.classes,
            "functions": {q: f.to_dict() for q, f in self.functions.items()},
            "toplevel": self.toplevel, "module_locks": self.module_locks,
            "jit_names": self.jit_names,
        }

    @classmethod
    def from_dict(cls, d):
        ms = cls(d["path"], d["module"])
        ms.imports = d["imports"]
        ms.classes = d["classes"]
        ms.functions = {
            q: FunctionSummary.from_dict(f)
            for q, f in d["functions"].items()
        }
        ms.toplevel = d["toplevel"]
        ms.module_locks = d["module_locks"]
        ms.jit_names = d["jit_names"]
        return ms


# -- summary construction ----------------------------------------------------


def _ctor_kind(call):
    text = _expr_text(call.func) or ""
    if text in _LOCK_CTORS:
        return _LOCK_CTORS[text]
    if text in _SEM_CTORS:
        return "semaphore"
    return None


def _collect_imports(tree, module):
    imports = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    imports[alias.asname] = alias.name
                else:
                    root = alias.name.split(".", 1)[0]
                    imports[root] = root
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = module.split(".")
                parts = parts[: len(parts) - node.level]
                base = ".".join(
                    parts + ([node.module] if node.module else [])
                )
            for alias in node.names:
                if alias.name == "*":
                    continue
                name = alias.asname or alias.name
                imports[name] = f"{base}:{alias.name}"
    return imports


def _direct_nested(fn_node):
    """Immediate nested function defs (not crossing deeper functions)."""
    out = []
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(node)
            continue
        stack.extend(ast.iter_child_nodes(node))
    return sorted(out, key=lambda n: n.lineno)


class _FunctionScanner:
    """Walk one function body with a lexical held-lock stack."""

    def __init__(self, modsum, cls_name, fn_summary, local_locks):
        self.mod = modsum
        self.cls = cls_name
        self.fn = fn_summary
        self.local_locks = local_locks  # local name -> kind
        self._lambda_depth = 0

    # -- lock identity -------------------------------------------------------

    def lock_id(self, text):
        """Stable program-wide identity for a lock expression, or None."""
        if not text:
            return None
        if text.startswith("self."):
            rest = text[len("self."):]
            owner = self.cls or self.mod.module
            return f"{owner}.{rest}"
        if "." not in text:
            if text in self.local_locks:
                return f"{self.mod.module}::{self.fn.qualname}.{text}"
            if text in self.mod.module_locks:
                return f"{self.mod.module}.{text}"
            return f"{self.mod.module}::{self.fn.qualname}.{text}"
        return f"{self.mod.module}:{text}"

    def _is_lockish(self, text):
        if not text:
            return False
        last = _last_segment(text)
        if _LOCKISH_RE.search(last):
            return True
        if text.startswith("self.") and self.cls:
            attrs = self.mod.classes.get(self.cls, {}).get("lock_attrs", {})
            return text[len("self."):] in attrs
        return text in self.local_locks or text in self.mod.module_locks

    # -- classification ------------------------------------------------------

    def _is_jit_bound(self, text):
        if text in self.mod.jit_names:
            return True
        if text.startswith("self.") and self.cls:
            jit_attrs = self.mod.classes.get(self.cls, {}).get("jit_attrs", [])
            return text[len("self."):] in jit_attrs
        return False

    @staticmethod
    def _call_timeout(call, pos_index):
        """True when the call carries a timeout (kw or positional slot)."""
        if any(kw.arg == "timeout" for kw in call.keywords):
            return True
        return len(call.args) > pos_index

    def _classify_blocking(self, call, text):
        """(desc, kind, waits_on) for a blocking call, else None.

        The torch keys (a CUDA-graph capture, a compile or extension
        build, a host sync, ``torch.cuda.synchronize`` among them) are
        of kind "dispatch": LOCK-DISPATCH reports them where the lock is
        taken, BLOCK-UNDER-LOCK where a call made under a lock reaches
        them."""
        torch_hit = _torch_dispatch(call)
        if torch_hit is not None:
            kind, shown = torch_hit
            desc = _BLOCKING_FULL.get(shown, f"{shown}()")
            return f"torch {kind} {desc}", "dispatch", None
        if text in _BLOCKING_FULL:
            return _BLOCKING_FULL[text], "host", None
        if text and text.startswith(_BLOCKING_PREFIXES):
            return f"{text}()", "host", None
        if self._is_jit_bound(text):
            return f"jit-compiled {text}()", "dispatch", None
        if text in _DISPATCH_FULL:
            return f"{text}()", "dispatch", None
        if text and _last_segment(text) in _DISPATCH_HINTS:
            return f"device-dispatch {text}()", "dispatch", None
        if not isinstance(call.func, ast.Attribute):
            return None
        attr = call.func.attr
        recv = _expr_text(call.func.value)
        if recv is None:
            return None
        last = _last_segment(recv)
        if attr in ("wait", "wait_for"):
            pos = 0 if attr == "wait" else 1
            if self._call_timeout(call, pos):
                return None  # bounded wait
            if _CVLIKE_RE.search(last) or self._is_lockish(recv):
                return (f"{recv}.{attr}()", "cv-wait", self.lock_id(recv))
            if _EVENTISH_RE.search(last):
                return f"{recv}.{attr}()", "event-wait", None
            return None
        if attr == "get" and _QUEUEISH_RE.search(last):
            kwargs = {kw.arg for kw in call.keywords}
            if "timeout" in kwargs or len(call.args) >= 2:
                return None
            for a in call.args[:1]:
                if isinstance(a, ast.Constant) and a.value is False:
                    return None  # non-blocking get
            for kw in call.keywords:
                if kw.arg == "block" and isinstance(
                    kw.value, ast.Constant
                ) and kw.value.value is False:
                    return None
            return f"{recv}.get()", "queue-get", None
        if attr == "join" and not call.args and not any(
            kw.arg == "timeout" for kw in call.keywords
        ):
            if _THREADISH_RE.search(last) or last in ("t", "th"):
                return f"{recv}.join()", "thread-join", None
        if attr == "acquire":
            if self._is_semaphore(recv) and not self._call_timeout(call, 1):
                return f"{recv}.acquire()", "semaphore", None
        return None

    def _is_semaphore(self, text):
        if text.startswith("self.") and self.cls:
            sems = self.mod.classes.get(self.cls, {}).get("sem_attrs", [])
            return text[len("self."):] in sems
        return False

    def _classify_callback(self, call, text):
        """Description for a dynamic callback invocation, else None."""
        func = call.func
        if isinstance(func, ast.Name):
            # calls through callback-named parameters or getattr()-derived
            # locals are dynamic: the callee is caller-supplied code
            if func.id in self.fn._param_names and (
                _CALLBACKISH_PARAM_RE.search(func.id)
            ):
                return f"parameter callback {func.id}()"
            if func.id in self.fn._getattr_locals:
                return f"dynamic callable {func.id}()"
            return None
        if not isinstance(func, ast.Attribute):
            return None
        recv = _expr_text(func.value)
        if recv is None:
            return None
        if _CALLBACKISH_RECV_RE.search(_last_segment(recv)):
            return f"{recv}.{func.attr}()"
        if _CALLBACKISH_ATTR_RE.search(func.attr):
            return f"{recv}.{func.attr}()"
        return None

    # -- shared-field accesses ----------------------------------------------

    def _field_path(self, expr):
        """(path, n_segments) for a ``self.``-rooted expression, or
        (None, 0).  The path keeps up to two segments past ``self`` so
        an owner-confined interior (``kv.pools``) is a distinct variable
        from the shared reference (``kv``) — ``self.kv.pools["k"]``
        accesses ``kv.pools``, ``self.kv.alloc(...)`` accesses ``kv``."""
        text = _expr_text(expr)
        if not text or not text.startswith("self.") or self.cls is None:
            return None, 0
        parts = text.split(".")
        return ".".join(parts[1:3]), len(parts) - 1

    def _field_of(self, expr):
        """The class-field path a ``self.``-rooted expression accesses
        (``self._pending[k].x`` -> ``_pending``), or None."""
        return self._field_path(expr)[0]

    def _record_access(self, attr, kind, node, held, deep=False):
        """Record one shared-field access, deduped per (attr, kind,
        deep, held).  *deep* marks writes that mutate the field's object
        (``self._map[k] = v``, ``self._q.append(x)``) as opposed to a
        pure reference rebind (``self.x = v``) — the lockset pass treats
        consistently guarded rebinds as safe publication (GIL-atomic
        reads) but never interior mutation.

        Lock/semaphore/jit attributes and the class's own methods are
        not data fields; they never enter the access table."""
        if attr is None or self.cls is None:
            return
        base = attr.split(".")[0]
        info = self.mod.classes.get(self.cls, {})
        if (
            base in info.get("lock_attrs", {})
            or base in info.get("sem_attrs", [])
            or base in info.get("jit_attrs", [])
            or base in info.get("methods", [])
        ):
            return
        key = (attr, kind, deep, tuple(held))
        if key in self.fn._access_seen:
            return
        self.fn._access_seen.add(key)
        self.fn.accesses.append({
            "attr": attr, "kind": kind, "deep": deep,
            "line": node.lineno, "col": node.col_offset,
            "held": list(held),
        })

    def _record_target(self, target, held):
        """Record write accesses for an assignment/delete target and walk
        its non-field parts (subscript keys) for the reads they perform."""
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._record_target(elt, held)
            return
        if isinstance(target, ast.Starred):
            self._record_target(target.value, held)
            return
        if isinstance(target, ast.Attribute):
            attr, nparts = self._field_path(target)
            if attr is not None:
                # self.a = v / self.a.b = v rebind their own path's
                # slot; self.a.b.c = v mutates the a.b object's interior
                self._record_access(attr, "write", target, held,
                                    deep=nparts > 2)
                return
            self._walk(target.value, held)
            return
        if isinstance(target, ast.Subscript):
            attr = self._field_of(target.value)
            if attr is not None:
                # self._map[k] = v mutates the object the field holds —
                # a write at field granularity
                self._record_access(attr, "write", target, held,
                                    deep=True)
            else:
                self._walk(target.value, held)
            self._walk(target.slice, held)
            return
        self._walk(target, held)

    def _call_ref(self, call):
        """Resolvable reference for a call site, or None."""
        func = call.func
        if isinstance(func, ast.Name):
            return ("name", func.id)
        if not isinstance(func, ast.Attribute):
            return None
        text = _expr_text(func)
        if text is None:
            return None
        if text.startswith("self.") and text.count(".") == 1:
            return ("self", func.attr)
        base = text.split(".", 1)[0]
        if base in self.mod.imports or base in self.mod.classes:
            return ("dotted", text)
        return ("method", func.attr)

    # -- the walk ------------------------------------------------------------

    def scan(self, fn_node):
        args = fn_node.args
        names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
        if names and names[0] in ("self", "cls"):
            names = names[1:]
        self.fn._param_names = set(names)
        self.fn._getattr_locals = {
            t.id
            for node in ast.walk(fn_node)
            if isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Call)
            and _expr_text(node.value.func) == "getattr"
            for t in node.targets
            if isinstance(t, ast.Name)
        }
        self.fn._access_seen = set()
        for stmt in fn_node.body:
            self._walk(stmt, ())
        self.fn._param_names = self.fn._getattr_locals = None
        self.fn._access_seen = None

    def _walk(self, node, held):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # nested defs are summarized separately
        if isinstance(node, ast.Lambda):
            # Split semantics: field ACCESSES keep the current held set
            # (inline combinator lambdas — sorted key=, filter preds —
            # run where they stand, the shape that produced a false
            # race on _resume_step's sort key), while blocking/callback/
            # call EVENTS inside the body record an empty held set as
            # before (a deferred lambda — Thread target, timer callback
            # — runs later on another thread; stamping the registration
            # site's locks onto it would fabricate BLOCK-UNDER-LOCK
            # findings).  _handle_call consults _lambda_depth.
            self._lambda_depth += 1
            self._walk(node.body, held)
            self._lambda_depth -= 1
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = list(held)
            for item in node.items:
                ctx = item.context_expr
                self._walk(ctx, tuple(inner))
                expr = ctx.func if isinstance(ctx, ast.Call) else ctx
                text = _expr_text(expr)
                if text and self._is_lockish(text):
                    lock = self.lock_id(text)
                    self.fn.acquisitions.append({
                        "lock": lock, "line": node.lineno,
                        "col": node.col_offset, "held": list(inner),
                    })
                    if lock not in inner:
                        inner.append(lock)
            for stmt in node.body:
                self._walk(stmt, tuple(inner))
            return
        if isinstance(node, ast.Assign):
            for target in node.targets:
                self._record_target(target, held)
            self._walk(node.value, held)
            return
        if isinstance(node, ast.AugAssign):
            # x += 1 reads and writes the field
            attr = self._field_of(node.target) or (
                self._field_of(node.target.value)
                if isinstance(node.target, ast.Subscript)
                else None
            )
            if attr is not None:
                self._record_access(attr, "read", node.target, held)
            self._record_target(node.target, held)
            self._walk(node.value, held)
            return
        if isinstance(node, ast.AnnAssign):
            if node.value is not None:
                self._record_target(node.target, held)
                self._walk(node.value, held)
            return
        if isinstance(node, ast.Delete):
            for target in node.targets:
                self._record_target(target, held)
            return
        if isinstance(node, ast.Call):
            self._handle_call(node, held)
            for child in node.args:
                self._walk(child, held)
            for kw in node.keywords:
                self._walk(kw.value, held)
            func = node.func
            # plain Name/dotted-chain callees were fully consumed by
            # _handle_call; anything else (a chained receiver like
            # self._factory().dispatch() or self._map[k].append())
            # still carries calls/accesses in its subtree — walk it
            if not isinstance(func, ast.Name) and (
                not isinstance(func, ast.Attribute)
                or _expr_text(func) is None
            ):
                self._walk(func, held)
            return
        if isinstance(node, ast.Subscript):
            # self.x[i] in load position observes the field's interior
            attr = self._field_of(node.value)
            if attr is not None:
                self._record_access(attr, "read", node, held, deep=True)
            else:
                self._walk(node.value, held)
            self._walk(node.slice, held)
            return
        if isinstance(node, (ast.For, ast.AsyncFor)):
            # iterating a shared field observes (and walks) its interior
            attr = self._field_of(node.iter)
            if attr is not None:
                self._record_access(attr, "read", node.iter, held,
                                    deep=True)
            else:
                self._walk(node.iter, held)
            self._walk(node.target, held)
            for stmt in node.body + node.orelse:
                self._walk(stmt, held)
            return
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            for gen in node.generators:
                attr = self._field_of(gen.iter)
                if attr is not None:
                    self._record_access(attr, "read", gen.iter, held,
                                        deep=True)
                else:
                    self._walk(gen.iter, held)
                for cond in gen.ifs:
                    self._walk(cond, held)
            if isinstance(node, ast.DictComp):
                self._walk(node.key, held)
                self._walk(node.value, held)
            else:
                self._walk(node.elt, held)
            return
        if isinstance(node, ast.Attribute):
            # a bare self-rooted chain in load position: a GIL-atomic
            # reference load of its path (deep when it dereferences past
            # the recorded two-segment path)
            attr, nparts = self._field_path(node)
            if attr is not None:
                self._record_access(attr, "read", node, held,
                                    deep=nparts > 2)
                return
            for child in ast.iter_child_nodes(node):
                self._walk(child, held)
            return
        for child in ast.iter_child_nodes(node):
            self._walk(child, held)

    def _handle_call(self, call, held):
        text = _expr_text(call.func) or ""
        # events inside lambda bodies never inherit the enclosing held
        # set (see the Lambda branch in _walk); field accesses do
        event_held = [] if self._lambda_depth else list(held)
        site = {"line": call.lineno, "col": call.col_offset,
                "held": event_held}
        # a method call THROUGH a field dereferences the receiver: a
        # mutator (self._q.append) writes its interior, anything else is
        # a deep read of it.  self.method() (one segment) is a call
        # edge, not a data access.
        if text.startswith("self.") and text.count(".") >= 2:
            recv, _ = self._field_path(call.func.value)
            if recv is not None:
                kind = (
                    "write" if call.func.attr in _MUTATOR_METHODS
                    else "read"
                )
                self._record_access(recv, kind, call, held, deep=True)
        # callback registration points: the registered callable runs later,
        # on another thread or frame — a deferred edge with no held locks
        if text.endswith("Thread"):
            for kw in call.keywords:
                if kw.arg == "target":
                    ref = self._ref_for_value(kw.value)
                    if ref is not None:
                        self.fn.calls.append({
                            "ref": ref, "line": call.lineno,
                            "col": call.col_offset, "held": [],
                            "nargs": -1, "deferred": True,
                        })
            return
        # explicit lock-method acquisition outside a with-statement
        if (
            isinstance(call.func, ast.Attribute)
            and call.func.attr == "acquire"
        ):
            recv = _expr_text(call.func.value)
            if recv and self._is_lockish(recv):
                self.fn.acquisitions.append({
                    "lock": self.lock_id(recv), "line": call.lineno,
                    "col": call.col_offset, "held": event_held,
                })
                return
        blocking = self._classify_blocking(call, text)
        if blocking is not None:
            desc, kind, waits_on = blocking
            self.fn.blocking.append(dict(
                site, desc=desc, kind=kind, waits_on=waits_on,
            ))
            return
        callback = self._classify_callback(call, text)
        if callback is not None:
            self.fn.callbacks.append(dict(site, desc=callback))
            return
        ref = self._call_ref(call)
        if ref is not None:
            nargs = len(call.args) + len(call.keywords)
            self.fn.calls.append(dict(
                site, ref=ref, nargs=nargs, deferred=False,
            ))

    def _ref_for_value(self, value):
        text = _expr_text(value)
        if not text:
            return None
        if text.startswith("self.") and text.count(".") == 1:
            return ("self", text[len("self."):])
        if "." not in text:
            return ("name", text)
        return ("dotted", text)


class _ResourceScanner:
    """Walk one function body collecting resource-handle lifecycles.

    Complements :class:`_FunctionScanner` (which tracks the held-lock
    dimension) with the OWNERSHIP dimension: every acquisition site from
    the registered spec table (``resources.SPECS``) — plus every local
    bound from a resolvable call, a *candidate* whose resource-ness the
    program pass decides through the callee's summary — gets a handle
    record carrying its branch-arm context, the ops/arg-passes performed
    on the handle, and how (if at all) ownership escaped the function.
    Function-level facts (what the function returns freshly acquired,
    which parameters it takes ownership of, its explicit exits) feed the
    callee side of the interprocedural transfer resolution.

    Contexts are "nid:arm" tokens per enclosing if/try/loop arm — the
    branch-arm bookkeeping ``resources.py``'s path algebra consumes.
    """

    def __init__(self, modsum, fn_summary):
        self.mod = modsum
        self.fn = fn_summary
        self.records = []
        self.open = {}        # local name -> its current handle record
        self.params = {}      # param name -> ownership events
        self.exits = []
        self.ret_calls = []
        self.returns = None
        self._param_idx = {}
        self._raises_depth = 0  # inside `with pytest.raises(...)`

    def scan(self, fn_node):
        args = fn_node.args
        pos = args.posonlyargs + args.args
        names = [a.arg for a in pos]
        if names and names[0] in ("self", "cls"):
            names = names[1:]
        self._param_idx = {n: i for i, n in enumerate(names)}
        for stmt in fn_node.body:
            self._stmt(stmt, (), False, ())
        if self.returns is None:
            for rec in self.records:
                if rec["res"] and "returned" in rec["escapes"] and (
                    not rec["in_with"]
                ):
                    self.returns = rec["res"]
                    break
        for rec in self.records:
            # a returned wrapper-call binding chains the returns fact
            if rec["via"] and "returned" in rec["escapes"]:
                self.ret_calls.append(list(rec["via"]))
        self.fn.resources = self.records
        facts = {}
        if self.returns is not None:
            facts["returns"] = self.returns
        if self.ret_calls:
            facts["ret_calls"] = self.ret_calls
        if self.params:
            facts["params"] = self.params
        if self.exits:
            facts["exits"] = self.exits
        self.fn.res_facts = facts

    # -- plumbing ------------------------------------------------------------

    @staticmethod
    def _unwrap(value):
        while isinstance(value, ast.Await):
            value = value.value
        return value

    def _ref(self, call):
        """Resolvable [kind, value] reference for a call, or None
        (list-typed: these are serialized into the summary)."""
        func = call.func
        if isinstance(func, ast.Name):
            return ["name", func.id]
        if not isinstance(func, ast.Attribute):
            return None
        text = _expr_text(func)
        if text is None:
            return None
        if text.startswith("self.") and text.count(".") == 1:
            return ["self", func.attr]
        base = text.split(".", 1)[0]
        if base in self.mod.imports or base in self.mod.classes:
            return ["dotted", text]
        return ["method", func.attr]

    def _open_record(self, var, res, api, via, node, ctx, fin,
                     in_with=False, daemon=False):
        rec = {
            "res": res, "api": api, "via": via, "var": var,
            "line": node.lineno, "col": node.col_offset,
            "ctx": list(ctx), "fin": fin, "in_with": in_with,
            "daemon": daemon, "escapes": [], "ops": [], "passed": [],
        }
        self.records.append(rec)
        if var is not None:
            self._bind(var, rec)
        return rec

    def _bind(self, name, rec):
        """Bind *name* to *rec*.  A rebind in a conditional arm does NOT
        drop earlier records for the name — on the other arm the name
        still refers to the old handle, so later ops/escapes must apply
        to both (``fresh = alloc(); if ...: fresh = alloc(); return
        fresh`` returns either one)."""
        ctx = rec["ctx"]
        kept = [
            r for r in self.open.get(name, ())
            if not _res._unconditional_after(r["ctx"], ctx)
        ]
        kept.append(rec)
        self.open[name] = kept

    def _clear(self, name, ctx):
        """*name* rebound to a non-handle at *ctx*: drop only the
        records the rebind definitely shadows."""
        kept = [
            r for r in self.open.get(name, ())
            if not _res._unconditional_after(r["ctx"], ctx)
        ]
        if kept:
            self.open[name] = kept
        else:
            self.open.pop(name, None)

    def _param_entry(self, name):
        idx = self._param_idx.get(name)
        if idx is None:
            return None
        entry = self.params.get(name)
        if entry is None:
            entry = self.params[name] = {
                "idx": idx, "released": False, "stored": False,
                "passed": [],
            }
        return entry

    def _op(self, name, api, node, ctx, fin):
        for rec in self.open.get(name, ()):
            rec["ops"].append({
                "api": api, "line": node.lineno,
                "col": node.col_offset, "ctx": list(ctx), "fin": fin,
            })

    def _escape(self, value, how):
        """Every tracked/param name inside *value* escapes as *how*."""
        for sub in ast.walk(value):
            if not isinstance(sub, ast.Name):
                continue
            recs = self.open.get(sub.id)
            if recs:
                for rec in recs:
                    if how not in rec["escapes"]:
                        rec["escapes"].append(how)
                continue
            entry = self._param_entry(sub.id)
            if entry is not None and how == "stored":
                entry["stored"] = True

    @staticmethod
    def _daemon_kw(call):
        for kw in call.keywords:
            if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
                return bool(kw.value.value)
        return False

    @staticmethod
    def _none_guards(test, guards):
        """(then-arm, else-arm) guard sets for an if-test: the arm on
        which a named handle is known None/falsy (so an exit there never
        leaks it — the admission-backpressure idiom)."""
        then_g, else_g = list(guards), list(guards)
        if (
            isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.comparators[0], ast.Constant)
            and test.comparators[0].value is None
            and isinstance(test.left, ast.Name)
        ):
            if isinstance(test.ops[0], ast.Is):
                then_g.append(test.left.id)
            elif isinstance(test.ops[0], ast.IsNot):
                else_g.append(test.left.id)
        elif isinstance(test, ast.UnaryOp) and isinstance(
            test.op, ast.Not
        ) and isinstance(test.operand, ast.Name):
            then_g.append(test.operand.id)
        elif isinstance(test, ast.Name):
            else_g.append(test.id)
        return tuple(then_g), tuple(else_g)

    # -- statements ----------------------------------------------------------

    def _stmt(self, node, ctx, fin, guards):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # nested defs carry their own summaries
        if isinstance(node, ast.Assign):
            self._assign(node.targets, node.value, node, ctx, fin)
            return
        if isinstance(node, ast.AnnAssign):
            if node.value is not None:
                self._assign([node.target], node.value, node, ctx, fin)
            return
        if isinstance(node, ast.AugAssign):
            self._expr(node.value, ctx, fin)
            return
        if isinstance(node, ast.Expr):
            self._expr(node.value, ctx, fin, discard=True)
            return
        if isinstance(node, ast.Return):
            self._return(node, ctx, fin, guards)
            return
        if isinstance(node, ast.Raise):
            for child in ast.iter_child_nodes(node):
                self._escape(child, "raised")
                self._expr(child, ctx, fin)
            self.exits.append({
                "kind": "raise", "line": node.lineno,
                "ctx": list(ctx), "guards": list(guards),
            })
            return
        if isinstance(node, ast.If):
            self._expr(node.test, ctx, fin)
            nid = f"if{node.lineno}"
            then_g, else_g = self._none_guards(node.test, guards)
            for stmt in node.body:
                self._stmt(stmt, ctx + (f"{nid}:t",), fin, then_g)
            for stmt in node.orelse:
                self._stmt(stmt, ctx + (f"{nid}:e",), fin, else_g)
            return
        if isinstance(node, ast.While):
            self._expr(node.test, ctx, fin)
            tok = f"loop{node.lineno}:l"
            for stmt in node.body:
                self._stmt(stmt, ctx + (tok,), fin, guards)
            for stmt in node.orelse:
                self._stmt(stmt, ctx, fin, guards)
            return
        if isinstance(node, (ast.For, ast.AsyncFor)):
            if isinstance(node.iter, ast.Name):
                self._op(node.iter.id, "[iterated]", node.iter, ctx, fin)
            else:
                self._expr(node.iter, ctx, fin)
            tok = f"loop{node.lineno}:l"
            for stmt in node.body:
                self._stmt(stmt, ctx + (tok,), fin, guards)
            for stmt in node.orelse:
                self._stmt(stmt, ctx, fin, guards)
            return
        if isinstance(node, ast.Try):
            nid = f"try{node.lineno}"
            for stmt in node.body:
                self._stmt(stmt, ctx + (f"{nid}:b",), fin, guards)
            for i, handler in enumerate(node.handlers):
                for stmt in handler.body:
                    self._stmt(stmt, ctx + (f"{nid}:h{i}",), fin, guards)
            for stmt in node.orelse:
                self._stmt(stmt, ctx + (f"{nid}:o",), fin, guards)
            for stmt in node.finalbody:
                self._stmt(stmt, ctx + (f"{nid}:f",), True, guards)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            raisesctx = False
            for item in node.items:
                ce = self._unwrap(item.context_expr)
                acq = None
                if isinstance(ce, ast.Call):
                    ftext = _expr_text(ce.func) or ""
                    acq = _res.classify_acquire(ftext)
                    last = _last_segment(ftext)
                    if last == "raises" or last.startswith("assertRaises"):
                        raisesctx = True
                if acq is not None:
                    var = (
                        item.optional_vars.id
                        if isinstance(item.optional_vars, ast.Name)
                        else None
                    )
                    self._open_record(var, acq[0], acq[1], None, ce, ctx,
                                      fin, in_with=True)
                    for a in ce.args:
                        self._expr(a, ctx, fin)
                else:
                    self._expr(item.context_expr, ctx, fin)
            self._raises_depth += raisesctx
            for stmt in node.body:
                self._stmt(stmt, ctx, fin, guards)
            self._raises_depth -= raisesctx
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                self._stmt(child, ctx, fin, guards)
            elif isinstance(child, ast.expr):
                self._expr(child, ctx, fin)

    def _assign(self, targets, value_node, node, ctx, fin):
        value = self._unwrap(value_node)
        if len(targets) == 1 and isinstance(targets[0], ast.Name):
            name = targets[0].id
            if isinstance(value, ast.Call):
                acq = _res.classify_acquire(
                    _expr_text(value.func) or ""
                )
                if acq is not None:
                    kind, api = acq
                    daemon = (
                        kind == "thread" and self._daemon_kw(value)
                    )
                    for a in value.args:
                        self._expr(a, ctx, fin)
                    for kw in value.keywords:
                        self._expr(kw.value, ctx, fin)
                    self._open_record(name, kind, api, None, node, ctx,
                                      fin, daemon=daemon)
                    return
                callee = self._ref(value)
                self._call(value, ctx, fin)
                if callee is not None:
                    nargs = len(value.args) + len(value.keywords)
                    self._open_record(
                        name, None, _expr_text(value.func) or callee[1],
                        callee + [nargs], node, ctx, fin,
                    )
                else:
                    self._clear(name, ctx)
                return
            if isinstance(value, ast.Name):
                recs = self.open.get(value.id)
                if recs:
                    self.open[name] = list(recs)  # alias: same handles
                    return
            # a tracked handle folded into a composite value (tuple,
            # list concat, slice) now travels under another local our
            # per-name map cannot follow — benefit of the doubt, it
            # escaped (FN over FP)
            self._escape(value_node, "merged")
            self._expr(value_node, ctx, fin)
            self._clear(name, ctx)
            return
        for target in targets:
            if isinstance(target, (ast.Attribute, ast.Subscript,
                                   ast.Tuple, ast.List, ast.Starred)):
                self._escape(value_node, "stored")
                if (
                    isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.attr == "daemon"
                ):
                    for rec in self.open.get(target.value.id, ()):
                        rec["daemon"] = not (
                            isinstance(value, ast.Constant)
                            and not value.value
                        )
                self._expr(target, ctx, fin)
        self._expr(value_node, ctx, fin)

    def _return(self, node, ctx, fin, guards):
        value = node.value
        if value is not None:
            v = self._unwrap(value)
            if isinstance(v, ast.Call):
                acq = _res.classify_acquire(_expr_text(v.func) or "")
                if acq is not None:
                    if self.returns is None:
                        self.returns = acq[0]
                else:
                    callee = self._ref(v)
                    if callee is not None:
                        nargs = len(v.args) + len(v.keywords)
                        self.ret_calls.append(
                            [callee[0], callee[1], nargs]
                        )
            self._escape(value, "returned")
            self._expr(value, ctx, fin)
        self.exits.append({
            "kind": "return", "line": node.lineno,
            "ctx": list(ctx), "guards": list(guards),
        })

    # -- expressions ---------------------------------------------------------

    def _expr(self, node, ctx, fin, discard=False):
        if node is None or isinstance(node, ast.Lambda):
            return
        if isinstance(node, ast.Await):
            self._expr(node.value, ctx, fin, discard=discard)
            return
        if isinstance(node, (ast.Yield, ast.YieldFrom)):
            if node.value is not None:
                self._escape(node.value, "yielded")
                self._expr(node.value, ctx, fin)
            return
        if isinstance(node, ast.Call):
            self._call(node, ctx, fin, discard=discard)
            return
        if isinstance(node, ast.Subscript):
            if isinstance(node.value, ast.Name):
                self._op(node.value.id, "[subscript]", node, ctx, fin)
            else:
                self._expr(node.value, ctx, fin)
            self._expr(node.slice, ctx, fin)
            return
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name):
                self._op(node.value.id, f"[attr {node.attr}]", node,
                         ctx, fin)
            else:
                self._expr(node.value, ctx, fin)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._expr(child, ctx, fin)

    def _call(self, call, ctx, fin, discard=False):
        func = call.func
        text = _expr_text(func) or ""
        if discard:
            acq = _res.classify_acquire(text)
            if acq is not None and acq[1] == "retain":
                # a standalone retain() increments a reference whose
                # owner lives elsewhere (prefix-trie nodes, an adopting
                # lane): class-level inc/dec balance is the lexical
                # REFCOUNT-PAIR rule's beat, not a local lifecycle
                acq = None
            if acq is not None and self._raises_depth:
                # `with pytest.raises(...): pool.lease()` — the call is
                # asserted to raise, so nothing is ever acquired
                acq = None
            if acq is not None:
                kind, api = acq
                daemon = kind == "thread" and self._daemon_kw(call)
                self._open_record(None, kind, api, None, call, ctx,
                                  fin, daemon=daemon)
                for a in call.args:
                    self._expr(a, ctx, fin)
                for kw in call.keywords:
                    self._expr(kw.value, ctx, fin)
                return
        # the callee itself: a method ON a tracked handle / param
        if isinstance(func, ast.Attribute) and isinstance(
            func.value, ast.Name
        ):
            name = func.value.id
            recs = self.open.get(name)
            if recs:
                self._op(name, func.attr, call, ctx, fin)
                if func.attr == "setDaemon":
                    for rec in recs:
                        rec["daemon"] = True
            else:
                entry = self._param_entry(name)
                if entry is not None and _res.release_api_any(func.attr):
                    entry["released"] = True
        elif isinstance(func, ast.Name):
            if self.open.get(func.id):
                self._op(func.id, "[called]", call, ctx, fin)
        else:
            self._expr(func, ctx, fin)
        # top-level arguments: handles/params handed to the callee
        recv_last = ""
        meth = None
        if isinstance(func, ast.Attribute):
            meth = func.attr
            recv_text = _expr_text(func.value)
            if recv_text:
                recv_last = _last_segment(recv_text)
        elif isinstance(func, ast.Name):
            meth = func.id
        callee = self._ref(call)
        nargs = len(call.args) + len(call.keywords)
        for i, arg in enumerate(call.args):
            argpos = i
            if isinstance(arg, ast.Starred):
                arg = arg.value
                argpos = -1
            if isinstance(arg, ast.Name):
                self._passed(arg.id, callee, nargs, argpos, meth,
                             recv_last, arg, ctx, fin)
            else:
                self._expr(arg, ctx, fin)
        for kw in call.keywords:
            if isinstance(kw.value, ast.Name):
                self._passed(kw.value.id, callee, nargs, -1, meth,
                             recv_last, kw.value, ctx, fin)
            else:
                self._expr(kw.value, ctx, fin)

    def _passed(self, name, callee, nargs, argpos, meth, recv_last,
                node, ctx, fin):
        recs = self.open.get(name)
        if recs:
            for rec in recs:
                rec["passed"].append({
                    "ref": callee, "nargs": nargs, "argpos": argpos,
                    "meth": meth, "recv": recv_last,
                    "line": node.lineno, "col": node.col_offset,
                    "ctx": list(ctx), "fin": fin,
                })
            return
        entry = self._param_entry(name)
        if entry is None:
            return
        if meth and _res.release_by_arg_any(meth, recv_last):
            entry["released"] = True
        elif callee is not None:
            entry["passed"].append([callee[0], callee[1], nargs, argpos])
        else:
            # handed to an unresolvable callee: claim ownership so the
            # CALLER treats its hand-off as a transfer (FN over FP)
            entry["passed"].append(["?", "", -1, -1])


def summarize_module(tree, path):
    """Build the ModuleSummary for one parsed file."""
    mod = ModuleSummary(path, module_name_for(path))
    mod.imports = _collect_imports(tree, mod.module)
    mod.jit_names = sorted(_jit_bound_names(tree))

    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            kind = _ctor_kind(node.value)
            if kind and kind != "semaphore":
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        mod.module_locks[t.id] = kind

    # class inventory first: lock/sem/jit attrs inform the scanners
    def collect_class(cls):
        info = {"bases": [], "methods": [], "lock_attrs": {},
                "sem_attrs": [], "jit_attrs": [], "field_ctors": {}}
        for base in cls.bases:
            text = _expr_text(base)
            if text:
                info["bases"].append(text)
        for sub in ast.walk(cls):
            if isinstance(sub, ast.Assign) and isinstance(
                sub.value, ast.Call
            ):
                kind = _ctor_kind(sub.value)
                ttexts = [_expr_text(t) for t in sub.targets]
                for tt in ttexts:
                    if tt and tt.startswith("self."):
                        attr = tt[len("self."):]
                        if kind == "semaphore":
                            info["sem_attrs"].append(attr)
                        elif kind:
                            info["lock_attrs"][attr] = kind
                ftext = _expr_text(sub.value.func) or ""
                if ftext in _JIT_CTORS:
                    for tt in ttexts:
                        if tt and tt.startswith("self."):
                            info["jit_attrs"].append(tt[len("self."):])
                elif ftext and kind is None:
                    # which constructor each plain field came from — the
                    # lockset pass resolves these to spot fields holding
                    # instances of lock-owning (self-synchronized)
                    # classes
                    for tt in ttexts:
                        if tt and tt.startswith("self.") and (
                            "." not in tt[len("self."):]
                        ):
                            info["field_ctors"].setdefault(
                                tt[len("self."):], ftext
                            )
        for item in cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info["methods"].append(item.name)
        mod.classes[cls.name] = info

    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            collect_class(node)

    def summarize_function(fn_node, cls_name, prefix, is_method):
        qual = f"{prefix}{fn_node.name}"
        args = fn_node.args
        pos = args.posonlyargs + args.args
        names = [a.arg for a in pos]
        skip_self = (
            1 if (is_method and names and names[0] in ("self", "cls"))
            else 0
        )
        n_pos = len(pos) - skip_self
        n_defaults = len(args.defaults)
        params_min = max(n_pos - n_defaults, 0)
        params_max = None if (args.vararg or args.kwarg) else (
            n_pos + len(args.kwonlyargs)
        )
        summary = FunctionSummary(
            qual, fn_node.name, cls_name, fn_node.lineno,
            fn_node.name.endswith("_locked"), params_min, params_max,
        )
        local_locks = {}
        for sub in ast.walk(fn_node):
            if isinstance(sub, ast.Assign) and isinstance(
                sub.value, ast.Call
            ):
                kind = _ctor_kind(sub.value)
                if kind and kind != "semaphore":
                    for t in sub.targets:
                        if isinstance(t, ast.Name):
                            local_locks[t.id] = kind
        _FunctionScanner(mod, cls_name, summary, local_locks).scan(fn_node)
        _ResourceScanner(mod, summary).scan(fn_node)
        mod.functions[qual] = summary
        for child in _direct_nested(fn_node):
            # nested defs: own summary, class context inherited
            summarize_function(child, cls_name, f"{qual}.", False)

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            mod.toplevel.append(node.name)
            summarize_function(node, None, "", False)
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    summarize_function(
                        item, node.name, f"{node.name}.", True
                    )
    return mod


# -- program assembly --------------------------------------------------------


class Program:
    """Resolved whole-program view over a set of ModuleSummaries."""

    def __init__(self, modules):
        self.modules = list(modules)
        self.by_module = {m.module: m for m in self.modules}
        # (module, qualname) -> (ModuleSummary, FunctionSummary)
        self.functions = {}
        # method name -> [(ModuleSummary, FunctionSummary)]
        self.methods_by_name = {}
        for m in self.modules:
            for qual, fn in m.functions.items():
                self.functions[(m.module, qual)] = (m, fn)
                if fn.cls is not None:
                    self.methods_by_name.setdefault(fn.name, []).append(
                        (m, fn)
                    )
        self._resolve_cache = {}

    def iter_functions(self):
        for m in self.modules:
            for fn in m.functions.values():
                yield m, fn

    # -- call resolution -----------------------------------------------------

    def _lookup_method(self, modsum, cls_name, method, _depth=0):
        """Find *method* on a class or its resolvable bases."""
        if _depth > 8 or modsum is None:
            return None
        info = modsum.classes.get(cls_name)
        if info is None:
            return None
        if method in info["methods"]:
            return self.functions.get(
                (modsum.module, f"{cls_name}.{method}")
            )
        for base in info["bases"]:
            base_mod, base_cls = self._resolve_class(modsum, base)
            if base_cls is not None:
                hit = self._lookup_method(
                    base_mod, base_cls, method, _depth + 1
                )
                if hit is not None:
                    return hit
        return None

    def _resolve_class(self, modsum, name):
        """(ModuleSummary, class name) for a class reference, if local or
        imported from an analyzed module."""
        if name in modsum.classes:
            return modsum, name
        target = modsum.imports.get(name.split(".", 1)[0])
        if target is None:
            return None, None
        if ":" in target:
            tmod, attr = target.split(":", 1)
            other = self.by_module.get(tmod)
            if other is not None and attr in other.classes:
                return other, attr
        else:
            other = self.by_module.get(target)
            if other is not None and "." in name:
                cls = name.split(".", 1)[1]
                if cls in other.classes:
                    return other, cls
        return None, None

    def _arity_ok(self, fn, nargs):
        if nargs < 0:
            return True
        if nargs < fn.params_min:
            return False
        return fn.params_max is None or nargs <= fn.params_max

    def resolve(self, modsum, caller, ref, nargs=-1):
        """Resolve a call reference to (ModuleSummary, FunctionSummary) or
        (None, None)."""
        key = (modsum.module, caller.qualname if caller else "", ref, nargs)
        if key in self._resolve_cache:
            return self._resolve_cache[key]
        result = self._resolve_uncached(modsum, caller, ref, nargs)
        self._resolve_cache[key] = result
        return result

    def _resolve_uncached(self, modsum, caller, ref, nargs):
        kind, value = ref
        if kind == "self":
            cls = caller.cls if caller else None
            if cls:
                hit = self._lookup_method(modsum, cls, value)
                if hit is not None:
                    return hit
            return None, None
        if kind == "name":
            if value in modsum.toplevel:
                return self.functions.get(
                    (modsum.module, value), (None, None)
                )
            if value in modsum.classes:
                return self._ctor(modsum, value)
            target = modsum.imports.get(value)
            if target is not None:
                return self._resolve_import_target(target)
            return None, None
        if kind == "dotted":
            base, rest = value.split(".", 1)
            if base in modsum.classes:
                # ClassName.method(...) — an unbound-call idiom
                hit = self._lookup_method(modsum, base, rest)
                return hit if hit is not None else (None, None)
            target = modsum.imports.get(base)
            if target is None:
                return None, None
            if ":" in target:
                tmod, attr = target.split(":", 1)
                other = self.by_module.get(tmod)
                if other is None:
                    return None, None
                return self._attr_in_module(other, f"{attr}.{rest}")
            other = self.by_module.get(target)
            if other is None:
                return None, None
            return self._attr_in_module(other, rest)
        if kind == "method":
            candidates = self.methods_by_name.get(value, ())
            live = [
                (m, f) for m, f in candidates if self._arity_ok(f, nargs)
            ]
            if len(live) == 1:
                return live[0]
            return None, None
        return None, None

    def _ctor(self, modsum, cls_name):
        hit = self._lookup_method(modsum, cls_name, "__init__")
        return hit if hit is not None else (None, None)

    def _attr_in_module(self, modsum, attr):
        if "." in attr:
            cls, method = attr.split(".", 1)
            if cls in modsum.classes:
                hit = self._lookup_method(modsum, cls, method)
                return hit if hit is not None else (None, None)
            return None, None
        if attr in modsum.toplevel:
            return self.functions.get((modsum.module, attr), (None, None))
        if attr in modsum.classes:
            return self._ctor(modsum, attr)
        return None, None

    def _resolve_import_target(self, target):
        if ":" in target:
            tmod, attr = target.split(":", 1)
            other = self.by_module.get(tmod)
            if other is None:
                return None, None
            return self._attr_in_module(other, attr)
        return None, None

    # -- convenience ---------------------------------------------------------

    def pseudo_required_lock(self, fn):
        """The pseudo lock id modeling the *_locked caller-holds-the-lock
        convention (never fed into the lock-order graph)."""
        owner = fn.cls or "<module>"
        return f"<caller-held:{owner}>"


def build_program(summaries):
    return Program(summaries)
