"""tpu-lint rule catalog.

Every rule encodes an invariant this repo has actually shipped (or nearly
shipped) a bug against — the rationale strings name the incident.  All
rules are lexical/AST heuristics: they prefer missing an exotic variant
over drowning the gate in false positives, and every finding can be
waived in place with ``# tpulint: disable=RULE`` plus a rationale.

The catalogue is the reference analyser's (``client_tpu.analysis.rules``)
with its JAX keys kept and torch keys added beside them: a CUDA-graph
capture, an extension build or ``torch.compile``, and a host sync count
as device dispatch under a lock (LOCK-DISPATCH); names bound from
``torch.compile`` or ``torch.cuda.make_graphed_callables`` are compiled
callables (LOCK-DISPATCH, JIT-UNBOUNDED-SHAPE); torch tensor producers
taint truth positions (NPY-TRUTH: on CUDA a tensor's truth value syncs);
host syncs are blocking calls in ``async def`` bodies (ASYNC-BLOCK).
"""

import ast
import re

from client_tpu_torch.analysis.core import Rule, register

# receivers that look like a mutex/condvar (last dotted segment)
_LOCKISH_RE = re.compile(r"(?i)(lock|mutex|cv|cond)")
# receivers that look specifically like a condition variable
_CVLIKE_RE = re.compile(r"(?i)(^|_)(cv|cond|condition)s?$")
# numpy array-producing module functions (np./numpy. namespaces)
_NP_ARRAY_FNS = {
    "asarray", "array", "zeros", "ones", "empty", "full", "arange",
    "linspace", "concatenate", "stack", "frombuffer", "where", "reshape",
    "copy", "asanyarray", "atleast_1d", "squeeze",
}
# device-dispatch callees beyond jit-bound names (last dotted segment)
_DISPATCH_HINTS = {"prefill", "decode_step", "block_until_ready"}
_DISPATCH_FULL = {
    "jax.device_put", "jax.device_get", "jax.block_until_ready",
}
# constructors whose assignment targets become jit-compiled callables
# (torch.compile and make_graphed_callables also specialise per shape)
_JIT_CTORS = (
    "jax.jit", "jit", "jax.pmap", "pmap",
    "torch.compile", "torch.cuda.make_graphed_callables",
    "make_graphed_callables",
)
# torch tensor producers (torch. namespace): truthiness of a CUDA tensor
# copies it to the host and waits for the device
_TORCH_TENSOR_FNS = {
    "tensor", "zeros", "ones", "empty", "full", "arange", "where", "cat",
    "stack", "from_numpy", "as_tensor",
}
# torch work that holds its caller for milliseconds to minutes: a
# CUDA-graph capture (the capture runs every kernel once and may not
# overlap another), a compile or an extension build (nvcc), a host sync
# (waits for every queued kernel).  A CUDAGraph.replay() is asynchronous
# and is not among them.
_TORCH_CAPTURE_FULL = {
    "torch.cuda.graph", "torch.cuda.make_graphed_callables",
}
_TORCH_CAPTURE_ATTRS = {"capture_begin"}
_TORCH_BUILD_FULL = {
    "torch.compile",
    "torch.utils.cpp_extension.load", "torch.utils.cpp_extension.load_inline",
    "cpp_extension.load", "cpp_extension.load_inline",
    # the port's own extension builders (client_tpu_torch.ops._build,
    # utils/cuda_shared_memory/_build)
    "kernels", "_build.kernels", "_build.extension",
}
_TORCH_SYNC_FULL = {"torch.cuda.synchronize"}
_TORCH_SYNC_ATTRS = {"synchronize"}


def _torch_dispatch(call):
    """What a torch call that holds its caller does ("capture", "build",
    "sync") and its text, else None."""
    text = _expr_text(call.func)
    if text in _TORCH_CAPTURE_FULL:
        return "capture", text
    if text in _TORCH_BUILD_FULL:
        return "build", text
    if text in _TORCH_SYNC_FULL:
        return "sync", text
    if isinstance(call.func, ast.Attribute):
        shown = text or f"<expr>.{call.func.attr}"
        if call.func.attr in _TORCH_CAPTURE_ATTRS:
            return "capture", shown
        if call.func.attr in _TORCH_SYNC_ATTRS:
            return "sync", shown
    return None


def _jit_bound_names(tree):
    """Names (bare or ``self.x``) assigned from jax.jit/pmap anywhere in
    *tree*.  Shared by the lexical LOCK-DISPATCH rule and the callgraph
    summaries so both rule families agree on what a dispatch is."""
    bound = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            text = _expr_text(node.value.func) or ""
            if text in _JIT_CTORS:
                for t in node.targets:
                    tt = _expr_text(t)
                    if tt:
                        bound.add(tt)
    return bound


# blocking callees never allowed in an async def body
_ASYNC_BLOCKING_FULL = {
    "time.sleep",
    "subprocess.run", "subprocess.call", "subprocess.check_output",
    "subprocess.check_call",
    "socket.create_connection",
}
_ASYNC_BLOCKING_PREFIXES = ("requests.",)
# queue.Queue constructors whose get/put block without a timeout
_QUEUE_CTORS = {
    "queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
    "queue.PriorityQueue", "Queue", "SimpleQueue",
}
# names that hold a point-in-time budget (deadline semantics)
_DEADLINE_NAME_RE = re.compile(r"(?i)(deadline|expires?|expiry|_until$|^until$)")
# Prometheus label position: an f-string constant part ending with
# `label="` right before an interpolated value
_LABEL_OPEN_RE = re.compile(r'[A-Za-z_][A-Za-z0-9_]*="$')
# sanctioned escape helpers for label values (serve/metrics.escape_label)
_LABEL_ESCAPERS = {"escape_label", "_escape_label"}
# in-place collection mutators (list/dict/set/deque) that race readers just
# like an assignment does — the discovery-membership shape (SHARED-MUT).
# Deliberately excludes names that are atomic/thread-safe on their common
# receivers (queue put/get, Event set/clear) to keep the gate quiet.
_COLLECTION_MUTATORS = {
    "append", "appendleft", "extend", "extendleft", "insert", "remove",
    "clear", "discard", "popitem", "setdefault",
}


def _expr_text(node):
    """Dotted text for Name/Attribute chains ('self._cv'); None otherwise."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _expr_text(node.value)
        if base is None:
            return None
        return base + "." + node.attr
    return None


def _last_segment(text):
    return text.rsplit(".", 1)[-1] if text else ""


def _walk_no_functions(node):
    """Yield descendants without crossing into nested function bodies."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            continue
        yield child
        stack.extend(ast.iter_child_nodes(child))


def _functions(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _is_lockish_with(node):
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return False
    for item in node.items:
        ctx = item.context_expr
        if isinstance(ctx, ast.Call):
            ctx = ctx.func
        text = _expr_text(ctx)
        if text and _LOCKISH_RE.search(_last_segment(text)):
            return True
    return False


@register
class NpyTruthRule(Rule):
    """NPY-TRUTH — numpy values in truthiness / membership positions.

    ``bool(array)`` raises ("truth value of an array is ambiguous") and
    list membership / ``remove`` compare elementwise — the exact crash
    fixed in commit a2654c4 (``cancel()`` did ``handle in self._pending``
    over entries holding numpy prompts).  Tracks names assigned from
    np/jnp array producers in the same function, plus list/tuple literals
    containing them (containers compare elementwise too).  Torch tensor
    producers (``torch.tensor``, ``zeros``, ``ones``, ``empty``, ``full``,
    ``arange``, ``where``, ``cat``, ``stack``, ``from_numpy``,
    ``as_tensor``) taint the same way: past one element a tensor's truth
    value raises, and on CUDA every truth value syncs with the device.
    """

    id = "NPY-TRUTH"
    rationale = (
        "numpy truthiness raises and membership compares elementwise "
        "(the a2654c4 cancel() crash)"
    )

    def _is_torch_expr(self, node):
        if not isinstance(node, ast.Call):
            return False
        func = node.func
        if isinstance(func, ast.Attribute):
            base = func.value
            if isinstance(base, ast.Name) and base.id == "torch":
                return func.attr in _TORCH_TENSOR_FNS
            if isinstance(base, ast.Call) and self._is_torch_expr(base):
                return True
        return False

    def _is_numpy_expr(self, node):
        if not isinstance(node, ast.Call):
            return False
        func = node.func
        if isinstance(func, ast.Attribute):
            base = func.value
            if isinstance(base, ast.Name):
                if base.id == "jnp":
                    return True
                if base.id in ("np", "numpy"):
                    return func.attr in _NP_ARRAY_FNS
                if base.id == "torch":
                    return func.attr in _TORCH_TENSOR_FNS
            # method chain on a numpy expression: np.asarray(x).reshape(...)
            if isinstance(base, ast.Call) and self._is_numpy_expr(base):
                return True
        return False

    def _collect_taint(self, fn):
        # two passes: container taint depends on the full array-name set
        # (tree walk order is not statement order)
        assigns = [
            node
            for node in _walk_no_functions(fn)
            if isinstance(node, ast.Assign)
        ]
        arrays, containers = {}, set()  # arrays: name -> "numpy"/"torch"
        for node in assigns:
            targets = [
                t.id for t in node.targets if isinstance(t, ast.Name)
            ]
            if targets and self._is_numpy_expr(node.value):
                kind = "torch" if self._is_torch_expr(node.value) else (
                    "numpy")
                arrays.update(dict.fromkeys(targets, kind))
        for node in assigns:
            targets = [
                t.id for t in node.targets if isinstance(t, ast.Name)
            ]
            if (
                targets
                and isinstance(node.value, (ast.List, ast.Tuple))
                and any(
                    isinstance(el, ast.Name) and el.id in arrays
                    for el in node.value.elts
                )
            ):
                containers.update(targets)
        return arrays, containers

    def _tainted(self, node, arrays, containers):
        if isinstance(node, ast.Name):
            return node.id in arrays or node.id in containers
        return self._is_numpy_expr(node)

    def _array_tainted(self, node, arrays):
        if isinstance(node, ast.Name):
            return node.id in arrays
        return self._is_numpy_expr(node)

    def _is_torch_value(self, node, arrays):
        if isinstance(node, ast.Name):
            return arrays.get(node.id) == "torch"
        return self._is_torch_expr(node)

    def check(self, tree, lines, path):
        findings = []
        for fn in list(_functions(tree)) + [tree]:
            arrays, containers = self._collect_taint(fn)
            if not arrays and not containers:
                continue
            for node in _walk_no_functions(fn):
                findings.extend(
                    self._check_node(node, arrays, containers, path, lines)
                )
        for cls in ast.walk(tree):
            if isinstance(cls, ast.ClassDef):
                findings.extend(self._check_class_attrs(cls, lines, path))
        return findings

    def _check_class_attrs(self, cls, lines, path):
        """Cross-method taint: a self-attribute collection that any method
        appends numpy-bearing entries into makes EVERY membership/remove
        over it elementwise — the exact a2654c4 cancel() crash, where the
        numpy-bearing handle arrived as a parameter and only submit()
        showed the taint."""
        methods = [
            n for n in ast.walk(cls)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        npy_attrs = set()
        for fn in methods:
            arrays, containers = self._collect_taint(fn)
            if not arrays and not containers:
                continue
            for node in _walk_no_functions(fn):
                if not (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("append", "insert", "add")
                ):
                    continue
                recv = _expr_text(node.func.value)
                if (
                    recv
                    and recv.startswith("self.")
                    and any(
                        isinstance(a, ast.Name)
                        and (a.id in arrays or a.id in containers)
                        for a in node.args
                    )
                ):
                    npy_attrs.add(recv)
        if not npy_attrs:
            return []
        out = []
        for fn in methods:
            for node in _walk_no_functions(fn):
                if isinstance(node, ast.Compare) and any(
                    isinstance(op, (ast.In, ast.NotIn)) for op in node.ops
                ):
                    sides = [node.left] + list(node.comparators)
                    hit = next(
                        (
                            _expr_text(s)
                            for s in sides
                            if _expr_text(s) in npy_attrs
                        ),
                        None,
                    )
                    if hit:
                        out.append(self.finding(
                            path, lines, node,
                            f"membership over {hit}, which holds "
                            "numpy-bearing entries: compares elementwise "
                            "and raises (scan by identity instead)",
                        ))
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("remove", "index", "count")
                    and _expr_text(node.func.value) in npy_attrs
                ):
                    out.append(self.finding(
                        path, lines, node,
                        f".{node.func.attr}() on "
                        f"{_expr_text(node.func.value)}, which holds "
                        "numpy-bearing entries: compares elementwise and "
                        "raises (scan by identity instead)",
                    ))
        return out

    def _check_node(self, node, arrays, containers, path, lines):
        out = []
        # truthiness: if/while/ternary/assert/not/and/or over a raw array
        tests = []
        if isinstance(node, (ast.If, ast.While, ast.IfExp)):
            tests.append(node.test)
        elif isinstance(node, ast.Assert):
            tests.append(node.test)
        for test in tests:
            operands = (
                test.values if isinstance(test, ast.BoolOp) else [test]
            )
            for op in operands:
                if isinstance(op, ast.UnaryOp) and isinstance(
                    op.op, ast.Not
                ):
                    op = op.operand
                if self._is_torch_value(op, arrays):
                    out.append(self.finding(
                        path, lines, node,
                        "torch tensor used for truthiness (raises past "
                        "one element; on CUDA it waits for the device)",
                    ))
                elif self._array_tainted(op, arrays):
                    out.append(self.finding(
                        path, lines, node,
                        "numpy value used for truthiness (ambiguous "
                        "bool raises at runtime)",
                    ))
        if isinstance(node, ast.Call):
            func = node.func
            # bool(arr)
            if (
                isinstance(func, ast.Name) and func.id == "bool"
                and node.args
                and self._array_tainted(node.args[0], arrays)
            ):
                out.append(self.finding(
                    path, lines, node,
                    "bool() over a torch tensor raises past one element "
                    "and waits for the device on CUDA"
                    if self._is_torch_value(node.args[0], arrays) else
                    "bool() over a numpy value raises (ambiguous truth)",
                ))
            # pending.remove(arr) / .index / .count compare elementwise
            if (
                isinstance(func, ast.Attribute)
                and func.attr in ("remove", "index", "count")
                and node.args
                and self._tainted(node.args[0], arrays, containers)
            ):
                out.append(self.finding(
                    path, lines, node,
                    f".{func.attr}() with a numpy-bearing argument "
                    "compares elementwise and raises on match ambiguity",
                ))
        if isinstance(node, ast.Compare) and any(
            isinstance(op, (ast.In, ast.NotIn)) for op in node.ops
        ):
            sides = [node.left] + list(node.comparators)
            if any(self._tainted(s, arrays, containers) for s in sides):
                out.append(self.finding(
                    path, lines, node,
                    "membership test over numpy-bearing values compares "
                    "elementwise (scan by identity instead)",
                ))
        return out


@register
class AsyncBlockRule(Rule):
    """ASYNC-BLOCK — blocking calls inside ``async def`` bodies.

    One blocking call inside the aio clients or the serving event loop
    stalls every coroutine sharing that loop.  Flags time.sleep /
    requests.* / subprocess.* and timeout-less queue.Queue get/put on
    queues constructed in the same function or bound to ``self`` in the
    same class, and the torch host syncs (``torch.cuda.synchronize``,
    ``.synchronize()`` on an event or a stream), which wait for every
    queued kernel.
    """

    id = "ASYNC-BLOCK"
    rationale = (
        "a blocking call in an async body stalls the whole event loop "
        "(aio clients, serve/)"
    )

    @staticmethod
    def _queue_call_blocks(call, bounded):
        """True when a queue .get/.put call can block indefinitely.

        Signatures: ``get(block=True, timeout=None)`` and
        ``put(item, block=True, timeout=None)`` — the positional slots
        differ by one, ``block=False`` never blocks, and ``put`` on an
        unbounded queue (no maxsize at construction) never blocks.
        """
        if call.func.attr == "put" and not bounded:
            return False
        kwargs = {kw.arg: kw.value for kw in call.keywords}
        first = 0 if call.func.attr == "get" else 1  # skip put's item
        positional = call.args[first:]
        block = kwargs.get("block", positional[0] if positional else None)
        if isinstance(block, ast.Constant) and block.value is False:
            return False  # non-blocking variant
        has_timeout = "timeout" in kwargs or len(positional) >= 2
        return not has_timeout

    @staticmethod
    def _ctor_is_bounded(ctor):
        """queue.Queue(maxsize>0) blocks on put; bare/0 never does."""
        sized = list(ctor.args) + [
            kw.value for kw in ctor.keywords if kw.arg == "maxsize"
        ]
        if not sized:
            return False
        arg = sized[0]
        return not (isinstance(arg, ast.Constant) and arg.value == 0)

    def _queue_attrs(self, cls):
        attrs = {}
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                if _expr_text(node.value.func) in _QUEUE_CTORS:
                    for t in node.targets:
                        text = _expr_text(t)
                        if text and text.startswith("self."):
                            attrs[text] = self._ctor_is_bounded(node.value)
        return attrs

    def check(self, tree, lines, path):
        findings = []
        class_queue_attrs = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                qattrs = self._queue_attrs(node)
                for sub in ast.walk(node):
                    if isinstance(sub, ast.AsyncFunctionDef):
                        class_queue_attrs[id(sub)] = qattrs
        for fn in _functions(tree):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            qnames = {
                t.id: self._ctor_is_bounded(node.value)
                for node in _walk_no_functions(fn)
                if isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)
                and _expr_text(node.value.func) in _QUEUE_CTORS
                for t in node.targets
                if isinstance(t, ast.Name)
            }
            qattrs = class_queue_attrs.get(id(fn), {})
            for node in _walk_no_functions(fn):
                if not isinstance(node, ast.Call):
                    continue
                text = _expr_text(node.func) or ""
                hit = _torch_dispatch(node)
                if hit is not None and hit[0] == "sync":
                    findings.append(self.finding(
                        path, lines, node,
                        f"host sync {hit[1]}() inside async def "
                        f"{fn.name} stalls the event loop until the "
                        "device drains",
                    ))
                    continue
                if text in _ASYNC_BLOCKING_FULL or text.startswith(
                    _ASYNC_BLOCKING_PREFIXES
                ):
                    findings.append(self.finding(
                        path, lines, node,
                        f"blocking call {text}() inside async def "
                        f"{fn.name} stalls the event loop",
                    ))
                    continue
                if isinstance(node.func, ast.Attribute) and node.func.attr in (
                    "get", "put"
                ):
                    recv = _expr_text(node.func.value)
                    is_queue = recv in qnames or recv in qattrs
                    bounded = qnames.get(recv, qattrs.get(recv, False))
                    if is_queue and self._queue_call_blocks(node, bounded):
                        findings.append(self.finding(
                            path, lines, node,
                            f"sync {recv}.{node.func.attr}() without "
                            f"timeout inside async def {fn.name} blocks "
                            "the event loop",
                        ))
        return findings


@register
class LockDispatchRule(Rule):
    """LOCK-DISPATCH — device dispatch while holding a scheduler lock.

    jax.jit compiles per novel input signature; a dispatch under
    ``with self._cv:`` holds the lock for a full XLA compile (seconds)
    and head-of-line-blocks every other thread (the pre-fix
    ``_admit_locked`` prefill in serve/models/continuous.py).  Lock-held
    regions are lexical ``with *lock/cv/cond:`` bodies plus whole methods
    named ``*_locked`` (this codebase's caller-holds-the-lock
    convention).  Dispatch callees are names bound from ``jax.jit(...)``
    (or ``torch.compile`` / ``make_graphed_callables``) anywhere in the
    module, jax.device_put/get/block_until_ready, and the
    prefill/decode_step hint names.  Torch keys: a CUDA-graph capture
    (``torch.cuda.graph``, ``capture_begin``, ``make_graphed_callables``),
    a compile or an extension build (``torch.compile``,
    ``cpp_extension.load``/``load_inline``, the port's
    ``_build.kernels()``) and a host sync (``torch.cuda.synchronize``,
    ``Event``/``Stream.synchronize``) hold the lock just as long: the
    engine's first submit once built and captured under ``_cv``.
    """

    id = "LOCK-DISPATCH"
    rationale = (
        "device dispatch under a lock head-of-line-blocks every waiter "
        "for a full XLA compile (continuous.py _admit_locked)"
    )

    def _is_dispatch(self, call, jit_bound):
        text = _expr_text(call.func)
        if not text:
            return None
        if text in jit_bound:
            return f"jit-compiled callable {text}()"
        if text in _DISPATCH_FULL:
            return f"{text}()"
        if _last_segment(text) in _DISPATCH_HINTS:
            return f"device-dispatch {text}()"
        return None

    @staticmethod
    def _torch_message(call, where):
        hit = _torch_dispatch(call)
        if hit is None:
            return None
        kind, text = hit
        if kind == "capture":
            return (f"CUDA-graph capture {text}() inside {where}: holds "
                    "the lock across the whole capture — capture before "
                    "taking the lock")
        if kind == "build":
            return (f"compile/build {text}() inside {where}: holds the "
                    "lock across a compile or an nvcc build — build "
                    "before taking the lock")
        return (f"host sync {text}() inside {where}: holds the lock until "
                "the device drains — sync outside the critical section")

    def check(self, tree, lines, path):
        jit_bound = _jit_bound_names(tree)
        findings = []
        regions = []
        for node in ast.walk(tree):
            if _is_lockish_with(node):
                regions.append((node, "with-lock block"))
            elif isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ) and node.name.endswith("_locked"):
                regions.append((node, f"lock-held method {node.name}"))
        seen = set()
        for region, where in regions:
            for node in ast.walk(region):
                if not isinstance(node, ast.Call) or id(node) in seen:
                    continue
                what = self._is_dispatch(node, jit_bound)
                if what:
                    seen.add(id(node))
                    findings.append(self.finding(
                        path, lines, node,
                        f"{what} dispatched inside {where}: holds the "
                        "lock across a potential XLA compile — move the "
                        "dispatch outside the critical section",
                    ))
                    continue
                message = self._torch_message(node, where)
                if message:
                    seen.add(id(node))
                    findings.append(self.finding(path, lines, node, message))
        return findings


@register
class QueueSentinelRule(Rule):
    """QUEUE-SENTINEL — deactivating a streaming slot without closing
    its queue.

    A per-request token queue's reader blocks on ``get()`` until the
    close sentinel arrives; any path that flips ``<slot>.active = False``
    without a ``<slot>.queue.put(...)`` in the same branch strands that
    reader forever (the pre-fix active-slot branch of ``cancel()`` in
    serve/models/continuous.py).  Applies to receivers that have a
    ``.queue`` attribute somewhere in the same module.
    """

    id = "QUEUE-SENTINEL"
    rationale = (
        "slot deactivated without enqueueing the close sentinel strands "
        "the stream reader (continuous.py cancel() on an active slot)"
    )

    def check(self, tree, lines, path):
        queue_receivers = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and node.attr == "queue":
                text = _expr_text(node.value)
                if text:
                    queue_receivers.add(text)
        if not queue_receivers:
            return []

        # constructor bodies initialize .active = False; that is not a
        # deactivation and has no reader to strand yet
        in_init = set()
        for node in ast.walk(tree):
            if (
                isinstance(node, ast.FunctionDef)
                and node.name == "__init__"
            ):
                for sub in ast.walk(node):
                    in_init.add(id(sub))

        # map each statement to its containing body list (its branch)
        blocks = {}
        for node in ast.walk(tree):
            for field in ("body", "orelse", "finalbody"):
                body = getattr(node, field, None)
                if isinstance(body, list):
                    for stmt in body:
                        blocks[id(stmt)] = body

        def block_has_close(body, recv):
            put_text = recv + ".queue.put"
            for stmt in body:
                for sub in ast.walk(stmt):
                    if (
                        isinstance(sub, ast.Call)
                        and _expr_text(sub.func) == put_text
                    ):
                        return True
            return False

        findings = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Assign) or id(node) in in_init:
                continue
            for target in node.targets:
                if not (
                    isinstance(target, ast.Attribute)
                    and target.attr == "active"
                ):
                    continue
                if not (
                    isinstance(node.value, ast.Constant)
                    and node.value.value is False
                ):
                    continue
                recv = _expr_text(target.value)
                if recv not in queue_receivers:
                    continue
                body = blocks.get(id(node))
                if body is not None and not block_has_close(body, recv):
                    findings.append(self.finding(
                        path, lines, node,
                        f"{recv}.active = False without "
                        f"{recv}.queue.put(<close sentinel>) in the same "
                        "branch: a queue reader will hang on get()",
                    ))
        return findings


@register
class CvWaitLoopRule(Rule):
    """CV-WAIT-LOOP — ``Condition.wait()`` outside a predicate loop.

    Condition variables wake spuriously and predicates can be consumed
    by other waiters: every cv-like ``.wait()`` must sit inside a loop
    that re-checks its predicate (or use ``wait_for``).  Receivers are
    matched by name (``*_cv``, ``*_cond``, ``condition``).
    """

    id = "CV-WAIT-LOOP"
    rationale = (
        "cv.wait() without an enclosing predicate loop misses wakeups "
        "and acts on stale state"
    )

    def check(self, tree, lines, path):
        findings = []
        for fn in list(_functions(tree)) + [tree]:
            loops = set()
            for node in _walk_no_functions(fn):
                if isinstance(node, (ast.While, ast.For)):
                    loops.add(id(node))
                    for sub in ast.walk(node):
                        loops.add(id(sub))
            for node in _walk_no_functions(fn):
                if not (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "wait"
                ):
                    continue
                recv = _expr_text(node.func.value)
                if not recv or not _CVLIKE_RE.search(_last_segment(recv)):
                    continue
                if id(node) not in loops:
                    findings.append(self.finding(
                        path, lines, node,
                        f"{recv}.wait() outside a predicate re-check "
                        "loop: wrap in `while <predicate>:` or use "
                        "wait_for()",
                    ))
        return findings


@register
class TimeWallRule(Rule):
    """TIME-WALL — deadlines computed from the wall clock.

    ``time.time()`` jumps under NTP slew/step and DST-adjacent clock
    management; a deadline derived from it can expire instantly (every
    in-flight wait aborts) or never (a drain that hangs).  Every
    point-in-time budget must come from ``time.monotonic()`` — the
    invariant the resilience layer's Deadline/backoff code is built on.
    Flags (a) assignments of ``time.time()``-derived values to
    deadline-named targets and (b) comparisons between ``time.time()``
    and a deadline-named value.  Wall-clock *timestamps* (metrics, log
    fields) are untouched: the rule keys on deadline naming.
    """

    id = "TIME-WALL"
    rationale = (
        "a wall-clock deadline jumps with NTP adjustment: expires "
        "instantly or never (use time.monotonic())"
    )

    @staticmethod
    def _has_wall_clock_call(node):
        for sub in ast.walk(node):
            if (
                isinstance(sub, ast.Call)
                and _expr_text(sub.func) == "time.time"
            ):
                return True
        return False

    @staticmethod
    def _is_deadline_name(node):
        text = _expr_text(node)
        return bool(text and _DEADLINE_NAME_RE.search(_last_segment(text)))

    def check(self, tree, lines, path):
        findings = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                if node.value is None:  # bare annotation: no computation
                    continue
                targets = (
                    node.targets
                    if isinstance(node, ast.Assign)
                    else [node.target]
                )
                if any(self._is_deadline_name(t) for t in targets) and (
                    self._has_wall_clock_call(node.value)
                ):
                    findings.append(self.finding(
                        path, lines, node,
                        "deadline computed from time.time(): wall-clock "
                        "jumps (NTP) break the budget — use "
                        "time.monotonic()",
                    ))
            elif isinstance(node, ast.Compare):
                sides = [node.left] + list(node.comparators)
                has_wall = any(self._has_wall_clock_call(s) for s in sides)
                has_deadline = any(self._is_deadline_name(s) for s in sides)
                if has_wall and has_deadline:
                    findings.append(self.finding(
                        path, lines, node,
                        "deadline compared against time.time(): wall-clock "
                        "jumps (NTP) break the budget — use "
                        "time.monotonic()",
                    ))
        return findings


@register
class MetricLabelRule(Rule):
    """METRIC-LABEL — unescaped interpolation into Prometheus label values.

    The text exposition format reserves ``\\``, ``"`` and newline inside
    quoted label values; an f-string that drops a model/version name into
    ``{model="..."}`` unescaped lets one hostile (or merely creative) model
    name corrupt the whole /metrics payload — the serve/metrics.py bug this
    PR fixed.  Flags any f-string FormattedValue whose preceding constant
    part ends in ``label="`` unless the value is wrapped in the sanctioned
    escape helper (``escape_label``).
    """

    id = "METRIC-LABEL"
    rationale = (
        "a quote/backslash/newline interpolated into a Prometheus label "
        "corrupts the exposition format (wrap the value in escape_label())"
    )

    def check(self, tree, lines, path):
        findings = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.JoinedStr):
                continue
            prev_const = ""
            for part in node.values:
                if isinstance(part, ast.Constant) and isinstance(
                    part.value, str
                ):
                    prev_const = part.value
                    continue
                if isinstance(part, ast.FormattedValue):
                    if _LABEL_OPEN_RE.search(prev_const):
                        escaper = ""
                        if isinstance(part.value, ast.Call):
                            escaper = _last_segment(
                                _expr_text(part.value.func) or ""
                            )
                        if escaper not in _LABEL_ESCAPERS:
                            label = _LABEL_OPEN_RE.search(prev_const).group()
                            what = _expr_text(part.value) or "<expression>"
                            findings.append(self.finding(
                                path, lines, part,
                                f"f-string interpolates {what} into the "
                                f"Prometheus label position {label}...\" "
                                "without escape_label(): a quote/backslash/"
                                "newline in the value corrupts the "
                                "exposition format",
                            ))
                    prev_const = ""
        return findings


@register
class RespParamOverwriteRule(Rule):
    """RESP-PARAM-OVERWRITE — dict-literal assignment stamps a marker over
    shared response parameters.

    ``response["parameters"] = {"some_flag": True}`` REPLACES whatever
    response-level parameters the model or an earlier render step set —
    the silent-vanish bug the decoupled stream's ``triton_final_response``
    stamp shipped (ADVICE round 5: model-set params disappeared once
    grpc_server started forwarding response parameters).  The sanctioned
    shape merges instead::

        response.setdefault("parameters", {})["some_flag"] = True

    Heuristic: flags assignments of a dict LITERAL carrying at least one
    boolean-constant value (the marker-stamp shape) to a ``["parameters"]``
    subscript, unless the subscripted object is a dict literal freshly
    built in the same function (constructing a new response is not an
    overwrite — there is nothing to lose yet).
    """

    id = "RESP-PARAM-OVERWRITE"
    rationale = (
        "assigning a marker dict to [\"parameters\"] replaces model-set "
        "response parameters (merge via setdefault instead)"
    )

    @staticmethod
    def _fresh_dict_names(fn):
        """Local names assigned a dict/list literal in this function —
        responses under construction, not shared responses."""
        fresh = set()
        for node in _walk_no_functions(fn):
            if isinstance(node, ast.Assign) and isinstance(
                node.value, (ast.Dict, ast.List, ast.DictComp)
            ):
                fresh.update(
                    t.id for t in node.targets if isinstance(t, ast.Name)
                )
        return fresh

    @staticmethod
    def _base_name(node):
        """Innermost Name a subscript chain hangs off (rendered[0] ->
        'rendered'); None for call results etc."""
        while isinstance(node, ast.Subscript):
            node = node.value
        return node.id if isinstance(node, ast.Name) else None

    def check(self, tree, lines, path):
        findings = []
        for fn in list(_functions(tree)) + [tree]:
            fresh = self._fresh_dict_names(fn)
            for node in _walk_no_functions(fn):
                if not isinstance(node, ast.Assign):
                    continue
                for target in node.targets:
                    if not (
                        isinstance(target, ast.Subscript)
                        and isinstance(target.slice, ast.Constant)
                        and target.slice.value == "parameters"
                    ):
                        continue
                    if not (
                        isinstance(node.value, ast.Dict)
                        and any(
                            isinstance(v, ast.Constant)
                            and isinstance(v.value, bool)
                            for v in node.value.values
                        )
                    ):
                        continue  # not the marker-stamp shape
                    base = self._base_name(target.value)
                    if base is not None and base in fresh:
                        continue  # freshly built response: nothing to lose
                    findings.append(self.finding(
                        path, lines, node,
                        'marker dict assigned to ["parameters"] replaces '
                        "any response parameters the model set — merge "
                        'with .setdefault("parameters", {})[key] = value',
                    ))
        return findings


@register
class SharedMutRule(Rule):
    """SHARED-MUT — unlocked mutation of state shared with a spawned
    thread.

    For every class that spawns ``threading.Thread(target=self.<m>)``,
    the attributes that thread closure touches are shared state: any
    assignment to them — or in-place collection mutation
    (``self._endpoints.append(...)``, the live-discovery membership
    shape) — from OTHER methods must happen under a lock (lexically
    inside ``with *lock/cv/cond:`` or in a ``*_locked`` method, this
    repo's caller-holds-the-lock convention), or in ``__init__`` before
    the thread can exist.
    """

    id = "SHARED-MUT"
    rationale = (
        "writes racing a scheduler/worker thread corrupt state "
        "invisibly; every cross-thread write needs the lock"
    )

    def _thread_targets(self, cls):
        targets = set()
        for node in ast.walk(cls):
            if not isinstance(node, ast.Call):
                continue
            func_text = _expr_text(node.func) or ""
            if not func_text.endswith("Thread"):
                continue
            for kw in node.keywords:
                if kw.arg == "target":
                    text = _expr_text(kw.value) or ""
                    if text.startswith("self."):
                        targets.add(text[len("self."):])
        return targets

    def check(self, tree, lines, path):
        findings = []
        for cls in ast.walk(tree):
            if isinstance(cls, ast.ClassDef):
                findings.extend(self._check_class(cls, lines, path))
        return findings

    def _check_class(self, cls, lines, path):
        methods = {
            node.name: node
            for node in cls.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        closure = set()
        frontier = [m for m in self._thread_targets(cls) if m in methods]
        if not frontier:
            return []
        while frontier:
            name = frontier.pop()
            if name in closure:
                continue
            closure.add(name)
            for node in ast.walk(methods[name]):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "self"
                    and node.func.attr in methods
                ):
                    frontier.append(node.func.attr)

        shared = set()
        for name in closure:
            for node in ast.walk(methods[name]):
                if (
                    isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self"
                    and node.attr not in methods
                ):
                    shared.add(node.attr)
        if not shared:
            return []

        findings = []
        for name, fn in methods.items():
            if name in closure or name == "__init__":
                continue
            if name.endswith("_locked"):
                continue  # caller holds the lock by convention
            locked_nodes = set()
            for node in ast.walk(fn):
                if _is_lockish_with(node):
                    for sub in ast.walk(node):
                        locked_nodes.add(id(sub))
            for node in ast.walk(fn):
                if id(node) in locked_nodes:
                    continue
                if isinstance(node, (ast.Assign, ast.AugAssign)):
                    targets = (
                        node.targets
                        if isinstance(node, ast.Assign)
                        else [node.target]
                    )
                    flat = []
                    for t in targets:
                        flat.extend(
                            t.elts if isinstance(t, (ast.Tuple, ast.List))
                            else [t]
                        )
                    for t in flat:
                        if self._is_shared_attr(t, shared):
                            findings.append(self.finding(
                                path, lines, node,
                                f"self.{t.attr} is touched by the "
                                f"{'/'.join(sorted(closure))} thread "
                                f"closure but written here ({name}) "
                                "without the lock",
                            ))
                elif (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _COLLECTION_MUTATORS
                    and self._is_shared_attr(node.func.value, shared)
                ):
                    # in-place mutation races the reader exactly like an
                    # assignment: a prober iterating self._endpoints while
                    # update_endpoints appends/removes sees a torn list
                    findings.append(self.finding(
                        path, lines, node,
                        f"self.{node.func.value.attr}."
                        f"{node.func.attr}() mutates state the "
                        f"{'/'.join(sorted(closure))} thread closure "
                        f"reads, here ({name}) without the lock",
                    ))
        return findings

    @staticmethod
    def _is_shared_attr(node, shared):
        """Whether *node* is ``self.<attr>`` for a thread-shared attr."""
        return (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and node.attr in shared
        )


# callees that fix an array's dispatch shape (bucketing/padding helpers)
_SHAPE_SANITIZER_RE = re.compile(r"(?i)(pad|bucket|chunk)")


@register
class JitUnboundedShapeRule(Rule):
    """JIT-UNBOUNDED-SHAPE — jitted callable invoked with a
    request-shaped array and no bucketing/padding on the path.

    ``jax.jit`` keys executables on input SHAPE: a jitted prefill fed
    ``np.asarray(prompt_tokens).reshape(1, -1)`` compiles a fresh XLA
    program for EVERY distinct prompt length (seconds each on a real
    chip), unbounded by anything but client behavior — the serving-path
    recompile storm serve/lm's geometric bucket set exists to fix (the
    pre-fix ``_admit`` prefill in serve/models/continuous.py).  Within a
    function, a local whose value came through a ragged ``reshape``
    (any ``-1`` dimension — the shape is data-dependent) must pass
    through a shape sanitizer (a ``pad*``/``bucket*``/``chunk*`` call)
    before reaching a jit-bound callable's argument list.  Torch key:
    names bound from ``torch.compile(...)`` or
    ``torch.cuda.make_graphed_callables(...)`` are jit-bound too (each
    specialises per input shape: a recompile, or a graph that does not
    fit).
    """

    id = "JIT-UNBOUNDED-SHAPE"
    rationale = (
        "a jitted callable fed a request-shaped array compiles one "
        "executable per distinct length — bucket/pad the shape first "
        "(continuous.py per-prompt-length prefill recompiles)"
    )

    @staticmethod
    def _is_ragged_reshape(node):
        """A ``<expr>.reshape(...)`` call with a -1 dimension (including
        ``reshape((-1,))`` tuple forms): the result's shape follows the
        DATA, not the code."""
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "reshape"):
            return False
        args = []
        for a in node.args:
            args.extend(a.elts if isinstance(a, (ast.Tuple, ast.List))
                        else [a])
        return any(
            isinstance(a, ast.Constant) and a.value == -1 for a in args
        ) or any(
            isinstance(a, ast.UnaryOp) and isinstance(a.op, ast.USub)
            and isinstance(a.operand, ast.Constant)
            and a.operand.value == 1
            for a in args
        )

    @classmethod
    def _is_sanitizer(cls, node):
        if not isinstance(node, ast.Call):
            return False
        text = _expr_text(node.func)
        return bool(
            text and _SHAPE_SANITIZER_RE.search(_last_segment(text))
        )

    def _tainted_names(self, func):
        """Locals whose LAST shaping assignment in *func* is a ragged
        reshape (a later sanitizer assignment clears the taint).
        _walk_no_functions yields statements in reverse source order, so
        assignments are re-sorted by position before last-wins folding."""
        tainted = {}
        assigns = sorted(
            (n for n in _walk_no_functions(func)
             if isinstance(n, ast.Assign)),
            key=lambda n: (n.lineno, n.col_offset),
        )
        for node in assigns:
            targets = [
                _expr_text(t) for t in node.targets
                if _expr_text(t) is not None
            ]
            if not targets:
                continue
            value = node.value
            if self._is_sanitizer(value):
                for t in targets:
                    tainted[t] = False
            elif any(
                self._is_ragged_reshape(sub) for sub in ast.walk(value)
            ):
                for t in targets:
                    tainted[t] = True
        return {name for name, on in tainted.items() if on}

    def _names_outside_sanitizers(self, node):
        """Name/attr texts in *node*, skipping sanitizer-call subtrees
        (``jitfn(pad_prompt(prompt, w))`` is the FIXED shape)."""
        if self._is_sanitizer(node):
            return
        text = _expr_text(node)
        if text is not None:
            yield text
        if isinstance(node, (ast.Name, ast.Attribute)):
            return
        for child in ast.iter_child_nodes(node):
            yield from self._names_outside_sanitizers(child)

    def check(self, tree, lines, path):
        jit_bound = _jit_bound_names(tree)
        if not jit_bound:
            return []
        findings = []
        for func in _functions(tree):
            tainted = self._tainted_names(func)
            if not tainted:
                continue
            for node in _walk_no_functions(func):
                if not isinstance(node, ast.Call):
                    continue
                callee = _expr_text(node.func)
                if callee not in jit_bound:
                    continue
                hit = sorted(
                    name
                    for arg in list(node.args)
                    + [kw.value for kw in node.keywords]
                    for name in self._names_outside_sanitizers(arg)
                    if name in tainted
                )
                if hit:
                    findings.append(self.finding(
                        path, lines, node,
                        f"jit-compiled {callee}() takes "
                        f"{'/'.join(dict.fromkeys(hit))}, whose shape "
                        "follows request data (ragged reshape): one XLA "
                        "compile per distinct length — pad/bucket the "
                        "shape first",
                    ))
        return findings


# Shared with the interprocedural resource engine: one spec vocabulary
# drives this lexical pre-filter, the whole-program rules, and the
# dynamic ResourceWitness (see analysis/resources.py).
from client_tpu_torch.analysis.resources import _REFCOUNT_NAME_RE  # noqa: E402


@register
class BgThreadCrashRule(Rule):
    """BG-THREAD-CRASH — a ``threading.Thread`` loop target with no
    top-level exception guard dies silently and takes its subsystem
    with it.

    Background service threads (probers, gossip loops, accept loops,
    schedulers) are registered once and expected to run forever.  Python
    prints an unhandled thread exception to stderr and simply ends the
    thread — health probing freezes, membership stops updating, the peer
    server goes deaf — with zero errors surfaced to anyone.  This is the
    bug class the endpoint-pool prober fix patched by hand (a malformed
    probe tuple unpacked in the loop body killed all probing forever);
    this rule makes the *shape* illegal instead of the one instance.

    Heuristic: resolve each ``threading.Thread(target=X)`` registration
    to a same-file function (``self.method`` within the class, bare
    names to the class's or module's functions).  Every ``while`` loop
    in the target must either sit inside a ``try`` or have a fully
    guarded body — every top-level statement a ``try``, a trivial
    control statement (``pass``/``break``/``continue``/``return``), or
    an ``if`` composed of those (the ``if stop.wait(t): return`` sleep
    shape).  Bounded ``for`` loops and loop-less targets are exempt: the
    rule is about loops meant to run forever.
    """

    id = "BG-THREAD-CRASH"
    rationale = (
        "an unguarded exception in a background thread's service loop "
        "kills the thread silently — probing/gossip/accept stops forever "
        "with no surfaced error (the endpoint-pool prober-arity incident)"
    )

    @staticmethod
    def _thread_target(call):
        """('self'|'bare', name) for a threading.Thread(target=...)
        registration, else None."""
        if _last_segment(_expr_text(call.func) or "") != "Thread":
            return None
        for kw in call.keywords:
            if kw.arg != "target":
                continue
            value = kw.value
            if (
                isinstance(value, ast.Attribute)
                and isinstance(value.value, ast.Name)
                and value.value.id == "self"
            ):
                return ("self", value.attr)
            if isinstance(value, ast.Name):
                return ("bare", value.id)
        return None

    @classmethod
    def _safe_stmt(cls, stmt):
        if isinstance(stmt, (ast.Try, ast.Pass, ast.Break, ast.Continue,
                             ast.Return)):
            return True
        if isinstance(stmt, ast.If):
            return all(
                cls._safe_stmt(s) for s in stmt.body + stmt.orelse
            )
        return False

    @classmethod
    def _unguarded_loops(cls, fn):
        """``while`` loops in *fn* that are neither under a ``try`` nor
        fully-guarded-bodied (nested defs not crossed)."""
        out = []

        def scan(node, guarded):
            if isinstance(node, ast.Try):
                for child in node.body:
                    scan(child, True)
                for handler in node.handlers:
                    for child in handler.body:
                        scan(child, guarded)
                for child in node.orelse + node.finalbody:
                    scan(child, guarded)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                return
            if isinstance(node, ast.While) and not guarded:
                if not all(cls._safe_stmt(s) for s in node.body):
                    out.append(node)
            for child in ast.iter_child_nodes(node):
                scan(child, guarded)

        for stmt in fn.body:
            scan(stmt, False)
        return out

    def check(self, tree, lines, path):
        findings = []
        module_fns = {
            n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)
        }
        seen = set()

        def visit(node, methods):
            if isinstance(node, ast.ClassDef):
                methods = {
                    f.name: f for f in node.body
                    if isinstance(f, ast.FunctionDef)
                }
            if isinstance(node, ast.Call):
                target = self._thread_target(node)
                if target is not None:
                    kind, name = target
                    fn = methods.get(name)
                    if fn is None and kind == "bare":
                        fn = module_fns.get(name)
                    if fn is not None:
                        for loop in self._unguarded_loops(fn):
                            key = (fn.name, loop.lineno)
                            if key in seen:
                                continue
                            seen.add(key)
                            findings.append(self.finding(
                                path, lines, loop,
                                f"{fn.name}() runs as a thread target "
                                f"(registered at line {node.lineno}) but "
                                "this while loop has no top-level "
                                "exception guard — one escaped exception "
                                "kills the thread silently and its "
                                "subsystem with it; wrap the loop (or "
                                "its whole body) in try/except",
                            ))
            for child in ast.iter_child_nodes(node):
                visit(child, methods)

        visit(tree, {})
        return findings


@register
class RefcountPairRule(Rule):
    """REFCOUNT-PAIR — a class increments a refcount attribute with no
    decrement anywhere in the class.

    The paged KV pool's block sharing (serve/lm/kv.py) lives and dies by
    refcount discipline: ``retain`` adds a reference, ``release`` drops
    one, and a reference that is incremented but never decremented is a
    LEAKED SHARED BLOCK — never freed, never readable, silently shrinking
    the pool until admission backpressure bricks the engine.  The leak is
    invisible in tests that don't drain to zero, which is exactly how it
    ships.

    Heuristic: within one class, an increment of an attribute or mapping
    whose name looks refcount-ish (``refs``, ``_refs``, ``refcount``,
    ``*_refcount``, ``ref_count``) — ``+= 1``-style AugAssign or an
    ``x = <ref> + n`` rebind — must be paired with a decrement of the
    SAME name somewhere in the class (``-=`` or a ``<ref> - n``
    expression on every holder's exit path; the class-level pairing is
    the static floor we can check).  A class that only ever increments
    gets one finding per incrementing method.
    """

    id = "REFCOUNT-PAIR"
    rationale = (
        "a refcount incremented with no paired decrement is a leaked "
        "shared block: the pool shrinks until admission bricks "
        "(serve/lm/kv.py retain/release discipline)"
    )

    @staticmethod
    def _ref_name(node):
        """The refcount-ish name a target/operand refers to, or None.
        Accepts ``self._refs`` (Attribute), ``self._refs[b]`` (Subscript
        over an Attribute/Name) and bare ``refs`` names."""
        if isinstance(node, ast.Subscript):
            node = node.value
        if isinstance(node, ast.Attribute):
            name = node.attr
        elif isinstance(node, ast.Name):
            name = node.id
        else:
            return None
        return name if _REFCOUNT_NAME_RE.search(name) else None

    @classmethod
    def _deltas(cls, fn):
        """(increments, decrements) ref-name sets in one function."""
        incs, decs = {}, set()
        for node in _walk_no_functions(fn):
            if isinstance(node, ast.AugAssign):
                name = cls._ref_name(node.target)
                if name is None:
                    continue
                if isinstance(node.op, ast.Add):
                    incs.setdefault(name, node)
                elif isinstance(node.op, ast.Sub):
                    decs.add(name)
            elif isinstance(node, ast.BinOp):
                # x = self._refs[b] + 1 / left = self._refs[b] - 1 forms
                name = cls._ref_name(node.left)
                if name is None:
                    continue
                if isinstance(node.op, ast.Add):
                    incs.setdefault(name, node)
                elif isinstance(node.op, ast.Sub):
                    decs.add(name)
        return incs, decs

    def check(self, tree, lines, path):
        findings = []
        for cls_node in ast.walk(tree):
            if not isinstance(cls_node, ast.ClassDef):
                continue
            incs = {}   # ref name -> [(method, witness node), ...]
            decs = set()
            for fn in _functions(cls_node):
                fn_incs, fn_decs = self._deltas(fn)
                for name, node in fn_incs.items():
                    incs.setdefault(name, []).append((fn.name, node))
                decs.update(fn_decs)
            for name, sites in sorted(incs.items()):
                if name in decs:
                    continue
                for method, node in sites:
                    findings.append(self.finding(
                        path, lines, node,
                        f"{method}() increments {name} but class "
                        f"{cls_node.name} never decrements it — a "
                        "leaked reference is a block the pool can "
                        "neither free nor read; pair every retain "
                        "with a release on each holder's exit path",
                    ))
        return findings


# Span vocabulary also lives in the resource spec table: explicit
# span/timer starters (any receiver) + the tracers' sample(), and the
# calls that end a started span's lifetime (receiver = the span, or the
# span passed as an argument: trace.close() / tracer.complete(trace)).
from client_tpu_torch.analysis.resources import (  # noqa: E402
    _SPAN_FINISH_METHODS,
    _SPAN_START_METHODS,
    _TRACERISH_RE,
)


@register
class SpanLeakRule(Rule):
    """SPAN-LEAK — a span/timer started without a finish on every exit
    path.

    The tracing layer's contract is that every sampled span COMPLETES:
    completion is what appends the record to the bounded deque and the
    trace file.  A span started (``tracer.sample(...)``, ``start_span``,
    ``start_timer``) whose finish (``complete``/``finish``/``close``/
    ``end``/``stop``) is not inside a ``finally`` leaks the moment any
    statement between start and finish raises — the request happened,
    the timeline says it didn't, and the flight recorder's ring (fed by
    the completion hook) has a hole exactly where the postmortem needs
    it.  Every tracing bracket in this repo is a ``try/finally`` or a
    context manager for this reason; the rule freezes that shape.

    Heuristic, per function: an assignment ``x = <tracer-ish>.sample(...)``
    (or any ``*.start_span/begin_span/start_timer(...)``) must be paired
    with a finish call on ``x`` that sits inside a ``finally`` block.  A
    span that ESCAPES the function — returned, yielded, stored on an
    attribute, or handed to another call — transfers ownership and is
    exempt (the frontends sample, then complete in their own finally).
    """

    id = "SPAN-LEAK"
    rationale = (
        "a span started without a finish on every exit path (try/finally "
        "or context manager) vanishes from the trace file and the flight "
        "recorder exactly when a failure makes it interesting — the "
        "timeline hole the tracing brackets exist to prevent"
    )

    @classmethod
    def _start_call(cls, node):
        """The span-starting Call inside an assignment value, or None."""
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            fn = sub.func
            if not isinstance(fn, ast.Attribute):
                continue
            if fn.attr in _SPAN_START_METHODS:
                return sub
            if fn.attr == "sample":
                recv = _expr_text(fn.value)
                if recv and _TRACERISH_RE.search(_last_segment(recv)):
                    return sub
        return None

    @staticmethod
    def _uses_name(node, name):
        return any(
            isinstance(sub, ast.Name) and sub.id == name
            for sub in ast.walk(node)
        )

    @classmethod
    def _classify(cls, fn, name, start_assign):
        """(finishes, protected_finishes, escapes) of span var *name*."""
        finishes = []
        protected = []
        escaped = False
        final_nodes = set()
        for sub in _walk_no_functions(fn):
            if isinstance(sub, ast.Try):
                for stmt in sub.finalbody:
                    final_nodes.update(id(n) for n in ast.walk(stmt))
        for sub in _walk_no_functions(fn):
            if isinstance(sub, (ast.Return, ast.Yield, ast.YieldFrom)):
                if sub.value is not None and cls._uses_name(sub.value, name):
                    escaped = True
            elif isinstance(sub, ast.Assign) and sub is not start_assign:
                # self._trace = x: stored; finished elsewhere
                if cls._uses_name(sub.value, name) and any(
                    isinstance(t, (ast.Attribute, ast.Subscript))
                    for t in sub.targets
                ):
                    escaped = True
            elif isinstance(sub, ast.Call):
                fn_expr = sub.func
                is_finish = (
                    isinstance(fn_expr, ast.Attribute)
                    and fn_expr.attr in _SPAN_FINISH_METHODS
                    and (
                        cls._uses_name(fn_expr.value, name)
                        or any(cls._uses_name(a, name) for a in sub.args)
                    )
                )
                if is_finish:
                    finishes.append(sub)
                    if id(sub) in final_nodes:
                        protected.append(sub)
                elif any(
                    cls._uses_name(a, name) for a in sub.args
                ) or any(
                    kw.value is not None and cls._uses_name(kw.value, name)
                    for kw in sub.keywords
                ):
                    # handed to another callable: ownership transferred
                    # (the callee finishing it is beyond a per-file pass)
                    escaped = True
        return finishes, protected, escaped

    def check(self, tree, lines, path):
        findings = []
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for node in _walk_no_functions(fn):
                if not isinstance(node, ast.Assign):
                    continue
                if len(node.targets) != 1 or not isinstance(
                    node.targets[0], ast.Name
                ):
                    continue
                start = self._start_call(node.value)
                if start is None:
                    continue
                name = node.targets[0].id
                finishes, protected, escaped = self._classify(
                    fn, name, node
                )
                if escaped:
                    continue
                if not finishes:
                    findings.append(self.finding(
                        path, lines, node,
                        f"{fn.name}() starts span {name!r} and never "
                        "finishes it — the sampled request vanishes from "
                        "the trace file; complete it in a try/finally or "
                        "use the context-manager bracket",
                    ))
                elif not protected:
                    findings.append(self.finding(
                        path, lines, node,
                        f"{fn.name}() finishes span {name!r} outside any "
                        "finally block — an exception between start and "
                        "finish leaks the span exactly when the timeline "
                        "matters; move the finish into try/finally or use "
                        "the context-manager bracket",
                    ))
        return findings


# peer-RPC callees whose bound replies the ACK-BEFORE-STORE rule tracks
# (last dotted segment) — the fleet tier's transport verbs
_PEER_REPLY_CALLS = {
    "_peer_call", "peer_call", "_traced_peer_call", "recv_frame",
    "_recv_frame", "_ask",
}
# counter names that read as durability acks (bounded: 'ack' at a word
# boundary so e.g. 'backoff' never matches)
_ACK_NAME_RE = re.compile(r"(?i)(^|_)(n?acks?|acked)(_|$)")


@register
class AckBeforeStoreRule(Rule):
    """ACK-BEFORE-STORE — a peer reply counted as durability unchecked.

    The fleet tier's replicated stores answer every reachable request
    with a frame, and the frame says whether the payload was actually
    STORED (``{"stored": false}`` marks a stale snapshot the peer
    REJECTED).  A quorum/durability counter that increments on the mere
    arrival of a reply counts reachability, not durability: a fleet of
    peers all rejecting a stale snapshot would still 'reach quorum' and
    the client would hold an ack for a step a SIGKILL can lose — the
    exact acks-then-loses fork the write-quorum mode exists to prevent.
    Fires in functions that (a) bind a peer-transport reply, (b) bump
    an ack-named counter, and (c) never consult a ``"stored"`` field.
    Transport-level delivery counters should use a non-ack name
    (``accepted``, ``delivered``); real ack accounting must check
    ``reply.get("stored")``.
    """

    id = "ACK-BEFORE-STORE"
    rationale = (
        "a peer reply is reachability, not durability: acking without "
        "checking the reply's 'stored' field can ack a step every peer "
        "rejected as stale (acks-then-loses)"
    )

    @staticmethod
    def _binds_peer_reply(fn):
        for node in _walk_no_functions(fn):
            calls = ()
            if isinstance(node, ast.Assign):
                calls = ast.walk(node.value)
            elif isinstance(node, ast.For):
                calls = ast.walk(node.iter)
            for sub in calls:
                if isinstance(sub, ast.Call) and _last_segment(
                    _expr_text(sub.func) or ""
                ) in _PEER_REPLY_CALLS:
                    return True
        return False

    @staticmethod
    def _checks_stored(fn):
        for node in _walk_no_functions(fn):
            if isinstance(node, ast.Constant) and node.value == "stored":
                return True
        return False

    def check(self, tree, lines, path):
        findings = []
        for fn in _functions(tree):
            if not self._binds_peer_reply(fn) or self._checks_stored(fn):
                continue
            for node in _walk_no_functions(fn):
                if not (
                    isinstance(node, ast.AugAssign)
                    and isinstance(node.op, ast.Add)
                ):
                    continue
                target = _last_segment(_expr_text(node.target) or "")
                if target and _ACK_NAME_RE.search(target):
                    findings.append(self.finding(
                        path, lines, node,
                        f"{fn.name}() counts a peer reply as ack "
                        f"{target!r} without checking the reply's "
                        "'stored' field — a stale-rejecting peer is "
                        "reachable but is no durability; gate the "
                        "increment on reply.get('stored')",
                    ))
        return findings
