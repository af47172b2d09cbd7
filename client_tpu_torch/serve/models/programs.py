"""The serial LM programs and the train steps as CUDA graphs.

The port's counterpart of the JAX package's last compiled LM programs
(client_tpu/serve/models/transformer.py):

- ``_jitted_steps(cfg)``: ``jax.jit(prefill)`` and ``jax.jit(decode_step)``
  behind ``generate``.  Here a :class:`SerialPrograms` owns one static KV
  cache with its decode graph and a bounded LRU of prefill graphs, one per
  exact prompt length (``PREFILL_GRAPHS``, as ``_jitted_steps``'
  ``lru_cache``): the first sight of a length captures its graph, as
  ``jax.jit`` compiles a new shape.  Token choice stays outside the graphs,
  as JAX picks the token outside its jitted ``decode_step``.  A
  :class:`SerialPool` hands out program sets for one params tree, one a
  stream at a time, since two streams cannot share a static cache (JAX's
  jitted steps are reentrant: each call gets its own cache).
- ``_make_adam_step``: ``jax.jit(step, donate_argnums=(0, 1))``, on one
  device and, through GSPMD, over a mesh (``make_train_step(mesh=)`` and
  ``make_pipeline_train_step``).  Here a :class:`TrainProgram` runs its
  first call eagerly (a real step and the warm-up: it builds the kernels'
  extension and allocates the gradients), captures the whole step
  (zero-grad, forward, backward, the Adam update) on its second and
  replays it from then on, the params and the optimizer state updated in
  place (the port's stand-in for buffer donation).  :func:`graphable`
  says which worlds a mesh step is captured on.

A graph is captured by ``ops.capture_graph`` (a warm-up, then the capture
on a side stream, one capture at a time in the process, with no device
sync or cache flush), with the kernels' launches recorded and counted at
each replay (``ops.Graph.replay``).  On a CPU device the same bodies run
eagerly on the same static buffers.  A failed capture or replay raises;
nothing runs the eager body on CUDA in its place.
"""

import collections
import contextlib
import threading
import weakref

import torch

from client_tpu_torch import ops
from client_tpu_torch.serve.models import transformer as tfm

PREFILL_GRAPHS = 8  # prefill graphs a program set keeps (LRU)
IDLE_SETS = 8       # program sets a pool keeps between streams
_leaves = tfm._leaves


# -- the serial LM programs (generate) ---------------------------------------

def _scratch(cache):
    return {"k": [x.clone() for x in cache["k"]],
            "v": [x.clone() for x in cache["v"]],
            "len": cache["len"].clone()}


class SerialPrograms:
    """One stream's programs: a static KV cache, the static token input
    and logits output, the decode program and the prefill programs by
    prompt length (``PREFILL_GRAPHS`` at most, least recently used out).

    ``prefill(params, prompt)`` and ``decode(params, token)`` copy their
    input into the static buffer, run the program and return the static
    logits [B, V] f32, valid until the next call.  On CUDA each program is
    a CUDA graph (captured for ``params``' tensors: the caller passes the
    same tree every call, which :class:`SerialPool` checks); on the CPU the
    same body runs eagerly."""

    def __init__(self, params, cfg, batch, device):
        self.cfg, self.batch, self.device = cfg, int(batch), device
        self.cache = tfm.init_cache(cfg, batch, device)
        self.token = torch.zeros((batch,), dtype=torch.int32, device=device)
        self.logits = torch.zeros((batch, cfg.vocab_size),
                                  dtype=torch.float32, device=device)
        self._prefill = collections.OrderedDict()  # length -> (buf, graph)
        self.captures = {}  # {"decode" or prefill length: capture seconds}
        self._graphs = device.type == "cuda"
        self._decode = None
        if self._graphs:
            from client_tpu_torch.ops._build import kernels

            kernels()  # build the extension before any capture
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(device)
            self._decode = self._capture(
                lambda c, out: self._decode_body(params, self.token, c, out))
            self.captures["decode"] = self._decode.seconds

    @property
    def decode_launches(self):
        """{(kernel, route): launches} of one decode replay ({} on the
        CPU)."""
        return dict(self._decode.launches) if self._decode else {}

    @property
    def prefill_lengths(self):
        """The prompt lengths whose prefill programs the set holds, least
        recently used first."""
        return tuple(self._prefill)

    def _capture(self, run):
        """A graph of ``run(cache, logits)`` on the static buffers, after a
        warm-up on scratch copies (it changes no live row)."""
        scratch = _scratch(self.cache)
        out = torch.empty_like(self.logits)
        return ops.capture_graph(lambda: run(self.cache, self.logits),
                                 lambda: run(scratch, out), self._pool,
                                 self._stream)

    def _decode_body(self, params, token, cache, logits):
        out, _ = tfm.decode_step(params, token, self.cfg, cache)
        logits.copy_(out)

    def _prefill_body(self, params, prompt, cache, logits):
        out, _ = tfm.prefill(params, prompt, self.cfg, cache)
        logits.copy_(out)

    def prefill(self, params, prompt):
        """Fill the cache from ``prompt`` [B, T] int32 (on the device);
        returns the last position's logits."""
        t = int(prompt.shape[1])
        entry = self._prefill.get(t)
        if entry is None:
            buf = torch.zeros((self.batch, t), dtype=torch.int32,
                              device=self.device)
            graph = None
            if self._graphs:
                graph = self._capture(
                    lambda c, out: self._prefill_body(params, buf, c, out))
                self.captures[t] = graph.seconds
            entry = (buf, graph)
            self._prefill[t] = entry
            while len(self._prefill) > PREFILL_GRAPHS:
                self._prefill.popitem(last=False)
        else:
            self._prefill.move_to_end(t)
        buf, graph = entry
        buf.copy_(prompt)
        if graph is None:
            self._prefill_body(params, buf, self.cache, self.logits)
        else:
            graph.replay()
        return self.logits

    def decode(self, params, token):
        """One decode step from ``token`` [B] int32 (on the device) at the
        cache's length; returns the logits."""
        self.token.copy_(token)
        if self._decode is None:
            self._decode_body(params, self.token, self.cache, self.logits)
        else:
            self._decode.replay()
        return self.logits


class SerialPool:
    """Program sets for one params tree at one config: ``acquire(params,
    batch)`` lends a set to one stream (the one freed last) and takes it
    back after.  A set is
    made (and on CUDA captured) outside the pool's lock when none is free;
    up to ``IDLE_SETS`` are kept between streams.

    The graphs bake the params' tensors in.  The pool remembers the tree's
    leaves by weak reference: a call with other leaves (weights swapped)
    drops every set and captures new ones.  It holds no strong reference to
    the params, so a pool kept for a params tree frees nothing of it."""

    def __init__(self, cfg):
        self.cfg = cfg
        self._lock = threading.Lock()
        self._leaves = ()
        self._version = 0
        self._free = []  # [(batch, SerialPrograms, event or None)]

    def idle_sets(self):
        """The program sets waiting for a stream, oldest first."""
        with self._lock:
            return [progs for _, progs, _ in self._free]

    def _serves_locked(self, leaves):
        return len(leaves) == len(self._leaves) and all(
            ref() is w for ref, w in zip(self._leaves, leaves))

    @contextlib.contextmanager
    def acquire(self, params, batch):
        leaves = list(_leaves(params))
        device = leaves[0].device
        progs = done = None
        with self._lock:
            if not self._serves_locked(leaves):
                self._leaves = tuple(weakref.ref(w) for w in leaves)
                self._version += 1
                self._free.clear()
            version = self._version
            for i in range(len(self._free) - 1, -1, -1):
                b, p, ev = self._free[i]
                if b == batch:  # the set freed last: its prefills are warm
                    progs, done = p, ev
                    del self._free[i]
                    break
        if progs is None:
            progs = SerialPrograms(params, self.cfg, batch, device)
        elif done is not None:
            # the last stream's replays may run on another stream
            torch.cuda.current_stream(device).wait_event(done)
        try:
            yield progs
        finally:
            done = None
            if device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
            with self._lock:
                if (self._version == version
                        and len(self._free) < IDLE_SETS):
                    self._free.append((batch, progs, done))


# pools for ``generate`` callers that bring no pool, by the params tree's
# first LM-head leaf (a float tree and its int8 copy share the embedding,
# not the head): {id(head): (weakref to head, {cfg: pool})}.  The weak
# reference's callback drops the entry as the head dies, before its id can
# be reused, and a lookup checks the referent too.
_POOLS = {}
_POOLS_LOCK = threading.Lock()


def _forget(key, ref):
    entry = _POOLS.get(key)
    if entry is not None and entry[0] is ref:
        _POOLS.pop(key, None)  # no lock: a callback may run inside one


def serial_pool(params, cfg):
    """The shared :class:`SerialPool` of ``params`` at ``cfg``."""
    anchor = next(_leaves(params["lm_head"]))
    key = id(anchor)
    with _POOLS_LOCK:
        entry = _POOLS.get(key)
        if entry is None or entry[0]() is not anchor:
            ref = weakref.ref(anchor, lambda r, key=key: _forget(key, r))
            entry = _POOLS[key] = (ref, {})
        pools = entry[1]
        pool = pools.get(cfg)
        if pool is None:
            pool = pools[cfg] = SerialPool(cfg)
        return pool


# -- the train step -----------------------------------------------------------

def graphable(mesh):
    """Whether a train step on ``mesh`` (None: one device) runs as a
    :class:`TrainProgram`.

    With no mesh, always.  On a mesh, only where the mesh lies on CUDA and
    every group of every mesh dim runs on NCCL, whose collectives a CUDA
    graph records.  A gloo world stays eager: gloo sends and receives a
    CUDA tensor through pinned host memory (``collectives._sendrecv``), a
    host copy that a capture cannot record.  That covers the CPU worlds
    and several ranks that share one card over gloo.

    A capture of a multi-rank NCCL step is unproven: the mesh step has
    been captured on a one-rank world only, where every mesh dim has size
    1 and the step issues no collective."""
    if mesh is None:
        return True
    import torch.distributed as dist

    return mesh.device_type == "cuda" and all(
        dist.get_backend(mesh.get_group(dim)) == "nccl"
        for dim in range(mesh.ndim))


def _token_key(tokens):
    """What a program's static token buffer is made for: the tokens'
    shape, dtype and device, and a DTensor's mesh and placements."""
    return (tuple(tokens.shape), tokens.dtype, tokens.device,
            getattr(tokens, "device_mesh", None),
            tuple(getattr(tokens, "placements", ())))


class TrainProgram:
    """``body(params, opt_state, tokens) -> loss`` (zero-grad, forward,
    backward, the optimizer's update, all in place) as one program.

    On CUDA the first call with a params tree, an optimizer state and a
    token shape runs ``body`` eagerly on the program's stream; the second
    captures it as a CUDA graph (the gradients, set to None inside, come
    back from the graph's pool and stay there) and replays it; every later
    call copies the tokens into the static buffer and replays.  Other
    params, another state or another token shape start over.  On the CPU
    every call runs ``body`` on the static token buffer.

    On a mesh the params are DTensors: the key holds their leaves, and the
    graph reads and the optimizer updates their local shards, the same
    tensor objects on every call (``parallel.local_shard``).  Tokens may
    be a plain tensor or a DTensor; the static buffer is made like them
    (a DTensor's placements are part of the key).

    The optimizer's hyperparameters (its learning rate) are baked into the
    graph, as optax's are into the jitted step.  Returns a copy of the
    step's loss, as the JAX step returns a new array."""

    def __init__(self, body):
        self.body = body
        self._key = None
        self._tokens = None
        self._graph = None
        self._loss = None
        self._calls = 0
        self.capture_s = None

    @property
    def launches(self):
        """{(kernel, route): launches} of one replay ({} before the
        capture)."""
        return dict(self._graph.launches) if self._graph else {}

    @property
    def pool(self):
        """The id of the memory pool the graph allocates from (None before
        the capture)."""
        return self._graph.graph.pool() if self._graph else None

    def _matches(self, params, opt_state, tokens):
        key = self._key
        if key is None:
            return False
        opt_ref, leaf_refs, token_key = key
        leaves = list(_leaves(params))
        return (opt_ref() is opt_state
                and token_key == _token_key(tokens)
                and len(leaves) == len(leaf_refs)
                and all(r() is w for r, w in zip(leaf_refs, leaves)))

    def __call__(self, params, opt_state, tokens):
        if not self._matches(params, opt_state, tokens):
            self._key = (weakref.ref(opt_state),
                         tuple(weakref.ref(w) for w in _leaves(params)),
                         _token_key(tokens))
            self._tokens = torch.empty_like(tokens)
            self._graph = self._loss = None
            self._calls = 0
        self._tokens.copy_(tokens)
        self._calls += 1
        if tokens.device.type != "cuda":
            return self.body(params, opt_state, self._tokens).detach()
        if self._graph is not None:
            self._graph.replay()
            return self._loss.clone()
        if self._calls == 1:
            return self._warm_up(params, opt_state)
        box = {}

        def run():
            box["loss"] = self.body(params, opt_state,
                                    self._tokens).detach()

        self._graph = ops.capture_graph(run, None,
                                        torch.cuda.graph_pool_handle(),
                                        self._stream)
        self.capture_s = self._graph.seconds
        self._loss = box["loss"]
        self._graph.replay()
        return self._loss.clone()

    def _warm_up(self, params, opt_state):
        """The first call: one real step, eagerly, on the stream the graph
        will be captured on."""
        device = self._tokens.device
        self._stream = torch.cuda.Stream(device)
        main = torch.cuda.current_stream(device)
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            loss = self.body(params, opt_state, self._tokens).detach()
        main.wait_stream(self._stream)
        loss.record_stream(main)
        return loss
