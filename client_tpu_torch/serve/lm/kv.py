"""Paged KV cache: a refcounted block-table pool shared by every decode

The port's counterpart of client_tpu/serve/lm/kv.py.  The host refcount
and free-list logic is the JAX package's, word for word.  The pools are
per-layer torch tensors of shape ``[n_blocks + 1, block_size, n_kv,
head_dim]`` in ``cfg.tdtype`` on the engine's device, written IN PLACE
by the engine's programs (``index_put_``): that takes the place of the
JAX engine's buffer donation.

lane (and, since the prefix cache, by every REQUEST that shares a prompt
prefix).

The fixed-lane prototype allocated per layer ``[lanes, max_seq, kv, hd]``
— every lane pinned max-seq-len rows of HBM whether it held a 5-token
request, a 500-token one, or nothing.  The pool here is per layer
``[n_blocks, block_size, kv, hd]`` with a host-side free list: a request
reserves exactly ``ceil((prompt_len + max_tokens) / block_size)`` blocks
at admission and frees them at completion/cancel, so HBM capacity is a
function of *aggregate live tokens*, not ``lanes * max_seq``.

Blocks carry a REFERENCE COUNT: ``alloc`` hands out blocks at refcount 1,
``retain`` adds a reference (a second request adopting a shared prompt-
prefix block, or the prefix cache keeping a retired request's blocks
warm), and ``release`` decrements — a block returns to the free list only
when its last reference drops.  That is what makes block-granular KV
sharing safe: an 80%-shared prompt adopts its prefix blocks by reference
instead of recomputing them, and nobody can free a block out from under
another holder.

Static shapes throughout: the device tensors never change shape;
splice/free are index bookkeeping on the host plus scatter/gather
through per-lane block tables inside the engine's programs.
Block 0 is reserved as the *trash block*: idle lanes and write-masked
pad positions scatter there, so the tick needs no per-lane
branch.  Nothing ever reads it (the length mask excludes every position
a table maps to trash).
"""

import threading

import torch

_KV_HELP = {
    "ctpu_lm_kv_blocks_used": "Paged-KV blocks currently referenced",
    "ctpu_lm_kv_blocks_free": "Paged-KV blocks free in the pool",
}


class KvBlockPool:
    """Device block pool + host free-list/refcount accounting.

    ``n_blocks`` counts usable blocks; one extra trash block (index 0) is
    allocated on top, so the device arrays hold ``n_blocks + 1`` blocks.
    """

    TRASH = 0

    def __init__(self, cfg, n_blocks, block_size, registry=None,
                 device=None):
        if block_size <= 0 or n_blocks <= 0:
            raise ValueError("block_size and n_blocks must be positive")
        self.cfg = cfg
        self.block_size = int(block_size)
        self.n_blocks = int(n_blocks)
        self.registry = registry
        shape = (self.n_blocks + 1, self.block_size,
                 cfg.n_kv_heads, cfg.head_dim)
        self.pools = {
            kind: [torch.zeros(shape, dtype=cfg.tdtype, device=device)
                   for _ in range(cfg.n_layers)]
            for kind in ("k", "v")
        }
        self._lock = threading.Lock()
        self._free = list(range(1, self.n_blocks + 1))
        self._refs = {}  # block -> live reference count (absent = free)

    def blocks_for(self, n_tokens):
        """Blocks a sequence of ``n_tokens`` total (prompt + generation
        budget) reserves."""
        return -(-int(n_tokens) // self.block_size)

    def alloc(self, n):
        """Reserve ``n`` blocks at refcount 1; returns the block index
        list or None when the pool cannot satisfy the reservation
        (admission backpressure — the caller evicts cache blocks,
        preempts a lane, or retries once completions free blocks)."""
        n = int(n)
        with self._lock:
            if n > len(self._free):
                return None
            taken = self._free[:n]
            del self._free[:n]
            for block in taken:
                self._refs[block] = 1
            self._gauges_locked()
            return taken

    def retain(self, blocks):
        """Add one reference to each block (prefix-cache adoption; the
        block must already be live — retaining a freed block is a bug)."""
        with self._lock:
            for block in blocks:
                self._refs[block] += 1

    def release(self, blocks):
        """Drop one reference from each block; blocks whose last
        reference drops return to the free list.  Every ``alloc``/
        ``retain`` must be paired with exactly one release — the
        REFCOUNT-PAIR lint rule guards the shape (a leaked reference
        bricks the pool: the block is never free and never readable)."""
        if not blocks:
            return
        with self._lock:
            for block in blocks:
                left = self._refs[block] - 1
                if left > 0:
                    self._refs[block] = left
                else:
                    del self._refs[block]
                    self._free.append(block)
            self._gauges_locked()

    def ref_count(self, block):
        """Live reference count of one block (0 = free)."""
        with self._lock:
            return self._refs.get(block, 0)

    def ref_counts(self):
        """{block: refcount} snapshot of every live block (leak audits)."""
        with self._lock:
            return dict(self._refs)

    @property
    def free_blocks(self):
        with self._lock:
            return len(self._free)

    @property
    def used_blocks(self):
        with self._lock:
            return self.n_blocks - len(self._free)

    def _gauges_locked(self):
        if self.registry is None:
            return
        free = len(self._free)
        self.registry.set("ctpu_lm_kv_blocks_used", None,
                          self.n_blocks - free,
                          help_=_KV_HELP["ctpu_lm_kv_blocks_used"])
        self.registry.set("ctpu_lm_kv_blocks_free", None, free,
                          help_=_KV_HELP["ctpu_lm_kv_blocks_free"])

    def set_registry(self, registry):
        """Late-bind a metrics registry (the engine learns its server's
        registry at add_model time) and publish the current gauges."""
        with self._lock:
            self.registry = registry
            self._gauges_locked()
