"""Radix/trie prefix cache over token-block hashes for the paged KV pool.

The port's copy of client_tpu/serve/lm/prefix.py (host logic only).

Production LM traffic reuses prompt prefixes heavily — shared system
prompts, few-shot templates, the whole history of a multi-turn chat —
and prefill is the compute-bound phase, so cross-request prefix reuse is
where most of the prefill FLOPs come back from.  The paged KV layout
(serve/lm/kv.py) was built for exactly this: blocks are position-fixed
(K is RoPE'd with its absolute position), so a full block of prompt
tokens at logical block index ``b`` is bit-identical for every request
whose first ``(b + 1) * block_size`` tokens match.  This module caches
those blocks and lets admission adopt them **by reference**.

Structure: a radix trie keyed by the token-chain — each node is one FULL
block of prompt tokens, its children keyed by the next block's token
tuple.  Matching walks the new prompt block-by-block from the root;
exact tuple keys (not just hashes) mean a match is a guarantee, never a
collision gamble.  Each cached node holds one pool reference on its
block (``KvBlockPool.retain``/``release`` semantics), so an active
request and the cache can share a block without either freeing it under
the other.

Lifecycle:

- **admission** (`match` + `adopt`): the engine walks the prompt's full
  blocks; every matched block is retained for the lane and chunked
  prefill starts at the first miss — an 80%-shared prompt runs ~20% of
  its prefill compute;
- **retirement** (`give_back`): a completed/cancelled request's fully
  written full prompt blocks are INSERTED into the trie (the lane's
  reference transfers to the cache) instead of freed; everything else
  (partial tail block, generated-token blocks) is released;
- **pressure** (`evict`): the cache holds blocks only as long as the
  pool is not starved — when an allocation falls short, the engine
  evicts least-recently-used leaf nodes whose block nobody else
  references until the reservation fits.  LRU over leaves keeps every
  cached chain contiguous from the root (a hole in the middle of a
  chain would make its suffix unreachable anyway).

Thread-safety: externally synchronized — every method is called with
the engine's ``_cv`` held (admission, retirement and eviction are all
scheduler-side bookkeeping).  All work here is host-side dict/list
manipulation; nothing blocks and nothing dispatches to the device, so
holding the condition lock is safe (the BLOCK-UNDER-LOCK gate agrees).
"""

import heapq

from client_tpu_torch.serve.metrics import LM_PREFIX_HELP


class _Node:
    """One cached full block of prompt tokens."""

    __slots__ = ("tokens", "block", "parent", "children", "stamp")

    def __init__(self, tokens, block, parent):
        self.tokens = tokens      # tuple of this block's token ids
        self.block = block        # physical pool block index
        self.parent = parent      # _Node or the root sentinel None
        self.children = {}        # token tuple -> _Node
        self.stamp = 0            # LRU clock value of the last touch


class PrefixCache:
    """Trie of cached prompt-prefix KV blocks over a ``KvBlockPool``.

    ``min_prefix_blocks`` is the per-model hint knob: prefixes shorter
    than this many full blocks are not worth the table bookkeeping and
    are reported as a miss (0 = adopt any match).
    """

    def __init__(self, pool, registry=None, min_prefix_blocks=1):
        self.pool = pool
        self.block_size = pool.block_size
        self.registry = registry
        self.min_prefix_blocks = max(int(min_prefix_blocks), 0)
        self._children = {}  # root level: token tuple -> _Node
        self._nodes = 0
        self._clock = 0
        self.hits = 0        # blocks adopted
        self.misses = 0      # shareable full blocks with no cached match
        self.evictions = 0   # blocks evicted under pool pressure
        self.inserted = 0    # blocks handed over by retiring requests

    # -- internals ---------------------------------------------------------

    def _tick(self):
        self._clock += 1
        return self._clock

    def _blocks_of(self, prompt_row, limit):
        """The prompt's leading full-block token tuples, at most *limit*."""
        bs = self.block_size
        out = []
        for i in range(limit):
            out.append(tuple(int(t) for t in prompt_row[i * bs:(i + 1) * bs]))
        return out

    def _gauge(self):
        if self.registry is not None:
            self.registry.set(
                "ctpu_lm_prefix_cached_blocks", None, self._nodes,
                help_=LM_PREFIX_HELP["ctpu_lm_prefix_cached_blocks"],
            )

    def _count(self, name, value=1):
        if self.registry is not None and value:
            self.registry.inc(name, None, value=value,
                              help_=LM_PREFIX_HELP[name])

    # -- admission ---------------------------------------------------------

    def match(self, prompt_row, max_blocks):
        """Longest cached chain for this prompt, as ``(blocks, nodes)``.

        ``max_blocks`` caps the walk (the engine passes
        ``(prompt_len - 1) // block_size`` so at least one prompt token
        is always left to prefill — the final position's logits seed the
        first generated token).  Pure lookup: no refcounts move until
        :meth:`adopt`, so a failed admission has nothing to unwind.
        """
        nodes = []
        children = self._children
        for key in self._blocks_of(prompt_row, max_blocks):
            node = children.get(key)
            if node is None:
                break
            nodes.append(node)
            children = node.children
        if len(nodes) < self.min_prefix_blocks:
            nodes = []
        return [n.block for n in nodes], nodes

    def adopt(self, nodes):
        """Take one reference per matched block for the admitting lane
        and refresh the chain's LRU stamps."""
        if not nodes:
            return
        stamp = self._tick()
        for node in nodes:
            node.stamp = stamp
        self.pool.retain([n.block for n in nodes])

    def note_lookup(self, hits, misses):
        """Count one COMMITTED admission's lookup outcome (called after
        the reservation succeeds — a backpressured admission re-matches
        on retry and must not double-count)."""
        self.hits += hits
        self.misses += misses
        self._count("ctpu_lm_prefix_hits_total", hits)
        self._count("ctpu_lm_prefix_misses_total", misses)

    def publish(self, prompt_row, cacheable_blocks, blocks):
        """Make a live lane's full prompt blocks matchable NOW — called
        at prefill completion, so a burst of same-prefix admissions
        shares from the FIRST finished prefill instead of waiting for a
        whole stream to retire.  New nodes take their own pool reference
        (the lane keeps its); chains that already exist are only
        LRU-touched."""
        cacheable_blocks = min(int(cacheable_blocks), len(blocks))
        stamp = self._tick()
        children = self._children
        parent = None
        fresh = []
        for i, key in enumerate(self._blocks_of(prompt_row,
                                                cacheable_blocks)):
            node = children.get(key)
            if node is None:
                node = _Node(key, blocks[i], parent)
                children[key] = node
                self._nodes += 1
                self.inserted += 1
                fresh.append(blocks[i])
            node.stamp = stamp
            parent = node
            children = node.children
        if fresh:
            self.pool.retain(fresh)
            self._gauge()

    # -- retirement --------------------------------------------------------

    def give_back(self, prompt_row, cacheable_blocks, blocks):
        """Return a retiring request's reservation.

        ``blocks`` is the lane's ordered physical block list (adopted
        prefix + fresh); the first ``cacheable_blocks`` entries cover
        fully written FULL blocks of prompt tokens and are offered to
        the trie — a new node takes over the lane's reference, while a
        block whose chain node already exists (it was adopted, or an
        identical prompt retired first) is simply released.  Every
        remaining block (partial prompt tail, generation budget) is
        released outright.  Exactly one reference leaves the lane for
        every block either way: the refcount ledger stays balanced.
        """
        cacheable_blocks = min(int(cacheable_blocks), len(blocks))
        stamp = self._tick()
        to_release = list(blocks[cacheable_blocks:])
        children = self._children
        parent = None
        for i, key in enumerate(self._blocks_of(prompt_row,
                                                cacheable_blocks)):
            block = blocks[i]
            node = children.get(key)
            if node is None:
                # new chain entry: the lane's reference TRANSFERS to the
                # cache (no release — the cache now keeps the block warm)
                node = _Node(key, block, parent)
                children[key] = node
                self._nodes += 1
                self.inserted += 1
            else:
                # chain node already holds this content (the lane adopted
                # it, or an identical prompt retired first): the cache has
                # its own reference, so the lane's reference drops —
                # whether ``block`` is the shared block or a duplicate
                # computation of the same tokens
                to_release.append(block)
            node.stamp = stamp
            parent = node
            children = node.children
        self._gauge()
        self.pool.release(to_release)

    # -- pressure ----------------------------------------------------------

    def evict(self, n_blocks):
        """Free at least ``n_blocks`` pool blocks by dropping LRU leaf
        nodes nobody else references.  Returns the number actually
        freed (0 when every cached block is pinned by an active lane).

        Leaves-first keeps chains rooted: evicting an interior node
        would orphan its suffix, which no future walk could reach.  One
        DFS collects the evictable leaves into an LRU heap; a parent
        whose last child is evicted is promoted onto it — O(N log N)
        per call instead of one full-trie rescan per freed block (the
        caller holds the engine's _cv, so a rescan per block would
        stall every decode tick while backpressured).
        """
        n_blocks = int(n_blocks)
        if n_blocks <= 0 or not self._children:
            return 0
        heap = []
        seq = 0  # tie-break: nodes never compare
        stack = list(self._children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            elif self.pool.ref_count(node.block) == 1:
                heapq.heappush(heap, (node.stamp, seq, node))
                seq += 1
        released = []
        while len(released) < n_blocks and heap:
            _, _, victim = heapq.heappop(heap)
            siblings = (
                victim.parent.children if victim.parent is not None
                else self._children
            )
            del siblings[victim.tokens]
            self._nodes -= 1
            self.evictions += 1
            self._count("ctpu_lm_prefix_evictions_total")
            released.append(victim.block)
            parent = victim.parent
            if (parent is not None and not parent.children
                    and self.pool.ref_count(parent.block) == 1):
                heapq.heappush(heap, (parent.stamp, seq, parent))
                seq += 1
        self.pool.release(released)
        if released:
            self._gauge()
        return len(released)

    def clear(self):
        """Drop every cached block (engine shutdown): the pool must end
        fully free so close() leaves no leaked references behind."""
        blocks = []
        stack = list(self._children.values())
        while stack:
            node = stack.pop()
            blocks.append(node.block)
            stack.extend(node.children.values())
        self._children = {}
        self._nodes = 0
        self._gauge()
        self.pool.release(blocks)

    # -- introspection -----------------------------------------------------

    @property
    def cached_blocks(self):
        return self._nodes

    def stats(self):
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "inserted": self.inserted,
            "cached_blocks": self._nodes,
        }
