"""Continuous-batching LM engine: bucketed chunked prefill over a paged
KV pool, prefix-cache block sharing, priority preemption with host-side
swap, lane autoscaling, per-lane sampling, tenant-aware admission.

The port's counterpart of client_tpu/serve/lm/engine.py.  The scheduler
(admission, tenant quotas, autoscaling, chunked prefill interleaved with
decode, prefix adoption and give-back, preemption through the swap and
recompute paths, speculative verify, readback pipelining, tick logs and
profiler phases) is the JAX package's, with its lock discipline: every
device dispatch happens outside ``_cv``.  What differs:

- the device programs (``_decode_tick``, ``_verify_tick``,
  ``_prefill_chunk``) are PyTorch functions; every step's attention is the
  paged-attention kernel (client_tpu_torch.ops.paged_attention) and every
  int8 projection the dequant-matmul kernel, through the same ``_mm``
  dispatch.  Their inputs are device values, as in JAX's traced
  programs: nothing in them reads a device value on the host or branches
  on one;
- the counterpart of the JAX engine's per-shape ``jax.jit`` executables
  is a :class:`_Program` per static shape (decode by lane count, verify by
  (lanes, width), prefill by chunk width), each with static input buffers
  its host arrays reach through one pinned buffer and one ``copy_`` a
  tick.  On a CUDA device every program is captured as a CUDA graph when
  the engine starts (before it serves, one capture at a time in the
  process, all graphs in one memory pool) and every tick replays one; a
  failed capture raises from the ``submit`` that started the engine, and
  nothing runs the programs eagerly on the card.  On the CPU the same
  programs run eagerly through the same buffers.  ``_adopt`` is an
  in-place write into the lane buffers;
- the KV pools are written IN PLACE (``index_put_``) and the programs
  return nothing for them: that takes the place of the JAX engine's
  buffer donation.  The lane token and RNG tensors are written in place
  too, by the decode and verify programs and by ``_adopt``, and the
  programs write their other outputs (verify's ``[2, n]``, prefill's
  token and RNG carry) into buffers allocated before capture, outside the
  graphs' memory pool;
- ONE STREAM, IN ORDER: every device operation of the engine (the
  static-input copy, each replay, each readback's device-to-host copy,
  ``_adopt``, the swap-out read and the swap-in write) is issued from the
  scheduler thread on its current stream.  So a readback of a buffer a
  program writes (the lane tokens, verify's result, prefill's token) is
  queued before the next replay that overwrites it, a static input is
  rewritten only after the replay that read it, and the recycling-safety
  argument below, which rests on dispatch order, holds;
- per-lane sampling uses a counter-based generator of the port's own
  (``_uniforms``): a lane's state is (seed, draw counter), and its stream
  depends only on those, not on its slot or the lanes beside it.  It is
  not JAX's threefry stream, so seeded temperature streams differ from the
  JAX engine's; greedy streams do not;
- "executables" count the programs built (captured graphs on CUDA):
  every static shape, at most ``len(lane_counts)`` decode,
  ``len(verify_widths) * len(lane_counts)`` verify and ``len(buckets)``
  prefill programs;
- the fleet prefix tier (serve/fleet.py) is the JAX engine's: a peer
  lookup on the submit caller's thread with no lock held, the fetched
  tail installed by the first prefill step, prefill completion exported
  into the tier's host store, and drain migrating parked streams.  The
  install writes the fetched blocks into the pool IN PLACE, on the
  scheduler thread's stream, before that chunk's replay: the captured
  graphs read the pool at the addresses they recorded, so a rebind (the
  JAX engine's ``pool.at[idx].set``) would leave them reading the old
  tensors.  The export reads the blocks back to the host (``.cpu()``)
  on the scheduler thread, as a swap-out does;
- a stream may bound how far it runs ahead of its reader
  (``submit(window=N)``; the served runner's streams do): once N tokens
  wait unread in its queue, the lane's further tokens are held on the
  host and the lane leaves the ticks (its next input token and RNG are
  saved on the device before a tick that leaves it out, and put back
  when it returns) until the reader reads on.  A network stream whose
  frontend stalls then costs at most N + ``readback_depth`` ticks, and a
  cancel drops what was held.  The JAX engine streams every token at
  once.

Scheduling model (one scheduler thread, every device dispatch outside
the condition lock):

Each scheduler pass runs AT MOST one prefill chunk and then one decode
tick.  That 1:1 interleave is the head-of-line fix: a novel max-length
prompt used to run its whole prefill between decode ticks, stalling
every active token stream; now the stall per pass is bounded by one
fixed-width chunk whose shape comes from a small geometric bucket set
(``policy.chunk_plan``), so the dispatched shape set is bounded too.

Static shapes everywhere:

- decode ticks run at one of a few lane counts (``lane_counts``),
  stepped by :class:`policy.LaneAutoscaler` on sustained queue depth;
- the KV cache is a paged block pool (:class:`kv.KvBlockPool`): per-lane
  block tables map the logical cache inside the device programs, and
  the new token's K/V scatters to ``(table[pos // bs], pos % bs)``.
  Idle lanes and write-masked pad positions scatter to the reserved
  trash block, which the length mask guarantees is never read;
- sampling happens inside the tick with per-lane RNG state,
  temperatures and top-k — greedy lanes (temperature 0) take the
  on-device argmax, so mixed greedy/sampled batches share one program.

Prefix cache (serve/lm/prefix.py): admission walks the prompt's full
token blocks through a radix trie and ADOPTS every cached match by
reference (per-block refcounts in kv.py), so chunked prefill starts at
the first miss; retiring requests hand their full prompt blocks to the
cache instead of freeing them, and the cache yields blocks back (LRU,
leaves first) only under pool pressure.

Preemption: when the pool is exhausted and a strictly higher-priority
tenant (the ``tenant_priority`` hook) is waiting, the lowest-priority
active lane is swapped out — its written KV blocks copied to a bounded
host-side store (or, past the swap budget, dropped for recompute), its
stream PAUSED (no CLOSE, no error) — and swapped back in once blocks
free up, byte-exact with an unpreempted run on the swap path.

Safety of block recycling: device dispatches from the scheduler thread
execute in dispatch order on one stream, so a stale in-flight tick's
scatter into a freed block always lands before the block's next owner
writes (and every position the next owner ever *reads* is one its own
later dispatches wrote).  Cached blocks extend the argument: no program
ever WRITES a cached block — decode writes at ``pos >= prompt_len`` and
prefill writes at ``pos >= adopted_start``, both past the full-prompt-
block region the cache holds — so adopting one is a pure read of
content whose producing dispatch already ordered before the adopter's.
"""

import functools
import itertools
import queue
import threading
import time
from collections import OrderedDict, deque

import numpy as np
import torch

from client_tpu_torch import ops, resolve_device
from client_tpu_torch.serve.lm.kv import KvBlockPool
from client_tpu_torch.serve.lm.policy import (
    LaneAutoscaler,
    bucket_for,
    chunk_plan,
    geometric_buckets,
    pad_prompt,
    verify_widths,
)
from client_tpu_torch.serve.lm.prefix import PrefixCache
from client_tpu_torch.serve.lm.spec import LaneSpec, SpecConfig
from client_tpu_torch.serve.metrics import (
    FLEET_HELP,
    LM_PREFIX_HELP,
    LM_SPEC_HELP,
)
from client_tpu_torch.serve.models.transformer import (
    _ffn_block,
    _mm,
    _readback_values,
    _rms_norm,
    _rope,
    _start_readback,
    lm_flops_per_token,
    paged_attention,
)
from client_tpu_torch.serve.prof import NULL_TICK, PhaseProfiler

# sentinel object closing a stream's token queue
_CLOSE = object()

# placed-marker for a handle cancelled while its prefill job was in
# flight (chunks dispatch outside _cv); the job step sees it, frees the
# reservation and closes the queue
_CANCELLED = object()

# static cap for the per-lane top-k filter (per-lane k is dynamic below it)
_TOPK_CAP = 64

_LANE_HELP = {
    "ctpu_lm_lanes": "Configured decode lane count (autoscaled)",
    "ctpu_lm_active_lanes": "Decode lanes currently streaming",
}

# -- per-lane counter-based random numbers ---------------------------------
#
# A lane's RNG state is a row (seed, counter) of an int64 device tensor;
# every draw event (one prefill chunk, decode tick or verify tick) reads
# uniforms at (seed, counter, index) and advances the counter by one.  The
# hash works on 32-bit values held in int64: every multiplier is below
# 2**31, so a product stays below 2**63, and each is masked back to 32
# bits (nothing relies on int64 overflow).

_M32 = 0xFFFFFFFF


def _mix32(x):
    """A bijective integer hash of 32-bit values (xorshift-multiply)."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x31848BAB) & _M32
    return x ^ (x >> 16)


def _seed32(seed):
    """A request's integer seed folded to 32 bits (host side)."""
    seed = int(seed) & ((1 << 64) - 1)
    return (seed ^ (seed >> 32)) & _M32


def _uniforms(rng, index):
    """Uniforms in (0, 1), f32, ``[n, len(index)]``: lane ``i``'s draw at
    (seed, counter) = ``rng[i]`` for each integer in ``index``."""
    lane = _mix32(_mix32(rng[:, 0] & _M32) ^ (rng[:, 1] & _M32))
    h = _mix32(lane[:, None] ^ index[None, :])
    return ((h >> 8).float() + 0.5) * (2.0 ** -24)


def _gumbel(rng, vocab, device):
    u = _uniforms(rng, torch.arange(vocab, device=device))
    return -torch.log(-torch.log(u))


def _topk_keep(logits, top_k):
    """The per-lane top-k filter: keep logits >= the lane's k-th largest
    (all of them for top_k <= 0).  ``logits [n, ..., V]``, ``top_k [n]``."""
    vocab = logits.shape[-1]
    kmax = min(_TOPK_CAP, vocab)
    vals = torch.topk(logits, kmax, dim=-1).values
    extra = (1,) * (logits.dim() - 1)
    kth = (top_k - 1).clamp(0, kmax - 1).long().reshape(-1, *extra)
    thresh = torch.gather(vals, -1, kth.expand(*vals.shape[:-1], 1))
    off = (top_k <= 0).reshape(-1, *extra)
    return off | (logits >= thresh)


def _select_token(logits, rng, temperature, top_k):
    """Each lane's token choice on device (``logits [n, V]`` f32): argmax
    when its temperature is 0, else a temperature softmax draw over the
    top-k filtered logits (Gumbel-max with the lane's own uniforms).

    ``torch.argmax`` returns the FIRST maximal index, as ``jnp.argmax``
    does: greedy parity with the JAX engine at exact ties rests on it."""
    greedy = torch.argmax(logits, dim=-1)
    keep = _topk_keep(logits, top_k)
    filtered = torch.where(keep, logits, float("-inf"))
    scaled = filtered / temperature.clamp_min(1e-6)[:, None]
    sampled = torch.argmax(
        scaled + _gumbel(rng, logits.shape[-1], logits.device), dim=-1
    )
    return torch.where(temperature > 0.0, sampled, greedy).to(torch.int32)


def _advance(rng_full, n):
    """The lane RNG tensor after one draw by the first ``n`` lanes."""
    out = rng_full.clone()
    out[:n, 1] += 1
    return out


def _write_kv(pools, i, blk, slot, k, v):
    """Scatter this step's K/V into layer ``i``'s pools, in place."""
    pools["k"][i][blk, slot] = k
    pools["v"][i][blk, slot] = v


@torch.no_grad()
def _decode_tick(params, tokens_full, pools, tables, lens, temps, topks,
                 rng_full, *, cfg, n, block_size):
    """One batched decode step over the first ``n`` lanes (n is static:
    one shape per configured lane count).  Writes this step's K/V into
    ``pools`` in place; returns ``(tokens_out, rng_out)``."""
    tok = tokens_full[:n]
    x = params["embed"][tok.long()][:, None, :]  # [n,1,D]
    pos = lens  # [n] int32
    hd = cfg.head_dim
    lane = torch.arange(n, device=x.device)
    blk = tables[lane, (pos // block_size).long()].long()  # [n]
    slot = (pos % block_size).long()
    for i, layer in enumerate(params["layers"]):
        h = _rms_norm(x, layer["ln_attn"])
        q = _mm(h, layer["attn"]["wq"]).reshape(n, 1, cfg.n_heads, hd)
        k = _mm(h, layer["attn"]["wk"]).reshape(n, 1, cfg.n_kv_heads, hd)
        v = _mm(h, layer["attn"]["wv"]).reshape(n, 1, cfg.n_kv_heads, hd)
        q = _rope(q, pos[:, None], cfg.rope_theta)
        k = _rope(k, pos[:, None], cfg.rope_theta)
        _write_kv(pools, i, blk, slot, k[:, 0], v[:, 0])
        attn = paged_attention(
            q, pools["k"][i], pools["v"][i], tables, pos[:, None], cfg,
            block_size,
        )
        out = _mm(attn.reshape(n, 1, cfg.n_heads * hd), layer["attn"]["wo"])
        x = x + out.to(x.dtype)
        x, _ = _ffn_block(layer, x, cfg, with_aux=False)
    x = _rms_norm(x, params["ln_f"])
    logits = _mm(x[:, 0], params["lm_head"]).float()  # [n,V]
    nxt = _select_token(logits, rng_full[:n], temps, topks)
    tokens_out = tokens_full.clone()
    tokens_out[:n] = nxt
    return tokens_out, _advance(rng_full, n)


def _accept_lanes(logits, props, counts, temps, topks, rng, *, width):
    """Every lane's speculative acceptance rule on device.

    ``logits`` [n, w, V] are the target model's scores at positions
    ``length .. length + w - 1`` (position j scores the token FOLLOWING
    ``seq[j]``), ``props`` [n, w - 1] the drafted tokens (``props[:, j]``
    is the proposal for what position j generates), ``counts`` how many
    are real, ``rng`` [n, 2] the lanes' RNG state for this tick.

    Greedy lanes (temperature 0) accept a draft iff it equals the
    argmax — the accepted prefix + the argmax correction reconstructs
    plain greedy decode byte-exactly.  Temperature lanes run rejection
    sampling for a point-mass proposal: accept draft ``x`` with
    probability ``p(x)`` under the lane's filtered/tempered target
    distribution (the exact `_select_token` distribution), and on
    rejection sample the correction from the residual (``p`` with
    ``x``'s mass removed, renormalized) — the delivered tokens are an
    exact draw from the target distribution.  When every draft is
    accepted the correction is a free "bonus" sample from the last
    position's full distribution.  The acceptance uniforms and the
    correction's Gumbel noise are the lane's draws at disjoint indices
    of one (seed, counter).

    Returns (n_accepted [n], correction_token [n]).
    """
    n, w, vocab = logits.shape
    dev = logits.device
    greedy = torch.argmax(logits, dim=-1)  # [n,w]
    keep = _topk_keep(logits, topks)
    scaled = (torch.where(keep, logits, float("-inf"))
              / temps.clamp_min(1e-6)[:, None, None])
    probs = torch.softmax(scaled, dim=-1)  # [n,w,V] target distribution
    j = torch.arange(w - 1, device=dev)
    p_draft = torch.gather(probs[:, :w - 1], 2, props.long()[:, :, None])[..., 0]
    u = _uniforms(rng, vocab + j)  # [n, w-1]
    sampling = (temps > 0.0)[:, None]
    accept = torch.where(sampling, u < p_draft, props == greedy[:, :w - 1])
    # longest accepted prefix of the REAL drafts (cumprod stops at the
    # first rejection; padding past ``count`` never counts)
    real = j[None, :] < counts[:, None]
    chain = torch.cumprod((real & accept).to(torch.int32), dim=1)
    n_acc = chain.sum(dim=1).to(torch.int32)
    rejected = n_acc < counts
    rej_tok = torch.gather(
        props, 1, n_acc.clamp(max=w - 2).long()[:, None]
    )[:, 0]
    at = n_acc.long()[:, None, None].expand(n, 1, vocab)
    scaled_at = torch.gather(scaled, 1, at)[:, 0]  # [n,V]
    vocab_ids = torch.arange(vocab, device=dev)
    corr_scaled = torch.where(
        rejected[:, None] & (vocab_ids[None, :] == rej_tok[:, None]),
        float("-inf"), scaled_at,
    )
    sampled = torch.argmax(corr_scaled + _gumbel(rng, vocab, dev), dim=-1)
    greedy_at = torch.gather(greedy, 1, n_acc.long()[:, None])[:, 0]
    corr = torch.where(temps > 0.0, sampled, greedy_at)
    return n_acc, corr.to(torch.int32)


@torch.no_grad()
def _verify_tick(params, tokens_full, pools, tables, lens, temps, topks,
                 rng_full, props, counts, *, cfg, n, width, block_size):
    """One speculative verify step over the first ``n`` lanes: embed the
    pending input token plus up to ``width - 1`` drafted tokens per lane
    and score all of them in ONE multi-position paged-attention pass
    (``paged_attention`` already handles [n, T] query positions — this
    is ``_decode_tick`` generalized from T = 1 to T = width).

    K/V for every drafted position scatters into the lane's own block
    reservation as it is computed (position ``lens + j`` attends only
    positions ``<= lens + j``, all of which this tick or history wrote),
    so accepted positions need no second write.  Positions past the
    lane's draft count write to the trash block (the prefill padding
    trick); positions past the ACCEPTED prefix hold garbage the length
    mask never reads — the host advances ``lane.length`` only to the
    accepted end, and the next tick overwrites from there.  Rejection
    therefore "rewinds" by pointer arithmetic alone: no block ever
    leaves the lane's reservation, so nothing can leak.

    Returns ``(out, tokens_out, rng_out)`` where ``out`` is ``[2, n]``
    (accepted count, correction token) — one host readback for the whole
    tick.  ``n`` and ``width`` are static: the dispatched shapes stay
    ``<= len(verify_widths) * len(lane_counts)``.
    """
    w = width
    dev = tokens_full.device
    seq = torch.cat([tokens_full[:n, None], props], dim=1)  # [n,w]
    x = params["embed"][seq.long()]  # [n,w,D]
    steps = torch.arange(w, dtype=torch.int32, device=dev)
    pos = lens[:, None] + steps[None, :]  # [n,w] int32
    writable = steps[None, :] <= counts[:, None]
    hd = cfg.head_dim
    col = torch.clamp(pos // block_size, max=tables.shape[1] - 1)
    blk = torch.where(
        writable, torch.gather(tables, 1, col.long()),
        KvBlockPool.TRASH,
    ).long()
    slot = (pos % block_size).long()
    for i, layer in enumerate(params["layers"]):
        h = _rms_norm(x, layer["ln_attn"])
        q = _mm(h, layer["attn"]["wq"]).reshape(n, w, cfg.n_heads, hd)
        k = _mm(h, layer["attn"]["wk"]).reshape(n, w, cfg.n_kv_heads, hd)
        v = _mm(h, layer["attn"]["wv"]).reshape(n, w, cfg.n_kv_heads, hd)
        q = _rope(q, pos, cfg.rope_theta)
        k = _rope(k, pos, cfg.rope_theta)
        _write_kv(pools, i, blk, slot, k, v)
        attn = paged_attention(
            q, pools["k"][i], pools["v"][i], tables, pos, cfg, block_size
        )
        out = _mm(attn.reshape(n, w, cfg.n_heads * hd), layer["attn"]["wo"])
        x = x + out.to(x.dtype)
        x, _ = _ffn_block(layer, x, cfg, with_aux=False)
    x = _rms_norm(x, params["ln_f"])
    logits = _mm(x, params["lm_head"]).float()  # [n,w,V]
    n_acc, corr = _accept_lanes(
        logits, props, counts, temps, topks, rng_full[:n], width=w
    )
    tokens_out = tokens_full.clone()
    tokens_out[:n] = corr
    out = torch.stack([n_acc, corr])  # [2, n]: one readback per tick
    return out, tokens_out, _advance(rng_full, n)


@torch.no_grad()
def _prefill_chunk(params, chunk, pools, table, start, prompt_len, rng,
                   temperature, top_k, *, cfg, block_size):
    """One prefill chunk ([1, C] tokens at logical positions
    start..start+C-1) written straight into the paged pool, in place.

    Positions >= prompt_len (bucket padding) write to the trash block
    and are never attended (the length mask), so padding is inert.  The
    returned token is the sampled/greedy first generation token — only
    the FINAL chunk's return is meaningful (its chunk contains position
    prompt_len - 1).  ``start`` and ``prompt_len`` are 0-d int32 tensors
    (device values, as the JAX engine traces them), so one program serves
    every chunk of a width.  ``rng`` is the lane's [2] (seed, counter);
    returns ``(token [1] int32, rng_carry [2])``."""
    c = chunk.shape[1]
    dev = chunk.device
    x = params["embed"][chunk.long()]  # [1,C,D]
    pos = start + torch.arange(c, dtype=torch.int32, device=dev)  # [C]
    writable = pos < prompt_len
    hd = cfg.head_dim
    # a padded position past the table reads its last entry (as JAX's
    # clamped gather does) and is routed to the trash block anyway
    col = torch.clamp(pos // block_size, max=table.shape[0] - 1)
    blk = torch.where(writable, table[col.long()], KvBlockPool.TRASH).long()
    slot = (pos % block_size).long()
    for i, layer in enumerate(params["layers"]):
        h = _rms_norm(x, layer["ln_attn"])
        q = _mm(h, layer["attn"]["wq"]).reshape(1, c, cfg.n_heads, hd)
        k = _mm(h, layer["attn"]["wk"]).reshape(1, c, cfg.n_kv_heads, hd)
        v = _mm(h, layer["attn"]["wv"]).reshape(1, c, cfg.n_kv_heads, hd)
        q = _rope(q, pos[None, :], cfg.rope_theta)
        k = _rope(k, pos[None, :], cfg.rope_theta)
        _write_kv(pools, i, blk, slot, k[0], v[0])
        attn = paged_attention(
            q, pools["k"][i], pools["v"][i], table[None], pos[None], cfg,
            block_size,
        )
        out = _mm(attn.reshape(1, c, cfg.n_heads * hd), layer["attn"]["wo"])
        x = x + out.to(x.dtype)
        x, _ = _ffn_block(layer, x, cfg, with_aux=False)
    x = _rms_norm(x, params["ln_f"])
    # the row of position prompt_len - 1, clipped into the chunk (JAX's
    # jnp.clip then take), picked on the device
    last = torch.clamp(prompt_len - 1 - start, 0, c - 1)
    xsel = torch.index_select(x, 1, last.reshape(1).long())  # [1,1,D]
    logits = _mm(xsel[:, 0], params["lm_head"]).float()  # [1,V]
    tok = _select_token(logits, rng[None], temperature, top_k)
    carry = rng.clone()
    carry[1] += 1
    return tok, carry


def _to_device(arr, device):
    """A host array as a tensor on *device*.  On a CUDA device the copy goes
    through pinned memory and does not block the host, so dispatch keeps
    running ahead of the device (the caching host allocator holds the
    pinned buffer until its copy is done)."""
    host = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


# -- the device programs at their static shapes ------------------------------
#
# Each body runs one program on its static inputs (``feeds``) and writes
# its results into the buffers of ``state`` in place: the lane token and
# RNG tensors, the KV pools, and its own outputs.

@torch.no_grad()
def _decode_body(params, feeds, state, *, cfg, n, block_size):
    tokens, keys = _decode_tick(
        params, state["tokens"], state["pools"], feeds["tables"],
        feeds["lens"], feeds["temps"], feeds["topks"], state["keys"],
        cfg=cfg, n=n, block_size=block_size,
    )
    state["tokens"].copy_(tokens)
    state["keys"].copy_(keys)


@torch.no_grad()
def _verify_body(params, feeds, state, *, cfg, n, width, block_size):
    out, tokens, keys = _verify_tick(
        params, state["tokens"], state["pools"], feeds["tables"],
        feeds["lens"], feeds["temps"], feeds["topks"], state["keys"],
        feeds["props"], feeds["counts"], cfg=cfg, n=n, width=width,
        block_size=block_size,
    )
    state["out"].copy_(out)
    state["tokens"].copy_(tokens)
    state["keys"].copy_(keys)


@torch.no_grad()
def _prefill_body(params, feeds, state, *, cfg, block_size):
    tok, carry = _prefill_chunk(
        params, feeds["chunk"], state["pools"], feeds["table"],
        feeds["start"], feeds["prompt_len"], feeds["key"],
        feeds["temperature"], feeds["top_k"], cfg=cfg,
        block_size=block_size,
    )
    state["tok"].copy_(tok)
    state["carry"].copy_(carry)


def _lane_feeds(n, table_width):
    return [("tables", (n, table_width), np.int32), ("lens", (n,), np.int32),
            ("temps", (n,), np.float32), ("topks", (n,), np.int32)]


def _prefill_feeds(width, table_width):
    return [("chunk", (1, width), np.int32),
            ("table", (table_width,), np.int32),
            ("start", (), np.int32), ("prompt_len", (), np.int32),
            ("key", (2,), np.int64), ("temperature", (1,), np.float32),
            ("top_k", (1,), np.int32)]


_TORCH_DTYPES = {np.dtype(np.int32): torch.int32,
                 np.dtype(np.int64): torch.int64,
                 np.dtype(np.float32): torch.float32}

class _Program:
    """One device program at one static shape: the port's counterpart of
    one ``jax.jit`` executable of the JAX engine.

    ``body(feeds, state)`` runs it.  ``feeds`` are its host-fed inputs,
    ``spec`` ``(name, shape, numpy dtype)``, as views of ONE device buffer
    allocated here; ``state`` holds the device buffers it reads and writes
    in place, all allocated before any capture.  ``program(values)`` packs
    the host arrays ``values`` (by name) into one host buffer, pinned on
    CUDA (the caching host allocator keeps it until its copy ran), makes
    one ``copy_`` into the feeds, and runs the program: by replaying the
    CUDA graph ``capture`` recorded, counting the launches the capture
    recorded (``ops.count_replay``), or on the CPU by calling ``body``."""

    def __init__(self, body, spec, state, device):
        self.body = body
        self.state = state
        self.device = device
        self._fields = []
        size = 0
        for name, shape, dtype in spec:
            dtype = np.dtype(dtype)
            nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            self._fields.append((name, tuple(shape), dtype, size, nbytes))
            size += -(-nbytes // 8) * 8  # every field 8-byte aligned
        self._buf = torch.zeros((size,), dtype=torch.uint8, device=device)
        self.feeds = {
            name: self._buf[off:off + nbytes].view(_TORCH_DTYPES[dtype])
            .view(shape)
            for name, shape, dtype, off, nbytes in self._fields
        }
        self.graph = None
        self.launches = {}  # {(kernel, route): launches} of one replay

    def __call__(self, values):
        self.feed(values)
        self.run()

    def feed(self, values):
        """Pack ``values`` into the static inputs with one copy."""
        cuda = self.device.type == "cuda"
        host = (torch.empty(self._buf.shape, dtype=torch.uint8,
                            pin_memory=True) if cuda else self._buf)
        raw = host.numpy()
        for name, shape, dtype, off, nbytes in self._fields:
            raw[off:off + nbytes].view(dtype).reshape(shape)[...] = (
                values[name])
        if cuda:
            self._buf.copy_(host, non_blocking=True)

    def run(self):
        if self.graph is None:
            self.body(self.feeds, self.state)
            return
        self.graph.replay()
        ops.count_replay(self.launches)

    def capture(self, pool, stream):
        """Record the program as a CUDA graph in ``pool`` on ``stream``.

        A warm-up run comes first (the kernels' lazy set-up: cuBLAS's
        handle and workspace for ``stream``, the allocator's blocks), on
        zeroed feeds, which send every K/V write to the trash block
        (``KvBlockPool.TRASH`` is 0; prefill at ``prompt_len`` 0 writes no
        position), and on scratch copies of every state buffer but the
        pools: it changes no live row.  The capture itself runs nothing.
        The warm-up's launches count nowhere; the capture's are recorded
        and counted at each replay."""
        self._buf.zero_()
        scratch = {name: buf if name == "pools" else buf.clone()
                   for name, buf in self.state.items()}
        captured = ops.capture_graph(
            lambda: self.body(self.feeds, self.state),
            lambda: self.body(self.feeds, scratch), pool, stream)
        self.graph, self.launches = captured.graph, captured.launches


class _Lane:
    __slots__ = ("gen", "active", "queue", "remaining", "produced",
                 "length", "limit", "tenant", "temperature", "top_k",
                 "table", "blocks", "prompt", "tokens", "handle", "spec",
                 "held", "parked")

    def __init__(self, table_width):
        self.gen = 0        # bumped on every (re)assignment and cancel
        self.active = False
        self.queue = None
        self.remaining = 0
        self.produced = 0
        self.length = 0     # logical sequence length (next write position)
        self.limit = 0      # prompt_len + max_tokens: last writable pos + 1
        self.tenant = ""
        self.temperature = 0.0
        self.top_k = 0
        self.table = np.zeros((table_width,), np.int32)  # trash-filled
        self.blocks = None  # reservation owned while active
        self.prompt = None  # [1, T] prompt row (prefix-cache insertion)
        self.tokens = []    # delivered generation tokens (recompute replay)
        self.handle = None  # the submit() handle streaming on this lane
        self.spec = None    # LaneSpec when speculative decoding is on
        self.held = []      # decoded tokens its windowed reader has no room for
        # (gen, next input token, RNG) saved on the device while the lane
        # sits out the ticks; the scheduler thread alone writes it
        self.parked = None


class _Handle:
    """Opaque submit() handle; ``placed`` is None (pending / mid-prefill),
    _CANCELLED, or (slot, gen) once streaming."""

    __slots__ = ("prompt", "prompt_len", "max_tokens", "queue", "tenant",
                 "temperature", "top_k", "seed", "placed", "remote_kv",
                 "window", "arrival")

    def __init__(self, prompt, max_tokens, q, tenant, temperature, top_k,
                 seed, window=0, arrival=0):
        self.window = int(window)  # 0: every token streams at once
        self.arrival = arrival  # the submit's place in arrival order
        self.prompt = prompt
        self.prompt_len = int(prompt.shape[1])
        self.max_tokens = int(max_tokens)
        self.queue = q
        self.tenant = tenant
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)
        self.placed = None
        # (covered_blocks, host_k, host_v, start) fetched from the fleet
        # prefix tier on the submit caller's thread (never under _cv);
        # _admit adopts whatever still beats the local trie at admission
        self.remote_kv = None


class _LaneQueue(queue.Queue):
    """A windowed stream's token queue: every read sets the engine's wake
    event, so a lane holding tokens for this reader streams them at
    once."""

    def __init__(self, wake):
        super().__init__()
        self._wake_event = wake

    def _get(self):
        item = super()._get()
        self._wake_event.set()
        return item


class _PrefillJob:
    __slots__ = ("handle", "slot", "blocks", "table", "plan", "chunk_idx",
                 "resume", "remote")

    def __init__(self, handle, slot, blocks, table, plan):
        self.handle = handle
        self.slot = slot
        self.blocks = blocks
        self.table = table
        self.plan = plan
        self.chunk_idx = 0
        # _Swapped being resumed via the recompute path (None for normal
        # admissions): activation restores its produced/remaining state
        # and the saved token/RNG carry instead of the chunk's sample
        self.resume = None
        # [lo, hi, host_k, host_v, rstart]: fleet-fetched KV content
        # destined for blocks[lo:hi]; installed by the FIRST _prefill_step
        # (outside _cv), cleared once on device — abort before install
        # must not cache those blocks as valid content
        self.remote = None


class _Swapped:
    """One preempted stream parked off-device.

    ``host_k``/``host_v`` hold the lane's written blocks per layer (CPU
    tensors) when the swap fit the host budget; None means the recompute path (replay
    prompt + delivered tokens through chunked prefill on resume).  The
    stream's queue is PAUSED — no CLOSE, no error — until resume or
    cancel."""

    __slots__ = ("handle", "queue", "tenant", "prompt", "prompt_len",
                 "produced", "remaining", "length", "limit", "temperature",
                 "top_k", "tokens", "token", "key", "host_k", "host_v",
                 "n_blocks", "written_blocks", "cancelled", "t_swap")

    def __init__(self, lane, n_blocks, written_blocks, token, key,
                 host_k, host_v):
        self.handle = lane.handle
        self.queue = lane.queue
        self.tenant = lane.tenant
        self.prompt = lane.prompt
        self.prompt_len = int(lane.prompt.shape[1])
        self.produced = lane.produced
        self.remaining = lane.remaining
        self.length = lane.length
        self.limit = lane.limit
        self.temperature = lane.temperature
        self.top_k = lane.top_k
        self.tokens = list(lane.tokens)
        self.token = token          # input token for the next decode tick
        self.key = key              # RNG (seed, counter) at preemption
        self.host_k = host_k
        self.host_v = host_v
        self.n_blocks = int(n_blocks)
        self.written_blocks = int(written_blocks)
        self.cancelled = False
        self.t_swap = time.monotonic()


class LmEngine:
    """Continuous-batching decode engine (submit/cancel/close surface
    compatible with the old ContinuousLmScheduler).

    ``submit(prompt_tokens, max_tokens, temperature=0, top_k=0, seed=0,
    tenant="")`` returns ``(queue, handle)``; the queue yields int token
    ids and finally :data:`CLOSE`.  ``cancel(handle)`` releases a stream
    early.  Device state (KV pool, lane arrays, scheduler thread)
    allocates lazily on the first submit so an idle engine pins no HBM.

    ``device`` is where the KV pool and lane tensors live (``cuda``
    unless the caller passes ``device="cpu"``); ``params`` must be there.
    """

    CLOSE = _CLOSE

    def __init__(self, params, cfg, max_slots=8, lane_counts=None,
                 block_size=16, pool_tokens=None, prefill_chunk=None,
                 min_bucket=16, readback_depth=8, eos_id=None,
                 check_prompt=None, registry=None, tracer=None,
                 tenant_lane_share=0.75, scale_up_after=3,
                 scale_down_after=50, tick_log_len=8192,
                 prefix_cache=True, min_prefix_blocks=1,
                 tenant_priority=None, swap_block_limit=None, fleet=None,
                 speculative=None, device=None):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.max_slots = int(max_slots)
        if lane_counts is None:
            lane_counts = sorted({
                max(1, self.max_slots // 4),
                max(1, self.max_slots // 2),
                self.max_slots,
            })
        self.lane_counts = tuple(sorted(set(int(c) for c in lane_counts)))
        if self.lane_counts[-1] != self.max_slots:
            raise ValueError("largest lane count must equal max_slots")
        self.depth = max(int(readback_depth), 0)
        self.eos_id = eos_id
        self.check_prompt = check_prompt  # optional prompt validator
        self.registry = registry
        self.tracer = tracer
        # flight recorder (bound by the model binder): preemptions and a
        # wedged scheduler loop land in the server's postmortem ring — a
        # wedge also dumps it automatically
        self.flight = None
        self.tenant_lane_share = tenant_lane_share
        self.block_size = int(block_size)
        chunk = int(prefill_chunk or min(64, cfg.max_seq))
        self.buckets = geometric_buckets(
            min(min_bucket, chunk), min(chunk, cfg.max_seq)
        )
        self._table_width = -(-cfg.max_seq // self.block_size)
        self._pool_tokens = int(pool_tokens or self.max_slots * cfg.max_seq)

        self._cv = threading.Condition()
        # set by a windowed stream's read (and by submit and close): the
        # scheduler waits on it while every lane it could tick holds
        # tokens for a reader that has not read them
        self._wake_event = threading.Event()
        self._closed = False
        self._lanes = [
            _Lane(self._table_width) for _ in range(self.max_slots)
        ]
        self._pending = OrderedDict()  # tenant -> deque[_Handle]
        self._arrivals = itertools.count()  # submit order, before any wait
        self._rr = 0                   # round-robin cursor over tenants
        self._job = None
        self._scaler = LaneAutoscaler(
            self.lane_counts, up_after=scale_up_after,
            down_after=scale_down_after,
        )
        self._tick_log = deque(maxlen=int(tick_log_len))
        self._inflight = deque()
        self._thread = None  # started lazily on the first submit
        self._starting = False  # a submit is building the programs

        # continuous profiler (serve/prof.py): each scheduler pass is one
        # tick with schedule/dispatch/device-wait/delivery phase spans;
        # the model binder rebinds the registry and adopts this profiler
        # into the server's, so /v2/debug/prof and flight dumps cover
        # the LM engine too.  _ptick is the scheduler thread's current
        # tick — only that thread ever touches it.
        self.prof = PhaseProfiler(name="lm", registry=registry)
        self._ptick = NULL_TICK
        self._flops_per_token = lm_flops_per_token(cfg)

        # prefix cache + preemption state
        self._prefix_enabled = bool(prefix_cache)
        self.min_prefix_blocks = int(min_prefix_blocks)
        # tenant -> priority (callable or mapping; None/absent = 0.0) —
        # preemption triggers only for a STRICTLY higher-priority waiter
        self.tenant_priority = tenant_priority
        # host-side swap store budget in blocks (None = one pool's worth)
        self.swap_block_limit = swap_block_limit
        self._swapped = []          # paused _Swapped streams, FIFO
        self._swapped_blocks = 0    # blocks parked in the host store
        self._preempt = None        # (slot, gen) chosen by _admit
        self._preemptions = 0
        self._resume_ms = []        # swap-out -> reactivation latencies

        # fleet prefix tier (serve/fleet.py): peer lookups run on the
        # SUBMIT caller's thread and exports on the scheduler thread,
        # both strictly outside _cv (the PEER-CALL-UNDER-LOCK gate)
        self.fleet = fleet
        self._fleet_lookups = 0     # peer prefix lookups issued
        self._fleet_blocks = 0      # blocks installed from peers

        # device state allocates lazily with the thread
        self.kv = None
        self.prefix = None
        self._tokens = None
        self._keys = None   # [max_slots, 2] int64: each lane's (seed, counter)
        # the device programs, one per static shape (the JAX engine's jit
        # caches), built with the device state: decode by lane count,
        # verify by (lanes, width), prefill by chunk width.  _prefill is
        # the one prefill dispatch the scheduler calls (tests gate it).
        self._decode_programs = {}
        self._verify_programs = {}
        self._prefill_programs = {}
        self._prefill = self._run_prefill
        self._graph_stats = {}

        # speculative decoding (serve/lm/spec.py; off by default): the
        # drafter + adaptive-k policy is per-model config, the verify
        # widths a fixed geometric set so the verify shape count is
        # provably <= len(_verify_widths) * len(lane_counts)
        self._spec = SpecConfig.parse(speculative)
        self._verify_widths = (
            verify_widths(self._spec.k) if self._spec is not None else ()
        )
        self._spec_proposed = 0
        self._spec_accepted = 0

    # -- shape accounting (the bounded-shape proofs) ------------------------

    def prefill_executables(self):
        """Prefill programs built, one per chunk width (captured graphs on
        CUDA; <= len(self.buckets): chunk widths come from the bucket
        set)."""
        with self._cv:
            return len(self._prefill_programs)

    def decode_executables(self):
        """Decode programs built, one per lane count (captured graphs on
        CUDA; <= len(lane_counts))."""
        with self._cv:
            return len(self._decode_programs)

    def verify_executables(self):
        """Speculative-verify programs built, one per (lanes, width)
        (captured graphs on CUDA; <= len(verify_widths(k)) *
        len(lane_counts))."""
        with self._cv:
            return len(self._verify_programs)

    def graph_stats(self):
        """The CUDA graphs' capture record ({} on the CPU or before the
        engine started): graphs by kind, capture seconds, and
        ``torch.cuda.memory_reserved()`` before and after the whole set."""
        with self._cv:
            return dict(self._graph_stats)

    def spec_stats(self):
        """Speculative-decoding counters ({} when speculation is off)."""
        with self._cv:
            if self._spec is None:
                return {}
            prop, acc = self._spec_proposed, self._spec_accepted
            return {
                "proposed": prop,
                "accepted": acc,
                "rejected": prop - acc,
                "acceptance_rate": round(acc / max(prop, 1), 4),
            }

    def tick_trace(self):
        """Recent per-tick records ({kind, t0, t1, lanes, n_lanes}) —
        the fairness/jitter evidence tests and ops read."""
        with self._cv:
            return list(self._tick_log)

    def prefix_stats(self):
        """Prefix-cache counters ({} when the cache is disabled or the
        engine never started)."""
        with self._cv:
            return {} if self.prefix is None else self.prefix.stats()

    def preempt_stats(self):
        """Preemption/swap counters: preemptions, completed resumes with
        their swap-out -> reactivation latencies, streams still parked."""
        with self._cv:
            return {
                "preemptions": self._preemptions,
                "resumes": len(self._resume_ms),
                "resume_ms": list(self._resume_ms),
                "swapped_streams": len(self._swapped),
                "swapped_blocks": self._swapped_blocks,
            }

    def set_registry(self, registry):
        """Late-bind the serving metrics registry (add_model wiring)."""
        with self._cv:
            self.registry = registry
            if self.prefix is not None:
                self.prefix.registry = registry
            kv = self.kv
        if kv is not None:
            kv.set_registry(registry)
        self.prof.set_registry(registry)

    def set_fleet(self, fleet):
        """Late-bind the cross-replica prefix tier (add_model wiring):
        submit consults it on local-trie shortfall, prefill completion
        exports into it, drain migrates parked streams through it."""
        with self._cv:
            self.fleet = fleet

    def fleet_stats(self):
        """Fleet prefix-tier counters: peer lookups issued at submit and
        KV blocks installed from peers (zeros when no tier is bound)."""
        with self._cv:
            return {
                "remote_lookups": self._fleet_lookups,
                "remote_blocks": self._fleet_blocks,
            }

    def pressure(self):
        """Autoscaling signal: queued submissions + parked (swapped)
        streams + active lanes — the LM half of the per-replica
        queue-depth gauge the fleet tier gossips on probes — plus
        paged-KV occupancy (block exhaustion is the earliest scale-up
        signal for LM workloads)."""
        with self._cv:
            pending = sum(len(dq) for dq in self._pending.values())
            active = sum(1 for lane in self._lanes if lane.active)
            kv = self.kv
        # KV accounting outside the condition lock: the pool has its own
        # synchronization and holding _cv across it invites lock nesting
        kv_fraction = 0.0
        if kv is not None:
            used = kv.used_blocks
            total = used + kv.free_blocks
            kv_fraction = round(used / total, 4) if total > 0 else 0.0
        return {
            "queue_depth": pending + len(self._swapped),
            "inflight": active,
            "kv_used_fraction": kv_fraction,
        }

    # -- request side ------------------------------------------------------

    def submit(self, prompt_tokens, max_tokens, temperature=0.0, top_k=0,
               seed=0, tenant="", window=0):
        """Returns (token_queue, handle); the queue ends with CLOSE.

        ``window`` > 0 bounds the tokens that wait unread in the queue:
        past it the engine holds the stream's tokens back and leaves its
        lane out of the ticks until the reader reads on (the tokens and
        their order are the same either way)."""
        prompt = np.asarray(prompt_tokens, np.int32).reshape(1, -1)
        max_tokens = min(int(max_tokens),
                         self.cfg.max_seq - prompt.shape[1])
        q = _LaneQueue(self._wake_event) if window > 0 else queue.Queue()
        if max_tokens <= 0:
            q.put(_CLOSE)
            return q, None
        handle = _Handle(prompt, max_tokens, q, str(tenant or ""),
                         temperature, top_k, seed, window,
                         next(self._arrivals))
        self._ensure_started()
        fleet = self.fleet
        if fleet is not None and self._prefix_enabled:
            shareable = (handle.prompt_len - 1) // self.block_size
            if shareable > 0:
                with self._cv:
                    if self._closed:
                        q.put(_CLOSE)
                        return q, None
                    local = len(
                        self.prefix.match(handle.prompt[0], shareable)[0]
                    )
                    if local < shareable:
                        self._fleet_lookups += 1
                if local < shareable:
                    # peer RPC on the CALLER's thread with no engine lock
                    # held: a slow/dead peer delays only this submit, by
                    # at most the tier's bounded fan-out x timeout — the
                    # scheduler keeps ticking throughout.  Only the tail
                    # past the local match travels (start_blocks).
                    got = fleet.prefix_lookup(
                        handle.prompt[0], self.block_size, shareable,
                        start_blocks=local,
                    )
                    if got is not None and got[0] > local:
                        handle.remote_kv = got
        with self._cv:
            if self._closed:
                q.put(_CLOSE)
                return q, None
            # in arrival order: submits that waited while another started
            # the engine wake in any order (the JAX engine starts under
            # _cv and enqueues each submit as it comes)
            lane_q = self._pending.setdefault(handle.tenant, deque())
            at = len(lane_q)
            while at and lane_q[at - 1].arrival > handle.arrival:
                at -= 1
            lane_q.insert(at, handle)
            self._cv.notify_all()
        self._wake_event.set()
        return q, handle

    def cancel(self, handle):
        """Release a stream early (consumer went away)."""
        if handle is None:
            return
        with self._cv:
            lane_q = self._pending.get(handle.tenant)
            if lane_q is not None:
                for i, entry in enumerate(lane_q):
                    if entry is handle:
                        entry.queue.put(_CLOSE)
                        del lane_q[i]
                        if not lane_q:
                            del self._pending[handle.tenant]
                        return
            placed = handle.placed
            if placed is None:
                # popped from pending but not yet streaming: the prefill
                # job is mid-dispatch outside _cv.  Mark the handle; the
                # job step aborts and closes the queue.
                handle.placed = _CANCELLED
                return
            if placed is _CANCELLED:
                return
            if isinstance(placed, _Swapped):
                # preempted and parked: its blocks were already released
                # at swap-out, so cancel just closes the paused stream
                # and drops the host copies (a resume job in flight for
                # it sees .cancelled and aborts)
                if not placed.cancelled:
                    placed.cancelled = True
                    placed.queue.put(_CLOSE)
                    if placed in self._swapped:
                        self._swapped.remove(placed)
                        if placed.host_k is not None:
                            self._swapped_blocks -= placed.written_blocks
                            self._swap_gauge_locked()
                    placed.host_k = placed.host_v = None
                return
            slot_idx, gen = placed
            lane = self._lanes[slot_idx]
            if lane.active and lane.gen == gen:
                # what the lane held for its reader is dropped, as the
                # readbacks still in flight are
                self._retire_lane_locked(lane, drop_held=True)

    def close(self):
        with self._cv:
            self._closed = True
            self._release_all_locked()
            self._cv.notify_all()
        self._wake_event.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            if self._thread.is_alive():
                return  # a tick still running keeps its programs
        self._release_programs()

    def _release_programs(self):
        """Drop every program (and with the last graph, the graphs'
        memory pool) once no replay can be running."""
        if self.device.type == "cuda" and self._decode_programs:
            torch.cuda.synchronize(self.device)
        with self._cv:
            self._decode_programs = {}
            self._verify_programs = {}
            self._prefill_programs = {}

    # -- locked helpers ----------------------------------------------------

    def _ensure_started(self):
        """Start the engine on the first submit: the device state (under
        ``_cv``), every program (built and captured OUTSIDE ``_cv``, so
        no reader of the engine's state waits through an extension build
        or a capture; a failed build or capture raises here, from the
        submit that started the engine), then the scheduler thread.  A
        submit that comes while another starts the engine waits for it;
        one after a failed start starts it again."""
        with self._cv:
            while self._starting:
                self._cv.wait()
            if self._thread is not None or self._closed:
                return
            self._starting = True
            self._init_device_locked()
        try:
            self._build_programs()
            with self._cv:
                closed = self._closed
                if not closed:
                    self._thread = threading.Thread(
                        target=self._loop, name="lm-engine", daemon=True
                    )
                    self._thread.start()
            if closed:  # closed while building: no thread will replay
                self._release_programs()
        finally:
            with self._cv:
                self._starting = False
                self._cv.notify_all()

    def _init_device_locked(self):
        self.kv = KvBlockPool(
            self.cfg,
            n_blocks=max(
                self._pool_tokens // self.block_size, self._table_width
            ),
            block_size=self.block_size,
            registry=self.registry,
            device=self.device,
        )
        if self._prefix_enabled:
            self.prefix = PrefixCache(
                self.kv, registry=self.registry,
                min_prefix_blocks=self.min_prefix_blocks,
            )
        if self.swap_block_limit is None:
            self.swap_block_limit = self.kv.n_blocks
        self._tokens = torch.zeros(
            (self.max_slots,), dtype=torch.int32, device=self.device
        )
        self._keys = torch.zeros(
            (self.max_slots, 2), dtype=torch.int64, device=self.device
        )

    def _build_programs(self):
        """One program per static shape over the engine's device state;
        on CUDA each is captured as a CUDA graph, all in one memory pool,
        before the scheduler serves.  Runs outside ``_cv`` (the device
        state it reads is set up before and not replaced until the engine
        closes) and installs the programs under it."""
        params, cfg, bs = self.params, self.cfg, self.block_size
        width, dev = self._table_width, self.device
        lanes = {"tokens": self._tokens, "keys": self._keys,
                 "pools": self.kv.pools}
        decode = {
            n: _Program(
                functools.partial(_decode_body, params, cfg=cfg, n=n,
                                  block_size=bs),
                _lane_feeds(n, width), lanes, dev,
            )
            for n in self.lane_counts
        }
        verify = {
            (n, w): _Program(
                functools.partial(_verify_body, params, cfg=cfg, n=n,
                                  width=w, block_size=bs),
                _lane_feeds(n, width) + [
                    ("props", (n, w - 1), np.int32),
                    ("counts", (n,), np.int32)],
                {**lanes, "out": torch.zeros((2, n), dtype=torch.int32,
                                             device=dev)},
                dev,
            )
            for n in self.lane_counts for w in self._verify_widths
        }
        # one token and RNG carry for every width: chunks run one at a
        # time, and the final one's are read before the next chunk
        first = {"pools": self.kv.pools,
                 "tok": torch.zeros((1,), dtype=torch.int32, device=dev),
                 "carry": torch.zeros((2,), dtype=torch.int64, device=dev)}
        prefill = {
            c: _Program(
                functools.partial(_prefill_body, params, cfg=cfg,
                                  block_size=bs),
                _prefill_feeds(c, width), first, dev,
            )
            for c in self.buckets
        }
        stats = {}
        if dev.type == "cuda":
            from client_tpu_torch.ops._build import kernels

            kernels()  # build the extension before any capture
            programs = [*decode.values(), *verify.values(),
                        *prefill.values()]
            pool = torch.cuda.graph_pool_handle()
            stream = torch.cuda.Stream(dev)
            with ops.CAPTURE_LOCK:
                torch.cuda.synchronize(dev)
                before = torch.cuda.memory_reserved(dev)
                t0 = time.monotonic()
                for prog in programs:
                    prog.capture(pool, stream)
                torch.cuda.synchronize(dev)
                stats = {
                    "graphs": {"decode": len(decode),
                               "verify": len(verify),
                               "prefill": len(prefill)},
                    "capture_s": time.monotonic() - t0,
                    "memory_reserved_before": before,
                    "memory_reserved_after": torch.cuda.memory_reserved(dev),
                }
        with self._cv:
            self._decode_programs = decode
            self._verify_programs = verify
            self._prefill_programs = prefill
            self._graph_stats = stats

    def _adopt(self, slot, tok, key):
        """Install a lane's next input token and RNG (seed, counter) in
        place (the JAX engine's jitted ``_adopt``): on the scheduler's
        stream, after every tick dispatched so far and its readback."""
        self._tokens[slot:slot + 1] = tok
        self._keys[slot] = key

    def _run_prefill(self, width, values):
        """Run one prefill chunk through its width's program; returns its
        (token [1], RNG carry [2]) output buffers."""
        prog = self._prefill_programs[width]
        prog(values)
        return prog.state["tok"], prog.state["carry"]

    def _retire_lane_locked(self, lane, close_queue=True, drop_held=False):
        """Release a lane and return its KV reservation (full prompt
        blocks go to the prefix cache; the rest free).  ``close_queue``
        False is the preemption path: the stream pauses, it does not
        end.  Tokens held for a windowed reader stream first, past its
        window, unless ``drop_held`` (a cancel)."""
        held, lane.held = lane.held, []
        if not drop_held:
            for token in held:
                self._put_locked(lane, token)
        lane.active = False
        lane.gen += 1  # in-flight ticks for this lane drop on drain
        if close_queue:
            lane.queue.put(_CLOSE)
        lane.table[:] = KvBlockPool.TRASH
        written, lane.length = lane.length, 0
        prompt, lane.prompt = lane.prompt, None
        lane.tokens = []
        lane.handle = None
        lane.spec = None
        blocks, lane.blocks = lane.blocks, None
        if blocks:
            self._release_blocks_locked(prompt, written, blocks)

    # -- windowed streams ---------------------------------------------------

    def _put_locked(self, lane, token):
        lane.queue.put(token)
        if self.registry is not None:
            self.registry.inc(
                "ctpu_lm_tokens_total",
                help_="Tokens streamed by the LM engine",
            )

    def _emit_locked(self, lane, token):
        """Stream one decoded *token*, or hold it while the lane's
        windowed reader has its window's worth unread."""
        window = lane.handle.window if lane.handle is not None else 0
        if window and (lane.held or lane.queue.qsize() >= window):
            lane.held.append(token)
        else:
            self._put_locked(lane, token)

    def _release_held_locked(self):
        """Stream held tokens as far as each reader's window allows."""
        for lane in self._lanes:
            while lane.held and lane.queue.qsize() < lane.handle.window:
                self._put_locked(lane, lane.held.pop(0))

    def _sit_out_locked(self, n, included):
        """For a tick over the first *n* lanes: the lanes it leaves out
        because they hold tokens, not yet parked (``(slot, gen)``), and
        the parked lanes it takes in again (``(slot, parked)``)."""
        park, unpark = [], []
        for i in range(n):
            lane = self._lanes[i]
            parked = lane.parked
            if parked is not None and parked[0] != lane.gen:
                parked = None  # retired since: stale
            if i in included:
                if parked is not None:
                    unpark.append((i, parked))
            elif lane.active and lane.held and parked is None:
                park.append((i, lane.gen))
        return park, unpark

    def _park(self, park, unpark):
        """Before a tick (scheduler thread, stream order): save the next
        input token and RNG of each lane it leaves out that holds tokens,
        since the tick overwrites every lane's, and put back those of
        each parked lane it takes in again."""
        for i, gen in park:
            self._lanes[i].parked = (
                gen, self._tokens[i].clone(), self._keys[i].clone()
            )
        for i, (_, tok, key) in unpark:
            self._adopt(i, tok, key)
            self._lanes[i].parked = None

    def _release_blocks_locked(self, prompt, written_tokens, blocks):
        """Return one reservation: fully written FULL prompt blocks are
        offered to the prefix cache (the holder's reference transfers or
        drops — see PrefixCache.give_back), everything else frees."""
        if self.prefix is None or prompt is None:
            self.kv.release(blocks)
            return
        prompt_row = prompt[0]
        cacheable = (
            min(int(written_tokens), prompt_row.shape[0]) // self.block_size
        )
        self.prefix.give_back(prompt_row, cacheable, blocks)

    def _release_all_locked(self):
        """Close every pending/active/in-prefill/swapped stream and drop
        the warm cache (caller holds _cv)."""
        for lane_q in self._pending.values():
            for entry in lane_q:
                entry.queue.put(_CLOSE)
        self._pending.clear()
        for lane in self._lanes:
            if lane.active:
                self._retire_lane_locked(lane)
        job, self._job = self._job, None
        if job is not None:
            self._abort_job_locked(job)
        swapped, self._swapped = self._swapped, []
        for entry in swapped:
            if not entry.cancelled:
                entry.cancelled = True
                entry.queue.put(_CLOSE)
        self._swapped_blocks = 0
        self._preempt = None
        if self.prefix is not None:
            # AFTER every give_back above: the pool must end fully free
            self.prefix.clear()

    def _abort_job_locked(self, job):
        blocks, job.blocks = job.blocks, None
        if blocks:
            # chunks already dispatched cover positions up to the next
            # chunk's start; those full prompt blocks are valid cache
            # content even though the request died mid-prefill
            written = (
                job.plan[job.chunk_idx][0]
                if job.chunk_idx < len(job.plan)
                else job.handle.prompt_len
            )
            if job.remote is not None:
                # fleet-fetched blocks were never installed on device:
                # only the locally adopted prefix below them is real
                # content — caching the uninstalled range would poison
                # the trie with garbage KV
                written = min(written, job.remote[0] * self.block_size)
            self._release_blocks_locked(job.handle.prompt, written, blocks)
        if job.resume is not None:
            if not job.resume.cancelled:
                job.resume.cancelled = True
                job.resume.queue.put(_CLOSE)
        else:
            job.handle.queue.put(_CLOSE)

    def _tenant_lanes_locked(self, tenant):
        held = sum(
            1 for lane in self._lanes if lane.active and lane.tenant == tenant
        )
        if self._job is not None and self._job.handle.tenant == tenant:
            held += 1
        return held

    def _tenant_quota_locked(self, tenant, n_lanes, others_pending):
        """Max lanes *tenant* may hold right now.  Work-conserving: the
        quota binds only while another tenant is waiting."""
        if not others_pending:
            return n_lanes
        share = self.tenant_lane_share
        if callable(share):
            share = share(tenant)
        if share is None:
            share = 1.0
        return max(1, min(n_lanes, int(np.ceil(float(share) * n_lanes))))

    def _pick_pending_locked(self, n_lanes):
        """Pop the next admissible pending handle: strict priority-class
        order first (a gold request queued behind a backpressured bronze
        one must be picked — and preempt — FIRST, or pool exhaustion
        re-picks the bronze head forever and preemption never fires),
        round-robin-fair within a class (the only order when no
        priorities are configured); tenants at their lane quota are
        skipped while others wait."""
        tenants = [t for t, dq in self._pending.items() if dq]
        if not tenants:
            return None
        rotated = tenants[self._rr % len(tenants):] + \
            tenants[:self._rr % len(tenants)]
        # stable sort: equal classes keep their rotated (rr) order
        order = sorted(rotated, key=lambda t: -self._priority_of(t))
        for tenant in order:
            others = any(t != tenant and dq for t, dq in
                         self._pending.items() if dq)
            quota = self._tenant_quota_locked(tenant, n_lanes, others)
            if self._tenant_lanes_locked(tenant) >= quota:
                continue
            self._rr += 1
            lane_q = self._pending[tenant]
            handle = lane_q.popleft()
            if not lane_q:
                # a drained tenant's entry is evicted: client-minted
                # tenant ids must not grow the map (or the per-pass
                # scan) without bound
                del self._pending[tenant]
            return handle
        return None

    def _max_active_locked(self):
        top = -1
        for i, lane in enumerate(self._lanes):
            if lane.active:
                top = i
        if self._job is not None:
            top = max(top, self._job.slot)
        return top

    def _queued_locked(self):
        return any(dq for dq in self._pending.values())

    def _has_pending_locked(self):
        # swapped streams count as pending pressure: they need a lane and
        # blocks to resume, so the autoscaler must not scale down past them
        return self._queued_locked() or bool(self._swapped)

    def _priority_of(self, tenant):
        """Priority class of *tenant* (higher preempts lower; default 0)."""
        source = self.tenant_priority
        if source is None:
            return 0.0
        value = source(tenant) if callable(source) else source.get(tenant)
        return 0.0 if value is None else float(value)

    def _pick_preempt_victim_locked(self, tenant):
        """Lowest-priority active lane STRICTLY below *tenant*'s class
        (ties broken toward the shortest sequence — least KV to swap);
        None when nothing qualifies."""
        want = self._priority_of(tenant)
        victim = None
        victim_key = None
        for i, lane in enumerate(self._lanes):
            if not lane.active:
                continue
            pri = self._priority_of(lane.tenant)
            if pri >= want:
                continue
            key = (pri, lane.length)
            if victim_key is None or key < victim_key:
                victim, victim_key = i, key
        return victim

    def _restore_lane_locked(self, lane, entry, slot):
        """Install a parked _Swapped stream's saved counters/identity on
        a lane and stamp the resume latency.  The caller owns gen/active
        and the table/blocks install — those differ between the swap-in
        and recompute-replay paths."""
        lane.queue = entry.queue
        lane.remaining = entry.remaining
        lane.produced = entry.produced
        lane.length = entry.length
        lane.limit = entry.limit
        lane.tenant = entry.tenant
        lane.temperature = entry.temperature
        lane.top_k = entry.top_k
        lane.prompt = entry.prompt
        lane.tokens = list(entry.tokens)
        lane.handle = entry.handle
        # drafter state rebuilds from the prompt; the adaptive-k window
        # restarts (a resume is rare — one extra window to re-disable an
        # adversarial lane is noise)
        lane.spec = (
            LaneSpec(self._spec, entry.prompt[0])
            if self._spec is not None else None
        )
        if entry.handle is not None:
            entry.handle.placed = (slot, lane.gen)
        self._resume_ms.append((time.monotonic() - entry.t_swap) * 1e3)

    def _swap_gauge_locked(self):
        if self.registry is not None:
            self.registry.set(
                "ctpu_lm_swapped_blocks", None, self._swapped_blocks,
                help_=LM_PREFIX_HELP["ctpu_lm_swapped_blocks"],
            )

    def _lane_gauges_locked(self, active_count=None):
        if self.registry is None:
            return
        self.registry.set("ctpu_lm_lanes", None, self._scaler.n_lanes,
                          help_=_LANE_HELP["ctpu_lm_lanes"])
        if active_count is None:
            active_count = sum(1 for lane in self._lanes if lane.active)
        self.registry.set("ctpu_lm_active_lanes", None, active_count,
                          help_=_LANE_HELP["ctpu_lm_active_lanes"])

    # -- scheduler loop ----------------------------------------------------

    def _reserve_locked(self, needed, matched_blocks):
        """Allocate ``needed - len(matched)`` fresh blocks, evicting warm
        cache blocks under pressure.  Matched blocks must already be
        adopted (refcount >= 2) so eviction can never steal them.
        Returns the fresh list or None."""
        short = needed - len(matched_blocks)
        fresh = self.kv.alloc(short)
        if fresh is None and self.prefix is not None:
            missing = short - self.kv.free_blocks
            if self.prefix.evict(missing) >= missing:
                fresh = self.kv.alloc(short)
        return fresh

    def _admit(self):
        """Move one pending request into a prefill job (bookkeeping under
        _cv; every chunk dispatch happens later, outside the lock).
        Prefix-cache adoption happens here: matched prompt blocks are
        retained by reference and the chunk plan starts at the first
        miss."""
        with self._cv:
            if (self._closed or self._job is not None
                    or self._preempt is not None):
                return
            n_lanes = self._scaler.n_lanes
            slot = next(
                (i for i in range(n_lanes) if not self._lanes[i].active),
                None,
            )
            if slot is None:
                # every lane busy: ANY pending work is starvation —
                # sustained starvation steps the lane count up.  (Checked
                # before the quota-aware pick: a tenant at its lane quota
                # with zero free lanes must still register pressure.)
                if self._has_pending_locked():
                    if self._scaler.note_starved():
                        self._lane_gauges_locked()
                else:
                    self._scaler.note_ok(False, self._max_active_locked())
                return
            handle = self._pick_pending_locked(n_lanes)
            if handle is None:
                # nothing admissible: idle, or every pending tenant is at
                # its quota while a lane sits free (note_ok with pending
                # True so the free lane cannot drive a scale-down under a
                # quota-capped backlog)
                self._scaler.note_ok(
                    self._has_pending_locked(), self._max_active_locked()
                )
                self._lane_gauges_locked()
                return
            needed = self.kv.blocks_for(
                handle.prompt_len + handle.max_tokens
            )
            matched_blocks, matched_nodes = [], []
            shareable = (handle.prompt_len - 1) // self.block_size
            if self.prefix is not None and shareable:
                # cap at (prompt_len - 1): the final prompt position must
                # always prefill — its logits seed the first new token
                matched_blocks, matched_nodes = self.prefix.match(
                    handle.prompt[0], shareable
                )
                # adopt BEFORE the allocation attempt: refcount 2 pins the
                # matched chain against the eviction pass below
                self.prefix.adopt(matched_nodes)
            fresh = self._reserve_locked(needed, matched_blocks)
            if fresh is None:
                # pool exhausted even after cache eviction: drop the
                # adoption, then either preempt a strictly lower-priority
                # lane for a higher-priority waiter or backpressure until
                # completions free blocks.  (The pick may have evicted the
                # tenant's drained entry — recreate it.)
                if matched_blocks:
                    self.kv.release(matched_blocks)
                victim = self._pick_preempt_victim_locked(handle.tenant)
                if victim is not None:
                    self._preempt = (victim, self._lanes[victim].gen)
                self._pending.setdefault(
                    handle.tenant, deque()
                ).appendleft(handle)
                self._rr -= 1
                return
            blocks = matched_blocks + fresh
            table = np.full(
                (self._table_width,), KvBlockPool.TRASH, np.int32
            )
            table[:len(blocks)] = blocks
            start = len(matched_blocks) * self.block_size
            job_remote = None
            if handle.remote_kv is not None:
                # fleet-tier adoption beyond the local trie: blocks
                # [local..covered) are FRESH pool blocks whose content the
                # first _prefill_step installs from the peer's host tensors
                # (outside _cv); the chunk plan starts past them.  The
                # fetched tensors cover blocks [rstart, covered) — if the
                # trie shrank below rstart since the submit-time probe
                # (eviction under pressure), the fetch cannot bridge the
                # gap and is dropped: prefill is always correct, just
                # slower.
                covered = min(int(handle.remote_kv[0]), shareable)
                rstart = handle.remote_kv[3]
                if rstart <= len(matched_blocks) < covered:
                    job_remote = [
                        len(matched_blocks), covered,
                        handle.remote_kv[1], handle.remote_kv[2], rstart,
                    ]
                    start = covered * self.block_size
                    self._fleet_blocks += covered - len(matched_blocks)
                    if self.registry is not None:
                        self.registry.inc(
                            "ctpu_fleet_prefix_blocks_total", None,
                            value=covered - len(matched_blocks),
                            help_=FLEET_HELP[
                                "ctpu_fleet_prefix_blocks_total"],
                        )
                        self.registry.inc(
                            "ctpu_fleet_prefix_tokens_saved_total", None,
                            value=(covered - len(matched_blocks))
                            * self.block_size,
                            help_=FLEET_HELP[
                                "ctpu_fleet_prefix_tokens_saved_total"],
                        )
            if self.prefix is not None and shareable:
                self.prefix.note_lookup(
                    len(matched_blocks), shareable - len(matched_blocks)
                )
            if self.registry is not None and start:
                self.registry.inc(
                    "ctpu_lm_prefill_tokens_saved_total", None, value=start,
                    help_=LM_PREFIX_HELP["ctpu_lm_prefill_tokens_saved_total"],
                )
            self._job = _PrefillJob(
                handle, slot, blocks, table,
                chunk_plan(handle.prompt_len, self.buckets, start=start),
            )
            self._job.remote = job_remote
            self._scaler.note_ok(False, self._max_active_locked())

    def _job_cancelled_locked(self, job):
        """True when the stream this job serves went away: a normal
        admission's handle was cancelled, or a recompute-resume's
        swapped stream was."""
        if job.resume is not None:
            return job.resume.cancelled
        return job.handle.placed is _CANCELLED

    def _prefill_step(self):
        """Dispatch ONE chunk of the current prefill job (outside _cv);
        the final chunk activates the lane."""
        with self._cv:
            # re-read under the lock: a concurrent close() may have
            # aborted and cleared the job since the caller's check
            job = self._job
            if job is None:
                return
            if self._closed or self._job_cancelled_locked(job):
                self._abort_job_locked(job)
                self._job = None
                return
            start, width = job.plan[job.chunk_idx]
            # snapshot the remote-install plan under the lock: a close()
            # racing this step nulls job.blocks in _abort_job_locked, and
            # the consumed job.remote marks the blocks as real content
            # for the eventual give_back
            remote, job.remote = job.remote, None
            remote_blocks = (
                list(job.blocks[remote[0]:remote[1]])
                if remote is not None else None
            )
        handle = job.handle
        if remote is not None:
            self._install_remote(remote, remote_blocks)
        chunk = pad_prompt(
            handle.prompt[:, start:start + width], width,
            pad_id=0,
        )
        t0 = time.monotonic()
        # chunk i is the lane's i-th draw: RNG state (seed, i); the final
        # chunk's carry (seed, i + 1) seeds the decode ticks
        tok, carry = self._prefill(width, {
            "chunk": chunk, "table": job.table, "start": start,
            "prompt_len": handle.prompt_len,
            "key": (_seed32(handle.seed), job.chunk_idx),
            "temperature": handle.temperature, "top_k": handle.top_k,
        })
        job.chunk_idx += 1
        self._log_tick("prefill_chunk", t0, (job.slot,))
        if self.registry is not None:
            self.registry.inc(
                "ctpu_lm_prefill_chunks_total",
                help_="Prefill chunks dispatched between decode ticks",
            )
            # real (non-pad) prompt tokens this chunk computed — the
            # denominator side of the prefix-cache savings accounting
            self.registry.inc(
                "ctpu_lm_prefill_tokens_total", None,
                value=min(start + width, handle.prompt_len) - start,
                help_=LM_PREFIX_HELP["ctpu_lm_prefill_tokens_total"],
            )
        if job.chunk_idx < len(job.plan):
            return
        export = None
        with self._cv:
            self._job = None
            if self._closed or self._job_cancelled_locked(job):
                self._abort_job_locked(job)
                return
            lane = self._lanes[job.slot]
            resume = job.resume
            lane.gen += 1
            lane.active = True
            lane.table[:] = job.table
            lane.blocks, job.blocks = job.blocks, None
            if resume is None and self.fleet is not None:
                nfull = handle.prompt_len // self.block_size
                if nfull:
                    export = (
                        handle.prompt[0],
                        [int(b) for b in lane.blocks[:nfull]],
                        nfull,
                    )
            if resume is None:
                lane.queue = handle.queue
                lane.remaining = handle.max_tokens
                lane.produced = 0
                lane.length = handle.prompt_len
                lane.limit = handle.prompt_len + handle.max_tokens
                lane.tenant = handle.tenant
                lane.temperature = handle.temperature
                lane.top_k = handle.top_k
                lane.prompt = handle.prompt
                lane.tokens = []
                lane.handle = handle
                lane.spec = (
                    LaneSpec(self._spec, handle.prompt[0])
                    if self._spec is not None else None
                )
                handle.placed = (job.slot, lane.gen)
                if self.prefix is not None:
                    # the prompt's full blocks are fully written as of
                    # this chunk: publish them so a same-prefix burst
                    # shares from the first finished prefill
                    self.prefix.publish(
                        handle.prompt[0],
                        handle.prompt_len // self.block_size,
                        lane.blocks,
                    )
            else:
                # recompute-resume: the replayed prefill rebuilt the KV
                # for prompt + delivered tokens; streaming continues from
                # the SAVED counters, token and RNG carry — the chunk's
                # sampled token is discarded (that position's token was
                # already delivered before preemption)
                self._restore_lane_locked(lane, resume, job.slot)
            snapshot = ((job.slot, lane.gen),)
            self._lane_gauges_locked()
        if export is not None:
            self._export_prefix(export)
        if resume is not None:
            # install the saved next-tick input token + RNG carry; nothing
            # streams (everything up to `produced` was already delivered)
            self._adopt(job.slot, resume.token, resume.key)
            return
        # install the first token + RNG carry into the lane arrays and
        # stream the token through the readback pipeline (single-lane
        # entry, exactly like a full tick's vector)
        self._adopt(job.slot, tok, carry)
        self._inflight.append((_start_readback(tok), snapshot))

    def _install_remote(self, remote, blocks):
        """Install fleet-fetched KV content into the reservation's fresh
        blocks (scheduler thread, outside _cv).  The host tensors cover
        chain blocks [rstart, covered); the destination is blocks
        [lo, hi) of the reservation.  The pools are written IN PLACE on
        the scheduler thread's stream, so the copy orders before this
        job's chunk replay, and the captured graphs, which read the pool
        at the addresses they recorded, see the peer-computed content.
        Each host slice goes to the device by a blocking copy: the host
        tensor has been read before the call returns."""
        lo, hi, host_k, host_v, rstart = remote
        idx = _to_device(np.asarray(blocks, np.int64), self.device)
        sel = slice(lo - rstart, hi - rstart)
        for layer in range(len(host_k)):
            for pools, host in ((self.kv.pools["k"], host_k),
                                (self.kv.pools["v"], host_v)):
                pool = pools[layer]
                pool[idx] = host[layer][sel].to(self.device, pool.dtype)

    def _export_prefix(self, export):
        """Publish freshly prefilled full prompt blocks into the fleet
        tier's host store (scheduler thread, OUTSIDE _cv: the gather is
        a device read ordered after this job's chunk writes, and the
        store insert is host-side only).  One device->host copy per
        layer and pool at each prefill — the price of making the prefix
        fleet-visible, paid only while a tier is attached; the first
        copy waits for every tick dispatched before it."""
        row, blocks, nfull = export
        idx = _to_device(np.asarray(blocks, np.int64), self.device)
        host_k = [p[idx].cpu() for p in self.kv.pools["k"]]
        host_v = [p[idx].cpu() for p in self.kv.pools["v"]]
        self.fleet.export_prefix(
            row, nfull, self.block_size, host_k, host_v
        )

    def drain(self):
        """Planned retire: migrate what can migrate, then close.

        Active lanes' prompt prefixes were already exported to the fleet
        tier at prefill completion, so a client replaying
        prompt + delivered tokens on a surviving replica resumes
        byte-exact with its prefill largely served from the tier.
        Parked (preempted) streams are the case with otherwise-stranded
        state: their host-swapped KV chains — prompt AND generated-token
        blocks — are exported here, and the swap store drops with the
        close (audited: no leaked blocks).  Returns the number of parked
        streams exported."""
        exports = []
        with self._cv:
            fleet = self.fleet if self.prefix is not None else None
            if fleet is not None:
                for entry in self._swapped:
                    if entry.cancelled or entry.host_k is None:
                        continue
                    nfull = entry.length // self.block_size
                    if not nfull:
                        continue
                    row = entry.prompt[0]
                    if entry.produced > 1:
                        # the written sequence is prompt + every delivered
                        # token except the last (which is the NEXT tick's
                        # input): exactly `length` tokens
                        row = np.concatenate([
                            row,
                            np.asarray(
                                entry.tokens[:entry.produced - 1], np.int32
                            ),
                        ])
                    exports.append(
                        (row, nfull, entry.host_k, entry.host_v)
                    )
        for row, nfull, host_k, host_v in exports:
            fleet.export_prefix(
                row, nfull, self.block_size,
                [a[:nfull] for a in host_k],
                [a[:nfull] for a in host_v],
            )
        if exports and self.registry is not None:
            self.registry.inc(
                "ctpu_fleet_sessions_migrated_total", None,
                value=len(exports),
                help_=FLEET_HELP["ctpu_fleet_sessions_migrated_total"],
            )
        self.close()
        return len(exports)

    def _decode_pass(self):
        """One batched decode tick over the active lanes (dispatch
        outside _cv).  Returns True if a tick ran."""
        with self._cv:
            if self._closed:
                return False
            n = self._scaler.n_lanes
            # a lane drops out of the tick batch once it has dispatched
            # its full token budget (readback may still be in flight) —
            # dispatch-ahead must never write past the lane's block
            # reservation
            # a lane holding tokens for its reader sits the tick out
            active = [
                (i, self._lanes[i].gen)
                for i in range(n)
                if self._lanes[i].active
                and self._lanes[i].length < self._lanes[i].limit
                and not self._lanes[i].held
            ]
            if not active:
                return False
            # lanes outside the batch (idle, at-budget awaiting drain, or
            # holding) get a trash table + position 0: their scatter lands
            # in the trash block and their garbage token is never delivered
            included = {i for i, _ in active}
            park, unpark = self._sit_out_locked(n, included)
            trash_row = np.zeros((self._table_width,), np.int32)
            tables = np.stack([
                self._lanes[i].table if i in included else trash_row
                for i in range(n)
            ])
            lens = np.array(
                [self._lanes[i].length if i in included else 0
                 for i in range(n)], np.int32,
            )
            temps = np.array(
                [self._lanes[i].temperature for i in range(n)], np.float32
            )
            topks = np.array(
                [self._lanes[i].top_k for i in range(n)], np.int32
            )
            for i, _ in active:
                self._lanes[i].length += 1  # this tick writes position len
            self._lane_gauges_locked(active_count=len(active))
        self._park(park, unpark)
        t0 = time.monotonic()
        self._decode_programs[n]({"tables": tables, "lens": lens,
                                  "temps": temps, "topks": topks})
        self._inflight.append(
            (_start_readback(self._tokens), tuple(active))
        )
        self._log_tick("decode", t0, tuple(i for i, _ in active))
        return True

    def _spec_pass(self, ptick):
        """One speculative draft + verify pass over the active lanes;
        True when a verify tick ran, False to fall through to the plain
        decode tick.

        The fall-through IS the never-slower path: a lane whose adaptive
        k backed off to 0 skips drafting, and when NO lane drafts the
        pass returns before touching the readback pipeline — the engine
        then runs the exact plain-decode code (dispatch-ahead included),
        paying only this method's host-side enabled check.

        The verify tick is SYNCHRONOUS (no dispatch-ahead): how far a
        lane advances depends on its accepted count, which the host
        learns only at readback.  The in-flight pipeline is drained
        before drafting so each lane's host history is complete
        (``lane.tokens[-1]`` == the device-side next input token — the
        same consistency point ``_preempt_step`` establishes), and
        because verify never spans a pass boundary, a preemption, swap
        or cancel can never observe a half-applied verify: the
        swap/recompute byte-exactness argument is unchanged.
        """
        with self._cv:
            if self._closed:
                return False
            n = self._scaler.n_lanes
            want = False
            for i in range(n):
                lane = self._lanes[i]
                if (not lane.active or lane.spec is None
                        or lane.length >= lane.limit or lane.held):
                    continue
                room = min(lane.limit - 1 - lane.length,
                           lane.remaining - lane.produced - 1)
                if lane.spec.k > 0 and room > 0:
                    want = True
                else:
                    lane.spec.note_plain()  # re-probe timer while k == 0
            if not want:
                return False
        while self._inflight:
            self._drain_one(ptick)
        cands = []
        with self._cv:
            if self._closed:
                return False
            for i in range(n):
                lane = self._lanes[i]
                if (not lane.active or lane.spec is None
                        or lane.length >= lane.limit or not lane.tokens
                        or lane.held):
                    continue
                room = min(lane.limit - 1 - lane.length,
                           lane.remaining - lane.produced - 1)
                if lane.spec.k <= 0 or room <= 0:
                    continue
                hist = np.concatenate([
                    lane.prompt[0], np.asarray(lane.tokens, np.int32),
                ])
                cands.append((i, lane.gen, lane.spec, hist, room))
        if not cands:
            return False
        # drafting is pure host work, outside the lock; its own phase +
        # tick-span so profview prices draft against verify and decode
        t_draft = time.monotonic()
        proposals = {}
        with ptick.phase("draft"):
            for i, gen, lane_spec, hist, room in cands:
                toks = lane_spec.draft(hist)[:room]
                if toks:
                    proposals[i] = (gen, toks)
        if not proposals:
            return False
        self._log_tick("draft", t_draft, tuple(sorted(proposals)))
        with self._cv:
            if self._closed:
                return False
            active = [
                (i, self._lanes[i].gen)
                for i in range(n)
                if self._lanes[i].active
                and self._lanes[i].length < self._lanes[i].limit
                and not self._lanes[i].held
            ]
            if not active:
                return False
            included = {i for i, _ in active}
            # gen-checked: a lane cancelled while drafting drops its
            # proposal; other active lanes ride the tick as plain decode
            # (count 0 — they deliver exactly one token)
            drafts = {
                i: toks for i, (gen, toks) in proposals.items()
                if i in included and self._lanes[i].gen == gen
            }
            if not drafts:
                return False
            max_d = max(len(toks) for toks in drafts.values())
            w = bucket_for(max_d + 1, self._verify_widths)
            props = np.zeros((n, w - 1), np.int32)
            counts = np.zeros((n,), np.int32)
            for i, toks in drafts.items():
                d = min(len(toks), w - 1)
                props[i, :d] = toks[:d]
                counts[i] = d
            trash_row = np.zeros((self._table_width,), np.int32)
            tables = np.stack([
                self._lanes[i].table if i in included else trash_row
                for i in range(n)
            ])
            lens = np.array(
                [self._lanes[i].length if i in included else 0
                 for i in range(n)], np.int32,
            )
            temps = np.array(
                [self._lanes[i].temperature for i in range(n)], np.float32
            )
            topks = np.array(
                [self._lanes[i].top_k for i in range(n)], np.int32
            )
            self._lane_gauges_locked(active_count=len(active))
            park, unpark = self._sit_out_locked(n, included)
        self._park(park, unpark)
        t0 = time.monotonic()
        prog = self._verify_programs[(n, w)]
        with ptick.phase("verify_dispatch"):
            prog({"tables": tables, "lens": lens, "temps": temps,
                  "topks": topks, "props": props, "counts": counts})
        with ptick.phase("device_wait"):
            # [2, n]: accepted count, correction
            vals = _readback_values(_start_readback(prog.state["out"]))
        self._log_tick("verify", t0, tuple(i for i, _ in active))
        self._deliver_verified(ptick, active, vals, props, counts)
        return True

    def _deliver_verified(self, ptick, active, vals, props, counts):
        """Stream one verify tick's accepted drafts + correction token
        per lane and advance the per-lane length/budget/adaptive-k
        bookkeeping (under _cv; the tick already completed on device)."""
        delivered = 0
        proposed = accepted = 0
        with ptick.phase("deliver"), self._cv:
            for slot_idx, gen in active:
                lane = self._lanes[slot_idx]
                if not lane.active or lane.gen != gen:
                    continue  # cancelled since dispatch: stale tick
                d = int(counts[slot_idx])
                acc = min(int(vals[0, slot_idx]), d)
                toks = [int(t) for t in props[slot_idx, :acc]]
                toks.append(int(vals[1, slot_idx]))
                if lane.spec is not None:
                    if d:
                        lane.spec.note(d, acc)
                    else:
                        lane.spec.note_plain()
                proposed += d
                accepted += acc
                for token in toks:
                    self._emit_locked(lane, token)
                    lane.produced += 1
                    lane.tokens.append(token)
                    # the tick wrote K/V for this token's position; the
                    # first garbage (rejected) position becomes the next
                    # tick's write position — the rewind is this pointer
                    lane.length += 1
                    delivered += 1
                    if (lane.produced >= lane.remaining
                            or (self.eos_id is not None
                                and token == self.eos_id)):
                        self._retire_lane_locked(lane)
                        break
            self._spec_proposed += proposed
            self._spec_accepted += accepted
            if proposed and self.registry is not None:
                self.registry.inc(
                    "ctpu_lm_spec_proposed_tokens_total", None,
                    value=proposed,
                    help_=LM_SPEC_HELP[
                        "ctpu_lm_spec_proposed_tokens_total"],
                )
                if accepted:
                    self.registry.inc(
                        "ctpu_lm_spec_accepted_tokens_total", None,
                        value=accepted,
                        help_=LM_SPEC_HELP[
                            "ctpu_lm_spec_accepted_tokens_total"],
                    )
                if proposed - accepted:
                    self.registry.inc(
                        "ctpu_lm_spec_rejected_tokens_total", None,
                        value=proposed - accepted,
                        help_=LM_SPEC_HELP[
                            "ctpu_lm_spec_rejected_tokens_total"],
                    )
                self.registry.set(
                    "ctpu_lm_spec_acceptance_rate", None,
                    round(
                        self._spec_accepted
                        / max(self._spec_proposed, 1), 4,
                    ),
                    help_=LM_SPEC_HELP["ctpu_lm_spec_acceptance_rate"],
                )
        if delivered:
            ptick.compute("lm", delivered, self._flops_per_token)

    def _log_tick(self, kind, t0, slots):
        t1 = time.monotonic()
        with self._cv:
            self._tick_log.append({
                "kind": kind, "t0": t0, "t1": t1, "lanes": slots,
                "n_lanes": self._scaler.n_lanes,
            })
        tracer = self.tracer
        if tracer is not None:
            tracer.tick_span(kind, t0, t1)

    def _drain_one(self, ptick=NULL_TICK):
        pending, snapshot = self._inflight.popleft()
        with ptick.phase("device_wait"):
            # the host-side materialization is where async dispatch pays:
            # this blocks until the tick's device work lands
            vals = _readback_values(pending).reshape(-1)
        delivered = 0
        with ptick.phase("deliver"), self._cv:
            for slot_idx, gen in snapshot:
                lane = self._lanes[slot_idx]
                if not lane.active or lane.gen != gen:
                    continue  # cancelled/finished lane: stale tick token
                # full ticks carry one token PER LANE (index by slot);
                # single-lane prefill entries carry exactly one value
                token = (
                    int(vals[slot_idx]) if vals.size > 1 else int(vals[0])
                )
                self._emit_locked(lane, token)
                lane.produced += 1
                lane.tokens.append(token)  # recompute-replay history
                delivered += 1
                done = (
                    lane.produced >= lane.remaining
                    or (self.eos_id is not None and token == self.eos_id)
                )
                if done:
                    self._retire_lane_locked(lane)
        if delivered:
            ptick.compute("lm", delivered, self._flops_per_token)

    # -- preemption / swap -------------------------------------------------

    def _preempt_step(self):
        """Swap the victim _admit chose out to the host store (or drop
        its KV for recompute when the store is full).  Scheduler thread;
        every device copy runs OUTSIDE _cv."""
        # deliver every dispatched token first so the swap record's
        # counters (produced/length) and the lane arrays' token/RNG carry
        # describe one consistent preemption point
        while self._inflight:
            self._drain_one()
        with self._cv:
            decision, self._preempt = self._preempt, None
            if decision is None or self._closed:
                return
            slot, gen = decision
            lane = self._lanes[slot]
            if not lane.active or lane.gen != gen:
                return  # completed or cancelled since the decision
            written_blocks = -(-lane.length // self.block_size)
            blocks = [int(b) for b in lane.table[:written_blocks]]
            n_blocks = len(lane.blocks)
            # a lane sitting the ticks out keeps its token and RNG aside
            parked = lane.parked
            if parked is not None and parked[0] != gen:
                parked = None
            use_swap = (
                self._swapped_blocks + written_blocks
                <= self.swap_block_limit
            )
        # device -> host gather outside the lock: scheduler-thread
        # dispatch order on the one stream guarantees every write to these
        # blocks was issued before this read, and nobody re-allocates them
        # until the release below
        host_k = host_v = None
        if use_swap:
            idx = _to_device(np.asarray(blocks, np.int64), self.device)
            host_k = [p[idx].cpu() for p in self.kv.pools["k"]]
            host_v = [p[idx].cpu() for p in self.kv.pools["v"]]
        if parked is not None:
            _, token, key = parked
            token, key = int(token), key.to("cpu", copy=True)
        else:
            token = int(self._tokens[slot])
            key = self._keys[slot].to("cpu", copy=True)  # the lane is reused
        with self._cv:
            lane = self._lanes[slot]
            if self._closed or not lane.active or lane.gen != gen:
                return  # raced with cancel/close: drop the copies
            entry = _Swapped(
                lane, n_blocks, written_blocks, token, key, host_k, host_v
            )
            self._swapped.append(entry)
            if entry.handle is not None:
                entry.handle.placed = entry
            if use_swap:
                self._swapped_blocks += written_blocks
            self._preemptions += 1
            if self.registry is not None:
                self.registry.inc(
                    "ctpu_lm_preemptions_total", None,
                    help_=LM_PREFIX_HELP["ctpu_lm_preemptions_total"],
                )
            if self.flight is not None:
                self.flight.note(
                    "lm_preemption", slot=slot, tenant=lane.tenant,
                    swapped=bool(use_swap), blocks=written_blocks,
                )
            self._swap_gauge_locked()
            # pause, don't end: the stream's queue stays open
            self._retire_lane_locked(lane, close_queue=False)

    def _resume_step(self):
        """Swap one parked stream back in when a free lane + blocks
        exist and no queued request outranks it (otherwise the blocks a
        preemption just freed would thrash straight back to the stream
        it preempted)."""
        plan = None
        with self._cv:
            if (self._closed or not self._swapped or self._job is not None
                    or self._preempt is not None):
                return
            n_lanes = self._scaler.n_lanes
            slot = next(
                (i for i in range(n_lanes) if not self._lanes[i].active),
                None,
            )
            if slot is None:
                return
            queued_pri = None
            for tenant, dq in self._pending.items():
                if dq:
                    pri = self._priority_of(tenant)
                    queued_pri = (
                        pri if queued_pri is None else max(queued_pri, pri)
                    )
            order = sorted(
                range(len(self._swapped)),
                key=lambda i: (
                    -self._priority_of(self._swapped[i].tenant), i,
                ),
            )
            for i in order:
                entry = self._swapped[i]
                if entry.cancelled:
                    continue  # cancel() removes eagerly; belt and braces
                if (queued_pri is not None
                        and self._priority_of(entry.tenant) < queued_pri):
                    continue
                if entry.host_k is not None:
                    row = entry.prompt[0]
                    cap = min(entry.prompt_len // self.block_size,
                              entry.written_blocks)
                else:
                    # recompute: the replay chain is prompt + delivered
                    # tokens, so cached generated-token blocks match too
                    row = np.concatenate([
                        entry.prompt[0],
                        np.asarray(entry.tokens[:entry.produced - 1],
                                   np.int32),
                    ])
                    cap = (entry.length - 1) // self.block_size
                matched_blocks, matched_nodes = [], []
                if self.prefix is not None and cap:
                    matched_blocks, matched_nodes = self.prefix.match(
                        row, cap
                    )
                    self.prefix.adopt(matched_nodes)
                fresh = self._reserve_locked(entry.n_blocks, matched_blocks)
                if fresh is None:
                    if matched_blocks:
                        self.kv.release(matched_blocks)
                    continue
                self._swapped.pop(i)
                blocks = matched_blocks + fresh
                table = np.full(
                    (self._table_width,), KvBlockPool.TRASH, np.int32
                )
                table[:len(blocks)] = blocks
                if entry.host_k is None:
                    pseudo = row[None, :].astype(np.int32)
                    handle = _Handle(
                        pseudo, entry.limit - entry.length, entry.queue,
                        entry.tenant, entry.temperature, entry.top_k, 0,
                    )
                    job = _PrefillJob(
                        handle, slot, blocks, table,
                        chunk_plan(
                            entry.length, self.buckets,
                            start=len(matched_blocks) * self.block_size,
                        ),
                    )
                    job.resume = entry
                    self._job = job  # _prefill_step replays from here
                    return
                plan = (entry, slot, blocks, len(matched_blocks), table,
                        entry.host_k, entry.host_v)
                break
        if plan is None:
            return
        entry, slot, blocks, n_matched, table, host_k, host_v = plan
        # restore the written, non-adopted blocks from the host store, in
        # place, on the scheduler thread's stream
        dst = blocks[n_matched:entry.written_blocks]
        if dst:
            idx = _to_device(np.asarray(dst, np.int64), self.device)
            sel = slice(n_matched, entry.written_blocks)
            for layer in range(len(host_k)):
                self.kv.pools["k"][layer][idx] = (
                    host_k[layer][sel].to(self.device)
                )
                self.kv.pools["v"][layer][idx] = (
                    host_v[layer][sel].to(self.device)
                )
        with self._cv:
            if self._closed or entry.cancelled:
                # the stream died while restoring: unwind the reservation.
                # host_k is the plan-local reference — cancel may have
                # nulled the entry's.
                if self._closed:
                    # _release_all_locked already zeroed _swapped_blocks
                    # (and cleared the cache), so no gauge decrement here.
                    # The entry was popped from _swapped BEFORE close ran,
                    # so close's sweep missed its queue: close it here or
                    # the consumer blocks on q.get() forever.
                    if not entry.cancelled:
                        entry.cancelled = True
                        entry.queue.put(_CLOSE)
                    self.kv.release(blocks)
                else:
                    self._release_blocks_locked(
                        entry.prompt, entry.length, blocks
                    )
                    self._swapped_blocks -= entry.written_blocks
                    self._swap_gauge_locked()
                return
            lane = self._lanes[slot]
            lane.gen += 1
            lane.active = True
            lane.table[:] = table
            lane.blocks = blocks
            self._restore_lane_locked(lane, entry, slot)
            self._swapped_blocks -= entry.written_blocks
            self._swap_gauge_locked()
            self._lane_gauges_locked()
        # install the saved next-tick input token + RNG carry (scheduler
        # thread: the next decode pass dispatches strictly after this)
        self._adopt(slot, entry.token, entry.key)

    def _loop(self):
        try:
            self._loop_inner()
        except Exception as exc:
            # a dying scheduler must never strand consumers on q.get()
            with self._cv:
                self._release_all_locked()
                self._closed = True
            # an engine wedge is the flagship flight-recorder anomaly:
            # capture the ring (recent ticks, spans, preemptions) NOW —
            # the postmortem must not depend on tracing having been on
            flight = self.flight
            if flight is not None:
                flight.note("lm_engine_wedge", error=repr(exc))
                flight.dump("lm_engine_wedge")
            raise

    def _loop_inner(self):
        while True:
            # every pass is one profiler tick; finish-in-finally is the
            # bracket shape the SPAN-LEAK lint demands, so a pass that
            # dies still commits the phases it measured before wedging
            tick = self.prof.start_tick("sched")
            self._ptick = tick
            try:
                alive = self._loop_pass(tick)
            finally:
                self._ptick = NULL_TICK
                self.prof.finish(tick)
            if not alive:
                break
        # shutdown: drop the in-flight tail (queues already closed)
        self._inflight.clear()

    def _loop_pass(self, ptick):
        """One scheduler pass (the former _loop_inner body); returns
        False when the engine closed and the loop must stop."""
        if self._preempt is not None:
            with ptick.phase("preempt"):
                self._preempt_step()  # device copies outside _cv
        if self._swapped:
            with ptick.phase("resume"):
                self._resume_step()
        if any(lane.held for lane in self._lanes):
            # windowed readers that read on: stream what they have room
            # for (cleared first, so a read from here on wakes the wait
            # below)
            self._wake_event.clear()
            with self._cv:
                self._release_held_locked()
        with ptick.phase("schedule"):
            self._admit()  # takes/releases _cv itself; no dispatch inside
        worked = False
        if self._job is not None:
            with ptick.phase("prefill_dispatch"):
                self._prefill_step()  # ONE chunk, outside _cv
            ptick.relabel("prefill")
            worked = True
        verified = False
        if self._spec is not None:
            # _spec_pass brackets its own phases (draft / verify_dispatch
            # / device_wait / deliver); False falls through to the plain
            # decode tick — the never-slower path
            verified = self._spec_pass(ptick)
        ticked = verified
        if not ticked:
            with ptick.phase("decode_dispatch"):
                ticked = self._decode_pass()  # ONE decode tick, outside _cv
        if ticked:
            ptick.relabel("verify" if verified else "decode")
        worked = worked or ticked
        with self._cv:
            if self._closed:
                return False
        while len(self._inflight) > (self.depth if ticked else 0):
            self._drain_one(ptick)
        if not worked and not self._inflight:
            with self._cv:
                if self._closed:
                    return False
                # swapped streams deliberately DON'T block the wait:
                # an unresumable one (blocks pinned) retries on the
                # 50ms tick instead of busy-spinning the loop
                if (not self._queued_locked()
                        and self._job is None
                        and not any(l.active for l in self._lanes)):
                    ptick.relabel("idle")
                    with ptick.phase("idle"):
                        self._cv.wait_for(
                            lambda: (self._closed
                                     or self._job is not None
                                     or self._queued_locked()
                                     or any(l.active
                                            for l in self._lanes)),
                            timeout=0.05,
                        )
            if any(lane.held for lane in self._lanes):
                # every lane left holds tokens its reader has not read:
                # wait for a read (or a submit, or close)
                ptick.relabel("idle")
                with ptick.phase("idle"):
                    self._wake_event.wait(timeout=0.05)
        return True
