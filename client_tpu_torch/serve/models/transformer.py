"""Decoder-only transformer LM, the served flagship model, in PyTorch.

Counterpart of client_tpu/serve/models/transformer.py:
RMSNorm, rotary embeddings, grouped-query attention, a SwiGLU MLP or a
top-k-routed mixture of SwiGLU experts (``n_experts > 0``), untied LM
head.  Params are the JAX package's pytree as nested dicts of tensors,
weights in its ``[in, out]`` layout (the port computes ``x @ w``); int8
weights are ``{"q", "s"}`` dicts that ``_mm`` sends to the CUDA kernel.

- ``init_params(generator, cfg, device)``: random weights from a seeded
  ``torch.Generator``
- ``forward(params, tokens, cfg, attn_impl)``: full-sequence logits;
  ``attn_impl="flash"`` runs attention through the flash-attention
  kernels (client_tpu_torch.ops.flash_attention)
- ``prefill`` / ``decode_step``: KV-cache incremental decoding with a
  static-shape cache, written in place, its length too (plain attention,
  as in JAX); no host read, so both capture in a CUDA graph
- ``generate``: the token-by-token loop behind the streaming models, its
  prefill and decode steps replayed as CUDA graphs on CUDA
  (``programs.SerialPrograms``, the counterpart of JAX's ``_jitted_steps``)
- ``paged_attention``: attention against the continuous-batching engine's
  paged KV pool (client_tpu_torch.serve.lm), through the paged-attention
  kernel (client_tpu_torch.ops.paged_attention)
- ``loss_fn`` / ``make_train_step``: next-token cross-entropy (plus the
  router's load-balance term for MoE configs) and the Adam train step, on
  one device replayed as one CUDA graph from its second call
  (``programs.TrainProgram``, the counterpart of JAX's jitted step)
- ``stack_pipeline_params`` / ``forward_pipelined`` /
  ``make_pipeline_train_step``: the layer stack as GPipe stages over the
  mesh's ``pp`` dim (client_tpu_torch.parallel.pipeline)

With ``mesh=`` (a ``parallel.make_mesh`` DeviceMesh) ``forward``,
``loss_fn`` and ``make_train_step`` run sharded, the params DTensors laid
out by ``parallel.param_specs`` (JAX's Megatron layout): each rank runs
its local shards in a local region with the collectives written out
(``parallel.collectives``): q/k/v and the MLP's gate/up column-parallel
over ``tp`` with the cotangent of their input all-reduced, o and down
row-parallel with their output all-reduced, the embedding, LM head and
cross-entropy vocab-parallel, MoE experts over ``ep`` (each expert's
hidden dim over ``tp``), activations ``("dp","sp",None)`` and logits
``("dp","sp","tp")``.  The single-device blocks are the same code: with
no mesh every group has one rank and the collectives do nothing.
``attn_impl="ring"`` / ``"ring_flash"`` attend through
``parallel.ring_attention`` on the local shards over the ``sp`` group
(plain blocks or the flash kernels each ring step).  The gradients land on
the params' local shards, partial over ``dp`` and ``sp``; the optimizer
sums them over those dims before Adam (``_MeshAdam``).
"""

import collections
import dataclasses

import torch
import torch.nn.functional as F

from client_tpu_torch import resolve_device
from client_tpu_torch.ops import paged_attention as _paged
from client_tpu_torch.ops.flash_attention import flash_attention
from client_tpu_torch.ops.quant import matmul as _mm
from client_tpu_torch.parallel import AXES, collectives
from client_tpu_torch.parallel.ring_attention import (
    _NEG,
    plain_attention,
    ring_attention,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4
    d_ff: int = 1536
    max_seq: int = 1024
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"
    n_experts: int = 0
    top_k: int = 2
    router_aux_coef: float = 0.01

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    @property
    def tdtype(self):
        return _DTYPES[self.dtype]


def init_params(generator, cfg, device=None):
    """Random params (the JAX package's layout) from a seeded CPU
    ``torch.Generator``, then moved to *device*: one seed gives the same
    weights on every device."""
    device = resolve_device(device)
    dt = cfg.tdtype

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (w * float(fan_in ** -0.5)).to(device=device, dtype=dt)

    def ones(n):
        return torch.ones((n,), dtype=dt, device=device)

    hd = cfg.head_dim
    layers = []
    for _ in range(cfg.n_layers):
        entry = {
            "attn": {
                "wq": dense((cfg.d_model, cfg.n_heads * hd), cfg.d_model),
                "wk": dense((cfg.d_model, cfg.n_kv_heads * hd), cfg.d_model),
                "wv": dense((cfg.d_model, cfg.n_kv_heads * hd), cfg.d_model),
                "wo": dense((cfg.n_heads * hd, cfg.d_model), cfg.n_heads * hd),
            },
            "ln_attn": ones(cfg.d_model),
            "ln_mlp": ones(cfg.d_model),
        }
        if cfg.n_experts > 0:
            e = cfg.n_experts
            entry["moe"] = {
                "router": dense((cfg.d_model, e), cfg.d_model),
                "w_gate": dense((e, cfg.d_model, cfg.d_ff), cfg.d_model),
                "w_up": dense((e, cfg.d_model, cfg.d_ff), cfg.d_model),
                "w_down": dense((e, cfg.d_ff, cfg.d_model), cfg.d_ff),
            }
        else:
            entry["mlp"] = {
                "w_gate": dense((cfg.d_model, cfg.d_ff), cfg.d_model),
                "w_up": dense((cfg.d_model, cfg.d_ff), cfg.d_model),
                "w_down": dense((cfg.d_ff, cfg.d_model), cfg.d_ff),
            }
        layers.append(entry)
    return {
        "embed": dense((cfg.vocab_size, cfg.d_model), cfg.d_model),
        "layers": layers,
        "ln_f": ones(cfg.d_model),
        "lm_head": dense((cfg.d_model, cfg.vocab_size), cfg.d_model),
    }


def _rms_norm(x, scale, eps=1e-5):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def _rope(x, positions, theta):
    # x: [B,T,H,D]; positions: [B,T] or [T]
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freqs  # [B,T,half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _repeat_kv(x, n_rep):
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=2)


class _Region:
    """A rank's view of the mesh: each dim's size, this rank's index along
    it and its process group.  With no mesh, one device: every size 1 and
    no group, so the collectives in the blocks below do nothing."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        names = AXES if mesh is None else mesh.mesh_dim_names
        self.size = {a: 1 if mesh is None else mesh.size(i)
                     for i, a in enumerate(names)}
        self.rank = {a: 0 if mesh is None else mesh.get_local_rank(a)
                     for a in names}
        self.group = {a: None if mesh is None else mesh.get_group(a)
                      for a in names}

    def groups(self, *axes):
        return tuple(self.group[a] for a in axes)


_ONE_DEVICE = _Region()


def _attention_block(layer, x, cfg, positions, attn_impl="plain",
                     region=_ONE_DEVICE):
    """Full-sequence causal self-attention sublayer; returns (x, (k, v)) so
    prefill can capture the per-layer KV blocks for the cache.  In a mesh
    ``region``: heads over tp (the input's cotangent all-reduced, the
    output all-reduced), the sequence over sp through the ring."""
    r = region
    if r.mesh is None and attn_impl in ("ring", "ring_flash"):
        raise ValueError(
            f"attn_impl={attn_impl!r} runs over a sequence-parallel mesh: "
            "pass mesh=")
    b, t, _ = x.shape
    hd = cfg.head_dim
    tp = r.size["tp"]
    if cfg.n_kv_heads % tp:
        raise ValueError(
            f"{cfg.n_kv_heads} KV heads do not split over tp={tp}")
    h = _rms_norm(x, layer["ln_attn"])
    h = collectives.pbroadcast([h], r.groups("tp"))[0]
    q = _mm(h, layer["attn"]["wq"]).reshape(b, t, cfg.n_heads // tp, hd)
    k = _mm(h, layer["attn"]["wk"]).reshape(b, t, cfg.n_kv_heads // tp, hd)
    v = _mm(h, layer["attn"]["wv"]).reshape(b, t, cfg.n_kv_heads // tp, hd)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    # a tp rank's q heads read exactly its own KV heads
    n_rep = cfg.n_heads // cfg.n_kv_heads
    kr, vr = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    if attn_impl == "flash":
        # the flash kernels: no [T, T] scores in device memory
        attn = flash_attention(q, kr, vr)
    elif attn_impl in ("ring", "ring_flash") or r.size["sp"] > 1:
        # "plain" over several sp ranks is the plain ring: the same
        # attention of the whole sequence
        attn = ring_attention(q, kr, vr, r.group["sp"],
                              impl="flash" if attn_impl == "ring_flash"
                              else "plain")
    else:
        attn = plain_attention(q, kr, vr)
    out = _mm(attn.reshape(b, t, -1), layer["attn"]["wo"])
    return x + collectives.psum([out], r.groups("tp"))[0], (k, v)


def _mlp_block(layer, x, region=_ONE_DEVICE):
    """SwiGLU MLP; in a mesh region gate/up column- and down row-parallel
    over tp."""
    h = _rms_norm(x, layer["ln_mlp"])
    h = collectives.pbroadcast([h], region.groups("tp"))[0]
    gate = F.silu(_mm(h, layer["mlp"]["w_gate"]))
    up = _mm(h, layer["mlp"]["w_up"])
    out = _mm(gate * up, layer["mlp"]["w_down"])
    return x + collectives.psum([out], region.groups("tp"))[0]


def _moe_block(layer, x, cfg, with_aux=True, route=None,
               region=_ONE_DEVICE):
    """Top-k-routed mixture-of-experts FFN, the JAX package's dense
    formulation: every expert computes on every token (stacked-weight
    einsums in the params' dtype) and the router's top-k weights, a
    softmax over the k selected f32 logits, zero the unselected experts in
    an f32 combine.  Static shapes and no host read: it captures in a CUDA
    graph.

    Returns ``(x + out, aux)``: aux is the Switch load-balance loss, E ·
    Σ_e (fraction of the B·T·K routed slots on e) · (mean router
    probability of e), 1 at uniform routing; None with
    ``with_aux=False`` (the engine's ticks, which discard it: a captured
    graph would replay what XLA drops as dead code).  ``route`` ([B, T, k]
    expert indices), where given, takes the router's top-k's place, so
    that two runs can be compared on one routing.

    In a mesh ``region`` every rank routes each of its tokens (the router
    is replicated); its experts (over ep) run their hidden slice (over
    tp); the combine sums over tp and ep; the aux loss's token means run
    over the whole batch (dp and sp)."""
    r = region
    moe = layer["moe"]
    h = _rms_norm(x, layer["ln_mlp"])
    logits = h.float() @ moe["router"].float()  # [B,T,E], true f32
    if route is None:
        top_w, top_idx = torch.topk(logits, cfg.top_k, dim=-1)
    else:
        top_idx = route
        top_w = logits.gather(-1, top_idx)
    top_w = torch.softmax(top_w, dim=-1)  # renormalized over the k chosen
    # [B,T,E]: each token's k weights at their experts, 0 elsewhere (the
    # gradient reaches top_w, none the integer indices)
    combine = torch.zeros_like(logits).scatter_add(-1, top_idx, top_w)
    groups = r.groups("tp", "ep")
    hx, combine_x = collectives.pbroadcast([h, combine], groups)
    e_loc = moe["w_gate"].shape[0]
    g = torch.einsum("btd,edf->ebtf", hx, moe["w_gate"])
    u = torch.einsum("btd,edf->ebtf", hx, moe["w_up"])
    expert_out = torch.einsum(
        "ebtf,efd->ebtd", F.silu(g) * u, moe["w_down"])  # [E/ep,B,T,D]
    out = torch.einsum(
        "ebtd,bte->btd", expert_out.float(),
        combine_x.narrow(-1, r.rank["ep"] * e_loc, e_loc))
    out = collectives.psum([out], groups)[0].to(x.dtype)
    if not with_aux:
        return x + out, None
    probs = torch.softmax(logits, dim=-1)
    frac = F.one_hot(top_idx, cfg.n_experts).float().mean(dim=(0, 1, 2))
    mean_p = probs.mean(dim=(0, 1))
    # every rank holds as many tokens: the batch's mean is the ranks' mean
    n = r.size["dp"] * r.size["sp"]
    frac, mean_p = (s / n for s in collectives.psum(
        [frac, mean_p], r.groups("dp", "sp")))
    aux = cfg.n_experts * torch.sum(frac * mean_p)
    return x + out, aux


def _ffn_block(layer, x, cfg, with_aux=True, region=_ONE_DEVICE):
    """FFN (dense or MoE) -> (residual output, router aux loss): 0 for a
    dense layer; None with ``with_aux=False``, where the caller discards
    it (prefill, decode and the engine's ticks)."""
    if "moe" in layer:
        return _moe_block(layer, x, cfg, with_aux, region=region)
    out = _mlp_block(layer, x, region)
    if not with_aux:
        return out, None
    return out, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(params, tokens, cfg, attn_impl="plain", with_aux=False, *,
            mesh=None):
    """Full-sequence causal LM: tokens [B,T] int -> logits [B,T,V] f32.

    With ``with_aux=True`` returns ``(logits, aux)``, aux being the mean
    per-layer router load-balance loss (0 for dense configs).  With
    ``mesh`` the logits are a DTensor laid out ``("dp","sp","tp")`` (see
    the module docstring; tokens the same on every rank, or a DTensor).
    """
    if mesh is None:
        logits, aux = _forward_local(params, tokens, cfg, attn_impl,
                                     with_aux)
    else:
        rows = _local_rows(tokens, mesh)
        logits, aux = _forward_local(params, _sp_chunk(rows, mesh), cfg,
                                     attn_impl, with_aux, mesh)
        logits = _logits_dtensor(logits, mesh, tokens.shape)
    return (logits, aux) if with_aux else logits


def _forward_local(params, tokens, cfg, attn_impl, with_aux, mesh=None):
    """Logits f32 of this rank's tokens [b, t] and the mean router aux
    loss (None without ``with_aux``).  With ``mesh``: the tokens are its dp
    rows and sp chunk, the logits [b, t, V/tp], and the params' gradients
    land on their local shards, partial over dp and sp."""
    r = _ONE_DEVICE
    if mesh is not None:
        from client_tpu_torch.parallel import param_specs

        _check_mesh(params, attn_impl)
        r = _Region(mesh)
        params = _local_params(params, param_specs(cfg), mesh, ("dp", "sp"))
    x = _embed(params["embed"], tokens, r)
    t = tokens.shape[1]
    start = r.rank["sp"] * t
    positions = torch.arange(start, start + t, device=x.device)
    aux_total = 0.0
    for layer in params["layers"]:
        x, _ = _attention_block(layer, x, cfg, positions, attn_impl, r)
        x, aux = _ffn_block(layer, x, cfg, with_aux, r)
        if with_aux:
            aux_total = aux_total + aux
    x = _rms_norm(x, params["ln_f"])
    x = collectives.pbroadcast([x], r.groups("tp"))[0]
    logits = _mm(x, params["lm_head"]).float()
    return logits, aux_total / len(params["layers"]) if with_aux else None


# -- the sharded forward's pieces ------------------------------------------

def _check_mesh(params, attn_impl):
    """JAX's two refusals on a mesh (its transformer.py:170 and :251)."""
    from client_tpu_torch.ops.quant import is_quantized

    if is_quantized(params["lm_head"]):
        # the int8 kernel runs on one device's weights; JAX refuses too
        raise ValueError(
            "quantized params are single-device serving weights; "
            "dequantize or drop the mesh"
        )
    if attn_impl == "flash":
        raise ValueError(
            "attn_impl='flash' is single-shard; use attn_impl='ring' "
            "with a mesh"
        )


def _local_params(tree, specs, mesh, partial):
    """Each param's local shard, by ``specs``' layout
    (``parallel.local_shard``); its gradient is partial over the mesh dims
    in ``partial`` (the ones whose ranks see other tokens)."""
    from client_tpu_torch.parallel import local_shard, tree_map

    return tree_map(lambda x, spec: local_shard(x, mesh, spec, partial),
                    tree, specs)


def _local_rows(tokens, mesh):
    """This rank's rows of the batch ([B/dp, T], dp-contiguous) from
    tokens the same on every rank, or from a DTensor."""
    from torch.distributed.tensor import DTensor

    from client_tpu_torch.parallel import P, placements

    if isinstance(tokens, DTensor):
        return tokens.redistribute(
            mesh, placements(mesh, P("dp", None))).to_local()
    return _chunk(tokens, 0, mesh, "dp")


def _chunk(x, dim, mesh, axis):
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if x.shape[dim] % n:
        raise ValueError(
            f"dim {dim} of size {x.shape[dim]} does not split over "
            f"{axis}={n}")
    return x.chunk(n, dim)[mesh.get_local_rank(axis)]


def _sp_chunk(rows, mesh):
    return _chunk(rows, 1, mesh, "sp")


def _logits_dtensor(logits, mesh, token_shape):
    from torch.distributed.tensor import DTensor

    from client_tpu_torch.parallel import logit_spec, placements

    b, t = token_shape
    v = logits.shape[-1] * mesh.size(mesh.mesh_dim_names.index("tp"))
    return DTensor.from_local(
        logits, mesh, placements(mesh, logit_spec()), run_check=False,
        shape=torch.Size((b, t, v)), stride=(t * v, v, 1))


def _embed(embed, tokens, r):
    """Vocab-parallel lookup: each tp rank answers the tokens in its rows
    of the table, zeros elsewhere; the all-reduce sums the one answer."""
    if r.size["tp"] == 1:
        return embed[tokens.long()]
    rows = embed.shape[0]
    local = tokens.long() - r.rank["tp"] * rows
    inside = (local >= 0) & (local < rows)
    x = embed[local.clamp(0, rows - 1)] * inside[..., None].to(embed.dtype)
    return collectives.psum([x], r.groups("tp"))[0]


def _sharded_nll(logits, targets, r, batch_axes, vocab_parallel=True):
    """Mean next-token cross-entropy over the whole batch from this rank's
    logits [b, t, V/tp] (vocab-parallel over tp; whole rows with
    ``vocab_parallel=False``) and targets [b, t]; the token sum runs over
    ``batch_axes``."""
    if not vocab_parallel or r.size["tp"] == 1:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, targets[..., None].long()).sum()
    else:
        tp = r.groups("tp")
        shift = collectives.pmax(logits.amax(dim=-1, keepdim=True), tp)
        sumexp = torch.exp(logits - shift).sum(dim=-1, keepdim=True)
        cols = logits.shape[-1]
        local = targets.long()[..., None] - r.rank["tp"] * cols
        inside = (local >= 0) & (local < cols)
        picked = torch.gather(logits, -1, local.clamp(0, cols - 1)) * inside
        sumexp, picked = collectives.psum([sumexp, picked], tp)
        nll = (torch.log(sumexp) + shift - picked).sum()
    nll = collectives.psum([nll], r.groups(*batch_axes))[0]
    n = targets.numel()
    for axis in batch_axes:
        n *= r.size[axis]
    return nll / n


def init_cache(cfg, batch, device=None):
    """Static-shape KV cache: per layer k/v [B, max_seq, n_kv, head_dim]."""
    device = resolve_device(device)
    shape = (batch, cfg.max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": [torch.zeros(shape, dtype=cfg.tdtype, device=device)
              for _ in range(cfg.n_layers)],
        "v": [torch.zeros(shape, dtype=cfg.tdtype, device=device)
              for _ in range(cfg.n_layers)],
        "len": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def prefill(params, tokens, cfg, cache):
    """Run the prompt through the model, filling the cache from position 0
    (in place).  Returns (last-token logits [B,V], cache)."""
    b, t = tokens.shape
    x = params["embed"][tokens.long()]
    positions = torch.arange(t, device=x.device)
    for i, layer in enumerate(params["layers"]):
        x, (k, v) = _attention_block(layer, x, cfg, positions)
        cache["k"][i][:, :t] = k
        cache["v"][i][:, :t] = v
        x, _ = _ffn_block(layer, x, cfg, with_aux=False)
    x = _rms_norm(x, params["ln_f"])
    logits = _mm(x[:, -1], params["lm_head"]).float()
    cache["len"].fill_(t)
    return logits, cache


def decode_step(params, token, cfg, cache):
    """One incremental decode step: token [B] int -> (logits [B,V], cache).

    Writes this step's k/v into the cache in place at each row's position,
    and advances ``cache["len"]`` in place (the JAX package rebuilds the
    cache functionally): a CUDA graph of this step reads and writes the
    same buffers at every replay."""
    b = token.shape[0]
    x = params["embed"][token.long()][:, None, :]  # [B,1,D]
    pos = cache["len"]  # [B]
    rows = torch.arange(b, device=x.device)
    slot = pos.long()
    hd = cfg.head_dim
    n_rep = cfg.n_heads // cfg.n_kv_heads
    valid = torch.arange(cfg.max_seq, device=x.device)[None, :] <= pos[:, None]
    for i, layer in enumerate(params["layers"]):
        h = _rms_norm(x, layer["ln_attn"])
        q = _mm(h, layer["attn"]["wq"]).reshape(b, 1, cfg.n_heads, hd)
        k = _mm(h, layer["attn"]["wk"]).reshape(b, 1, cfg.n_kv_heads, hd)
        v = _mm(h, layer["attn"]["wv"]).reshape(b, 1, cfg.n_kv_heads, hd)
        q = _rope(q, pos[:, None], cfg.rope_theta)
        k = _rope(k, pos[:, None], cfg.rope_theta)
        # overwrite (not add) the slot at `pos`, so a reused cache with stale
        # rows beyond the prompt cannot corrupt this step's K/V
        cache["k"][i][rows, slot] = k[:, 0]
        cache["v"][i][rows, slot] = v[:, 0]
        # attention against the full static-shape cache, length-masked
        kk = _repeat_kv(cache["k"][i], n_rep)
        vv = _repeat_kv(cache["v"][i], n_rep)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float()) * (hd ** -0.5)
        s = s.masked_fill(~valid[:, None, None, :], _NEG)
        p = torch.softmax(s, dim=-1)
        attn = torch.einsum("bhqk,bkhd->bqhd", p.to(vv.dtype), vv)
        out = _mm(attn.reshape(b, 1, cfg.n_heads * hd), layer["attn"]["wo"])
        x = x + out.to(x.dtype)
        x, _ = _ffn_block(layer, x, cfg, with_aux=False)
    x = _rms_norm(x, params["ln_f"])
    logits = _mm(x[:, 0], params["lm_head"]).float()
    pos.add_(1)
    return logits, cache


def paged_attention(q, pool_k, pool_v, tables, pos, cfg, block_size):
    """Attention of ``q`` ([B,T,H,hd], already roped) against a PAGED KV
    cache: ``pool_k``/``pool_v`` are one layer's block pools
    ([n_blocks+1, block_size, n_kv, hd], serve/lm/kv.KvBlockPool layout)
    and ``tables`` ([B, table_width] int32) maps each lane's logical block
    index to its physical pool block.  Length-masked at ``pos`` ([B,T]
    int32 logical query positions; keys at logical position j attend iff
    j <= pos), so trash-mapped rows are never read.

    A CUDA tensor runs the paged-attention kernel (one launch); a CPU
    tensor its plain version, the JAX function step by step."""
    if q.shape[2] != cfg.n_heads or pool_k.shape[2] != cfg.n_kv_heads:
        raise ValueError(
            f"paged_attention: q has {q.shape[2]} heads and the pools "
            f"{pool_k.shape[2]} KV heads; the config has {cfg.n_heads} and "
            f"{cfg.n_kv_heads}"
        )
    return _paged.paged_attention(q, pool_k, pool_v, tables, pos, block_size)


def lm_flops_per_token(cfg, context=0):
    """Model FLOPs one generated token costs: 2 per weight element of every
    matmul the token traverses (the PaLM 2N convention), plus the attention
    score/combine term for ``context`` live positions."""
    hd = cfg.head_dim
    attn_w = (
        cfg.d_model * cfg.n_heads * hd          # wq
        + 2 * cfg.d_model * cfg.n_kv_heads * hd  # wk, wv
        + cfg.n_heads * hd * cfg.d_model         # wo
    )
    ffn_active = 3 * cfg.d_model * cfg.d_ff
    if cfg.n_experts > 0:
        ffn_active *= cfg.top_k
        ffn_active += cfg.d_model * cfg.n_experts  # router
    per_layer = 2 * (attn_w + ffn_active)
    per_layer += 4 * cfg.n_heads * hd * int(context)  # scores + combine
    head = 2 * cfg.d_model * cfg.vocab_size
    return cfg.n_layers * per_layer + head


def _next_token_nll(logits, targets):
    """Mean next-token cross-entropy: logits [B,T,V] f32, targets [B,T]."""
    logp = torch.log_softmax(logits, dim=-1)
    return torch.mean(-torch.gather(logp, -1, targets[..., None].long()))


def loss_fn(params, tokens, cfg, attn_impl="plain", *, mesh=None):
    """Next-token cross-entropy over tokens [B,T] (+ router aux for MoE).
    With ``mesh``: the mean over the whole batch, the same value on every
    rank, its gradients partial over ``dp`` and ``sp``."""
    if mesh is not None:
        rows = _local_rows(tokens, mesh)
        logits, aux = _forward_local(
            params, _sp_chunk(rows[:, :-1], mesh), cfg, attn_impl, True,
            mesh)
        loss = _sharded_nll(logits, _sp_chunk(rows[:, 1:], mesh),
                            _Region(mesh), ("dp", "sp"))
    else:
        logits, aux = forward(params, tokens[:, :-1], cfg, attn_impl,
                              with_aux=True)
        loss = _next_token_nll(logits, tokens[:, 1:])
    if cfg.n_experts > 0:
        loss = loss + cfg.router_aux_coef * aux
    return loss


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


class _Adam:
    """The counterpart of ``optax.adam(learning_rate)``: ``init(params)``
    returns the optimizer state, an ``_AdamState`` over the params' leaves
    (optax's formula and defaults: b1 0.9, b2 0.999, eps 1e-8); for params
    laid out on a mesh (DTensors), a ``_MeshAdam``."""

    def __init__(self, learning_rate):
        self.learning_rate = learning_rate

    def init(self, params):
        """Mark every leaf ``requires_grad`` and build the optimizer.  Its
        moments exist from step 0, as optax's do, so ``state_dict()`` has
        every tensor of the state (a checkpoint template needs them)."""
        from torch.distributed.tensor import DTensor

        leaves = list(_leaves(params))
        if not all(torch.is_floating_point(w) for w in leaves):
            raise ValueError(
                "quantized params are single-device serving weights and are "
                "not trainable; train the float params"
            )
        for w in leaves:
            w.requires_grad_(True)
        kw = dict(lr=self.learning_rate, betas=(0.9, 0.999), eps=1e-8)
        on_mesh = [isinstance(w, DTensor) for w in leaves]
        if any(on_mesh):
            if not all(on_mesh):
                raise ValueError(
                    "params mix DTensors and plain tensors; lay every leaf "
                    "out on the mesh (parallel.device_put)")
            return _MeshAdam(leaves, **kw)
        return _AdamState(leaves, **kw)


class _AdamState(torch.optim.Optimizer):
    """optax's Adam update as tensor ops, every tensor of the state on
    the params' device (``step`` too, as a float32 scalar a leaf, the
    layout of ``torch.optim.Adam``'s ``state_dict()``): the same formula
    runs eagerly on the CPU and inside a CUDA graph, with no host read.
    ``torch.optim.Adam``'s ``capturable`` refuses CPU params, and its
    non-capturable ``step`` lives on the host.

    ``load_state_dict`` copies the saved tensors into the live ones, so a
    captured step goes on updating the state it was captured over; the
    hyperparameters are the ones ``init`` was given (a checkpoint with
    others is refused), as optax's are fixed in its update function."""

    def __init__(self, params, lr, betas, eps):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))
        for w in self.param_groups[0]["params"]:
            self.state[w] = {
                "step": torch.zeros((), dtype=torch.float32,
                                    device=w.device),
                "exp_avg": torch.zeros_like(w),
                "exp_avg_sq": torch.zeros_like(w),
            }

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            live = [w for w in group["params"] if w.grad is not None]
            if not live:
                continue
            st = [self.state[w] for w in live]
            grads = [w.grad for w in live]
            steps = [x["step"] for x in st]
            mu = [x["exp_avg"] for x in st]
            nu = [x["exp_avg_sq"] for x in st]
            # optax.scale_by_adam: mu = b1 mu + (1 - b1) g,
            # nu = b2 nu + (1 - b2) g², both bias-corrected, then
            # mu_hat / (sqrt(nu_hat) + eps), scaled by -lr
            torch._foreach_add_(steps, 1.0)
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
            bc1 = torch._foreach_pow(b1, steps)
            bc2 = torch._foreach_pow(b2, steps)
            torch._foreach_neg_(bc1)
            torch._foreach_neg_(bc2)
            torch._foreach_add_(bc1, 1.0)
            torch._foreach_add_(bc2, 1.0)
            mu_hat = torch._foreach_div(mu, bc1)
            nu_hat = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(nu_hat)
            torch._foreach_add_(nu_hat, group["eps"])
            torch._foreach_div_(mu_hat, nu_hat)
            torch._foreach_add_(live, mu_hat, alpha=-group["lr"])

    def load_state_dict(self, state_dict):
        saved = state_dict["param_groups"]
        if len(saved) != len(self.param_groups):
            raise ValueError("the checkpoint has another number of "
                             "parameter groups")
        for group, old in zip(self.param_groups, saved):
            for key in ("lr", "betas", "eps"):
                if _floats(group[key]) != _floats(old[key]):
                    raise ValueError(
                        f"the checkpoint's {key} {old[key]} is not this "
                        f"optimizer's {group[key]}")
            if len(old["params"]) != len(group["params"]):
                raise ValueError("the checkpoint holds another number of "
                                 "parameters")
        params = [w for g in self.param_groups for w in g["params"]]
        ids = [i for g in saved for i in g["params"]]
        with torch.no_grad():
            for i, w in zip(ids, params):
                for key, value in state_dict["state"].get(i, {}).items():
                    self.state[w][key].copy_(value)


def _floats(x):
    """A hyperparameter as a tuple of floats (``betas`` is a pair)."""
    return tuple(float(v) for v in x) if isinstance(
        x, (tuple, list)) else (float(x),)


class _MeshAdam(_AdamState):
    """Adam over the local shards of DTensor params: each rank updates its
    shard with its moments, plain tensors (DTensor dispatch would look up
    a sharding rule for every op of the update on every step), by the
    single-device update's formula, so a one-rank mesh steps bit for bit
    as one device does.

    The model's local regions compute on these same shards
    (``parallel.local_shard``), so the gradients land on them; ``step()``
    first sums each one over the mesh dims where it is partial
    (``shard.partial_over``: an all-reduce a dim, in one order on every
    rank).  ``state_dict()`` gives the moments as DTensors of their
    params' layouts, sharing the shards' memory; ``load_state_dict``
    takes them back (or plain full tensors, which each rank slices)."""

    def __init__(self, params, **kw):
        self._mesh_params = list(params)
        with torch.no_grad():
            shards = [w.to_local() for w in self._mesh_params]
        for shard in shards:
            shard.requires_grad_(True)
        super().__init__(shards, **kw)

    def _pairs(self):
        return zip(self._mesh_params, self.param_groups[0]["params"])

    @torch.no_grad()
    def step(self, closure=None):
        import torch.distributed as dist

        for w, shard in self._pairs():
            if shard.grad is None:
                continue
            mesh = w.device_mesh
            for dim, name in enumerate(mesh.mesh_dim_names):
                if (name in getattr(shard, "partial_over", ())
                        and mesh.size(dim) > 1):
                    dist.all_reduce(shard.grad, group=mesh.get_group(dim))
        return super().step(closure)

    def state_dict(self):
        from torch.distributed.tensor import DTensor

        out = super().state_dict()
        for i, w in enumerate(self._mesh_params):
            if i not in out["state"]:
                continue
            # a copy: the packed dicts are the optimizer's own
            st = out["state"][i] = dict(out["state"][i])
            for key in ("exp_avg", "exp_avg_sq"):
                if key in st:
                    st[key] = DTensor.from_local(
                        st[key], w.device_mesh, w.placements,
                        run_check=False, shape=w.shape, stride=w.stride())
        return out

    def load_state_dict(self, state_dict):
        from torch.distributed.tensor import DTensor, distribute_tensor

        state_dict = {**state_dict, "state": {
            i: dict(st) for i, st in state_dict["state"].items()}}
        for i, st in state_dict["state"].items():
            w = self._mesh_params[i]
            for key in ("exp_avg", "exp_avg_sq"):
                x = st.get(key)
                if isinstance(x, DTensor):
                    st[key] = x.redistribute(w.device_mesh,
                                             w.placements).to_local()
                elif isinstance(x, torch.Tensor) and x.shape == w.shape:
                    st[key] = distribute_tensor(
                        x, w.device_mesh, w.placements,
                        src_data_rank=None).to_local()
        super().load_state_dict(state_dict)


def _make_adam_step(loss, learning_rate, graph=False):
    """Adam scaffolding: (loss(params, tokens) -> scalar) ->
    ``(opt, step)`` with ``step(params, opt_state, tokens) -> (params,
    opt_state, loss)``.

    The step updates the params and the optimizer state in place and hands
    the same objects back: that takes the place of the JAX step's buffer
    donation, and keeps the JAX call shape.  With ``graph`` the step is a
    ``programs.TrainProgram``: replayed as one CUDA graph from its second
    call on CUDA, run on a static token buffer on the CPU.  The callers
    pass ``programs.graphable(mesh)``: a gloo world's steps are eager."""
    from client_tpu_torch.serve.models.programs import TrainProgram

    opt = _Adam(learning_rate)

    def body(params, opt_state, tokens):
        opt_state.zero_grad(set_to_none=True)
        value = loss(params, tokens)
        value.backward()
        opt_state.step()
        return value

    program = TrainProgram(body) if graph else None

    def step(params, opt_state, tokens):
        if program is not None:
            return params, opt_state, program(params, opt_state, tokens)
        return params, opt_state, body(params, opt_state, tokens).detach()

    step.program = program
    return opt, step


def make_train_step(cfg, attn_impl="plain", learning_rate=1e-3, *,
                    mesh=None, eager=False):
    """Adam train step on next-token cross-entropy::

        opt, step = make_train_step(cfg, attn_impl="flash")
        opt_state = opt.init(params)
        params, opt_state, loss = step(params, opt_state, tokens)

    tokens [B, T+1] on the params' device; the forward sees T of them.
    Quantized params are serving-only: ``opt.init`` refuses them.  With
    ``mesh``, params are DTensors laid out by ``parallel.param_specs``
    (``parallel.device_put``), tokens the same on every rank (or a DTensor),
    and every rank runs the step; ``attn_impl`` "ring" or "ring_flash"
    shards the sequence over ``sp``.

    The step is one program, as JAX's jitted step is (``step.program``, a
    ``programs.TrainProgram``): on CUDA its first call runs eagerly (the
    warm-up), its second captures the whole step as a CUDA graph, and
    every later call with the same params, state and token shape replays
    it.  That holds on one device and on a mesh whose every group runs on
    NCCL (``programs.graphable``).  A mesh on a gloo world stays eager
    (``step.program`` is None): gloo stages CUDA tensors through host
    memory, which a capture cannot record.  ``eager=True`` runs every step
    eagerly (a comparison leg).  A capture or replay that fails raises;
    nothing runs the eager step in its place.
    """
    from client_tpu_torch.serve.models.programs import graphable

    return _make_adam_step(
        lambda params, tokens: loss_fn(params, tokens, cfg, attn_impl,
                                       mesh=mesh),
        learning_rate, graph=graphable(mesh) and not eager,
    )


def quantize_params(params):
    """Int8 weight-only quantization of the serving weights: every 2D
    projection (attention, dense MLP, LM head) becomes a {"q": int8, "s":
    f32} pair for the dequant-matmul kernel; the embedding (a gather)
    stays in full precision and MoE expert stacks keep their einsum path.
    Quantized params are serving-only."""
    from client_tpu_torch.ops.quant import quantize_int8

    def q_layer(layer):
        out = {
            "attn": {k: quantize_int8(w) for k, w in layer["attn"].items()},
            "ln_attn": layer["ln_attn"],
            "ln_mlp": layer["ln_mlp"],
        }
        if "mlp" in layer:
            out["mlp"] = {
                k: quantize_int8(w) for k, w in layer["mlp"].items()
            }
        if "moe" in layer:
            out["moe"] = layer["moe"]
        return out

    return {
        "embed": params["embed"],
        "layers": [q_layer(layer) for layer in params["layers"]],
        "ln_f": params["ln_f"],
        "lm_head": quantize_int8(params["lm_head"]),
    }


def stack_pipeline_params(params, n_stages):
    """Re-lay the per-layer list as pipeline stages (parallel.pipeline);
    ``pipeline_param_specs`` gives the layout on a mesh."""
    from client_tpu_torch.parallel.pipeline import stack_stage_params

    return {
        "embed": params["embed"],
        "stages": stack_stage_params(params["layers"], n_stages),
        "ln_f": params["ln_f"],
        "lm_head": params["lm_head"],
    }


def pipeline_param_specs(pparams, axis="pp"):
    """The layout of ``stack_pipeline_params``' tree: the stage dim over
    ``axis``, embedding, final norm and LM head replicated (they run
    outside the pipeline region, as in JAX)."""
    from client_tpu_torch.parallel import P
    from client_tpu_torch.parallel.pipeline import stage_specs

    return {"embed": P(), "stages": stage_specs(pparams["stages"], axis),
            "ln_f": P(), "lm_head": P()}


def _pipelined_local(pparams, rows, cfg, mesh, n_microbatches):
    """Logits [b, T, V] f32 of this rank's dp rows [b, T] through the
    pipelined stack; the params' gradients partial over dp."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from client_tpu_torch.parallel import P
    from client_tpu_torch.parallel.pipeline import pipeline_apply

    outside = {k: pparams[k] for k in ("embed", "ln_f", "lm_head")}
    lp = _local_params(outside, {k: P() for k in outside}, mesh, ("dp",))
    t = rows.shape[1]
    x = lp["embed"][rows.long()]
    positions = torch.arange(t, device=x.device)

    def stage_fn(stage_layers, h):
        for i in range(next(iter(_leaves(stage_layers))).shape[0]):
            layer = _index_tree(stage_layers, i)
            h, _ = _attention_block(layer, h, cfg, positions, "plain")
            h, _ = _ffn_block(layer, h, cfg, with_aux=False)
        return h

    names = mesh.mesh_dim_names
    n_dp = mesh.size(names.index("dp"))
    layout = [Shard(0) if name == "dp" else Replicate() for name in names]
    x = DTensor.from_local(x, mesh, layout, run_check=False,
                           shape=torch.Size((x.shape[0] * n_dp,
                                             *x.shape[1:])),
                           stride=x.stride())
    x = pipeline_apply(stage_fn, pparams["stages"], x, mesh,
                       n_microbatches).to_local()
    x = _rms_norm(x, lp["ln_f"])
    return _mm(x, lp["lm_head"]).float()


def _index_tree(tree, i):
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


def forward_pipelined(pparams, tokens, cfg, mesh, n_microbatches):
    """Full-sequence logits with the layer stack pipelined over ``pp``.

    Embedding and LM head run outside the pipeline region (replicated);
    each stage runs its local layer block over the incoming microbatch,
    whose rows split over ``dp`` (parallel.pipeline's batch_axis).
    Returns a DTensor [B, T, V]: rows over dp, replicated elsewhere."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    _check_mesh(pparams, "plain")
    rows = _local_rows(tokens, mesh)
    logits = _pipelined_local(pparams, rows, cfg, mesh, n_microbatches)
    b, t = tokens.shape
    v = logits.shape[-1]
    layout = [Shard(0) if name == "dp" else Replicate()
              for name in mesh.mesh_dim_names]
    return DTensor.from_local(logits, mesh, layout, run_check=False,
                              shape=torch.Size((b, t, v)),
                              stride=(t * v, v, 1))


def _pipeline_loss(pparams, tokens, cfg, mesh, n_microbatches):
    """Mean next-token cross-entropy of tokens [B, T+1] through the
    pipelined stack, the same value on every rank."""
    _check_mesh(pparams, "plain")
    rows = _local_rows(tokens, mesh)
    logits = _pipelined_local(pparams, rows[:, :-1], cfg, mesh,
                              n_microbatches)
    return _sharded_nll(logits, rows[:, 1:], _Region(mesh), ("dp",),
                        vocab_parallel=False)


def make_pipeline_train_step(cfg, mesh, n_microbatches, learning_rate=1e-3,
                             *, eager=False):
    """Adam train step over pipeline-stacked params laid out by
    ``pipeline_param_specs``: gradients flow back through the schedule
    (the reverse permute).  Pipeline composes with data parallelism (each
    dp rank pipelines its rows); stage weights are replicated over tp/ep
    within the region, and the MoE router aux loss is not collected on
    this path (as in JAX).

    As ``make_train_step``'s mesh step: one CUDA graph a step from the
    second call where every group of ``mesh`` runs on NCCL
    (``programs.graphable``), the schedule's Python loop run once, at the
    capture; eager on a gloo world and with ``eager=True``."""
    from client_tpu_torch.serve.models.programs import graphable

    return _make_adam_step(
        lambda pparams, tokens: _pipeline_loss(pparams, tokens, cfg, mesh,
                                               n_microbatches),
        learning_rate, graph=graphable(mesh) and not eager)


def _start_readback(token):
    """Begin the device-to-host copy of a [B] token tensor; returns what
    ``_finish_readback`` needs: the values the tensor holds now, though a
    later dispatch may overwrite it in place.  On CUDA the copy goes to
    pinned memory behind an event, so the host waits only when it reads
    the token."""
    if token.device.type != "cuda":
        return token.clone(), None
    host = torch.empty(token.shape, dtype=token.dtype, pin_memory=True)
    host.copy_(token, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _readback_values(pending):
    """Wait for a readback started by ``_start_readback``; returns the
    values as a numpy array (a copy: the device tensor may change)."""
    host, done = pending
    if done is not None:
        done.synchronize()
    return host.numpy().copy()


def _finish_readback(pending):
    return int(_readback_values(pending)[0])


def generate(params, cfg, prompt, max_new_tokens, temperature=0.0,
             generator=None, readback_depth=8, stop_tokens=(), eager=False):
    """Greedy/sampled generation; yields one int token id at a time.

    Each yield maps to one decoupled KServe response in the streaming
    serving path.  Generation stops early if the KV cache fills
    (prompt_len + new tokens > cfg.max_seq) or a ``stop_tokens`` id is
    produced (the stop token is still yielded).

    The decode loop is pipelined as in the JAX package: step i's token is
    selected on the device and its copy to the host started (pinned memory
    plus a ``torch.cuda.Event``) while decode step i+1 is launched, keeping
    up to ``readback_depth`` readbacks in flight.  The token stream is the
    serial order's; a stop token is known on the host up to
    ``readback_depth`` steps late, and those steps are discarded.
    ``readback_depth=0`` is the strict serial schedule.

    Sampling (``temperature > 0``) draws with ``torch.multinomial`` from
    *generator* (seed 0 if None): repeatable for a seed, but not the JAX
    package's threefry stream.

    The prefill and the decode steps run through a program set
    (``programs.SerialPrograms``) lent by the pool that
    ``programs.serial_pool`` keeps for these params: on CUDA each is a CUDA
    graph over the set's static cache, the prefill's captured at the first
    sight of a prompt length, and on the CPU the same bodies run eagerly on
    the same buffers.  The token is chosen outside the programs, as JAX picks
    it outside its jitted ``decode_step``.  ``eager=True`` runs ``prefill``
    and ``decode_step`` eagerly on a cache of the call's own (a comparison
    leg; the tokens are the same).
    """
    device = params["embed"].device
    prompt = torch.as_tensor(prompt, dtype=torch.int32, device=device)
    if prompt.dim() == 1:
        prompt = prompt[None, :]
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    # the cache slot for step i's token is prompt_len + i; the last usable
    # slot is max_seq - 1
    max_new_tokens = min(max_new_tokens, cfg.max_seq - prompt.shape[1])
    if eager:
        yield from _generate(params, cfg, prompt, max_new_tokens,
                             temperature, generator, readback_depth,
                             stop_tokens, None)
        return
    from client_tpu_torch.serve.models.programs import serial_pool

    with serial_pool(params, cfg).acquire(params, prompt.shape[0]) as progs:
        yield from _generate(params, cfg, prompt, max_new_tokens,
                             temperature, generator, readback_depth,
                             stop_tokens, progs)


def _generate(params, cfg, prompt, max_new_tokens, temperature, generator,
              readback_depth, stop_tokens, progs):
    """``generate``'s loop, through the program set ``progs`` (None: the
    eager functions on a cache of its own)."""
    if progs is None:
        cache = init_cache(cfg, prompt.shape[0], prompt.device)
        logits, cache = prefill(params, prompt, cfg, cache)
    else:
        logits = progs.prefill(params, prompt)
    depth = max(int(readback_depth), 0)
    stop = frozenset(int(t) for t in stop_tokens)
    pending = collections.deque()
    for i in range(max_new_tokens):
        if temperature > 0.0:
            probs = torch.softmax(logits / temperature, dim=-1)
            token = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            token = torch.argmax(logits, dim=-1)
        token = token.to(torch.int32)
        pending.append(_start_readback(token))
        if i + 1 < max_new_tokens:
            if progs is None:
                logits, cache = decode_step(params, token, cfg, cache)
            else:
                logits = progs.decode(params, token)
        while len(pending) > depth:
            t = _finish_readback(pending.popleft())
            yield t
            if t in stop:
                return  # stop launching; in-flight steps are discarded
    while pending:
        t = _finish_readback(pending.popleft())
        yield t
        if t in stop:
            return
