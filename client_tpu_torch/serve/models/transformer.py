"""Decoder-only transformer LM, the served flagship model, in PyTorch.

Counterpart of client_tpu/serve/models/transformer.py, dense path only:
RMSNorm, rotary embeddings, grouped-query attention, SwiGLU MLP, untied
LM head.  Params are the JAX package's pytree as nested dicts of tensors,
weights in its ``[in, out]`` layout (the port computes ``x @ w``); int8
weights are ``{"q", "s"}`` dicts that ``_mm`` sends to the CUDA kernel.

- ``init_params(generator, cfg, device)``: random weights from a seeded
  ``torch.Generator``
- ``forward(params, tokens, cfg, attn_impl)``: full-sequence logits;
  ``attn_impl="flash"`` runs attention through the flash-attention
  kernels (client_tpu_torch.ops.flash_attention)
- ``prefill`` / ``decode_step``: KV-cache incremental decoding with a
  static-shape cache, written in place (plain attention, as in JAX)
- ``generate``: the token-by-token loop behind the streaming models
- ``paged_attention``: attention against the continuous-batching engine's
  paged KV pool (client_tpu_torch.serve.lm), through the paged-attention
  kernel (client_tpu_torch.ops.paged_attention)
- ``loss_fn`` / ``make_train_step``: next-token cross-entropy and the
  single-device Adam train step

Ring attention (``"ring"``, ``"ring_flash"``) and mixture-of-experts FFNs
need a mesh of several GPUs and wait for the multi-GPU slice of the port.
"""

import collections
import dataclasses

import torch
import torch.nn.functional as F

from client_tpu_torch import resolve_device
from client_tpu_torch.ops import paged_attention as _paged
from client_tpu_torch.ops.flash_attention import flash_attention
from client_tpu_torch.ops.quant import matmul as _mm
from client_tpu_torch.parallel.ring_attention import _NEG, plain_attention

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


_MOE_LATER = (
    "mixture-of-experts FFNs (n_experts > 0) are expert-parallel over a "
    "mesh and come with the multi-GPU slice of the port"
)
_RING_LATER = (
    "attn_impl={!r}: ring attention runs over a sequence-parallel mesh and "
    "comes with the multi-GPU slice of the port"
)


def _dense_only(cfg):
    if cfg.n_experts > 0:
        raise NotImplementedError(_MOE_LATER)


def init_params(generator, cfg, device=None):
    """Random params (the JAX package's layout) from a seeded CPU
    ``torch.Generator``, then moved to *device*: one seed gives the same
    weights on every device."""
    _dense_only(cfg)
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
        layers.append({
            "attn": {
                "wq": dense((cfg.d_model, cfg.n_heads * hd), cfg.d_model),
                "wk": dense((cfg.d_model, cfg.n_kv_heads * hd), cfg.d_model),
                "wv": dense((cfg.d_model, cfg.n_kv_heads * hd), cfg.d_model),
                "wo": dense((cfg.n_heads * hd, cfg.d_model), cfg.n_heads * hd),
            },
            "ln_attn": ones(cfg.d_model),
            "ln_mlp": ones(cfg.d_model),
            "mlp": {
                "w_gate": dense((cfg.d_model, cfg.d_ff), cfg.d_model),
                "w_up": dense((cfg.d_model, cfg.d_ff), cfg.d_model),
                "w_down": dense((cfg.d_ff, cfg.d_model), cfg.d_ff),
            },
        })
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


def _attention_block(layer, x, cfg, positions, attn_impl="plain"):
    """Full-sequence causal self-attention sublayer; returns (x, (k, v)) so
    prefill can capture the per-layer KV blocks for the cache."""
    if attn_impl in ("ring", "ring_flash"):
        raise NotImplementedError(_RING_LATER.format(attn_impl))
    b, t, _ = x.shape
    hd = cfg.head_dim
    h = _rms_norm(x, layer["ln_attn"])
    q = _mm(h, layer["attn"]["wq"]).reshape(b, t, cfg.n_heads, hd)
    k = _mm(h, layer["attn"]["wk"]).reshape(b, t, cfg.n_kv_heads, hd)
    v = _mm(h, layer["attn"]["wv"]).reshape(b, t, cfg.n_kv_heads, hd)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    if attn_impl == "flash":
        # the flash kernels: no [T, T] scores in device memory
        attn = flash_attention(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep))
    else:
        attn = plain_attention(q, _repeat_kv(k, n_rep), _repeat_kv(v, n_rep))
    out = _mm(attn.reshape(b, t, cfg.n_heads * hd), layer["attn"]["wo"])
    return x + out, (k, v)


def _mlp_block(layer, x):
    h = _rms_norm(x, layer["ln_mlp"])
    gate = F.silu(_mm(h, layer["mlp"]["w_gate"]))
    up = _mm(h, layer["mlp"]["w_up"])
    return x + _mm(gate * up, layer["mlp"]["w_down"])


def _ffn_block(layer, x):
    """The layer's FFN sublayer (dense only; the router aux loss of the
    MoE FFN comes with it in the training slice)."""
    if "moe" in layer:
        raise NotImplementedError(_MOE_LATER)
    return _mlp_block(layer, x)


def forward(params, tokens, cfg, attn_impl="plain", with_aux=False):
    """Full-sequence causal LM: tokens [B,T] int -> logits [B,T,V] f32.

    With ``with_aux=True`` returns ``(logits, aux)``, aux being the mean
    per-layer router load-balance loss: 0 for the dense configs the port
    runs.
    """
    _dense_only(cfg)
    t = tokens.shape[1]
    x = params["embed"][tokens.long()]
    positions = torch.arange(t, device=x.device)
    for layer in params["layers"]:
        x, _ = _attention_block(layer, x, cfg, positions, attn_impl)
        x = _ffn_block(layer, x)
    x = _rms_norm(x, params["ln_f"])
    logits = _mm(x, params["lm_head"]).float()
    if with_aux:
        return logits, logits.new_zeros(())
    return logits


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
    _dense_only(cfg)
    b, t = tokens.shape
    x = params["embed"][tokens.long()]
    positions = torch.arange(t, device=x.device)
    for i, layer in enumerate(params["layers"]):
        x, (k, v) = _attention_block(layer, x, cfg, positions)
        cache["k"][i][:, :t] = k
        cache["v"][i][:, :t] = v
        x = _ffn_block(layer, x)
    x = _rms_norm(x, params["ln_f"])
    logits = _mm(x[:, -1], params["lm_head"]).float()
    cache["len"] = torch.full((b,), t, dtype=torch.int32, device=x.device)
    return logits, cache


def decode_step(params, token, cfg, cache):
    """One incremental decode step: token [B] int -> (logits [B,V], cache).

    Writes this step's k/v into the cache in place at each row's position
    (the JAX package rebuilds the cache functionally)."""
    _dense_only(cfg)
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
        x = _ffn_block(layer, x)
    x = _rms_norm(x, params["ln_f"])
    logits = _mm(x[:, 0], params["lm_head"]).float()
    cache["len"] = pos + 1
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


def loss_fn(params, tokens, cfg, attn_impl="plain"):
    """Next-token cross-entropy over tokens [B,T] (dense configs: no router
    aux term)."""
    logits = forward(params, tokens[:, :-1], cfg, attn_impl)
    return _next_token_nll(logits, tokens[:, 1:])


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
    returns the optimizer state, a ``torch.optim.Adam`` over the params'
    leaves (optax's formula and defaults: b1 0.9, b2 0.999, eps 1e-8)."""

    def __init__(self, learning_rate):
        self.learning_rate = learning_rate

    def init(self, params):
        """Mark every leaf ``requires_grad`` and build the optimizer.  Its
        moments exist from step 0, as optax's do, so ``state_dict()`` has
        every tensor of the state (a checkpoint template needs them)."""
        leaves = list(_leaves(params))
        if not all(torch.is_floating_point(w) for w in leaves):
            raise ValueError(
                "quantized params are single-device serving weights and are "
                "not trainable; train the float params"
            )
        for w in leaves:
            w.requires_grad_(True)
        opt = torch.optim.Adam(leaves, lr=self.learning_rate,
                               betas=(0.9, 0.999), eps=1e-8)
        for w in leaves:
            opt.state[w] = {
                "step": torch.tensor(0.0),
                "exp_avg": torch.zeros_like(w),
                "exp_avg_sq": torch.zeros_like(w),
            }
        return opt


def _make_adam_step(loss, learning_rate):
    """Adam scaffolding: (loss(params, tokens) -> scalar) ->
    ``(opt, step)`` with ``step(params, opt_state, tokens) -> (params,
    opt_state, loss)``.

    The step updates the params and the optimizer state in place and hands
    the same objects back: that takes the place of the JAX step's buffer
    donation, and keeps the JAX call shape."""
    opt = _Adam(learning_rate)

    def step(params, opt_state, tokens):
        opt_state.zero_grad(set_to_none=True)
        value = loss(params, tokens)
        value.backward()
        opt_state.step()
        return params, opt_state, value.detach()

    return opt, step


def make_train_step(cfg, attn_impl="plain", learning_rate=1e-3):
    """Single-device Adam train step on next-token cross-entropy::

        opt, step = make_train_step(cfg, attn_impl="flash")
        opt_state = opt.init(params)
        params, opt_state, loss = step(params, opt_state, tokens)

    tokens [B, T+1] on the params' device; the forward sees T of them.
    Quantized params are serving-only: ``opt.init`` refuses them.
    """
    if attn_impl in ("ring", "ring_flash"):
        raise NotImplementedError(_RING_LATER.format(attn_impl))
    _dense_only(cfg)
    return _make_adam_step(
        lambda params, tokens: loss_fn(params, tokens, cfg, attn_impl),
        learning_rate,
    )


def quantize_params(params):
    """Int8 weight-only quantization of the serving weights: every 2D
    projection (attention, MLP, LM head) becomes a {"q": int8, "s": f32}
    pair for the dequant-matmul kernel; the embedding (a gather) stays in
    full precision.  Quantized params are serving-only."""
    from client_tpu_torch.ops.quant import quantize_int8

    def q_layer(layer):
        return {
            "attn": {k: quantize_int8(w) for k, w in layer["attn"].items()},
            "ln_attn": layer["ln_attn"],
            "ln_mlp": layer["ln_mlp"],
            "mlp": {k: quantize_int8(w) for k, w in layer["mlp"].items()},
        }

    return {
        "embed": params["embed"],
        "layers": [q_layer(layer) for layer in params["layers"]],
        "ln_f": params["ln_f"],
        "lm_head": quantize_int8(params["lm_head"]),
    }


def _start_readback(token):
    """Begin the device-to-host copy of a [B] token tensor; returns what
    ``_finish_readback`` needs.  On CUDA the copy goes to pinned memory
    behind an event, so the host waits only when it reads the token."""
    if token.device.type != "cuda":
        return token, None
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
             generator=None, readback_depth=8, stop_tokens=()):
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
    cache = init_cache(cfg, prompt.shape[0], device)
    logits, cache = prefill(params, prompt, cfg, cache)
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
            logits, cache = decode_step(params, token, cfg, cache)
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
