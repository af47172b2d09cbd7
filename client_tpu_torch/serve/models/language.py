"""Language-model serving stack: tokenizer + streaming decoder LM.

Counterpart of client_tpu/serve/models/language.py: a byte-level
tokenizer model, decoupled LMs that stream one response per generated
token, and a text ensemble that chains them server-side.
``lm_streaming`` runs the serial ``generate`` loop (its prefill and decode
steps replayed as CUDA graphs on CUDA); ``lm_streaming_batched``
serves the same weights through the continuous-batching engine
(client_tpu_torch.serve.lm: paged KV pool, chunked prefill, prefix cache,
speculative decoding), every step's attention through the paged-attention
kernel; ``lm_streaming_int8`` serves them int8-quantized, every tiling
projection through the CUDA dequant-matmul kernel, batched on the engine
on a CUDA device and serially on the CPU.
"""

import numpy as np
import torch

from client_tpu_torch import resolve_device
from client_tpu_torch.serve.model_runtime import Model, TensorSpec
from client_tpu_torch.serve.models import transformer as tfm
from client_tpu_torch.utils import InferenceServerException

# byte-level vocab: 256 bytes + BOS + EOS
_BOS = 256
_EOS = 257
_VOCAB = 258

# the served configuration (the JAX package's DEFAULT_LM_CONFIG)
DEFAULT_LM_CONFIG = tfm.TransformerConfig(
    vocab_size=_VOCAB,
    d_model=256,
    n_layers=4,
    n_heads=8,
    n_kv_heads=4,
    d_ff=768,
    max_seq=512,
)


def encode_text(text):
    """Byte-level tokenize: BOS + utf-8 bytes."""
    if isinstance(text, str):
        text = text.encode("utf-8")
    return np.array([_BOS] + list(text), dtype=np.int32)


def decode_tokens(tokens):
    """Tokens -> utf-8 text (BOS/EOS stripped, lone surrogates replaced)."""
    return bytes(int(t) for t in tokens if 0 <= t < 256).decode(
        "utf-8", errors="replace"
    )


def tokenizer_model(name="tokenizer"):
    """BYTES text -> INT32 token ids (ragged rows padded with EOS)."""

    def fn(inputs, params, ctx):
        texts = np.atleast_1d(inputs["TEXT"]).reshape(-1)
        rows = [encode_text(t) for t in texts]
        width = max(len(r) for r in rows)
        out = np.full((len(rows), width), _EOS, dtype=np.int32)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
        lengths = np.array([len(r) for r in rows], dtype=np.int32)
        return {"TOKENS": out, "LENGTHS": lengths}

    return Model(
        name,
        inputs=[TensorSpec("TEXT", "BYTES", [-1])],
        outputs=[
            TensorSpec("TOKENS", "INT32", [-1, -1]),
            TensorSpec("LENGTHS", "INT32", [-1]),
        ],
        fn=fn,
        platform="python",
    )


def detokenizer_model(name="detokenizer"):
    """INT32 token ids -> BYTES text."""

    def fn(inputs, params, ctx):
        tokens = np.atleast_2d(inputs["TOKENS"])
        texts = [decode_tokens(row).encode("utf-8") for row in tokens]
        return {"TEXT": np.array(texts, dtype=np.object_)}

    return Model(
        name,
        inputs=[TensorSpec("TOKENS", "INT32", [-1, -1])],
        outputs=[TensorSpec("TEXT", "BYTES", [-1])],
        fn=fn,
        platform="python",
    )


class _LmRunner:
    """Owns the transformer params on one device.

    Params come from *params* (already on the device, e.g. from
    ``client_tpu_torch.convert``) or from a seeded ``torch.Generator``;
    ``quantize=True`` serves them int8 weight-only.  Each stream runs
    through a program set of its own from the params' pool
    (``programs.serial_pool``); assigning other ``params`` makes the next
    stream capture over them."""

    def __init__(self, cfg=None, seed=0, quantize=False, params=None,
                 device=None):
        self.cfg = cfg or DEFAULT_LM_CONFIG
        self.device = resolve_device(device)
        if params is None:
            params = tfm.init_params(
                torch.Generator().manual_seed(seed), self.cfg, self.device
            )
        self.params = params
        if quantize:
            self.params = tfm.quantize_params(self.params)

    def check_prompt(self, n_prompt_tokens):
        """Reject prompts the KV cache cannot hold with a clear 400."""
        if n_prompt_tokens >= self.cfg.max_seq:
            raise InferenceServerException(
                f"prompt of {n_prompt_tokens} tokens exceeds the model's "
                f"maximum context of {self.cfg.max_seq} (need at least one "
                "free slot to generate)",
                status="400",
            )
        if n_prompt_tokens == 0:
            raise InferenceServerException("empty prompt", status="400")

    def stream(self, tokens, max_tokens, temperature=0.0, seed=0, top_k=0,
               tenant=""):
        self.check_prompt(int(np.asarray(tokens).reshape(-1).shape[0]))
        if top_k and int(top_k) > 0:
            raise InferenceServerException(
                "top_k sampling needs the continuous-batching engine "
                "(lm_streaming_batched); this model samples the full "
                "distribution", status="400",
            )
        generator = None
        if temperature > 0:
            generator = torch.Generator(device=self.device).manual_seed(seed)
        for tok in tfm.generate(
            self.params, self.cfg, np.asarray(tokens, dtype=np.int32),
            max_tokens, temperature=temperature, generator=generator,
            stop_tokens=(_EOS,),
        ):
            yield tok
            if tok == _EOS:
                return


def lm_streaming_model(name="lm_streaming", runner=None, device=None):
    """Decoupled LM: one KServe response per generated token.

    Inputs: TOKENS (prompt ids), MAX_TOKENS; optional request parameters
    ``temperature``, ``seed`` and ``top_k``.  Each response carries the
    token id and its decoded text piece."""
    runner = runner or _LmRunner(device=device)

    def fn(inputs, params, ctx):
        tokens = np.asarray(inputs["TOKENS"]).reshape(-1).astype(np.int32)
        max_tokens = int(np.asarray(inputs["MAX_TOKENS"]).flatten()[0])
        temperature = float(params.get("temperature", 0.0) or 0.0)
        seed = int(params.get("seed", 0) or 0)
        # __tenant__ is the reserved caller identity; the batched engine
        # enforces per-tenant decode-lane quotas at lane admission
        top_k = int(params.get("top_k", 0) or 0)
        tenant = str(params.get("__tenant__", "") or "")
        for tok in runner.stream(tokens, max_tokens, temperature, seed,
                                 top_k=top_k, tenant=tenant):
            piece = decode_tokens([tok]).encode("utf-8")
            yield {
                "TOKEN": np.array([tok], dtype=np.int32),
                "TEXT": np.array([piece], dtype=np.object_),
            }

    return Model(
        name,
        inputs=[
            TensorSpec("TOKENS", "INT32", [-1]),
            TensorSpec("MAX_TOKENS", "INT32", [1]),
        ],
        outputs=[
            TensorSpec("TOKEN", "INT32", [1]),
            TensorSpec("TEXT", "BYTES", [1]),
        ],
        fn=fn,
        decoupled=True,
    )


def lm_streaming_batched_model(name="lm_streaming_batched", runner=None,
                               max_slots=8, response_cache=None,
                               speculative=None, device=None,
                               **engine_kwargs):
    """Decoupled LM with CONTINUOUS BATCHING: concurrent streams share one
    batched decode tick per token step (client_tpu_torch.serve.lm: paged KV
    cache, bucketed + chunked prefill, KV prefix caching, lane
    autoscaling), so aggregate tokens/s scales with active streams instead
    of serializing whole per-request decode loops.  Per-request
    ``temperature``/``top_k``/``seed`` sample inside the tick from per-lane
    RNG state; same request/response surface as lm_streaming — the model
    IS lm_streaming_model with the batched runner behind it.

    ``response_cache`` is the per-model cache-hint config block; its
    ``prefix_cache`` sub-block carries the KV prefix-cache knobs this
    model's engine honors: ``{"prefix_cache": {"enable": bool,
    "min_prefix_blocks": int}}``.

    ``speculative`` turns on speculative decoding for this model's engine
    (off by default): ``{"k": 4, "drafter": "ngram", ...}`` — see
    serve/lm/spec.py:SpecConfig.  Greedy streams keep their output;
    temperature streams stay distribution-exact via rejection sampling.

    The engine runs on the runner's device (``cuda`` unless the caller
    passes ``device="cpu"``)."""
    from client_tpu_torch.serve.models.continuous import BatchedLmRunner

    prefix_knobs = dict((response_cache or {}).get("prefix_cache") or {})
    if "enable" in prefix_knobs:
        engine_kwargs.setdefault("prefix_cache",
                                 bool(prefix_knobs["enable"]))
    if "min_prefix_blocks" in prefix_knobs:
        engine_kwargs.setdefault("min_prefix_blocks",
                                 int(prefix_knobs["min_prefix_blocks"]))
    if speculative is not None:
        engine_kwargs.setdefault("speculative", speculative)
    base = runner or _LmRunner(device=device)
    batched = BatchedLmRunner(
        base.params, base.cfg, max_slots=max_slots, eos_id=_EOS,
        check_prompt=base.check_prompt, device=base.device, **engine_kwargs,
    )
    model = lm_streaming_model(name=name, runner=batched)
    model.response_cache = dict(response_cache or {}) or None
    # the scheduler's thread + paged KV pool release with the engine
    model.closer = batched.scheduler.close

    def bind(engine):
        """Late-bind the owning InferenceEngine's observability + QoS
        (add_model calls this; it only sets attributes, so no device work
        and nothing inside a graph capture): lane/KV/
        prefix gauges land in the server's /metrics registry, per-tick
        spans ride its tracer, preemptions and wedges its flight recorder,
        the scheduler's profiler joins the server's (so /v2/debug/prof
        and flight dumps cover the LM engine), and tenant decode-lane
        quotas + preemption priority classes come from the front door's
        TenantQoS; an attached fleet tier becomes the scheduler's
        cross-replica prefix tier."""
        sched = batched.scheduler
        sched.set_registry(engine.metrics)
        sched.tracer = engine.tracer
        sched.flight = engine.flight
        engine.prof.adopt(sched.prof)
        if engine.qos is not None:
            sched.tenant_lane_share = engine.qos.lane_share
            sched.tenant_priority = engine.qos.priority
        if getattr(engine, "fleet", None) is not None:
            # cross-replica prefix tier: submit-side peer lookups,
            # prefill-completion exports, parked-stream migration
            sched.set_fleet(engine.fleet)

    model.binder = bind
    return model


def text_ensemble_model(name="text_generator", runner=None, device=None):
    """End-to-end ensemble: BYTES prompt -> streamed BYTES pieces (chains
    tokenizer -> LM server-side)."""
    runner = runner or _LmRunner(device=device)

    def fn(inputs, params, ctx):
        text = np.asarray(inputs["PROMPT"]).reshape(-1)[0]
        max_tokens = int(np.asarray(inputs["MAX_TOKENS"]).flatten()[0])
        temperature = float(params.get("temperature", 0.0) or 0.0)
        seed = int(params.get("seed", 0) or 0)
        tokens = encode_text(text)
        for tok in runner.stream(tokens, max_tokens, temperature, seed):
            piece = decode_tokens([tok]).encode("utf-8")
            yield {"TEXT": np.array([piece], dtype=np.object_)}

    return Model(
        name,
        inputs=[
            TensorSpec("PROMPT", "BYTES", [1]),
            TensorSpec("MAX_TOKENS", "INT32", [1]),
        ],
        outputs=[TensorSpec("TEXT", "BYTES", [1])],
        fn=fn,
        platform="ensemble",
        decoupled=True,
    )


def language_models(device=None, speculative=None, int8_batched=None):
    """The language set on *device* (``cuda`` unless the caller says
    otherwise): tokenizer, detokenizer, the serial ``lm_streaming``, the
    continuous-batching ``lm_streaming_batched`` and ``lm_streaming_int8``
    (the int8 runner quantizes the shared weights), and
    ``text_generator``.

    ``lm_streaming_int8`` serves through the batched engine on a CUDA
    device, where the int8 kernel runs, and serially on the CPU, where
    every int8 projection takes its plain version; ``int8_batched``
    overrides that either way.  ``speculative`` enables speculative
    decoding on the batched engines (see
    :func:`lm_streaming_batched_model`)."""
    runner = _LmRunner(device=device)
    int8_runner = _LmRunner(
        cfg=runner.cfg, params=runner.params, quantize=True, device=device,
    )
    if int8_batched is None:
        int8_batched = runner.device.type == "cuda"
    int8_model = (
        lm_streaming_batched_model(
            name="lm_streaming_int8", runner=int8_runner,
            speculative=speculative,
        )
        if int8_batched else
        lm_streaming_model(name="lm_streaming_int8", runner=int8_runner)
    )
    return [
        tokenizer_model(),
        detokenizer_model(),
        lm_streaming_model(runner=runner),
        int8_model,
        lm_streaming_batched_model(runner=runner, speculative=speculative),
        text_ensemble_model(runner=runner),
    ]
