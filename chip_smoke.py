#!/usr/bin/env python3
"""Smoke run of client_tpu_torch on one NVIDIA GPU: builds the kernels,
holds each against its plain PyTorch version, serves the LM over
KServe-v2 HTTP through the continuous-batching engine, trains the flagship
LM through the flash-attention kernels, and times the kernels, the serial
decode, the engine and the train step.

    python3 chip_smoke.py

Phases, one line each or more; any failure exits non-zero:
  1 device      CUDA present; the card's name and power limit
  2 build       the CUDA kernels, from the sources in this checkout; each
                kernel's registers, stack and spills (cuobjdump -res-usage
                on the built library)
  3 kernel      int8_matmul (kernel) against int8_matmul_reference on the
                card, on both routes (GEMV at M <= 8, tiled above): M in
                {1..9,16,37,128,511}, (K,N) in {(256,256),(256,128),
                (256,768)}, x in bf16 and f32
  4 model       DEFAULT_LM_CONFIG int8 forward + 32-token greedy generate
                on cuda (kernel) against the same weights on cpu (plain),
                24 kernel launches per decode step
  5 server      the serving path: the language set behind
                Server(http_port=0), driven over HTTP with urllib
                (MAX_TOKENS=1 to lm_streaming_int8 and lm_streaming_batched,
                both on the continuous-batching engine, and to the serial
                lm_streaming), then engine.execute streams 32 tokens from
                each batched model, equal to its engine's own stream; the
                int8 stream against the serial _LmRunner.stream (equal, or
                diverging only at a near-tie: see NEAR_TIE); the launch
                counts are reset just before this phase and read just
                after it
  6 timings     each served kernel shape at M=1 and 8 (GEMV route), M=63
                (the served prompt) and M=128 (tiled route) beside its bound,
                the plain version and torch.matmul on the dequantized
                weight: device time from CUDA-graph replay
                and back-to-back eager time, both by CUDA events; serial
                decode tokens/s and TTFT
  7 flash       the flash forward, dQ and dK/dV kernels against
                _fa_forward_reference / _fa_backward_reference on the
                card: T in {128,512,100}, D in {32,64,128}, causal and not,
                f32 and bf16, BH in {2,5}, a zero and a nonzero lse
                cotangent, and the main path's own shape (BH=64, T=512,
                D=64, bf16, causal); flash_attention at T=100 (padded by
                the wrapper) against plain_attention, forward and gradients.
                On an H100 80GB HBM3 (700 W) every bf16 error was at most
                one ulp of the output: 0.0156 for the forward and dQ,
                0.0313 for dK/dV (|dv| in [4, 8)); f32 dQ and dK/dV 0.0
  8 training    the training path: 10 Adam steps of the flagship config
                (__graft_entry__.entry(): vocab 8192, d_model 512, 4
                layers, bf16) on tokens [8, 513] with attn_impl="flash";
                the launch counts are reset just before and read just
                after (4/4/4 flash launches a step, no int8); the same 10
                steps with attn_impl="plain", every loss beside the flash
                one's; 3 float32 steps at 2 layers,
                flash against plain; forward flash against plain; a
                checkpoint save / restore / resume round trip
  9 timings     each flash kernel at the training shape (BH=64, T=512,
                D=64, bf16, causal; all three on the tensor cores) by
                CUDA-graph replay beside its bound, its plain version and
                scaled_dot_product_attention; the three once more at
                [32, 512, 128] (D=128) on a line of their own; the
                train step, plain and flash alternated, with its peak
                memory; a torch.profiler trace of 3 flash steps
 10 paged       paged_attention (kernel) against paged_attention_reference
                at the engine's shapes: decode B in {2,4,8}, T=1; verify
                B=8, T in {2,4,5}; prefill B=1, T in {16,32,64}; contexts 1
                to 511 with partly filled last blocks; hd in {16,32,64,128};
                bf16 and f32; shuffled, non-contiguous block tables.  Every
                pool row the mask excludes (the trash block included) is
                NaN for the kernel; the plain version reads a clean copy
 11 engine      LmEngine on DEFAULT_LM_CONFIG: 16 concurrent greedy streams
                over 8 lanes (prompts of 1 to 200 tokens, two sharing a
                48-token prefix) in float32, each equal to the serial
                generate; the same in bf16 and int8 (equal, or diverging
                only at a near-tie); a preempted and resumed stream and a
                speculative run (k=4, n-gram) against greedy; the launch
                counts a tick (paged n_layers, int8 6 x n_layers); the KV
                audit clean after close()
 12 timings     paged_attention by CUDA-graph replay at decode B=8,
                contexts 64, 256 and 511, and at prefill T=64, beside its
                bound, its plain version and scaled_dot_product_attention
                on K/V gathered through the table; the engine's aggregate
                tokens/s and TTFT at 1, 4 and 8 concurrent streams (bf16
                and int8, 128 tokens each); the device-busy share of a
                decode-heavy window under torch.profiler
 13 kernels     one JSON line: every ported kernel, its launches on its
                path (phase 5 or 8), its error (phase 3, 7 or 10) and its
                times (phase 6, 9 or 12)
Every timing line carries the card's name and power limit.  The last line
is {"ok": true, "device": {...}}.
"""

import dataclasses
import gzip
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM published peaks (dense): HBM bytes/s and bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12  # outside the tensor cores

# stated tolerances: kernel against its plain version on the same inputs
TOL = {
    torch.float32: (1e-4, 1e-4),   # atol, rtol: f32 sums in another order
    torch.bfloat16: (2e-2, 1e-2),  # one bf16 ulp of the f32-summed result
}
# model on cuda (kernel) against cpu (plain), both bf16: a few bf16 ulps at
# the logits' magnitude (2..4, ulp 1/64) after four layers of bf16 rounding
LOGIT_ATOL = 0.1
MIN_AGREE = 0.9  # greedy positions; allows the documented bf16 near-ties
# a bf16 or int8 stream of the batched engine against the serial runner
# (other kernels, other sums): equal, or diverging first where the serial
# logits of the two tokens lie within the bf16 logit tolerance above — a
# near-tie, which either order of the sums may resolve either way
NEAR_TIE = LOGIT_ATOL

# both int8 routes: the GEMV kernel takes M <= 8 (every served N is a
# multiple of 16), the tiled kernel the rest
M_LIST = tuple(range(1, 10)) + (16, 37, 128, 511)
GEMV_MAX_M = 8
SERVED_KN = ((256, 256), (256, 128), (256, 768))
# one layer's six kernel projections: wq, wk, wv, wo, w_gate, w_up
LAYER_KN = ((256, 256), (256, 128), (256, 128), (256, 256), (256, 768),
            (256, 768))
PROMPT = "KServe-v2 streaming inference on Hopper: the quick brown fox. "

# the flagship LM of __graft_entry__.entry(), at full width and depth
FLAGSHIP = dict(vocab_size=8192, d_model=512, n_layers=4, n_heads=8,
                n_kv_heads=4, d_ff=1536, max_seq=512)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEED, TRAIN_STEPS, TRAIN_LR = 8, 512, 0, 10, 1e-3
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# stated tolerances, training path:
# - bf16, flash against plain from the same weights: the first loss differs
#   only by the attention's rounding (plain and the bf16 kernels round p,
#   and the backward kernels ds, to bf16 before their products, at other
#   points of the softmax), averaged over 4096 tokens; over the 10 Adam
#   steps the two bf16 trajectories drift apart by their own rounding.
#   On an H100 80GB HBM3 (700 W) the losses (9.525 falling to 0.102)
#   differed by 1.4e-4 at step 1, by at most 1.05e-2 (step 5) and by 8.2e-4
#   at step 10 with the tensor-core backward (1.4e-4, 1.1e-2 and 6.9e-4
#   with f32 products in the backward; 1.2e-4, 2.7e-3 and 2.2e-4 with f32
#   products in the forward too, where the limits were set at about 10x);
#   each limit stays well below the loss it bounds
TRAIN_LOSS0_ATOL = 2e-3
TRAIN_LOSS_STEP_ATOL = 0.03
TRAIN_LOSS_LAST_ATOL = 2e-3
# - float32 (TF32 off), flash against plain: sums in another order
F32_LOSS_ATOL = 1e-4
F32_LOGIT_ATOL = 1e-4
# - flash_attention through the padding against plain_attention, f32
WRAPPER_TOL = (1e-4, 1e-3)


def phase(n, name, **fields):
    print(json.dumps({"phase": n, "name": name, **fields}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def eager_ms(fn, iters=200, warmup=20):
    """Mean time of one fn() call issued back to back from Python, by CUDA
    events: the host's launch overhead included."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=100, replays=5):
    """Device time of one fn() call: *iters* calls captured in one CUDA
    graph, replayed and timed by CUDA events, so the host's launch
    overhead is out of the figure."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def bound_ms(m, k, n):
    """Least time for x[m,k] bf16 @ q[k,n] int8 * s[n] f32 -> [m,n] bf16:
    each input read once and the output written once, against HBM; the
    multiply-adds against the bf16 dense peak."""
    nbytes = m * k * 2 + k * n + n * 4 + m * n * 2
    flops = 2 * m * k * n
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3


def int8_route(m, n):
    """The int8 kernel's route at this shape, as int8_matmul.cu's launch()
    picks it for a 16-byte-aligned q and x within 48 KB."""
    return "gemv" if m <= GEMV_MAX_M and n % 16 == 0 else "tiled"


def kernel_resources(library):
    """{kernel<D>: {"registers", "stack_bytes", "local_bytes"}} of every
    kernel in the built library, read by the toolkit's cuobjdump
    (-res-usage); "not measured" where the tool is missing or fails.  LOCAL
    is what spills to memory."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = shutil.which("cuobjdump") or os.path.join(home, "bin", "cuobjdump")
    if not os.path.isfile(tool):
        return "not measured"
    run = subprocess.run([tool, "-res-usage", library], capture_output=True,
                         text=True, timeout=120)
    if run.returncode:
        return "not measured"
    dump = run.stdout
    out = {}
    for name, reg, stack, local in re.findall(
            r"Function (\S+):\s*REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)",
            dump):
        # the last length-prefixed name ending in _kernel, then its
        # template arguments: integers (Li64E) and the types f and bf16
        kernel = re.search(
            r".*\d((?:fa|int8|paged)_[a-z0-9_]*?_kernel)(?:I(.*?)EE)?", name)
        key = kernel.group(1) if kernel else name
        args = [num or ("f32" if typ == "f" else "bf16")
                for num, typ in re.findall(r"Li(\d+)|(f|13__nv_bfloat16)",
                                           kernel.group(2) or "")
                ] if kernel else []
        key = f"{key}<{','.join(args)}>" if args else key
        out[key] = {"registers": int(reg), "stack_bytes": int(stack),
                    "local_bytes": int(local)}
    return out


def http(addr, path, body=None, headers=None):
    req = urllib.request.Request(
        f"http://{addr}{path}", data=body, headers=headers or {},
        method="POST" if body is not None else "GET",
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, resp.read(), dict(resp.headers)


def lm_request(tokens, max_tokens):
    return json.dumps({"inputs": [
        {"name": "TOKENS", "shape": [len(tokens)], "datatype": "INT32",
         "data": [int(t) for t in tokens]},
        {"name": "MAX_TOKENS", "shape": [1], "datatype": "INT32",
         "data": [max_tokens]},
    ]}).encode()


def dtype_name(dt):
    return str(dt).replace("torch.", "")


def flash_bounds(bh, t, d, causal, elt=2):
    """{kernel: (bound_ms, bound_by)} for the flash kernels on [bh, t, d]
    inputs of elt bytes: each input read once and each output written once
    over HBM, against the operations these inputs need (only the (q, k)
    pairs on or below the diagonal when causal) over the bf16 dense
    peak."""
    pairs = bh * (t * (t + 1) // 2 if causal else t * t)
    mat, row = bh * t * d * elt, bh * t * 4
    work = {
        # q, k, v in; out, lse out; s = q.k and p.v
        "flash_fwd": (4 * mat + row, 4 * pairs * d),
        # q, k, v, dO, lse, delta, g_lse in; dq out; s, dO.v, ds.k
        "flash_bwd_dq": (5 * mat + 3 * row, 6 * pairs * d),
        # the same in; dk, dv out; s, dO.v, p.dO, ds.q
        "flash_bwd_dkv": (6 * mat + 3 * row, 8 * pairs * d),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
        out[name] = (max(by_bytes, by_ops) * 1e3,
                     "bytes" if by_bytes >= by_ops else "operations")
    return out


def flash_vs_plain(fa, gen, main_shape):
    """Phase 7: every flash kernel against its plain version on the card,
    over a grid of shapes and at ``main_shape`` ([BH, T, D] of the training
    step, bf16, causal).  Returns ({kernel: {dtype: max abs err}}, cases,
    {kernel: max abs err} at ``main_shape``)."""
    worst = {name: {} for name in FLASH_KERNELS}

    def hold(name, dt, got, want, what, tol=None):
        atol, rtol = tol or TOL[dt]
        got, want = got.float(), want.float()
        err = (got - want).abs()
        check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
        check(bool((err <= atol + rtol * want.abs()).all()),
              f"{what}: max abs err {err.max().item()} beyond atol {atol} "
              f"rtol {rtol}")
        key = dtype_name(dt)
        worst[name][key] = max(worst[name].get(key, 0.0), err.max().item())
        return err.max().item()

    def case(dt, bh, t, d, causal):
        errs = dict.fromkeys(FLASH_KERNELS, 0.0)

        def held(name, *args):
            errs[name] = max(errs[name], hold(name, dt, *args))

        q, k, v, g = (torch.randn(bh, t, d, generator=gen).to(dt).cuda()
                      for _ in range(4))
        scale = d ** -0.5
        what = f"{dtype_name(dt)} BH={bh} T={t} D={d} causal={causal}"
        out, lse = fa._fa_forward(q, k, v, scale, causal)
        want_out, want_lse = fa._fa_forward_reference(q, k, v, scale, causal)
        held("flash_fwd", out, want_out, f"flash_fwd out {what}")
        # lse is f32 on both sides, whatever the inputs' dtype
        held("flash_fwd", lse, want_lse, f"flash_fwd lse {what}",
             TOL[torch.float32])
        for g_lse in (torch.zeros_like(lse),
                      torch.randn(bh, t, 1, generator=gen).cuda()):
            dq, dk, dv = fa._fa_backward(q, k, v, out, lse, g, g_lse, scale,
                                         causal)
            rq, rk, rv = fa._fa_backward_reference(q, k, v, out, lse, g,
                                                   g_lse, scale, causal)
            nz = f"{what} g_lse={'0' if not g_lse.any() else 'randn'}"
            held("flash_bwd_dq", dq, rq, f"flash_bwd_dq {nz}")
            held("flash_bwd_dkv", dk, rk, f"flash_bwd_dkv dk {nz}")
            held("flash_bwd_dkv", dv, rv, f"flash_bwd_dkv dv {nz}")
        return errs

    grid = [(dt, (2, 5)[i % 2], t, d, causal)
            for dt in (torch.float32, torch.bfloat16)
            for i, (t, d, causal) in enumerate(itertools.product(
                (128, 512, 100), (32, 64, 128), (True, False)))]
    for args in grid:
        case(*args)
    main = case(torch.bfloat16, *main_shape, True)
    torch.cuda.synchronize()
    return worst, len(grid) + 1, main


def wrapper_vs_plain(fa, plain_attention, gen):
    """flash_attention at T=100 (the wrapper pads to 128 on the causal path)
    against plain_attention, output and gradients, f32 on the card."""
    atol, rtol = WRAPPER_TOL
    qkv = [torch.randn(2, 100, 4, 64, generator=gen).cuda().requires_grad_()
           for _ in range(3)]
    errs = {}
    for name, fn in (("flash", fa.flash_attention), ("plain", plain_attention)):
        out = fn(*qkv)
        grads = torch.autograd.grad((out ** 2).sum(), qkv)
        errs[name] = [out.detach()] + list(grads)
    worst = 0.0
    for got, want in zip(errs["flash"], errs["plain"]):
        err = (got - want).abs()
        check(bool((err <= atol + rtol * want.abs()).all()),
              f"flash_attention T=100 against plain_attention: max abs err "
              f"{err.max().item()} beyond atol {atol} rtol {rtol}")
        worst = max(worst, err.max().item())
    return worst


def flash_d128(ext, fa, gen, graph, shape=(32, 512, 128)):
    """The three bf16 flash kernels once at head dim 128 ([32, 512, 128],
    causal: the training shape's work with half the heads, twice as wide),
    where the kernels hold the most registers and shared memory; each by
    CUDA-graph replay beside its bound and SDPA's forward and backward."""
    bh, t, d = shape
    q, k, v, g = (torch.randn(bh, t, d, generator=gen).to(torch.bfloat16)
                  .cuda() for _ in range(4))
    scale = d ** -0.5
    out, lse = ext.flash_fwd(q, k, v, scale, True)
    delta, g_lse = fa._delta(g, out), torch.zeros_like(lse)
    q4, k4, v4, g4 = (x.view(1, bh, t, d) for x in (q, k, v, g))
    q4r, k4r, v4r = (x.clone().requires_grad_() for x in (q4, k4, v4))
    sdpa_ms = graph(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True))
    sdpa_bwd_ms = graph(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(q4r, k4r, v4r, is_causal=True),
        (q4r, k4r, v4r), g4)) - sdpa_ms
    ms = {
        "flash_fwd": graph(lambda: ext.flash_fwd(q, k, v, scale, True)),
        "flash_bwd_dq": graph(lambda: ext.flash_bwd_dq(
            q, k, v, g, lse, delta, g_lse, scale, True)),
        "flash_bwd_dkv": graph(lambda: ext.flash_bwd_dkv(
            q, k, v, g, lse, delta, g_lse, scale, True)),
    }
    bounds = flash_bounds(bh, t, d, causal=True)
    return {"shape": [bh, t, d], "dtype": "bfloat16", "causal": True,
            "timing": "device time from CUDA-graph replay",
            "kernels": {name: {"ms": ms[name], "bound_ms": bounds[name][0],
                               "bound_by": bounds[name][1]} for name in ms},
            "sdpa_ms": sdpa_ms, "sdpa_bwd_ms": sdpa_bwd_ms}


def train_run(tfm, cfg, impl, tokens, steps, params=None):
    """``steps`` Adam steps from init_params(seed 0) through the port's
    train-step entry points; returns (params, opt_state, losses)."""
    if params is None:
        params = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    opt, step = tfm.make_train_step(cfg, attn_impl=impl,
                                    learning_rate=TRAIN_LR)
    state = opt.init(params)
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, tokens)
        losses.append(loss)
    return params, state, [float(x) for x in losses]


def checkpoint_round_trip(tfm, CheckpointManager, cfg, tokens):
    """Two flash steps, a checkpoint, then one more step from the live state
    and one from a fresh restore: both must be equal bit for bit."""
    opt, step = tfm.make_train_step(cfg, attn_impl="flash",
                                    learning_rate=TRAIN_LR)
    fresh = lambda: tfm.init_params(  # noqa: E731
        torch.Generator().manual_seed(0), cfg, "cuda")
    params = fresh()
    state = opt.init(params)
    for _ in range(2):
        params, state, _ = step(params, state, tokens)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as d:
        with CheckpointManager(d) as mgr:
            mgr.save(2, params=params, opt_state=state.state_dict())
            template = fresh()
            restored = mgr.restore({
                "params": template,
                "opt_state": opt.init(template).state_dict()})
            latest = mgr.latest_step()
    params2 = restored["params"]
    state2 = opt.init(params2)
    state2.load_state_dict(restored["opt_state"])
    params, state, loss = step(params, state, tokens)
    params2, state2, loss2 = step(params2, state2, tokens)
    same = all(torch.equal(a, b) for a, b in
               zip(tfm._leaves(params), tfm._leaves(params2)))
    check(latest == 2 and float(loss) == float(loss2) and same,
          f"resumed step differs from the uninterrupted one: loss "
          f"{float(loss2)} against {float(loss)}, params equal {same}")
    return float(loss)


def step_time(tfm, cfg, impl, tokens, steps=10, warmup=2):
    """Train-step wall time (host clock around synchronized steps) and the
    peak device memory of the steps, from fresh weights."""
    params, state, _ = train_run(tfm, cfg, impl, tokens, warmup)
    _, step = tfm.make_train_step(cfg, attn_impl=impl, learning_rate=TRAIN_LR)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        params, state, loss = step(params, state, tokens)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return {"attn_impl": impl, "ms_per_step": ms,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3),
            "peak_mb": torch.cuda.max_memory_allocated() / 2**20,
            "peak_above_state_mb":
                (torch.cuda.max_memory_allocated() - base) / 2**20,
            "steps": steps, "last_loss": float(loss)}


def profile_steps(tfm, cfg, tokens, steps=3):
    """torch.profiler over ``steps`` warm flash steps: the device-busy share
    of the wall time and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    params, state, _ = train_run(tfm, cfg, "flash", tokens, 2)
    _, step = tfm.make_train_step(cfg, attn_impl="flash",
                                  learning_rate=TRAIN_LR)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            params, state, _ = step(params, state, tokens)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return {"steps": steps, **busy_share(prof, wall_us)}


# -- the continuous-batching engine (phases 5, 10-12) -----------------------

# the engine's JAX defaults: 8 slots, lane counts {2, 4, 8}, 16-token
# blocks, 64-token prefill chunks (buckets {16, 32, 64}), table width 32
ENGINE_KW = dict(max_slots=8, block_size=16, prefill_chunk=64)
PAGED_BS, PAGED_WIDTH = 16, 32
PAGED_HEADS = (8, 4)  # DEFAULT_LM_CONFIG's query and KV heads
ENGINE_TOKENS = 128   # tokens a stream in the engine timings


def paged_case(batch, t, hd, dtype, contexts, seed, heads=PAGED_HEADS):
    """A paged-attention input on the card at the engine's layout: lane b's
    T queries end at key contexts[b] - 1, its blocks are shuffled
    physical blocks scattered over the pool, and its table's tail is the
    trash block 0.  Returns (clean args, the same args with every pool row
    the mask excludes set to NaN, pos as numpy)."""
    rng = np.random.default_rng(seed)
    n_heads, n_kv = heads
    bs = PAGED_BS
    ctx = np.maximum(np.asarray(contexts), t)
    pos = (ctx[:, None] - t + np.arange(t)[None, :]).astype(np.int32)
    own = pos.max(axis=1) // bs + 1
    n_blocks = int(own.sum()) + 3  # three blocks no lane owns
    perm = rng.permutation(np.arange(1, n_blocks + 1))
    tables = np.zeros((batch, PAGED_WIDTH), np.int32)
    live = np.zeros((n_blocks + 1, bs), bool)
    start = 0
    for b in range(batch):
        tables[b, :own[b]] = perm[start:start + own[b]]
        start += own[b]
        for j in range(int(pos[b].max()) + 1):
            live[tables[b, j // bs], j % bs] = True
    shape = (n_blocks + 1, bs, n_kv, hd)
    k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dtype) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal(
        (batch, t, n_heads, hd)).astype(np.float32)).to(dtype)
    kn, vn = k.clone(), v.clone()
    dead = torch.from_numpy(~live)
    kn[dead] = float("nan")
    vn[dead] = float("nan")
    tab, ps = torch.from_numpy(tables).cuda(), torch.from_numpy(pos).cuda()
    return ((q.cuda(), k.cuda(), v.cuda(), tab, ps),
            (q.cuda(), kn.cuda(), vn.cuda(), tab, ps), pos)


def paged_grid():
    """(kind, batch, t, contexts) of phase 10: the engine's decode, verify
    and prefill shapes, contexts from 1 to 511 (most end mid-block)."""
    grid = [("decode", b, 1, np.linspace(1, 511, b).astype(int))
            for b in (2, 4, 8)]
    grid += [("verify", 8, t, np.linspace(t, 511, 8).astype(int))
             for t in (2, 4, 5)]
    grid += [("prefill", 1, t, [ctx]) for t in (16, 32, 64)
             for ctx in (t, 511)]
    return grid


def paged_vs_plain(pa):
    """Phase 10: the kernel on NaN-poisoned pools against the plain version
    on clean ones, over paged_grid() x hd x dtype."""
    worst, cases = {}, 0
    for kind, batch, t, contexts in paged_grid():
        for hd in (16, 32, 64, 128):
            for dt in (torch.float32, torch.bfloat16):
                clean, poisoned, _ = paged_case(batch, t, hd, dt, contexts,
                                                seed=cases)
                got = pa._launch(*poisoned, PAGED_BS).float()
                want = pa.paged_attention_reference(*clean,
                                                    PAGED_BS).float()
                atol, rtol = TOL[dt]
                err = (got - want).abs()
                what = (f"paged_attention {kind} B={batch} T={t} hd={hd} "
                        f"{dtype_name(dt)}")
                check(bool(torch.isfinite(got).all()),
                      f"{what}: non-finite output (read a masked row?)")
                check(bool((err <= atol + rtol * want.abs()).all()),
                      f"{what}: max abs err {err.max().item()} beyond atol "
                      f"{atol} rtol {rtol}")
                key = dtype_name(dt)
                worst[key] = max(worst.get(key, 0.0), err.max().item())
                cases += 1
    torch.cuda.synchronize()
    return worst, cases


def paged_bound(pos, heads, hd, elt):
    """(bound_ms, bound_by) of one paged-attention call: each input read
    once (the K/V rows up to each lane's last pos, q, tables, pos) and out
    written once, over HBM; q.k and p.v for every attended (query, key)
    pair over the dense peak of the dtype (bf16 tensor cores, or f32)."""
    n_heads, n_kv = heads
    batch, t = pos.shape
    rows = int((pos.max(axis=1) + 1).sum())
    nbytes = (2 * rows * n_kv * hd * elt + 2 * batch * t * n_heads * hd * elt
              + batch * PAGED_WIDTH * 4 + batch * t * 4)
    flops = 4 * n_heads * hd * int((pos.astype(np.int64) + 1).sum())
    peak = BF16_FLOPS_PER_S if elt == 2 else F32_FLOPS_PER_S
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def paged_timings(pa, ext, graph):
    """Phase 12: the kernel by CUDA-graph replay at the engine's decode
    (B=8, contexts 64, 256, 511) and prefill (B=1, T=64 ending at key 256)
    shapes, bf16, hd 32, beside its bound, its plain version and SDPA on
    K/V gathered through the table (gather included)."""
    rows = []
    for kind, batch, t, ctx in (("decode", 8, 1, 64), ("decode", 8, 1, 256),
                                ("decode", 8, 1, 511),
                                ("prefill", 1, 64, 256)):
        (q, k, v, tables, pos), _, pos_np = paged_case(
            batch, t, 32, torch.bfloat16, [ctx] * batch, seed=ctx + t)
        n_kv, hd = k.shape[2], k.shape[3]
        s_len = PAGED_WIDTH * PAGED_BS
        idx = tables.long()
        mask = (torch.arange(s_len, device="cuda")[None, None, :]
                <= pos[:, :, None])[:, None]  # [B,1,T,S]
        qh = q.transpose(1, 2)

        def library():
            kk = k[idx].reshape(batch, s_len, n_kv, hd).transpose(1, 2)
            vv = v[idx].reshape(batch, s_len, n_kv, hd).transpose(1, 2)
            return F.scaled_dot_product_attention(qh, kk, vv, attn_mask=mask,
                                                  enable_gqa=True)

        want = pa.paged_attention_reference(q, k, v, tables, pos,
                                            PAGED_BS).float()
        got_lib = library().transpose(1, 2).float()
        check(bool(((got_lib - want).abs() <= 2e-2 + 1e-2 * want.abs()).all()),
              "SDPA on the gathered K/V does not compute the same function")
        bound, bound_by = paged_bound(pos_np, PAGED_HEADS, hd, 2)
        rows.append({
            "shape": kind, "B": batch, "T": t, "context": ctx, "hd": hd,
            "heads": list(PAGED_HEADS), "dtype": "bfloat16",
            "ms": graph(lambda: ext.paged_attention(q, k, v, tables, pos,
                                                    PAGED_BS)),
            "plain_ms": graph(lambda: pa.paged_attention_reference(
                q, k, v, tables, pos, PAGED_BS)),
            "library_ms": graph(library),
            "library": "F.scaled_dot_product_attention(attn_mask, "
                       "enable_gqa=True) on K/V gathered through the table",
            "bound_ms": bound, "bound_by": bound_by,
            "timing": "device time from CUDA-graph replay"})
    return rows


def collect(q, close, timeout=300):
    out = []
    while True:
        tok = q.get(timeout=timeout)
        if tok is close:
            return out
        out.append(tok)


def agreement(tfm, params, cfg, prompt, got, want):
    """A batched stream against the serial one: equal, or, where they first
    diverge, the serial model's logits of both tokens (a full forward over
    the common prefix) and their gap.  Fails unless the gap is a near-tie
    (at most NEAR_TIE)."""
    if got == want:
        return {"equal": True, "tokens": len(got)}
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    check(i < min(len(got), len(want)),
          f"stream lengths differ: {len(got)} against {len(want)}")
    seq = torch.as_tensor(list(prompt) + list(want[:i]), dtype=torch.int32,
                          device="cuda")[None]
    with torch.no_grad():
        logits = tfm.forward(params, seq, cfg)[0, -1].float()
    top2 = torch.topk(logits, 2).values
    gap = float(logits[want[i]] - logits[got[i]])
    check(gap <= NEAR_TIE,
          f"stream diverges from serial at position {i} where the serial "
          f"logits differ by {gap} > {NEAR_TIE}: {got} against {want}")
    return {"equal": False, "tokens": len(got), "first_divergence": i,
            "gap": gap, "top2_gap": float(top2[0] - top2[1])}


def engine_run(LmEngine, ops, params, cfg, prompts, lengths, **kw):
    """Submit every (prompt, n) to a fresh engine on the card at once and
    collect the streams; the launch counts are reset just before and read
    just after.  Returns (streams, launches, ticks by kind, stats); fails
    unless the KV audit is clean after close()."""
    eng = LmEngine(params, cfg, device="cuda", **{**ENGINE_KW, **kw})
    ops.reset_launches()
    try:
        qs = [eng.submit(p, n)[0] for p, n in zip(prompts, lengths)]
        got = [collect(q, LmEngine.CLOSE) for q in qs]
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        ticks = {}
        for rec in eng.tick_trace():
            ticks[rec["kind"]] = ticks.get(rec["kind"], 0) + 1
        stats = {"prefix": eng.prefix_stats(),
                 "preempt": eng.preempt_stats(), "spec": eng.spec_stats(),
                 "shapes": {"prefill_widths": eng.prefill_executables(),
                            "lane_counts": eng.decode_executables(),
                            "verify": eng.verify_executables()}}
    finally:
        eng.close()
    check(eng.kv.used_blocks == 0 and eng.kv.ref_counts() == {},
          f"KV audit after close: {eng.kv.used_blocks} blocks used, "
          f"refs {eng.kv.ref_counts()}")
    return got, launches, ticks, stats


def check_launches(launches, ticks, cfg, int8):
    """paged attention n_layers a device tick (decode, verify or prefill
    chunk); int8 6 x n_layers a tick when the weights are int8."""
    device_ticks = sum(n for kind, n in ticks.items() if kind != "draft")
    want = {"paged_attention": cfg.n_layers * device_ticks,
            "int8_matmul": 6 * cfg.n_layers * device_ticks if int8 else 0}
    for name, n in want.items():
        check(launches[name] == n,
              f"{name} launched {launches[name]} times in {ticks} ticks, "
              f"expected {n}")
    return {"per_tick": {name: n // max(device_ticks, 1)
                         for name, n in want.items()},
            "ticks": ticks, "launches": launches}


def distinct_prompts(prompt, n):
    """n copies of prompt, each with its own second token: no prefix is
    shared, so every stream prefills its own chunk."""
    out = []
    for i in range(n):
        p = np.array(prompt, np.int32)
        p[1] = 32 + i
        out.append(p)
    return out


def engine_rate(LmEngine, params, cfg, prompt, n_streams):
    """Aggregate tokens/s and TTFT of n_streams concurrent greedy streams of
    ENGINE_TOKENS tokens each, after a warm-up run; host clock from the
    first submit to the last token."""
    eng = LmEngine(params, cfg, device="cuda", **ENGINE_KW)

    def run(n, tokens):
        stamps = [[] for _ in range(n)]
        t0 = time.monotonic()
        qs = [eng.submit(p, tokens)[0] for p in distinct_prompts(prompt, n)]

        def drain(i):
            while qs[i].get(timeout=300) is not LmEngine.CLOSE:
                stamps[i].append(time.monotonic())

        threads = [threading.Thread(target=drain, args=(i,), daemon=True)
                   for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        return t0, stamps

    try:
        run(8, 8)  # warm-up: every lane count and the prefill width
        t0, stamps = run(n_streams, ENGINE_TOKENS)
    finally:
        eng.close()
    total = sum(len(s) for s in stamps)
    check(total == n_streams * ENGINE_TOKENS, f"{total} tokens delivered")
    end = max(s[-1] for s in stamps)
    ttft = [(s[0] - t0) * 1e3 for s in stamps]
    return {"streams": n_streams, "tokens_each": ENGINE_TOKENS,
            "tokens_per_s": total / (end - t0),
            "ttft_ms_mean": float(np.mean(ttft)), "ttft_ms_max": max(ttft)}


def busy_share(prof, wall_us):
    """Device-busy share of the wall time from a torch.profiler trace:
    kernels and copies merged on the device timeline (a user annotation,
    which spans the gaps between its kernels, is left out), and the top
    kernels by device time."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    if not spans:
        return {"device_busy_share": "not measured",
                "top_kernels": "not measured"}
    busy, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    for start, end, _ in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    by_name = {}
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us,
            "kernel_launches": len(spans),
            "top_kernels": [{"name": n[:120], "ms": us / 1e3,
                             "share_of_busy": us / busy} for n, us in top]}


def engine_profile(LmEngine, params, cfg, prompt, window_s=0.5):
    """torch.profiler over a decode-heavy window of the engine: 8 greedy
    streams, the window opened once every stream has its first token (all
    prefill done)."""
    from torch.profiler import ProfilerActivity, profile

    eng = LmEngine(params, cfg, device="cuda", **ENGINE_KW)
    try:
        collect(eng.submit(prompt, 8)[0], LmEngine.CLOSE)  # warm-up
        qs = [eng.submit(p, 400)[0] for p in distinct_prompts(prompt, 8)]
        for q in qs:
            q.get(timeout=300)
        before = sum(1 for r in eng.tick_trace() if r["kind"] == "decode")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            time.sleep(window_s)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        ticks = sum(1 for r in eng.tick_trace()
                    if r["kind"] == "decode") - before
    finally:
        eng.close()
    return {"window_s": window_s, "streams": 8, "decode_ticks": ticks,
            **busy_share(prof, wall_us)}


def main():
    # -- 1 device --------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    from client_tpu_torch import ops
    from client_tpu_torch.ops import _build, quant
    from client_tpu_torch.ops import flash_attention as fa
    from client_tpu_torch.ops import paged_attention as pa
    from client_tpu_torch.parallel.ring_attention import plain_attention
    from client_tpu_torch.serve import Server
    from client_tpu_torch.serve.lm import LmEngine
    from client_tpu_torch.serve.models import language
    from client_tpu_torch.serve.models import transformer as tfm
    from client_tpu_torch.train import CheckpointManager

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    card = {"gpu": kind, "nvidia_smi": smi}
    phase(1, "device", torch=torch.__version__, cuda=torch.version.cuda,
          count=torch.cuda.device_count(), **card)

    # -- 2 build ---------------------------------------------------------
    library = _build.kernels().__file__
    phase(2, "build", kernels=["int8_matmul", *FLASH_KERNELS,
                               "paged_attention"],
          seconds=round(_build.build_seconds, 3), flags=_build.CUDA_FLAGS,
          resources=kernel_resources(library))

    # -- 3 kernel against its plain version -------------------------------
    gen = torch.Generator().manual_seed(1234)
    worst, worst_route = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        atol, rtol = TOL[dt]
        for m in M_LIST:
            for k, n in SERVED_KN:
                x = torch.randn(m, k, generator=gen).to(dt).cuda()
                w = torch.randn(k, n, generator=gen) * k ** -0.5
                qw = tree_to(quant.quantize_int8(w), "cuda")
                got = quant._launch(x, qw["q"], qw["s"]).float()
                want = quant.int8_matmul_reference(x, qw["q"], qw["s"]).float()
                err = (got - want).abs()
                check(bool((err <= atol + rtol * want.abs()).all()),
                      f"int8_matmul {dt} M={m} K={k} N={n}: max abs err "
                      f"{err.max().item()} beyond atol {atol} rtol {rtol}")
                key = dtype_name(dt)
                worst[key] = max(worst.get(key, 0.0), err.max().item())
                route = worst_route.setdefault(int8_route(m, n), {})
                route[key] = max(route.get(key, 0.0), err.max().item())
    torch.cuda.synchronize()
    phase(3, "kernel_vs_plain", kernel="int8_matmul",
          cases=2 * len(M_LIST) * len(SERVED_KN), max_abs_err=worst,
          max_abs_err_by_route=worst_route,
          tolerance={"float32": TOL[torch.float32],
                     "bfloat16": TOL[torch.bfloat16]})

    # -- 4 model: cuda (kernel) against cpu (plain) -----------------------
    cfg = language.DEFAULT_LM_CONFIG
    params_cpu = tfm.quantize_params(
        tfm.init_params(torch.Generator().manual_seed(0), cfg, "cpu"))
    params_gpu = tree_to(params_cpu, "cuda")
    prompt = language.encode_text(PROMPT)
    toks = torch.as_tensor(prompt)[None]
    logits_gpu = tfm.forward(params_gpu, toks.cuda(), cfg).cpu()
    logits_cpu = tfm.forward(params_cpu, toks, cfg)
    check(bool(torch.isfinite(logits_gpu).all()), "non-finite logits on cuda")
    logit_err = (logits_gpu - logits_cpu).abs().max().item()
    fwd_agree = (logits_gpu.argmax(-1) == logits_cpu.argmax(-1)).float().mean().item()
    check(logit_err <= LOGIT_ATOL,
          f"forward logits differ by {logit_err} > {LOGIT_ATOL}")
    check(fwd_agree >= MIN_AGREE, f"forward argmax agreement {fwd_agree}")

    cache = tfm.init_cache(cfg, 1, "cuda")
    logits, cache = tfm.prefill(params_gpu, toks.cuda(), cfg, cache)
    ops.reset_launches()
    tfm.decode_step(params_gpu, logits.argmax(-1).to(torch.int32), cfg, cache)
    torch.cuda.synchronize()
    per_step = ops.LAUNCHES["int8_matmul"]
    check(per_step == 6 * cfg.n_layers,
          f"{per_step} int8_matmul launches per decode step, expected "
          f"{6 * cfg.n_layers}")

    n_new = 32
    ops.reset_launches()
    gen_gpu = list(tfm.generate(params_gpu, cfg, prompt, n_new))
    gen_launches = ops.LAUNCHES["int8_matmul"]
    gen_cpu = list(tfm.generate(params_cpu, cfg, prompt, n_new))
    check(gen_launches == 6 * cfg.n_layers * n_new,
          f"generate launched the kernel {gen_launches} times, expected "
          f"{6 * cfg.n_layers * n_new} (prefill + {n_new - 1} decode steps)")
    agree = float(np.mean(np.array(gen_gpu) == np.array(gen_cpu)))
    check(len(gen_gpu) == n_new and agree >= MIN_AGREE,
          f"greedy tokens agree on {agree:.3f} of positions: cuda {gen_gpu} "
          f"cpu {gen_cpu}")
    phase(4, "model", config="DEFAULT_LM_CONFIG int8", prompt_tokens=len(prompt),
          logits_max_abs_err=logit_err, logits_atol=LOGIT_ATOL,
          forward_argmax_agree=fwd_agree, launches_per_decode_step=per_step,
          generate_launches=gen_launches, greedy_agree=agree,
          tokens_cuda=gen_gpu)

    # -- 5 server: the main path, counted ---------------------------------
    # lm_streaming_int8 and lm_streaming_batched run on the continuous-
    # batching engine (paged attention; int8 at decode on the GEMV route)
    ops.reset_launches()
    served_models = language.language_models(device="cuda")
    engines = {m.name: m.closer.__self__ for m in served_models
               if m.closer is not None}
    check(set(engines) == {"lm_streaming_int8", "lm_streaming_batched"},
          f"batched models {sorted(engines)}")
    with Server(models=served_models, http_port=0) as server:
        addr = server.http_address
        status, _, _ = http(addr, "/v2/health/ready")
        check(status == 200, f"ready answered {status}")
        _, body, _ = http(addr, "/v2/models/lm_streaming_int8")
        meta = json.loads(body)
        check(meta["name"] == "lm_streaming_int8", f"metadata {meta}")
        tok_req = json.dumps({"inputs": [{
            "name": "TEXT", "shape": [1], "datatype": "BYTES",
            "data": [PROMPT]}]}).encode()
        _, body, _ = http(addr, "/v2/models/tokenizer/infer", tok_req)
        tok_out = {o["name"]: o for o in json.loads(body)["outputs"]}
        check(tok_out["TOKENS"]["data"] == prompt.tolist(),
              "tokenizer output differs from encode_text")
        served = {}
        for model_name in (("lm_streaming_int8",) * 3 + ("lm_streaming",)
                           + ("lm_streaming_batched",) * 2):
            _, body, headers = http(
                addr, f"/v2/models/{model_name}/infer",
                lm_request(prompt, 1), {"Accept-Encoding": "gzip"},
            )
            check(headers.get("Content-Encoding") == "gzip", "no gzip body")
            out = json.loads(gzip.decompress(body))
            served.setdefault(model_name, []).append(
                out["outputs"][0]["data"][0])
        for model_name, firsts in served.items():
            check(len(set(firsts)) == 1,
                  f"{model_name} answered {firsts} to one request")
        try:
            http(addr, "/v2/models/lm_streaming_int8/infer",
                 lm_request(prompt, 4))
            fail("MAX_TOKENS=4 over HTTP did not answer 400")
        except urllib.error.HTTPError as e:
            err_body = e.read().decode()
            check(e.code == 400 and "gRPC streaming" in err_body,
                  f"decoupled rule answered {e.code}: {err_body}")
        streamed, own = {}, {}
        for model_name, eng in engines.items():
            stream = server.engine.execute(
                model_name, "", json.loads(lm_request(prompt, 32)), b"")
            streamed[model_name] = [r[0]["outputs"][0]["data"][0]
                                    for r in stream]
            # the same request straight to the model's engine
            own[model_name] = collect(eng.submit(prompt, 32)[0],
                                      LmEngine.CLOSE)
            check(streamed[model_name] == own[model_name],
                  f"{model_name}: engine.execute stream "
                  f"{streamed[model_name]} != its engine's {own[model_name]}")
            check(served[model_name][0] == own[model_name][0],
                  f"{model_name}: HTTP answered {served[model_name][0]}, "
                  f"its engine {own[model_name][0]}")
    torch.cuda.synchronize()
    main_launches = dict(ops.LAUNCHES)
    check(all(not eng._thread.is_alive() for eng in engines.values()),
          "Server.stop left an engine's scheduler thread running")
    for name in ("int8_matmul", "paged_attention"):
        check(main_launches[name] > 0,
              f"the served path launched {name} no time")
    # the int8 engine against the serial runner on the same weights
    ref_runner = language._LmRunner(device="cuda", quantize=True)
    expected = list(ref_runner.stream(prompt, 32))
    int8_vs_serial = agreement(tfm, ref_runner.params, cfg, prompt,
                               streamed["lm_streaming_int8"], expected)
    phase(5, "server", requests=9, streamed_tokens={
              k: len(v) for k, v in streamed.items()},
          execute_matches_engine=True, int8_vs_serial=int8_vs_serial,
          near_tie=NEAR_TIE, first_tokens=served, launches=main_launches)

    # -- 6 timings ---------------------------------------------------------
    rows = []
    for m in (1, 8, 63, 128):
        for k, n in SERVED_KN:
            x = torch.randn(m, k, generator=gen).to(torch.bfloat16).cuda()
            qw = tree_to(quant.quantize_int8(
                torch.randn(k, n, generator=gen) * k ** -0.5), "cuda")
            q, s = qw["q"], qw["s"]
            w_deq = (q.float() * s).to(torch.bfloat16)
            kernel = lambda: quant._launch(x, q, s)  # noqa: E731
            plain = lambda: quant.int8_matmul_reference(x, q, s)  # noqa: E731
            library = lambda: torch.matmul(x, w_deq)  # noqa: E731
            rows.append({
                "M": m, "K": k, "N": n, "route": int8_route(m, n),
                "ms": graph_ms(kernel),
                "plain_ms": graph_ms(plain),
                "library_ms": graph_ms(library),
                "bound_ms": bound_ms(m, k, n),
                "eager_ms": eager_ms(kernel),
                "eager_plain_ms": eager_ms(plain),
                "eager_library_ms": eager_ms(library),
            })
    for row in rows:
        phase(6, "kernel_time", kernel="int8_matmul", dtype="bfloat16",
              **row, **card)

    def decode_rate(params, depth):
        list(tfm.generate(params, cfg, prompt, 8))  # warm-up
        t0 = time.monotonic()
        stamps = []
        for _ in tfm.generate(params, cfg, prompt, 128, readback_depth=depth):
            stamps.append(time.monotonic())
        return {"readback_depth": depth, "ttft_ms": (stamps[0] - t0) * 1e3,
                "tokens_per_s": (len(stamps) - 1) / (stamps[-1] - stamps[0]),
                "tokens": len(stamps)}

    bf16_params = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    for model, params in (("lm_streaming_int8", params_gpu),
                          ("lm_streaming", bf16_params)):
        for depth in (8, 0):  # 8: the served default; 0: strict serial
            phase(6, "serial_decode", model=model, **decode_rate(params, depth),
                  **card)

    # -- 7 flash kernels against their plain versions ----------------------
    tcfg = tfm.TransformerConfig(**FLAGSHIP)
    main_shape = [TRAIN_BATCH * tcfg.n_heads, TRAIN_SEQ, tcfg.head_dim]
    flash_worst, flash_cases, main_err = flash_vs_plain(fa, gen, main_shape)
    wrapper_err = wrapper_vs_plain(fa, plain_attention, gen)
    phase(7, "flash_vs_plain", kernels=list(FLASH_KERNELS),
          cases=flash_cases, max_abs_err=flash_worst,
          main_path_case={"shape": main_shape, "dtype": "bfloat16",
                          "causal": True, "max_abs_err": main_err},
          tolerance={"float32": TOL[torch.float32],
                     "bfloat16": TOL[torch.bfloat16],
                     "lse": TOL[torch.float32]},
          wrapper_t100_max_abs_err=wrapper_err, wrapper_tolerance=WRAPPER_TOL)

    # -- 8 training: the main path of the flash kernels, counted -------------
    tokens = torch.from_numpy(np.random.default_rng(TRAIN_SEED).integers(
        0, tcfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))).cuda()
    ops.reset_launches()
    _, _, flash_losses = train_run(tfm, tcfg, "flash", tokens, TRAIN_STEPS)
    torch.cuda.synchronize()
    train_launches = dict(ops.LAUNCHES)
    per_step = {n: c / TRAIN_STEPS for n, c in train_launches.items()}
    check(per_step == {"int8_matmul": 0, "paged_attention": 0,
                       **{n: tcfg.n_layers for n in FLASH_KERNELS}},
          f"flash training launched {train_launches} in {TRAIN_STEPS} "
          f"steps, expected {tcfg.n_layers} of each flash kernel a step")
    check(all(np.isfinite(flash_losses)) and flash_losses[-1] < flash_losses[0],
          f"flash training losses {flash_losses}")
    _, _, plain_losses = train_run(tfm, tcfg, "plain", tokens, TRAIN_STEPS)
    diffs = [abs(a - b) for a, b in zip(flash_losses, plain_losses)]
    d0, dstep, dlast = diffs[0], max(diffs), diffs[-1]
    check(d0 <= TRAIN_LOSS0_ATOL and dstep <= TRAIN_LOSS_STEP_ATOL
          and dlast <= TRAIN_LOSS_LAST_ATOL,
          f"flash losses {flash_losses} against plain {plain_losses}")
    cfg32 = dataclasses.replace(tcfg, n_layers=2, dtype="float32")
    _, _, f32_flash = train_run(tfm, cfg32, "flash", tokens, 3)
    _, _, f32_plain = train_run(tfm, cfg32, "plain", tokens, 3)
    d32 = max(abs(a - b) for a, b in zip(f32_flash, f32_plain))
    check(d32 <= F32_LOSS_ATOL,
          f"float32 flash losses {f32_flash} against plain {f32_plain}")
    with torch.no_grad():
        logit_err = {}
        for c, atol in ((tcfg, LOGIT_ATOL), (cfg32, F32_LOGIT_ATOL)):
            p0 = tfm.init_params(torch.Generator().manual_seed(0), c, "cuda")
            lf = tfm.forward(p0, tokens[:, :-1], c, attn_impl="flash")
            lp = tfm.forward(p0, tokens[:, :-1], c, attn_impl="plain")
            err = (lf - lp).abs().max().item()
            agree = (lf.argmax(-1) == lp.argmax(-1)).float().mean().item()
            check(bool(torch.isfinite(lf).all()) and err <= atol
                  and agree >= MIN_AGREE,
                  f"{c.dtype} forward flash against plain: max abs err "
                  f"{err} (atol {atol}), argmax agreement {agree}")
            logit_err[c.dtype] = {"max_abs_err": err, "atol": atol,
                                  "argmax_agree": agree}
            del p0, lf, lp
    resumed_loss = checkpoint_round_trip(tfm, CheckpointManager, tcfg, tokens)
    phase(8, "training", config=FLAGSHIP, dtype=tcfg.dtype,
          tokens=[TRAIN_BATCH, TRAIN_SEQ + 1], steps=TRAIN_STEPS,
          lr=TRAIN_LR, launches=train_launches, launches_per_step=per_step,
          flash_losses=flash_losses, plain_losses=plain_losses,
          loss0_diff=d0, loss0_atol=TRAIN_LOSS0_ATOL, max_loss_diff=dstep,
          max_loss_atol=TRAIN_LOSS_STEP_ATOL, last_loss_diff=dlast,
          last_loss_atol=TRAIN_LOSS_LAST_ATOL,
          float32_2layer={"flash": f32_flash, "plain": f32_plain,
                          "max_diff": d32, "atol": F32_LOSS_ATOL},
          forward_flash_vs_plain=logit_err,
          checkpoint_resume_bit_exact=True, resumed_step_loss=resumed_loss)

    # -- 9 timings: flash kernels, train step, profile -----------------------
    ext = _build.kernels()
    bh, t, d = main_shape
    q, k, v, g = (torch.randn(bh, t, d, generator=gen).to(torch.bfloat16)
                  .cuda() for _ in range(4))
    scale = d ** -0.5
    out, lse = ext.flash_fwd(q, k, v, scale, True)
    delta, g_lse = fa._delta(g, out), torch.zeros_like(lse)
    # SDPA takes [B, H, T, D]: the same memory as the folded [B*H, T, D]
    q4, k4, v4, g4 = (x.view(TRAIN_BATCH, tcfg.n_heads, t, d)
                      for x in (q, k, v, g))
    q4r, k4r, v4r = (x.clone().requires_grad_() for x in (q4, k4, v4))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q4, k4, v4, is_causal=True)
    sdpa_fwd_bwd = lambda: torch.autograd.grad(  # noqa: E731
        F.scaled_dot_product_attention(q4r, k4r, v4r, is_causal=True),
        (q4r, k4r, v4r), g4)
    bwd_plain = lambda: fa._fa_backward_reference(  # noqa: E731
        q, k, v, out, lse, g, g_lse, scale, True)
    graph = lambda fn: graph_ms(fn, iters=20)  # noqa: E731
    sdpa_ms = graph(sdpa)
    sdpa_bwd_ms = graph(sdpa_fwd_bwd) - sdpa_ms
    bwd_plain_ms = graph(bwd_plain)
    bounds = flash_bounds(bh, t, d, causal=True)
    flash_rows = {
        "flash_fwd": {
            "ms": graph(lambda: ext.flash_fwd(q, k, v, scale, True)),
            "plain_ms": graph(
                lambda: fa._fa_forward_reference(q, k, v, scale, True)),
            "library_ms": sdpa_ms,
            "library": "F.scaled_dot_product_attention(is_causal=True)"},
        "flash_bwd_dq": {
            "ms": graph(lambda: ext.flash_bwd_dq(q, k, v, g, lse, delta,
                                                 g_lse, scale, True))},
        "flash_bwd_dkv": {
            "ms": graph(lambda: ext.flash_bwd_dkv(q, k, v, g, lse, delta,
                                                  g_lse, scale, True))},
    }
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        flash_rows[name].update({
            "plain_ms": bwd_plain_ms,
            "plain": "_fa_backward_reference: dq, dk and dv in one call",
            "library_ms": sdpa_bwd_ms,
            "library": "SDPA backward (dq, dk and dv together): graph-timed "
                       "SDPA forward + torch.autograd.grad minus the "
                       "graph-timed SDPA forward"})
    for name, row in flash_rows.items():
        row["bound_ms"], row["bound_by"] = bounds[name]
        phase(9, "flash_kernel_time", kernel=name, shape=[bh, t, d],
              dtype="bfloat16", causal=True,
              timing="device time from CUDA-graph replay", **row, **card)
    del q, k, v, g, out, lse, delta, g_lse, q4, k4, v4, g4, q4r, k4r, v4r
    phase(9, "flash_kernel_time_d128", **flash_d128(ext, fa, gen, graph),
          **card)
    for impl in ("plain", "flash", "flash", "plain"):
        phase(9, "train_step", **step_time(tfm, tcfg, impl, tokens), **card)
    phase(9, "train_profile", attn_impl="flash",
          **profile_steps(tfm, tcfg, tokens), **card)

    # -- 10 paged attention against its plain version ----------------------
    paged_worst, paged_cases = paged_vs_plain(pa)
    phase(10, "paged_vs_plain", kernel="paged_attention", cases=paged_cases,
          shapes=[[kind, b, t_] for kind, b, t_, _ in paged_grid()],
          head_dims=[16, 32, 64, 128], heads=list(PAGED_HEADS),
          block_size=PAGED_BS, table_width=PAGED_WIDTH,
          masked_rows="NaN for the kernel, clean for the plain version",
          max_abs_err=paged_worst,
          tolerance={"float32": TOL[torch.float32],
                     "bfloat16": TOL[torch.bfloat16]})

    # -- 11 the engine on the card ------------------------------------------
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tfm.init_params(torch.Generator().manual_seed(0), cfg32, "cuda")
    pbf = tfm.init_params(torch.Generator().manual_seed(0), cfg, "cuda")
    p8 = tfm.quantize_params(pbf)
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 256, 48).tolist()
    lens = [1, 3, 9, 16, 17, 31, 40, 63, 64, 65, 100, 128, 150, 200]
    prompts = [rng.integers(0, 256, n).tolist() for n in lens]
    prompts += [shared + rng.integers(0, 256, 5).tolist(),
                shared + rng.integers(0, 256, 9).tolist()]
    lengths = [16 + (7 * i) % 33 for i in range(len(prompts))]
    engine_report = {}
    for name, params, c, int8 in (("float32", p32, cfg32, False),
                                  ("bfloat16", pbf, cfg, False),
                                  ("int8", p8, cfg, True)):
        got, launches, ticks, stats = engine_run(
            LmEngine, ops, params, c, prompts, lengths)
        serial = [list(tfm.generate(params, c, p, n, readback_depth=0))
                  for p, n in zip(prompts, lengths)]
        if name == "float32":
            for p, g, s in zip(prompts, got, serial):
                check(g == s, f"float32 engine stream of a {len(p)}-token "
                              f"prompt {g} != serial generate {s}")
            agree = [{"equal": True, "tokens": len(g)} for g in got]
        else:
            agree = [agreement(tfm, params, c, p, g, s)
                     for p, g, s in zip(prompts, got, serial)]
        check(stats["prefix"]["hits"] >= 3,
              f"the shared 48-token prefix was not adopted: {stats}")
        engine_report[name] = {
            "streams": len(prompts), "equal_streams":
                sum(a["equal"] for a in agree),
            "divergent": [dict(a, prompt_tokens=len(p))
                          for a, p in zip(agree, prompts) if not a["equal"]],
            **check_launches(launches, ticks, c, int8), **stats}
    # one preempted stream: 'lo' holds 26 of the 32 blocks when 'hi' comes
    eng = LmEngine(p32, cfg32, device="cuda", pool_tokens=512,
                   tenant_priority={"hi": 10.0}, **ENGINE_KW)
    try:
        pa_, pb_ = [256, 1, 2], [256, 7]
        qa, _ = eng.submit(pa_, 400, tenant="lo")
        first = qa.get(timeout=300)
        qb, _ = eng.submit(pb_, 100, tenant="hi")
        got_b = collect(qb, LmEngine.CLOSE)
        got_a = [first] + collect(qa, LmEngine.CLOSE)
        preempt = eng.preempt_stats()
    finally:
        eng.close()
    check(preempt["preemptions"] >= 1
          and preempt["resumes"] == preempt["preemptions"],
          f"no preemption and resume: {preempt}")
    for p, n, g in ((pa_, 400, got_a), (pb_, 100, got_b)):
        check(g == list(tfm.generate(p32, cfg32, p, n, readback_depth=0)),
              f"preempted run: the {len(g)}-token stream differs from "
              f"greedy")
    check(eng.kv.used_blocks == 0 and eng.kv.ref_counts() == {},
          "KV audit after the preemption run")
    # one speculative run: k=4, n-gram drafter, repetitive prompts
    spec_prompts = [language.encode_text("abcabcabcabcabcabc").tolist(),
                    language.encode_text(PROMPT * 2).tolist(),
                    [256] + [7, 9, 11] * 8, rng.integers(0, 256, 30).tolist()]
    got, launches, ticks, stats = engine_run(
        LmEngine, ops, p32, cfg32, spec_prompts, [64] * 4,
        speculative={"k": 4, "drafter": "ngram"})
    for p, g in zip(spec_prompts, got):
        check(g == list(tfm.generate(p32, cfg32, p, 64, readback_depth=0)),
              "speculative stream differs from greedy")
    check(stats["spec"]["accepted"] > 0 and ticks.get("verify", 0) > 0,
          f"speculation never engaged: {stats['spec']} {ticks}")
    engine_report["speculative"] = {
        "streams": len(spec_prompts), "tokens_each": 64,
        "equal_to_greedy": True, **check_launches(launches, ticks, cfg32,
                                                  False), **stats}
    phase(11, "engine", config="DEFAULT_LM_CONFIG", engine=ENGINE_KW,
          prompt_tokens=[len(p) for p in prompts], tokens=lengths,
          shared_prefix_tokens=48, near_tie=NEAR_TIE,
          preempted={"preempt": preempt, "equal_to_greedy": True,
                     "tokens": [len(got_a), len(got_b)]},
          kv_audit_after_close="clean", **engine_report)

    # -- 12 timings: paged attention, the engine ---------------------------
    paged_rows = paged_timings(pa, ext, graph)
    for row in paged_rows:
        phase(12, "paged_kernel_time", kernel="paged_attention", **row,
              **card)
    for name, params in (("bfloat16", pbf), ("int8", p8)):
        for n in (1, 4, 8):
            phase(12, "engine_rate", weights=name, **engine_rate(
                LmEngine, params, cfg, prompt, n), **card)
    phase(12, "engine_profile", weights="bfloat16",
          **engine_profile(LmEngine, pbf, cfg, prompt), **card)

    # -- 13 kernels ----------------------------------------------------------
    by_shape = {(r["M"], r["K"], r["N"]): r for r in rows}
    layer = [by_shape[(1, k, n)] for k, n in LAYER_KN]
    total = {key: sum(r[key] for r in layer)
             for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                         "eager_ms")}
    phase(13, "kernels", held_against_plain_in="phases 3, 7 and 10")
    kernels = [{
        "name": "int8_matmul",
        "route": "cuda",
        "source": "client_tpu_torch/ops/csrc/int8_matmul.cu",
        "replaces": "client_tpu/ops/quant.py:51",
        "launches": main_launches["int8_matmul"],
        "max_abs_err": max(worst.values()),
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": "bytes",
        "library_ms": total["library_ms"],
        "eager_ms": total["eager_ms"],
        "timing": "ms, plain_ms, library_ms: device time from CUDA-graph "
                  "replay; eager_ms: back-to-back Python calls",
        "work": "one decode layer's six int8 projections at M=1, bf16 "
                "(wq, wk, wv, wo, w_gate, w_up)",
        "launches_in": "phase 5 (serving)",
        "checked_in": "phase 3",
    }]
    sources = {"flash_fwd": "client_tpu_torch/ops/csrc/flash_fwd_bf16.cu",
               "flash_bwd_dq": "client_tpu_torch/ops/csrc/flash_bwd_bf16.cu",
               "flash_bwd_dkv": "client_tpu_torch/ops/csrc/flash_bwd_bf16.cu"}
    replaces = {"flash_fwd": "client_tpu/ops/flash_attention.py:91",
                "flash_bwd_dq": "client_tpu/ops/flash_attention.py:185",
                "flash_bwd_dkv": "client_tpu/ops/flash_attention.py:215"}
    for name in FLASH_KERNELS:
        row = flash_rows[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": sources[name],
            "replaces": replaces[name],
            "launches": train_launches[name],
            "max_abs_err": max(flash_worst[name].values()),
            **{key: row[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
            "timing": "device time from CUDA-graph replay",
            "work": f"one layer's attention at the training shape: "
                    f"[{bh}, {t}, {d}] bf16, causal",
            "launches_in": f"phase 8 ({TRAIN_STEPS} flash train steps)",
            "checked_in": "phase 7",
        })
    row = next(r for r in paged_rows
               if r["shape"] == "decode" and r["context"] == 511)
    kernels.append({
        "name": "paged_attention",
        "route": "cuda",
        "source": "client_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "client_tpu/serve/models/transformer.py:357 (jnp in the "
                    "reference, not Pallas)",
        "launches": main_launches["paged_attention"],
        "max_abs_err": max(paged_worst.values()),
        **{key: row[key] for key in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
        "timing": "device time from CUDA-graph replay",
        "work": "one decode tick's attention of one layer: B=8 lanes at "
                "context 511, 8 heads over 4 KV heads, hd 32, bf16",
        "launches_in": "phase 5 (serving)",
        "checked_in": "phase 10",
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
