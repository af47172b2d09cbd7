"""Int8 weight-only quantization with a hand-written CUDA dequant-matmul.

Counterpart of client_tpu/ops/quant.py.  Weights quantize per output
channel, symmetric (int8 value x f32 scale); activations stay unquantized.
``int8_matmul`` keeps the JAX package's dispatch rule (``kernel_takes``):
weights whose dims do not tile (``n % min(128, n)`` or ``k % min(512, k)``)
take the dequantize-then-matmul fallback, the rest take the kernel.  On a CUDA
tensor the kernel is ``csrc/int8_matmul.cu`` (replacing the Pallas
``_int8_mm_kernel``), which picks one of three routes by dtype and shape:
bf16 from M = 5 on the tensor cores, a GEMV below that (and for f32 up
to M = 8), f32 above on the CUDA cores;
each call counts one launch of ``int8_matmul`` and one of its route in
``ops.ROUTES``.  On a CPU tensor it is ``int8_matmul_reference``, the
plain PyTorch version of the same arithmetic.
"""

import torch

from client_tpu_torch.ops import count_launch

_ROUTE_NAMES = {1: "gemv", 2: "tiled", 3: "mma"}


def quantize_int8(w):
    """Per-output-channel symmetric int8 quantization of a [K, N] weight.

    Returns {"q": int8 [K, N], "s": f32 [N]} with w ~= q * s.
    """
    w32 = w.float()
    amax = w32.abs().amax(dim=0)  # per output channel
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def is_quantized(w):
    return isinstance(w, dict) and "q" in w and "s" in w


def int8_matmul_reference(x2, q, s):
    """Plain PyTorch version of the kernel: [M,K] x, int8 [K,N] q, f32 [N]
    s -> [M,N] in x's dtype.  Widens q exactly, sums over K in f32 and
    applies the channel scale once at the end, as the Pallas kernel does
    (bf16 x widens to f32 exactly, so the products are the kernel's)."""
    acc = x2.float() @ q.float()
    return (acc * s).to(x2.dtype)


def _launch(x2, q, s):
    from client_tpu_torch.ops._build import kernels

    out, route = kernels().int8_matmul(x2.contiguous(), q, s)
    if route:  # 0: an empty output, nothing launched
        count_launch("int8_matmul", _ROUTE_NAMES[route])
    return out


def kernel_takes(k, n, block_n=128, block_k=512):
    """True where a [K, N] weight takes the kernel: the JAX package's tile
    clamps (``min(block, dim)``) divide both dims; the rest dequantize."""
    return n % min(block_n, n) == 0 and k % min(block_k, k) == 0


def int8_matmul(x, qw, block_n=128, block_k=512):
    """``x @ (q * s)`` for x [..., K] (leading dims fold into M).

    Returns [..., N] in x's dtype.  The CUDA kernel masks the ragged M
    edge itself, so unlike the Pallas kernel nothing pads M.
    """
    q, s = qw["q"], qw["s"]
    k, n = q.shape
    lead = x.shape[:-1]
    m = 1
    for d in lead:
        m *= d
    x2 = x.reshape(m, k)

    if not kernel_takes(k, n, block_n, block_k):
        # ragged weight dims: dequantize in x's dtype, then a plain matmul
        # (the JAX package computes this outside Pallas too)
        w = q.to(x.dtype) * s.to(x.dtype)
        return (x2 @ w).reshape(*lead, n)
    if x2.device.type == "cpu":
        out = int8_matmul_reference(x2, q, s)
    else:
        out = _launch(x2, q, s)
    return out.reshape(*lead, n)


def matmul(x, w, **kwargs):
    """Dispatch helper: plain ``x @ w`` or the int8 kernel for quantized w."""
    if is_quantized(w):
        return int8_matmul(x, w, **kwargs)
    return x @ w
