"""Int8 quantized-training products (counterpart of ``d2r_tpu/ops/qdot.py``;
``--quant_train int8|int8_all``).

Dynamic symmetric quantization with no calibration: a scale per slice of
each operand over the contraction axis, computed from the live tensors
(activations one per row, weights one per output feature), an int8 x int8
-> int32 product, and a rank-1 rescale to fp32. The backward is a
straight-through estimator:

- ``int8``: the forward product only; the backward is the unquantized
  product's, from the saved operands in their own precision;
- ``int8_all``: both backward products (dx and dW) quantized as well, with
  fresh scales over their own contraction axes.

The arithmetic is the JAX package's, step for step, so both give the same
bits: the operands are cast to the compute type first, amax is taken in
that type, the scale is ``where(amax > 0, amax, 1) / 127`` in fp32, codes
are ``clip(round_half_even(x / scale), -127, 127)``, and the result is
``y.float() * sx * sw``.

The int32 product is ``torch._int_mm``: the JAX package computes it with
``lax.dot_general`` outside any Pallas kernel, so this is a library GEMM,
not a kernel port. On the card ``_int_mm`` takes an (M, K) x (K, N)
product only with M > 16 and K, N multiples of 8, the first operand
row-major and the second column-major; :func:`int_mm` zero-pads every
product to such a shape (exact in integer arithmetic) on both devices, so
a shape the library refuses never reaches it and none is routed to a float
product instead. The quantize passes are plain PyTorch, as in JAX.

The mode is not a module global here: ``D2RModel`` sets it on each of its
``TorchLinear`` and ``QKVDense`` modules at construction
(:func:`set_quant_mode`), so models of different modes may run side by
side in one process.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

MODES = ("none", "int8", "int8_all")


def check_mode(mode: str) -> str:
    """``mode`` if it is one of :data:`MODES`; the JAX package's
    ``ValueError`` otherwise."""
    if mode not in MODES:
        raise ValueError(f"quant_train must be one of {MODES}, got {mode!r}")
    return mode


def set_quant_mode(module: torch.nn.Module, mode: str) -> torch.nn.Module:
    """Set the quantized-training mode of every module under ``module`` that
    has one (``TorchLinear``, ``QKVDense``)."""
    check_mode(mode)
    for m in module.modules():
        if hasattr(m, "quant"):
            m.quant = mode
    return module


def _quantize(x: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 codes of ``x`` over ``dim`` and their fp32 scale (kept
    as a size-1 dim). An all-zero slice gets scale 1/127 and codes 0."""
    amax = x.abs().amax(dim=dim, keepdim=True).float()
    # a tensor divisor: CUDA divides by a host scalar as a product with its
    # reciprocal, which can be one ulp off the quotient that JAX and the CPU
    # compute, and would move the codes
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def int_mm(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """``a @ b_t.T`` in int32 for int8 ``a`` (M, K) and ``b_t`` (N, K),
    through ``torch._int_mm``: M padded to more than 16 and K, N to multiples
    of 8 with zeros, ``a`` row-major and ``b_t.T`` column-major (``b_t``
    row-major), the result cut back to (M, N)."""
    m, k = a.shape
    n = b_t.shape[0]
    mp, kp, np_ = max(_round_up(m, 8), 24), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        b_t = F.pad(b_t, (0, kp - k, 0, np_ - n))
    y = torch._int_mm(a.contiguous(), b_t.contiguous().t())
    return y[:m, :n] if (mp, np_) != (m, n) else y


def _int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., K) @ w.T`` for ``w`` (N, K), quantized: x per row over K, w
    per output row over K. fp32 (..., N)."""
    qx, sx = _quantize(x, -1)                       # sx (..., 1)
    qw, sw = _quantize(w, 1)                        # sw (N, 1)
    y = int_mm(qx.reshape(-1, x.shape[-1]), qw)
    return y.reshape(*x.shape[:-1], w.shape[0]).float() * sx * sw[:, 0]


class QuantDot(torch.autograd.Function):
    """``x @ w.T`` (``w`` (N, K), torch's Linear layout) quantized, with the
    straight-through backward of ``mode``. The output has ``x``'s type."""

    @staticmethod
    def forward(ctx, x, w, mode):
        ctx.save_for_backward(x, w)
        ctx.mode = mode
        return _int8_matmul(x, w).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        x2d = x.reshape(-1, x.shape[-1])
        g2d = g.reshape(-1, g.shape[-1])
        if ctx.mode == "int8_all":
            # dx[..., k] = sum_n g[..., n] w[n, k]: contract N, per-k scales of w
            dx = _int8_matmul(g, w.t())
            # dW[n, k] = sum_m g[m, n] x[m, k]: contract the rows
            qx, sx = _quantize(x2d, 0)              # sx (1, K)
            qg, sg = _quantize(g2d, 0)              # sg (1, N)
            dw = int_mm(qg.t(), qx.t()).float() * sx * sg.t()
        else:
            # the unquantized product's backward on the saved operands
            dx = torch.matmul(g, w)
            dw = torch.matmul(g2d.t().float(), x2d.float())
        return dx.to(x.dtype), dw.to(w.dtype), None


def quant_dot(x: torch.Tensor, w: torch.Tensor, mode: str = "int8") -> torch.Tensor:
    """Quantized ``x @ w.T`` with the backward of ``mode`` (``int8`` or
    ``int8_all``); ``w`` is (N, K)."""
    return QuantDot.apply(x, w, mode)
