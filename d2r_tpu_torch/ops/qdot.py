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
``(y.float() * sx) * sw`` rounded to the output's type.

The int32 product is ``torch._int_mm``: the JAX package computes it with
``lax.dot_general`` outside any Pallas kernel, so this is a library GEMM,
not a kernel port. On the card ``_int_mm`` takes an (M, K) x (K, N)
product only with M > 16 and K, N multiples of 8, the first operand
row-major and the second column-major; :func:`int_mm` zero-pads every
product to such a shape (exact in integer arithmetic) on both devices, so
a shape the library refuses never reaches it and none is routed to a float
product instead. The quantize and rescale passes around it, which XLA fuses
into the dots in the JAX package, are hand-written kernels on the card
(``ops/kernels/quantize.py``): one launch quantizes a tensor by rows, two
by columns (the amax over every row, then the codes, written transposed in
the layout ``_int_mm`` takes), and one rescales the int32 product into the
output's type. On the CPU they are their plain versions.

``int8``'s weight gradient is the unquantized product's, as in JAX: for
bf16 operands a bf16 product with fp32 accumulation rounded once to the
weight's type (JAX's ``preferred_element_type=jnp.float32`` dot); on the
card ``torch.mm(..., out_dtype=torch.float32)``, on the CPU (which has no
such kernel) the same exact products through an fp32 upcast. fp32 operands
keep the fp32 product.

The mode is not a module global here: ``D2RModel`` sets it on each of its
``TorchLinear`` and ``QKVDense`` modules at construction
(:func:`set_quant_mode`), so models of different modes may run side by
side in one process.

Under a data axis (``parallel/mesh.py``) the ``int8_all`` backward's dW
scales, one a column over ALL batch rows, take the max over the data group,
so every rank quantizes with the global batch's scales, as one process
would; the rest holds row by row and needs nothing.

Under a model axis (``split``): where the model axis splits a product's
contraction (a row-parallel forward, whose K it splits; a column-parallel
``int8_all`` input gradient, whose N it splits) every amax over the
contraction is a max over the model group and the int32 partial products
are summed over it before the scales multiply, as GSPMD partitions the JAX
program; the product then equals one process's bit for bit. A
column-parallel ``int8`` input gradient, a float product, is summed over
the group here too (the layer then skips ``copy_to``). Every other product
is local to the rank's rows or columns.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from d2r_tpu_torch.ops.kernels import quantize as qk
from d2r_tpu_torch.parallel.distributed import all_reduce_max, sum_over

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


def quantize_rows(x2d: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 codes (R, K) of each row of ``x2d`` and their fp32
    scales (R, 1), the amax taken over ``group`` too. An all-zero row gets
    scale 1/127 and codes 0."""
    if group is None:
        return qk.quantize_rows(x2d)
    return qk.quantize_rows(x2d, all_reduce_max(qk.row_amax(x2d), group))


def quantize_cols(x2d: torch.Tensor, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The codes of each column of ``x2d`` (R, C) over its rows, transposed
    (C, R), and their fp32 scales (1, C), the amax taken over ``group``
    too."""
    return qk.quantize_cols(x2d, all_reduce_max(qk.col_amax(x2d), group))


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


def _int8_matmul(x: torch.Tensor, w: torch.Tensor, group=None) -> torch.Tensor:
    """``x (..., K) @ w.T`` for ``w`` (N, K), quantized: x per row over K, w
    per output row over K. (..., N) in x's type. ``group``: the model ranks
    whose slices of K make the whole contraction."""
    qx, sx = quantize_rows(x.reshape(-1, x.shape[-1]), group)     # sx (M, 1)
    qw, sw = quantize_rows(w, group)                              # sw (N, 1)
    y = qk.rescale(sum_over(int_mm(qx, qw), group), sx, sw.t(), x.dtype)
    return y.view(*x.shape[:-1], w.shape[0])


class QuantDot(torch.autograd.Function):
    """``x @ w.T`` (``w`` (N, K), torch's Linear layout) quantized, with the
    straight-through backward of ``mode``. The output has ``x``'s type."""

    @staticmethod
    def forward(ctx, x, w, mode, group, model_group, split):
        ctx.save_for_backward(x, w)
        ctx.mode, ctx.group = mode, group
        ctx.column = model_group if split == "column" else None
        return _int8_matmul(x, w, model_group if split == "row" else None)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        x2d = x.reshape(-1, x.shape[-1])
        g2d = g.reshape(-1, g.shape[-1])
        if ctx.mode == "int8_all":
            # dx[..., k] = sum_n g[..., n] w[n, k]: contract N, per-k scales of w
            qg, sg = quantize_rows(g2d, ctx.column)       # sg (M, 1)
            qw, sw = quantize_cols(w, ctx.column)         # (K, N), sw (1, K)
            dx = qk.rescale(sum_over(int_mm(qg, qw), ctx.column), sg, sw, x.dtype)
            dx = dx.view(x.shape)
            # dW[n, k] = sum_m g[m, n] x[m, k]: contract the rows
            qx, sx = quantize_cols(x2d, ctx.group)        # (K, M), sx (1, K)
            qg, sg = quantize_cols(g2d, ctx.group)        # (N, M), sg (1, N)
            dw = qk.rescale(int_mm(qg, qx), sx, sg.t(), w.dtype)
        else:
            # the unquantized product's backward on the saved operands
            dx = sum_over(torch.matmul(g, w), ctx.column)
            if g2d.is_cuda and g2d.dtype == torch.bfloat16:
                dw = torch.mm(g2d.t(), x2d, out_dtype=torch.float32)
            else:
                dw = torch.matmul(g2d.t().float(), x2d.float())
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None, None


def quant_dot(x: torch.Tensor, w: torch.Tensor, mode: str = "int8",
              group=None, model_group=None, split=None) -> torch.Tensor:
    """Quantized ``x @ w.T`` with the backward of ``mode`` (``int8`` or
    ``int8_all``); ``w`` is (N, K). ``group``: the data group whose rows
    share the ``int8_all`` dW scales. ``split`` "row" or "column": this
    rank holds its ``model_group`` slice of K or of N (module
    docstring)."""
    if split not in ("row", "column"):
        model_group = split = None
    return QuantDot.apply(x, w, mode, group, model_group, split)
