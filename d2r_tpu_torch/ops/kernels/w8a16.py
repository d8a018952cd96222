"""The W8A16 product of weight-only int8 serving: the CUDA kernel
``csrc/w8a16_linear.cu``, its plain PyTorch version, and the wrapper
``quant.py``'s modules call.

``y = x . (q * s)^T (+ bias)`` in the compute type, for int8 codes ``q``
(N, K) and fp32 scales ``s`` with one value a group of output rows: row
``n`` takes ``s[n % period]`` (``period`` = N for a Linear and the patch
conv, the hidden width for a fused QKV, whose q, k and v rows share a
scale a hidden unit). The dequantized weight is ``q.to(dtype) *
s.to(dtype)``, ``Int8Weight.weight`` and the JAX package's
``QuantLeaf.dequant`` (``d2r_tpu/quant.py:37-38``) bit for bit; the
kernel builds each element of it on chip and writes none to device
memory, as XLA fuses the dequantize into the consuming dot in the JAX
package (``d2r_tpu/quant.py:91``). It replaces no Pallas kernel.

On a CPU tensor :func:`w8a16_linear` runs the plain version (the
dequantized weight, then ``F.linear``); on a CUDA tensor it launches the
kernel through the ``d2r_torch::w8a16_linear`` custom op (one node a
product in an exported program) or raises. The kernel's sums run in
another order than the library GEMM's, so it equals the plain version
within fp32 summation noise before the one rounding to the compute type:
in bf16 an output may differ by one bf16 ulp where the fp32 sum lies near
a rounding midpoint.

What the wrapper decides (:func:`tiling`): the body (a warp an output
column for at most :data:`GEMV_M` rows; 64 x 64 tiles on ``mma.sync``;
128 x 128 or 128 x 256 tiles on warpgroup MMA, ``wgmma``, for bf16 above
:data:`SMALL_M` rows; fp32 takes 64 x 64 on the CUDA cores), and a split
of K over the grid where the tiles alone would leave SMs idle. The splits of a
tile are one thread block cluster that sums their fp32 partials in split
order through distributed shared memory: one launch, and a shape's result
never depends on the schedule.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from d2r_tpu_torch.ops.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# k a step of the bf16 and fp32 bodies
K_STEP = {torch.bfloat16: 64, torch.float32: 16}
# the largest M of the one-warp-a-column body (the products of one row a
# post at buckets 1 and 8), and of the 64 x 64 bf16 tiling (serving bucket
# 1's 49-64 rows up to bucket 4's)
GEMV_M = 8
SMALL_M = 256
# a split of K: at most this many (a portable cluster), each at least
# MIN_SPLIT_STEPS k-steps; LONG_K: the K from which a small bf16 grid takes
# the 128 x 256 wgmma tiles split over K (the FFN-out products)
MAX_SPLITS = 8
MIN_SPLIT_STEPS = 2
LONG_K = 2048


def dequantize(q: torch.Tensor, scale: torch.Tensor, period: int,
               dtype: torch.dtype) -> torch.Tensor:
    """The (N, K) weight of codes ``q`` and scales ``scale`` (``period``
    values) in ``dtype``: ``q.to(dtype) * s.to(dtype)``, row n scaled by
    ``s[n % period]``."""
    n = q.shape[0]
    s = scale.reshape(-1).to(dtype)
    return (q.view(n // period, period, -1).to(dtype) * s[:, None]).view(q.shape)


def w8a16_linear_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, period: int,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the dequantized weight in
    ``x``'s type, then ``F.linear``."""
    return F.linear(x, dequantize(q, scale, period, x.dtype), bias)


_sms = {}


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


def tiling(m: int, n: int, k: int, dtype: torch.dtype, sms: int = 132) -> Tuple[int, int, int]:
    """``(body, splits, steps a split)`` of an (M, N, K) product. Bodies:
    2, a warp an output column (M <= :data:`GEMV_M`, never split); 0, 64 x
    64 tiles on ``mma.sync`` (M <= :data:`SMALL_M`, and fp32); in bf16 above
    that, 1, 128 x 128 tiles on ``wgmma``, never split, except that a long
    K (>= :data:`LONG_K`) under a grid of fewer such tiles than half the
    SMs takes 3, 128 x 256 tiles split over K. A 64 x 64 grid of fewer
    tiles than half the SMs splits K too, at most :data:`MAX_SPLITS` ways
    and :data:`MIN_SPLIT_STEPS` k-steps a split, until it covers ``sms``; a
    fuller grid is not split (each split's cluster reduction then costs
    more than the SMs it fills)."""
    steps = -(-k // K_STEP[dtype])
    if m <= GEMV_M:
        return 2, 1, steps
    count = lambda em, en: -(-m // em) * -(-n // en)
    body, tiles = 0, count(64, 64)
    if dtype == torch.bfloat16 and m > SMALL_M:
        if k < LONG_K or 2 * count(128, 128) >= sms:
            return 1, 1, steps
        body, tiles = 3, count(128, 256)
    splits = 1
    if 2 * tiles < sms:
        splits = max(1, min(MAX_SPLITS, -(-sms // tiles), steps // MIN_SPLIT_STEPS))
    per = -(-steps // splits)
    return body, -(-steps // per), per


def _check(x, q, scale, bias, period) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"w8a16_linear takes float32 or bfloat16 activations, got {x.dtype}")
    if x.dim() != 2 or x.stride(1) != 1 or x.stride(0) < x.shape[1]:
        raise ValueError(f"w8a16_linear: x must be 2-D with unit column stride, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if q.dtype != torch.int8 or q.dim() != 2 or not q.is_contiguous() or q.shape[1] != x.shape[1]:
        raise ValueError(f"w8a16_linear: q must be contiguous int8 (N, {x.shape[1]}), got "
                         f"{q.dtype} {tuple(q.shape)}")
    if (scale.dtype != torch.float32 or scale.dim() != 1 or not scale.is_contiguous()
            or scale.numel() != period or period < 1 or q.shape[0] % period):
        raise ValueError(f"w8a16_linear: scale must be a contiguous fp32 vector of the period "
                         f"{period} dividing N = {q.shape[0]}, got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    if bias is not None and (bias.dtype != x.dtype or bias.shape != (q.shape[0],)
                             or not bias.is_contiguous()):
        raise ValueError(f"w8a16_linear: bias must be contiguous {x.dtype} ({q.shape[0]},), got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    devices = {t.device for t in (x, q, scale, bias) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"w8a16_linear: tensors on several devices {devices}")


_fn = []


def _kernel():
    if not _fn:
        fn = build.load("w8a16_linear").d2r_w8a16_linear
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, p, ctypes.c_longlong, p, p, i, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]


@torch.library.custom_op(
    "d2r_torch::w8a16_linear", mutates_args=(), device_types="cuda",
    schema="(Tensor x, Tensor q, Tensor scale, Tensor? bias, int period) -> Tensor")
def w8a16_linear_op(x, q, scale, bias, period):
    """The kernel's launch: x (M, K) . dequant(q, scale)^T (+ bias) -> (M, N)
    in x's type."""
    _check(x, q, scale, bias, period)
    m, k = x.shape
    n = q.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    tile, splits, per = tiling(m, n, k, x.dtype, _sm_count(x.device))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(_DTYPE_CODES[x.dtype], tile, x.data_ptr(), x.stride(0), q.data_ptr(),
                        scale.data_ptr(), period, None if bias is None else bias.data_ptr(),
                        out.data_ptr(), m, n, k, splits, per, stream)
    if err != 0:
        raise RuntimeError(f"w8a16_linear launch failed: cudaError {err}")
    w8a16_linear.launches += 1
    return out


@w8a16_linear_op.register_fake
def _(x, q, scale, bias, period):
    _check(x, q, scale, bias, period)
    return x.new_empty((x.shape[0], q.shape[0]))


def w8a16_linear(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, period: int,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x (..., K) . (q * s)^T (+ bias)`` -> (..., N) in ``x``'s type
    (module docstring): the plain version on a CPU tensor, the kernel on a
    CUDA tensor. ``scale`` holds ``period`` values in any shape."""
    n = q.shape[0]
    x2d = x.reshape(-1, x.shape[-1])
    scale = scale.reshape(-1)
    if x.device.type == "cpu":
        y = w8a16_linear_plain(x2d, q, scale, period, bias)
    elif x.device.type != "cuda":
        raise ValueError(f"w8a16_linear: no kernel for device {x.device}")
    elif x2d.shape[0] == 0:
        y = x2d.new_empty((0, n))
    else:
        if x2d.stride(1) != 1 or x2d.stride(0) < x2d.shape[1]:
            x2d = x2d.contiguous()
        y = w8a16_linear_op(x2d, q, scale, bias, int(period))
    return y.view(*x.shape[:-1], n)


# host calls that launched the kernel since the count was last set to 0; a
# launch under CUDA graph capture counts once, a replay not at all
w8a16_linear.launches = 0
