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

What the wrapper decides (:func:`tiling`): the body, the grid and a split
of K. A warp an output column for at most :data:`GEMV_M` rows; in bf16
above that the warp-specialized ``wgmma`` body with the weight as the
register operand, a tile of 64 output features by 64, 128 or 256 tokens
(:data:`WGMMA_TILES`): at 64 tokens two consumer warpgroups on alternate
k-steps of the tile, so that one dequantizes while the other's products
run, or two blocks an SM, as at 128 tokens; fp32 takes 64 x 64 tiles on
the CUDA cores. The ``wgmma`` grid is persistent (at most the SMs times
the body's blocks an SM, walking the tiles in a fixed order:
:func:`schedule`). K is split where even the narrow tiles would leave most
SMs idle; the splits of a tile are one thread block cluster that sums
their fp32 partials in split order through distributed shared memory: one
launch, and a shape's result never depends on the schedule. A bf16 view
that TMA cannot take (rows off 16-byte alignment, K % 16 != 0) runs 64 x
64 ``mma.sync`` tiles, unsplit, whatever the tiling says.
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
# post at bucket 1; at 8 rows the wgmma bodies are faster, w8a16_sweep.py)
GEMV_M = 4
# the bf16 wgmma bodies, by the code the kernel takes (100 KW + NT / 64 +
# 10): (tokens NT, k-groups KW, blocks an SM) of a tile of 64 output
# features; KW consumer warpgroups take alternate k-steps of the tile and
# add their sums at the end
WGMMA_TILES = {211: (64, 2, 1), 111: (64, 1, 2), 112: (128, 1, 2), 114: (256, 1, 1)}
# the SM clocks a tile's 64-deep step takes (alone on its SM, and beside a
# second block of the SM for the bodies that hold two), and the clocks a
# tile costs outside its K loop (its first stage's wait, the epilogue; the
# persistent grid hides part of it), from the kernel's clock probe on an
# H100 (w8a16_sweep.py --probe); the tensor cores alone need NT clocks a
# step. A split costs about SPLIT_CLOCKS_PER_TOKEN a token of the tile
# (the cluster's reduction of its fp32 partial tiles)
STEP_CLOCKS = {211: (320, 320), 111: (380, 650), 112: (540, 790), 114: (780, 780)}
TILE_CLOCKS = {211: 3000, 111: 2600, 112: 2700, 114: 2600}
SPLIT_CLOCKS_PER_TOKEN = 31
# a split of K: at most this many (a portable cluster), each at least
# MIN_SPLIT_STEPS k-steps
MAX_SPLITS = 8
MIN_SPLIT_STEPS = 2


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


def tiling(m: int, n: int, k: int, dtype: torch.dtype,
           sms: int = 132) -> Tuple[int, int, int, int]:
    """``(body, splits, steps a split, blocks)`` of an (M, N, K) product.
    Bodies: 2, a warp an output column (M <= :data:`GEMV_M`, never split);
    fp32 0, 64 x 64 tiles; bf16 the key of :data:`WGMMA_TILES` and split
    whose launch takes the fewest clocks by :data:`STEP_CLOCKS`,
    :data:`TILE_CLOCKS` and :data:`SPLIT_CLOCKS_PER_TOKEN` (unsplit, then
    the wider tile, on a tie): the busiest SM's tiles (of tiles times
    splits over the SMs), each a tile's steps and its fixed cost, two at a
    time for the bodies an SM holds twice, so that a narrower tile wins
    where a wide one would leave the last round ragged. K is split over a
    cluster only for a grid of fewer tiles than half the SMs, a power of
    two ways up to about ``sms`` blocks, at most :data:`MAX_SPLITS` ways
    and :data:`MIN_SPLIT_STEPS` k-steps a split. ``blocks`` is the grid of
    the persistent bf16 body (each block a tile or more; a split launch,
    one tile a block), else the blocks the launch starts."""
    steps = -(-k // K_STEP[dtype])
    if m <= GEMV_M:
        return 2, 1, steps, -(-n // 4)
    count = lambda em, en: -(-m // em) * -(-n // en)
    if dtype == torch.float32:
        tiles = count(64, 64)
        splits = 1
        if 2 * tiles < sms:
            splits = max(1, min(MAX_SPLITS, -(-sms // tiles), steps // MIN_SPLIT_STEPS))
        per = -(-steps // splits)
        return 0, -(-steps // per), per, tiles * -(-steps // per)
    best = None
    for body, (tokens, _, per_sm) in WGMMA_TILES.items():
        tiles = count(tokens, 64)
        choices = [1]
        if 2 * tiles < sms:
            # a power of two: the clusters of a split must pack into the
            # card's processing clusters of 16-18 SMs, or part of the grid
            # waits for a second wave
            most = max(1, min(MAX_SPLITS, sms // tiles, steps // MIN_SPLIT_STEPS))
            choices.append(1 << (most.bit_length() - 1))
        for want in choices:
            per = -(-steps // want)
            splits = -(-steps // per)
            busiest = -(-tiles * splits // sms)
            alone, shared = STEP_CLOCKS[body]
            tile_clocks = per * (shared if busiest > 1 else alone) + TILE_CLOCKS[body]
            clocks = (busiest / per_sm if busiest > 1 else 1) * tile_clocks
            if splits > 1:
                clocks += SPLIT_CLOCKS_PER_TOKEN * tokens
            key = (clocks, splits, -tokens)
            if best is None or key < best[0]:
                blocks = tiles if splits > 1 else min(tiles, sms * per_sm)
                best = (key, (body, splits, per, blocks))
    return best[1]


def schedule(m: int, n: int, k: int, body: int, splits: int, per: int, blocks: int):
    """The bf16 ``wgmma`` launch's work as the kernel walks it: for each
    block, in its order, ``(token0, feature0, [k-steps])`` of every tile it
    computes (a split launch: one tile a block, its split's steps).
    Mirrors ``w8a16_wgmma_kernel``'s index math: tile t covers features (t %
    tiles_n) * 64 and tokens (t // tiles_n) * NT; unsplit, block b takes
    tiles b, b + blocks, ...; split, block (t, z) takes tile t's steps [z
    per, (z + 1) per). Within a tile (or split), k-group kw of a body takes
    the steps kw, kw + KW, ..."""
    tokens, _, _ = WGMMA_TILES[body]
    features = 64
    steps = -(-k // K_STEP[torch.bfloat16])
    tiles_n = -(-n // features)
    tiles = tiles_n * -(-m // tokens)
    where = lambda t: ((t // tiles_n) * tokens, (t % tiles_n) * features)
    if splits > 1:
        return [[(*where(t), list(range(z * per, min(steps, (z + 1) * per))))]
                for t in range(tiles) for z in range(splits)]
    return [[(*where(t), list(range(steps))) for t in range(b, tiles, blocks)]
            for b in range(blocks)]


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
        fn.argtypes = [i, i, p, ctypes.c_longlong, p, p, i, p, p, i, i, i, i, i, i, p]
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
    tile, splits, per, blocks = tiling(m, n, k, x.dtype, _sm_count(x.device))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(_DTYPE_CODES[x.dtype], tile, x.data_ptr(), x.stride(0), q.data_ptr(),
                        scale.data_ptr(), period, None if bias is None else bias.data_ptr(),
                        out.data_ptr(), m, n, k, splits, per, blocks, stream)
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
