"""The quantize and rescale passes of int8 quantized training
(``ops/qdot.py``): the CUDA kernels of ``csrc/quantize.cu``, their plain
PyTorch versions, and the wrappers.

Quantize: symmetric int8 codes of a 2-D tensor with one fp32 scale a
slice, the JAX package's ``_quantize`` (``d2r_tpu/ops/qdot.py:58-67``)
bit for bit: amax in the input's type, ``scale = where(amax > 0, amax, 1)
/ 127`` as a true division, codes ``clip(rint(x / scale), -127, 127)``.
By rows (a slice a row: :func:`row_amax`, :func:`quantize_rows`) or by
columns (:func:`col_amax`, :func:`quantize_cols`, whose codes come out
transposed, (C, R), the layout ``torch._int_mm`` takes). The amax is a
pass of its own where the caller reduces it over a process group between
the two; :func:`quantize_rows` without an amax reads each row once, into
registers, and writes its codes from there, in a launch shape that
:func:`rows_tiling` picks from the shape; :func:`col_amax` is one launch
whose last block of a column tile merges the row bands in a fixed order,
so its result never depends on the schedule.

Rescale: ``(float(y) * a) * b`` in fp32, rounded to the output type, for
the int32 product ``y`` (M, N) and two scales each (M, 1) or (1, N): the
JAX package's ``y.astype(f32) * sx * sw`` then its cast
(``d2r_tpu/ops/qdot.py:70-77``).

They replace no Pallas kernel: XLA fuses these passes into the dots in the
JAX package (``d2r_tpu/ops/qdot.py:58,70``); in PyTorch each was about
seven kernels an operand. On a CPU tensor each wrapper runs its plain
version; on a CUDA tensor it launches its kernel through a ``d2r_torch``
custom op or raises. Nothing reads a value back to the host, so a train
step stays one CUDA graph.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from d2r_tpu_torch.ops.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def row_amax_plain(x: torch.Tensor) -> torch.Tensor:
    """max |x| of each row, fp32 (R, 1)."""
    return x.abs().amax(dim=1, keepdim=True).float()


def col_amax_plain(x: torch.Tensor) -> torch.Tensor:
    """max |x| of each column, fp32 (1, C)."""
    return x.abs().amax(dim=0, keepdim=True).float()


def _codes(x: torch.Tensor, amax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    # a tensor divisor: CUDA divides by a host scalar as a product with its
    # reciprocal, which can be one ulp off the quotient that JAX and the CPU
    # compute, and would move the codes
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_rows_plain(x: torch.Tensor, amax: Optional[torch.Tensor] = None):
    """Codes (R, K) int8 and scales (R, 1) of each row of ``x``, from
    ``amax`` (R, 1) or the rows' own."""
    return _codes(x, row_amax_plain(x) if amax is None else amax)


def quantize_cols_plain(x: torch.Tensor, amax: torch.Tensor):
    """Codes of each column of ``x`` from ``amax`` (1, C), transposed: (C, R)
    int8, and scales (1, C)."""
    q, scale = _codes(x, amax)
    return q.t().contiguous(), scale


def rescale_plain(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """``(y.float() * a * b).to(dtype)``."""
    return (y.float() * a * b).to(dtype)


UNIT = 16                     # elements a lane takes at a time (its codes: one 16-byte store)
# units a lane holds in registers: 64 registers of x in either type
REGISTER_UNITS = {torch.bfloat16: 8, torch.float32: 4}
MAX_LANES = 256               # lanes a row: a block's threads at most
MIN_BLOCK = 64                # threads a block at least
# units a lane, read off quantize_sweep.py's table on the card: three were
# within 0.2 us of the fastest shape at every site (NVIDIA H100 80GB HBM3)
LANE_UNITS = 3


class RowsTiling(NamedTuple):
    """The rows kernel's launch shape: ``units`` of 16 elements a lane,
    ``lanes`` a row (a power of two; above 32 the row's warps merge their
    maxima in shared memory), ``block`` threads a block (``block //
    lanes`` rows), and the ``segments`` a row is read in (1 unless the row
    is wider than ``MAX_LANES`` lanes' registers; each segment but the last
    is read twice)."""
    units: int
    lanes: int
    block: int
    segments: int


def rows_tiling(k: int, dtype: torch.dtype) -> RowsTiling:
    """The launch shape of the rows kernel for rows of ``k`` elements of
    ``dtype``: as many lanes a row (a power of two, at most ``MAX_LANES``)
    as ``LANE_UNITS`` units a lane need, then as few units a lane as those
    lanes need (at most ``REGISTER_UNITS``; a wider row runs in segments),
    and ``MIN_BLOCK`` threads a block, or a row's lanes where they are
    more. The row count does not enter: 64-thread blocks already spread
    768 rows of 768 over 192 blocks, more than the card's 132 SMs, and the
    sweep found no shape faster by more than 0.2 us at any site."""
    units = -(-k // UNIT)
    lanes = 1
    while lanes < MAX_LANES and lanes * LANE_UNITS < units:
        lanes *= 2
    per_lane = min(REGISTER_UNITS[dtype], -(-units // lanes))
    return RowsTiling(per_lane, lanes, max(MIN_BLOCK, lanes), -(-units // (lanes * per_lane)))


_fns = {}


_ARGTYPES = {"quantize_rows": "ipLiippppiiip", "col_amax": "ipLiipppp",
             "quantize_cols": "ipLiipppp", "rescale": "ipLiipipipp"}


def _kernel(name: str):
    if name not in _fns:
        kinds = {"i": ctypes.c_int, "p": ctypes.c_void_p, "L": ctypes.c_longlong}
        fn = getattr(build.load("quantize"), f"d2r_{name}")
        fn.argtypes = [kinds[k] for k in _ARGTYPES[name]]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check(x: torch.Tensor, name: str) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or x.stride(1) != 1 or x.stride(0) < x.shape[1] or 0 in x.shape:
        raise ValueError(f"{name}: x must be a non-empty 2-D tensor with unit column stride, "
                         f"got shape {tuple(x.shape)} strides {x.stride()}")


def _launch(name: str, x: torch.Tensor, *args) -> None:
    """Launch kernel ``name`` on x's current stream: x, then ``args``
    (tensors as their pointers, None as null, ints as they are)."""
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        arg = lambda a: a.data_ptr() if isinstance(a, torch.Tensor) else a
        err = _kernel(name)(_DTYPE_CODES[x.dtype], x.data_ptr(), x.stride(0), x.shape[0],
                            x.shape[1], *(arg(a) for a in args), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _launch_rows(x: torch.Tensor, amax_in, amax_out, codes, scale,
                 tiling: Optional[RowsTiling] = None) -> None:
    t = tiling or rows_tiling(x.shape[1], x.dtype)
    _launch("quantize_rows", x, amax_in, amax_out, codes, scale, t.units, t.lanes, t.block)


# the column amax's arrival counts, one a 64-column tile: zero, and left
# zero by every launch; one buffer a (device, stream), so that launches on
# two streams never share one
_arrivals = {}


def _arrival_counts(x: torch.Tensor) -> torch.Tensor:
    tiles = -(-x.shape[1] // 64)
    key = (x.device, torch.cuda.current_stream(x.device).cuda_stream)
    counts = _arrivals.get(key)
    if counts is None or counts.numel() < tiles:
        counts = _arrivals[key] = torch.zeros(max(tiles, 1024), dtype=torch.int32,
                                              device=x.device)
    return counts


@torch.library.custom_op("d2r_torch::row_amax", mutates_args=(), device_types="cuda",
                         schema="(Tensor x) -> Tensor")
def row_amax_op(x):
    _check(x, "row_amax")
    amax = torch.empty((x.shape[0], 1), dtype=torch.float32, device=x.device)
    _launch_rows(x, None, amax, None, None)
    quantize_rows.launches += 1
    return amax


@row_amax_op.register_fake
def _(x):
    return x.new_empty((x.shape[0], 1), dtype=torch.float32)


@torch.library.custom_op("d2r_torch::quantize_rows", mutates_args=(), device_types="cuda",
                         schema="(Tensor x, Tensor? amax) -> (Tensor, Tensor)")
def quantize_rows_op(x, amax):
    _check(x, "quantize_rows")
    codes = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((x.shape[0], 1), dtype=torch.float32, device=x.device)
    _launch_rows(x, None if amax is None else amax.contiguous(), None, codes, scale)
    quantize_rows.launches += 1
    return codes, scale


@quantize_rows_op.register_fake
def _(x, amax):
    return (x.new_empty(x.shape, dtype=torch.int8),
            x.new_empty((x.shape[0], 1), dtype=torch.float32))


@torch.library.custom_op("d2r_torch::col_amax", mutates_args=(), device_types="cuda",
                         schema="(Tensor x) -> Tensor")
def col_amax_op(x):
    _check(x, "col_amax")
    amax = torch.empty((1, x.shape[1]), dtype=torch.float32, device=x.device)
    work = torch.empty((-(-x.shape[0] // 256), x.shape[1]), dtype=torch.float32,
                       device=x.device)
    _launch("col_amax", x, work, _arrival_counts(x), amax)
    quantize_cols.launches += 1
    return amax


@col_amax_op.register_fake
def _(x):
    return x.new_empty((1, x.shape[1]), dtype=torch.float32)


@torch.library.custom_op("d2r_torch::quantize_cols", mutates_args=(), device_types="cuda",
                         schema="(Tensor x, Tensor amax) -> (Tensor, Tensor)")
def quantize_cols_op(x, amax):
    _check(x, "quantize_cols")
    codes_t = torch.empty((x.shape[1], x.shape[0]), dtype=torch.int8, device=x.device)
    scale = torch.empty((1, x.shape[1]), dtype=torch.float32, device=x.device)
    _launch("quantize_cols", x, amax.contiguous(), codes_t, scale)
    quantize_cols.launches += 1
    return codes_t, scale


@quantize_cols_op.register_fake
def _(x, amax):
    return (x.new_empty((x.shape[1], x.shape[0]), dtype=torch.int8),
            x.new_empty((1, x.shape[1]), dtype=torch.float32))


def _scale_rows(s: torch.Tensor, m: int, n: int) -> int:
    """1 where scale ``s`` is (M, 1), a value a row; 0 where it is (1, N)."""
    if tuple(s.shape) == (m, 1):
        return 1
    if tuple(s.shape) == (1, n):
        return 0
    raise ValueError(f"rescale: a scale is (M, 1) or (1, N) = ({m}, 1) or (1, {n}), got "
                     f"{tuple(s.shape)}")


@torch.library.custom_op("d2r_torch::rescale", mutates_args=(), device_types="cuda",
                         schema="(Tensor y, Tensor a, Tensor b, ScalarType dtype) -> Tensor")
def rescale_op(y, a, b, dtype):
    if y.dtype != torch.int32 or y.dim() != 2 or y.stride(1) != 1 or 0 in y.shape:
        raise ValueError(f"rescale: y must be a non-empty 2-D int32 tensor with unit column "
                         f"stride, got {y.dtype} {tuple(y.shape)} strides {y.stride()}")
    if dtype not in _DTYPE_CODES or a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"rescale: fp32 scales into float32 or bfloat16, got {a.dtype}, "
                        f"{b.dtype} into {dtype}")
    m, n = y.shape
    a_rows, b_rows = _scale_rows(a, m, n), _scale_rows(b, m, n)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((m, n), dtype=dtype, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = _kernel("rescale")(_DTYPE_CODES[dtype], y.data_ptr(), y.stride(0), m, n,
                                 a.data_ptr(), a_rows, b.data_ptr(), b_rows, out.data_ptr(),
                                 stream)
    if err != 0:
        raise RuntimeError(f"rescale launch failed: cudaError {err}")
    rescale.launches += 1
    return out


@rescale_op.register_fake
def _(y, a, b, dtype):
    return y.new_empty(y.shape, dtype=dtype)


def _device(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU one (the plain
    version); raises for any other device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return x.device.type == "cuda"


def _rows_view(x: torch.Tensor) -> torch.Tensor:
    return x if x.stride(1) == 1 and x.stride(0) >= x.shape[1] else x.contiguous()


def row_amax(x: torch.Tensor) -> torch.Tensor:
    """max |x| of each row of the 2-D ``x``, fp32 (R, 1)."""
    return row_amax_op(_rows_view(x)) if _device(x, "row_amax") else row_amax_plain(x)


def quantize_rows(x: torch.Tensor, amax: Optional[torch.Tensor] = None):
    """Codes (R, K) and scales (R, 1) of each row of the 2-D ``x``, from
    ``amax`` (R, 1) (a max over a process group) or the rows' own."""
    if _device(x, "quantize_rows"):
        return quantize_rows_op(_rows_view(x), amax)
    return quantize_rows_plain(x, amax)


def col_amax(x: torch.Tensor) -> torch.Tensor:
    """max |x| of each column of the 2-D ``x``, fp32 (1, C)."""
    return col_amax_op(_rows_view(x)) if _device(x, "col_amax") else col_amax_plain(x)


def quantize_cols(x: torch.Tensor, amax: torch.Tensor):
    """Codes of each column of the 2-D ``x`` from ``amax`` (1, C), transposed
    (C, R), and scales (1, C)."""
    if _device(x, "quantize_cols"):
        return quantize_cols_op(_rows_view(x), amax)
    return quantize_cols_plain(x, amax)


def rescale(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """``((float(y) * a) * b)`` rounded to ``dtype``, for int32 ``y`` (M, N)
    and scales ``a``, ``b`` each (M, 1) or (1, N)."""
    if _device(y, "rescale"):
        return rescale_op(y, a, b, dtype)
    return rescale_plain(y, a, b, dtype)


# host calls that launched a kernel since the count was last set to 0: the
# row passes (amax alone, codes, or both in one launch), the column passes
# (amax, codes) and the rescale; a launch under CUDA graph capture counts
# once, a replay not at all
quantize_rows.launches = 0
quantize_cols.launches = 0
rescale.launches = 0
