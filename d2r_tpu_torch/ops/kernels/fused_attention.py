"""Short-sequence fused attention: K1 (forward) and K2 (backward), the CUDA
kernels ``csrc/fused_attention_fwd.cu`` and ``csrc/fused_attention_bwd.cu``,
their plain PyTorch versions, and the ``torch.autograd.Function`` that joins
them.

K1 replaces ``d2r_tpu/ops/kernels/fused_attention.py::_fwd_kernel``: per
head, ``softmax(q.k^T * scale + key_bias[b])`` in fp32 over the whole (L, S)
tile, optional post-softmax dropout scaled by 1/(1-rate), the probabilities
rounded to v's type, then ``p.V`` with an fp32 accumulator, for L, S <= 128.
K2 replaces ``_bwd_kernel``: it recomputes p from (q, k, bias), regenerates
the same dropout mask, and returns dq, dk (both x scale), dv = pd^T.g and,
on request, dbias = the sum over heads and queries of d(logits).

What bounds both on the H100 is bytes, not operations: at the model's sites
they do about L/3 (K1) and 5L/6 (K2) operations per byte read, far under
the card's ridge. Each reads q, k, v (and g) once, keeps scores and
probabilities on chip and writes only its outputs. In bf16 each stages one
(b, h) a block by ``cp.async`` and runs its products on the tensor cores
(``mma.sync``, fp32 sums), rounding to bf16 where the JAX kernel rounds: K1
p before p.V; K2, in one pass, pd before dv and d(logits) before dq and dk,
drawing each dropout bit once. In fp32 both run on the CUDA cores. They
read q, k and v through their batch and row strides, so the strided views
that the fused QKV projection yields need no copies. See the sources'
headers for the grids and the shared-memory layouts.

Dropout bits come from Philox4x32-10 keyed on a 64-bit seed, with the
counter made from (b, h, query row, key column): the mask depends on no grid
or tile size, the forward and the backward regenerate it without storing
it, and :func:`dropout_keep_mask` computes the same bits with int64 tensor
ops, so the card's kernels can be held against the plain versions element
by element. An element is kept iff its 32 bits are >= ``min(int(rate *
2**32), 2**32 - 1)``, the rule of ``_keep_mask`` in the JAX package.

:func:`fused_attention_small` and :func:`fused_attention_small_bwd` launch
the kernels for CUDA tensors and raise for what they cannot take; only a
tensor on the CPU goes to the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from d2r_tpu_torch.ops.kernels import build

MAX_SEQ = 128
MAX_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Philox4x32-10 (Salmon et al., SC'11; the generator of cuRAND and of
# PyTorch's CUDA dropout): round multipliers and Weyl key increments
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low 32 bits of ``a * b`` for a uint32 constant ``a`` and
    uint32 values ``b`` held in int64. The 64-bit product would overflow
    int64, so ``b`` is split into 16-bit halves: each partial product stays
    under 2**48."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    mid = ((p_hi & 0xFFFF) << 16) + p_lo
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(counter, key: Tuple[int, int]):
    """Philox4x32-10 of four uint32 counter words (int64 tensors of one
    shape, or ints) under a two-word key: the four uint32 output words, as
    int64 tensors. Rounds and key schedule as Random123's ``philox4x32_R``
    and cuRAND's ``curand_Philox4x32_10``."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _check_dropout(rate: float, seed: Optional[int]) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if rate > 0.0 and (seed is None or not 0 <= int(seed) < 2 ** 64):
        raise ValueError(f"dropout needs an integer seed in [0, 2**64), got {seed!r}")


def keep_threshold(rate: float) -> int:
    """The uint32 threshold of the keep rule: keep iff bits >= it."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def dropout_keep_mask(seed: int, b: int, h: int, l: int, s: int, rate: float,
                      device=None) -> torch.Tensor:
    """The kernels' (B, H, L, S) boolean keep mask, in plain tensor ops.

    Element (b, h, i, j) takes word ``j % 4`` of Philox4x32-10 at counter
    ``(j // 4, i, h, b)`` under key ``(seed mod 2**32, seed >> 32)``."""
    _check_dropout(rate, seed)
    seed = int(seed)
    groups = -(-s // 4)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    c0 = ar(groups)[None, None, None, :]
    c1 = ar(l)[None, None, :, None]
    c2 = ar(h)[None, :, None, None]
    c3 = ar(b)[:, None, None, None]
    shape = (b, h, l, groups)
    words = philox4x32_10([c.expand(shape) for c in (c0, c1, c2, c3)],
                          (seed & _MASK32, seed >> 32))
    bits = torch.stack(words, dim=-1).reshape(b, h, l, 4 * groups)[..., :s]
    return bits >= keep_threshold(rate)


def _inv_keep(rate: float) -> float:
    """1/(1-rate) as the fp32 value both the kernels and the plain versions
    multiply by."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


def fused_attention_small_plain(
    q: torch.Tensor,                       # (B, L, H, D)
    k: torch.Tensor,                       # (B, S, H, D)
    v: torch.Tensor,                       # (B, S, H, D)
    key_bias: Optional[torch.Tensor],      # (B, S) additive, or None
    scale: float,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
) -> torch.Tensor:
    """K1's function in plain PyTorch (also the einsum path of
    ``dot_product_attention``), differentiable by autograd. Dropout, when
    asked for, is post-softmax, scaled by 1/(1-rate) in fp32 before the
    rounding to v's type, with the kernels' bits."""
    _check_dropout(dropout_rate, dropout_seed)
    s = torch.einsum("blhd,bshd->bhls", q.float(), k.float()) * scale
    if key_bias is not None:
        s = s + key_bias[:, None, None, :].float()
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        b, h, l, n = p.shape
        keep = dropout_keep_mask(dropout_seed, b, h, l, n, dropout_rate, p.device)
        p = torch.where(keep, p * _inv_keep(dropout_rate), torch.zeros_like(p))
    out = torch.einsum("bhls,bshd->blhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def fused_attention_small_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_bias: Optional[torch.Tensor],
    g: torch.Tensor,                       # (B, L, H, D), d loss / d out
    scale: float,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's function in plain PyTorch, with the JAX kernel's rounding
    points (``fused_attention.py:124-165``): pd is rounded to g's type and
    d(logits) to q's type before their products. Returns dq, dk, dv in the
    inputs' types and dbias (B, S) in fp32 (zero-bias gradient when
    ``key_bias`` is None)."""
    _check_dropout(dropout_rate, dropout_seed)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    s = torch.einsum("blhd,bshd->bhls", qf, kf) * scale
    if key_bias is not None:
        s = s + key_bias[:, None, None, :].float()
    p = torch.softmax(s, dim=-1)                              # pre-dropout
    dpd = torch.einsum("blhd,bshd->bhls", gf, vf)
    if dropout_rate > 0.0:
        b, h, l, n = p.shape
        keep = dropout_keep_mask(dropout_seed, b, h, l, n, dropout_rate, p.device)
        inv, zero = _inv_keep(dropout_rate), torch.zeros_like(p)
        pd = torch.where(keep, p * inv, zero)
        dp = torch.where(keep, dpd * inv, zero)
    else:
        pd, dp = p, dpd
    dv = torch.einsum("bhls,blhd->bshd", pd.to(g.dtype).float(), gf)
    dlog = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dlog_c = dlog.to(q.dtype).float()
    dq = torch.einsum("bhls,bshd->blhd", dlog_c, kf) * scale
    dk = torch.einsum("bhls,blhd->bshd", dlog_c, qf) * scale
    dbias = torch.sum(dlog, dim=(1, 2))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def _check(q, k, v, key_bias):
    b, l, h, d = q.shape
    s = k.shape[1]
    if k.shape != (b, s, h, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if l > MAX_SEQ or s > MAX_SEQ or d > MAX_DIM:
        raise ValueError(f"fused_attention_small takes L, S <= {MAX_SEQ} and "
                         f"D <= {MAX_DIM}; got L={l}, S={s}, D={d}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"fused_attention_small takes float32 or bfloat16 "
                        f"q, k, v of one type; got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(3) != 1 or t.stride(2) != d:
            raise ValueError(
                f"{name} needs head stride {d} and element stride 1, got "
                f"strides {t.stride()}; any batch and row stride is fine")
    if key_bias is not None and (key_bias.shape != (b, s)
                                 or key_bias.device != q.device):
        raise ValueError(f"key_bias must be ({b}, {s}) on {q.device}, got "
                         f"{tuple(key_bias.shape)} on {key_bias.device}")


_fns = {}


def _kernel(name: str):
    """The C entry point of kernel ``name``, built and loaded at first use."""
    if name not in _fns:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        u32, u64 = ctypes.c_uint32, ctypes.c_uint64
        if name == "fused_attention_fwd":
            fn = build.load(name).d2r_fused_attention_fwd
            fn.argtypes = [i, p, p, p, p, p, i, i, i, i, i,
                           ll, ll, ll, ll, ll, ll, f, u32, f, u64, i, p]
        else:
            fn = build.load(name).d2r_fused_attention_bwd
            fn.argtypes = [i, p, p, p, p, p, p, p, p, p, i, i, i, i, i,
                           ll, ll, ll, ll, ll, ll, ll, ll, f, u32, f, u64, i, p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _dropout_args(rate: float, seed: Optional[int]):
    if rate > 0.0:
        return keep_threshold(rate), _inv_keep(rate), int(seed), 1
    return 0, 1.0, 0, 0


def _launch_fwd(q, k, v, bias, scale, rate, seed) -> torch.Tensor:
    _check(q, k, v, bias)
    b, l, h, d = q.shape
    s = k.shape[1]
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    fn = _kernel("fused_attention_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 b, l, s, h, d, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), float(scale), *_dropout_args(rate, seed),
                 stream)
    if err != 0:
        raise RuntimeError(f"fused_attention_fwd launch failed: cudaError {err}")
    fused_attention_small.launches += 1
    fused_attention_small.flops += 4 * b * h * l * s * d
    return out


def fused_attention_small_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_bias: Optional[torch.Tensor],
    g: torch.Tensor,
    scale: float,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    need_dbias: bool = True,
):
    """K2: (dq, dk, dv, dbias) of the fused attention. The CUDA kernel on a
    CUDA tensor (dbias only when ``need_dbias``, else None), the plain
    version on a CPU tensor. dq, dk and dv come back contiguous in the
    inputs' type, dbias (B, S) in fp32."""
    _check_dropout(dropout_rate, dropout_seed)
    if q.device.type == "cpu":
        out = fused_attention_small_bwd_plain(q, k, v, key_bias, g, scale,
                                              dropout_rate, dropout_seed)
        return out if need_dbias else out[:3] + (None,)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_small_bwd: no kernel for device {q.device}")
    _check(q, k, v, key_bias)
    if g.dtype != q.dtype:
        raise TypeError(f"g must be of q's type {q.dtype}, got {g.dtype}")
    if g.shape != q.shape or g.device != q.device:
        raise ValueError(f"g must match q: got {tuple(g.shape)} on {g.device}, "
                         f"q {tuple(q.shape)} on {q.device}")
    b, l, h, d = q.shape
    s = k.shape[1]
    if g.stride(3) != 1 or g.stride(2) != d:
        g = g.contiguous()
        fused_attention_small_bwd.g_copies += 1
    bias = None if key_bias is None else key_bias.to(torch.float32).contiguous()
    dq = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    dbias = (torch.zeros((b, s), dtype=torch.float32, device=q.device)
             if need_dbias else None)
    fn = _kernel("fused_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if bias is None else bias.data_ptr(), g.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 None if dbias is None else dbias.data_ptr(),
                 b, l, s, h, d, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), g.stride(0), g.stride(1), float(scale),
                 *_dropout_args(dropout_rate, dropout_seed), stream)
    if err != 0:
        raise RuntimeError(f"fused_attention_bwd launch failed: cudaError {err}")
    fused_attention_small_bwd.launches += 1
    fused_attention_small_bwd.flops += 8 * b * h * l * s * d
    return dq, dk, dv, dbias


# launches of the K2 kernel since the count was last set to 0, and copies of
# a g whose head or element stride the kernel cannot read; ``flops``: the
# backward's four products (dv, dp, dq, dk; the recompute of p left out, as
# autograd of the plain version has none) over those launches, which
# torch.utils.flop_counter cannot see (``cli --dry_run`` adds them)
fused_attention_small_bwd.launches = 0
fused_attention_small_bwd.flops = 0
fused_attention_small_bwd.g_copies = 0


class FusedAttention(torch.autograd.Function):
    """K1 forward, K2 backward. Saves (q, k, v, bias) and the seed, as the
    JAX custom VJP saves its residuals (``fused_attention.py:284-286``), and
    no (B, H, L, S) tensor. On the CPU both directions run the plain
    versions."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, rate, seed):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale, ctx.rate, ctx.seed = scale, rate, seed
        if q.device.type == "cpu":
            return fused_attention_small_plain(q, k, v, bias, scale, rate, seed)
        return _launch_fwd(q, k, v, bias, scale, rate, seed)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        need_dbias = ctx.needs_input_grad[3]
        dq, dk, dv, dbias = fused_attention_small_bwd(
            q, k, v, bias, g, ctx.scale, ctx.rate, ctx.seed, need_dbias=need_dbias)
        return dq, dk, dv, dbias, None, None, None


def fused_attention_small(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_bias: Optional[torch.Tensor],
    scale: float,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
) -> torch.Tensor:
    """Differentiable fused attention over (B, L, H, D): K1 forward and K2
    backward on a CUDA tensor, the plain versions on a CPU tensor. Returns
    a contiguous (B, L, H, D) in q's type."""
    _check_dropout(dropout_rate, dropout_seed)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_attention_small: no kernel for device {q.device}")
    bias = None if key_bias is None else key_bias.to(torch.float32).contiguous()
    return FusedAttention.apply(q, k, v, bias, float(scale), dropout_rate, dropout_seed)


# host calls that launched the K1 kernel since the count was last set to 0:
# a call under CUDA graph capture counts once (it records the kernel), and a
# replay of the graph counts not at all; ``flops``: the two products' FLOPs
# of those launches, which torch.utils.flop_counter cannot see
fused_attention_small.launches = 0
fused_attention_small.flops = 0


def supports_fused_small(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Shape gate: the kernels take L, S <= 128 and D <= 128."""
    return q.shape[1] <= MAX_SEQ and k.shape[1] <= MAX_SEQ and q.shape[-1] <= MAX_DIM
