"""Long-context attention: K3, the CUDA kernel ``csrc/flash_attention_fwd.cu``,
its plain PyTorch version, and the ``torch.autograd.Function`` that joins
them to the plain twin its backward differentiates.

K3 replaces ``d2r_tpu/ops/kernels/flash_attention.py::_attention_kernel``:
online-softmax attention over key tiles with an additive (B, S) fp32 key
bias and no dropout, for any L and S and D <= 256. Its rounding points are
the JAX kernel's, not K1's: q is scaled in fp32 before q.k^T (:48) and the
probabilities stay fp32 into p.V (:65); the output is cast once.

Its backward is not a kernel in the JAX package either: the custom VJP
recomputes through the XLA twin ``_xla_attention`` under ``jax.vjp``
(:155-182). :class:`FlashAttention` does the same under autograd, on the
CPU and on the card, through ``fused_attention_small_plain`` at rate 0: the
einsum path of the dispatch, which computes what ``_xla_attention`` does
(the scale after the fp32 product, p rounded to the input type before
p.V). It returns no bias gradient.

What bounds K3 on the H100 is bytes in bf16 and operations in fp32 (see the
source's header). In bf16 the kernel runs its products on the tensor cores
(``mma.sync``, fp32 sums) over K and V tiles brought in by ``cp.async``, and
keeps the JAX rounding as closely as bf16 operands allow: the scale is
applied in fp32 to the fp32 sum of the raw bf16 products (the JAX kernel
scales q first: the two differ by fp32 rounding alone), and p enters p.V as
two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), into one fp32
accumulator, within one output ulp of fp32 p. In fp32 it runs on the CUDA
cores, with exactly the rounding above. It reads q, k and v through their
batch and row strides, so the strided views of the fused QKV projection
need no copies.

:func:`flash_attention` launches the kernel for CUDA tensors and raises for
what it cannot take; only a tensor on the CPU goes to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from d2r_tpu_torch.ops.kernels import build
from d2r_tpu_torch.ops.kernels.fused_attention import fused_attention_small_plain

MAX_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(
    q: torch.Tensor,                       # (B, L, H, D)
    k: torch.Tensor,                       # (B, S, H, D)
    v: torch.Tensor,                       # (B, S, H, D)
    key_bias: Optional[torch.Tensor],      # (B, S) additive, or None
    scale: float,
) -> torch.Tensor:
    """K3's function in plain PyTorch: q scaled in fp32 before q.k^T, an
    fp32 softmax, p kept in fp32 for p.V, the output cast once to q's
    type."""
    s = torch.einsum("blhd,bshd->bhls", q.float() * scale, k.float())
    if key_bias is not None:
        s = s + key_bias[:, None, None, :].float()
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhls,bshd->blhd", p, v.float()).to(q.dtype)


def _check(q, k, v, key_bias):
    b, l, h, d = q.shape
    s = k.shape[1]
    if k.shape != (b, s, h, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if min(b, l, s, h, d) < 1 or d > MAX_DIM:
        raise ValueError(f"flash_attention takes D <= {MAX_DIM} and no empty "
                         f"axis; got q {tuple(q.shape)}, k {tuple(k.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v of one "
                        f"type; got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(3) != 1 or t.stride(2) != d:
            raise ValueError(
                f"{name} needs head stride {d} and element stride 1, got "
                f"strides {t.stride()}; any batch and row stride is fine")
    if key_bias is not None and (key_bias.shape != (b, s) or key_bias.device != q.device
                                 or key_bias.dtype != torch.float32
                                 or not key_bias.is_contiguous()):
        raise ValueError(f"key_bias must be a contiguous fp32 ({b}, {s}) on {q.device}, "
                         f"got {key_bias.dtype} {tuple(key_bias.shape)} on "
                         f"{key_bias.device}")


_fn = []


def _kernel():
    """The C entry point of K3, built and loaded at first use."""
    if not _fn:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        fn = build.load("flash_attention_fwd").d2r_flash_attention_fwd
        fn.argtypes = [i, p, p, p, p, p, i, i, i, i, i, ll, ll, ll, ll, ll, ll, f, p]
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]


def _launch(q, k, v, bias, scale) -> torch.Tensor:
    _check(q, k, v, bias)
    b, l, h, d = q.shape
    s = k.shape[1]
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 b, l, s, h, d, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                 v.stride(0), v.stride(1), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {err}")
    flash_attention.launches += 1
    flash_attention.flops += 4 * b * h * l * s * d
    return out


class FlashAttention(torch.autograd.Function):
    """K3 forward on a CUDA tensor (the plain version on a CPU tensor);
    backward by recomputation through the plain twin, as the JAX custom
    VJP (``flash_attention.py:175-179``). Saves (q, k, v, bias) and no
    (B, H, L, S) tensor; no gradient for the bias."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, bias, scale)
        return _launch(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            out = fused_attention_small_plain(*leaves, bias, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, leaves, g)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_bias: Optional[torch.Tensor],
    scale: float,
) -> torch.Tensor:
    """Differentiable long-context attention over (B, L, H, D): K3 forward on
    a CUDA tensor, the plain version on a CPU tensor, the twin's gradient
    backward. Returns a contiguous (B, L, H, D) in q's type."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    bias = None if key_bias is None else key_bias.to(torch.float32).contiguous()
    return FlashAttention.apply(q, k, v, bias, float(scale))


# host calls that launched the K3 kernel since the count was last set to 0:
# a call under CUDA graph capture counts once (it records the kernel), and a
# replay of the graph counts not at all; ``flops``: the two products' FLOPs
# of those launches, which torch.utils.flop_counter cannot see
flash_attention.launches = 0
flash_attention.flops = 0


def supports_flash(q: torch.Tensor) -> bool:
    """Shape gate: the kernel takes any L and S, and D <= 256."""
    return q.shape[-1] <= MAX_DIM
