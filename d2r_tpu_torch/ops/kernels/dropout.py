"""Hidden dropout from a seed in device memory: the CUDA kernel
``csrc/dropout.cu``, its plain PyTorch version, and the
``torch.autograd.Function`` that runs it both ways.

Element e of the flattened tensor is kept iff word ``e % 4`` of
Philox4x32-10 at counter ``((e // 4) mod 2**32, (e // 4) >> 32, 0, 0)``,
under the site's key (``fused_attention.site_key`` of the step's seed
buffer and the site's ordinal), is >= the keep threshold of K1's rule;
kept elements are multiplied by 1/(1-rate) in fp32 and rounded to the
input's type. The function is linear in x with its mask fixed by the seed,
so the backward is the same function of the gradient: the mask is drawn
again, not stored, and a remat recompute draws it from the site alone.

A ``layout`` ``(seg, stride, offset)`` makes the tensor a slice of a
larger one, the step's whole tensor, of which a process of a mesh holds
some batch rows (a data rank) and, under ``seq_shard``, a sequence slice:
its element e draws the bits of element ``(e // seg) * stride + offset + e
% seg`` of the whole, so the slices' masks are the whole tensor's mask cut
the same way (``models/layers.py::slice_layout``). ``seg``, ``stride`` and
``offset`` must be multiples of 4, which keeps each group of four elements
on one Philox call.

It replaces no TPU kernel (the JAX package draws the mask with
``jax.random`` inside its jitted step); the port needs it because a
captured train step must draw new masks at each replay from a seed buffer
the host rewrites, which a ``torch.Generator`` inside a graph cannot do
together with remat's recompute. On a CUDA tensor :func:`hidden_dropout`
launches the kernel or raises; on a CPU tensor it runs the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from d2r_tpu_torch.ops.kernels import build
from d2r_tpu_torch.ops.kernels.fused_attention import (
    DropoutSeed,
    _check_dropout,
    _inv_keep,
    dropout_key,
    dropout_launch_args,
    keep_threshold,
    philox4x32_10,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_layout(n: int, layout):
    """``layout`` as (seg, stride, offset): the default is the tensor itself."""
    if layout is None:
        return max(n, 1), max(n, 1), 0
    seg, stride, offset = (int(v) for v in layout)
    if seg % 4 or stride % 4 or offset % 4 or seg < 1 or n % seg or seg > stride or offset < 0:
        raise ValueError(f"dropout layout {layout} of {n} elements: seg, stride and offset "
                         f"must be multiples of 4 with seg dividing n, seg <= stride and "
                         f"offset >= 0")
    return seg, stride, offset


def hidden_keep_mask(seed: DropoutSeed, n: int, rate: float, device=None,
                     layout=None) -> torch.Tensor:
    """The kernel's (n,) boolean keep mask of a flat tensor (a slice of a
    larger one under ``layout``), in plain tensor ops."""
    _check_dropout(rate, seed)
    seg, stride, offset = _check_layout(n, layout)
    key = dropout_key(seed)
    e0 = torch.arange(-(-n // 4), dtype=torch.int64, device=device) * 4
    q = ((e0 // seg) * stride + offset + e0 % seg) // 4
    zero = torch.zeros_like(q)
    words = philox4x32_10((q & 0xFFFFFFFF, q >> 32, zero, zero),
                          (key & 0xFFFFFFFF, key >> 32))
    return (torch.stack(words, dim=-1).reshape(-1)[:n]) >= keep_threshold(rate)


def hidden_dropout_plain(x: torch.Tensor, rate: float, seed: DropoutSeed,
                         layout=None) -> torch.Tensor:
    """The kernel's function in plain PyTorch."""
    keep = hidden_keep_mask(seed, x.numel(), rate, x.device, layout).reshape(x.shape)
    kept = (x.float() * _inv_keep(rate)).to(x.dtype)
    return torch.where(keep, kept, torch.zeros_like(x))


_fn = []


def _kernel():
    if not _fn:
        fn = build.load("dropout").d2r_dropout
        p, u32 = ctypes.c_void_p, ctypes.c_uint32
        ll = ctypes.c_longlong
        fn.argtypes = [ctypes.c_int, p, p, ll, ll, ll, ll, u32, ctypes.c_float, p, u32, p]
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]


def _launch(x: torch.Tensor, rate: float, seed: DropoutSeed, layout=None) -> torch.Tensor:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"hidden_dropout takes float32 or bfloat16, got {x.dtype}")
    x = x.contiguous()
    y = torch.empty_like(x)
    seg, stride, offset = _check_layout(x.numel(), layout)
    threshold, inv_keep, seed_ptr, site, *_ = dropout_launch_args(rate, seed, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(_DTYPE_CODES[x.dtype], x.data_ptr(), y.data_ptr(), x.numel(),
                        seg, stride, offset, threshold, inv_keep, seed_ptr, site, stream)
    if err != 0:
        raise RuntimeError(f"dropout launch failed: cudaError {err}")
    hidden_dropout.launches += 1
    return y


def _apply(x: torch.Tensor, rate: float, seed: DropoutSeed, layout=None) -> torch.Tensor:
    if x.device.type == "cpu":
        return hidden_dropout_plain(x, rate, seed, layout)
    if x.device.type != "cuda":
        raise ValueError(f"hidden_dropout: no kernel for device {x.device}")
    return _launch(x, rate, seed, layout)


class _HiddenDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rate, seed, layout):
        ctx.rate, ctx.seed, ctx.layout = rate, seed, layout
        return _apply(x, rate, seed, layout)

    @staticmethod
    def backward(ctx, g):
        return _apply(g, ctx.rate, ctx.seed, ctx.layout), None, None, None


def hidden_dropout(x: torch.Tensor, rate: float, seed: DropoutSeed,
                   layout=None) -> torch.Tensor:
    """Differentiable dropout of ``x`` at ``rate`` with the mask of
    ``seed``: the kernel on a CUDA tensor (forward and backward), the plain
    version on a CPU tensor; ``layout`` as in the module docstring. Empty
    tensors pass through."""
    _check_dropout(rate, seed)
    if not isinstance(seed, DropoutSeed):
        raise ValueError(f"hidden_dropout draws from a DropoutSeed, got {seed!r}")
    if rate == 0.0 or x.numel() == 0:
        return x
    return _HiddenDropout.apply(x, rate, seed, layout)


# host calls that launched the kernel since the count was last set to 0
# (forward and backward); a launch under CUDA graph capture counts once,
# a replay not at all
hidden_dropout.launches = 0
