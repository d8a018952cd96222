"""Weight-only int8 for serving (counterpart of ``d2r_tpu/quant.py``).

Every matrix weight whose Flax leaf is a >=2-D fp32 ``kernel`` (the
weights of ``TorchLinear``, ``QKVDense`` and ``PatchConv``) is stored as
symmetric int8 codes with one fp32 scale per output channel, and
dequantized at use, inside the forward, as ``q.to(dtype) * scale.to(dtype)``
in the compute type: the JAX package's ``QuantLeaf.dequant``. Int8 codes are
exact in bf16, so in bf16 the dequantized weights equal the JAX package's
bit for bit. Embeddings, biases and norms stay as they are.

The scale groups are the JAX package's. Its ``kernel`` leaves put the
output channels last and its scale covers every axis but the last; the
port's weights put them first, so the scale covers every axis but the
first. ``QKVDense``'s Flax kernel is (in, 3, hidden): one scale per hidden
unit, shared by q, k and v.

On the card each quantized module's product is the W8A16 kernel
(``ops/kernels/w8a16.py``): it reads the int8 codes and scales, builds
each weight element in the compute type on chip, bit for bit the value
above, and never writes a dequantized weight, as XLA fuses the dequantize
into the consuming product in the JAX package. The patch conv is that
product over the patch matrix (stride = kernel, so the patches are a
permute of the pixels). On the CPU the product is the plain version: the
dequantized weight, then ``F.linear``.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from d2r_tpu_torch.models.layers import QKVDense, TorchLinear
from d2r_tpu_torch.models.vit import PatchConv
from d2r_tpu_torch.ops.kernels.w8a16 import dequantize, w8a16_linear


def quantize_array(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of ``w`` (output channels on axis
    0): ``scale = max(amax(|w|) / 127, 1e-12)`` over every other axis, codes
    ``clip(rint(w / scale), -127, 127)``. Returns (int8 codes shaped as
    ``w``, fp32 scale shaped (out, 1, ..., 1))."""
    w = w.detach().to(torch.float32)
    axes = tuple(range(1, w.ndim))
    amax = torch.amax(w.abs(), dim=axes, keepdim=True)
    scale = torch.clamp_min(amax / 127.0, 1e-12)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


class Int8Weight:
    """Mixin of a quantized module: the buffers ``weight_q`` (int8, the
    weight's shape) and ``weight_scale`` (fp32, one value a group of output
    channels: ``weight_scale.numel()`` of them, output channel n taking
    value ``n % numel``). ``weight`` is the dequantized weight in the
    module's compute type (the plain path); the module's product is the
    W8A16 one, which never builds it."""

    @property
    def weight(self) -> torch.Tensor:
        return dequantize(self.weight_q, self.weight_scale, self.weight_scale.numel(),
                          self.dtype)

    def _dense(self, x: torch.Tensor, bias) -> torch.Tensor:
        q = self.weight_q.view(self.weight_q.shape[0], -1)
        return w8a16_linear(x, q, self.weight_scale, self.weight_scale.numel(), bias)


class Int8TorchLinear(Int8Weight, TorchLinear):
    pass


class Int8QKVDense(Int8Weight, QKVDense):
    pass


class Int8PatchConv(Int8Weight, PatchConv):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The conv as the W8A16 product over the patch matrix: (B, C, H, W)
        -> (B, out, H / p, W / p), each patch flattened in the weight's
        (C, p, p) order."""
        b, c, hh, ww = x.shape
        p = self.patch
        h, w = hh // p, ww // p
        patches = (x[:, :, :h * p, :w * p].to(self.dtype).reshape(b, c, h, p, w, p)
                   .permute(0, 2, 4, 1, 3, 5).reshape(b * h * w, c * p * p))
        y = self._dense(patches, None)
        return y.view(b, h, w, -1).permute(0, 3, 1, 2)


_INT8 = {TorchLinear: Int8TorchLinear, QKVDense: Int8QKVDense, PatchConv: Int8PatchConv}


def _quantize_module(m: nn.Module) -> None:
    w = m.weight.detach()
    if isinstance(m, QKVDense):
        # (3h, in) rows are [q | k | v]: group as (h, 3, in) for the scale
        q, scale = quantize_array(w.view(3, m.hidden, w.shape[1]).transpose(0, 1))
        q, scale = q.transpose(0, 1), scale.view(1, m.hidden, 1)
    else:
        q, scale = quantize_array(w)
    del m.weight
    m.register_buffer("weight_q", q.reshape(w.shape).contiguous())
    m.register_buffer("weight_scale", scale.contiguous())
    m.__class__ = _INT8[type(m)]


@torch.no_grad()
def quantize_model(model: nn.Module, mode: str = "int8") -> nn.Module:
    """Quantize, in place, the weight of every ``TorchLinear``,
    ``QKVDense`` and ``PatchConv`` (the Flax ``kernel`` leaves that
    ``quantize_params`` selects); returns ``model``."""
    if mode != "int8":
        raise ValueError(f"unknown quantization mode {mode!r}; only 'int8'")
    for m in list(model.modules()):
        if type(m) in _INT8:
            _quantize_module(m)
    return model


def quantized_bytes(model: nn.Module) -> int:
    """Parameter bytes as stored (int8 codes + scales + the other
    parameters), the JAX package's count over its ``params`` tree: the
    BatchNorm running statistics (``batch_stats`` there) are left out."""
    total = sum(p.nbytes for p in model.parameters())
    for m in model.modules():
        if isinstance(m, Int8Weight):
            total += m.weight_q.nbytes + m.weight_scale.nbytes
    return total
