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

This is plain PyTorch. In the JAX package XLA fuses the multiply into the
consuming product, so only the int8 bytes are read; here each forward
materialises the dequantized weight in the compute type before its
product, so the weight bytes a forward reads do not shrink.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from d2r_tpu_torch.models.layers import QKVDense, TorchLinear
from d2r_tpu_torch.models.vit import PatchConv


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
    """Mixin of a quantized module: ``weight`` is computed from the buffers
    ``weight_q`` (int8) and ``weight_scale`` (fp32), which broadcast
    against each other in the shape ``_qgroups``, in the module's compute
    type."""

    @property
    def weight(self) -> torch.Tensor:
        q = self.weight_q.view(self._qgroups).to(self.dtype)
        return (q * self.weight_scale.to(self.dtype)).view(self.weight_q.shape)


class Int8TorchLinear(Int8Weight, TorchLinear):
    pass


class Int8QKVDense(Int8Weight, QKVDense):
    pass


class Int8PatchConv(Int8Weight, PatchConv):
    pass


_INT8 = {TorchLinear: Int8TorchLinear, QKVDense: Int8QKVDense, PatchConv: Int8PatchConv}


def _quantize_module(m: nn.Module) -> None:
    w = m.weight.detach()
    if isinstance(m, QKVDense):
        # (3h, in) rows are [q | k | v]: group as (h, 3, in) for the scale
        groups = (3, m.hidden, w.shape[1])
        q, scale = quantize_array(w.view(groups).transpose(0, 1))
        q, scale = q.transpose(0, 1), scale.view(1, m.hidden, 1)
    else:
        groups = tuple(w.shape)
        q, scale = quantize_array(w)
    del m.weight
    m.register_buffer("weight_q", q.reshape(w.shape).contiguous())
    m.register_buffer("weight_scale", scale.contiguous())
    m._qgroups = groups
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
