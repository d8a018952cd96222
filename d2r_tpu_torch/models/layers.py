"""Shared building blocks (counterpart of ``d2r_tpu/models/layers.py``).

Every module takes the compute ``dtype`` and casts its input and weights to
it at use, as the JAX modules do (parameters stay fp32, in training too);
LayerNorm and BatchNorm compute in fp32 and return the compute type.
``nn.Module.training`` plays the part of the JAX modules' ``deterministic=
False, use_running_average=False``: dropout runs and BatchNorm uses and
updates batch statistics. Dropout draws only from the :class:`DropoutRNG`
the caller passes down. Weights are stored torch-style
(``weight`` is (out, in)); ``d2r_tpu_torch/weights.py`` translates the Flax
layouts. Parameters are created empty: :func:`init_weights` fills them from
an explicit ``torch.Generator``, in the JAX package's init families.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as BERT uses."""
    return F.gelu(x, approximate="none")


ACT2FN = {
    "gelu": gelu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "quick_gelu": quick_gelu,
    "relu": torch.relu,
    "tanh": torch.tanh,
}


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape))


class TorchLinear(nn.Module):
    """Dense layer with torch.nn.Linear's init: weight and bias uniform in
    +-1/sqrt(in); ``bias_init_value`` fixes the bias instead (the Router's
    1.5)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32,
                 bias_init_value: Optional[float] = None):
        super().__init__()
        self.dtype = dtype
        self.bias_init_value = bias_init_value
        self.weight = _param(out_features, in_features)
        self.bias = _param(out_features)

    def init_params(self, gen: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        self.weight.data.uniform_(-bound, bound, generator=gen)
        if self.bias_init_value is None:
            self.bias.data.uniform_(-bound, bound, generator=gen)
        else:
            self.bias.data.fill_(self.bias_init_value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class QKVDense(nn.Module):
    """Fused q/k/v projection: one (in -> 3*hidden) product. q, k and v come
    back as views of the (..., 3, hidden) result, with a row stride of
    3*hidden, which the attention kernel reads as they are."""

    def __init__(self, in_features: int, hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.hidden = hidden
        self.weight = _param(3 * hidden, in_features)
        self.bias = _param(3 * hidden)

    def init_params(self, gen: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        self.weight.data.uniform_(-bound, bound, generator=gen)
        self.bias.data.uniform_(-bound, bound, generator=gen)

    def forward(self, x: torch.Tensor):
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                     self.bias.to(self.dtype))
        y = y.view(*y.shape[:-1], 3, self.hidden)
        return y[..., 0, :], y[..., 1, :], y[..., 2, :]


class BertPooler(nn.Module):
    """Token 0 -> Linear -> tanh."""

    def __init__(self, hidden_size: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense = TorchLinear(hidden_size, hidden_size, dtype=dtype)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(hidden_states[:, 0]))


class LayerNorm(nn.Module):
    """LayerNorm computed in fp32 (Flax's LayerNorm promotes bf16 input to
    fp32 for its statistics), returned in the compute type."""

    def __init__(self, features: int, eps: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = _param(features)
        self.bias = _param(features)

    def init_params(self, gen: torch.Generator) -> None:
        self.weight.data.fill_(1.0)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.dtype)


class Embed(nn.Module):
    """Lookup table returning the compute type."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = _param(num_embeddings, features)

    def init_params(self, gen: torch.Generator) -> None:
        self.weight.data.normal_(0.0, 1.0 / math.sqrt(self.weight.shape[1]),
                                 generator=gen)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids.long(), self.weight).to(self.dtype)


class DropoutRNG:
    """The randomness of one training forward, passed down explicitly (the
    global RNG is never read). ``host`` is a CPU generator: its draws are
    the attention kernels' dropout seeds, host ints that cost no device
    sync. ``device`` is a generator on the model's device, seeded from the
    first draw, for the hidden dropout masks."""

    def __init__(self, seed: int, device):
        self.host = torch.Generator().manual_seed(int(seed))
        self.device = torch.Generator(device=device).manual_seed(self.next_seed())

    def next_seed(self) -> int:
        """A fresh 63-bit seed from the host generator."""
        return int(torch.randint(0, 2 ** 63 - 1, (1,), generator=self.host))


class Dropout(nn.Module):
    """Inverted dropout, as Flax's ``nn.Dropout``: in train mode an element
    is kept with probability 1 - rate and scaled by 1/(1-rate), with the
    mask drawn from ``rng.device``; the identity in eval mode or at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, rng: Optional[DropoutRNG]) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if rng is None:
            raise ValueError("train-mode dropout needs a DropoutRNG")
        keep = torch.rand(x.shape, generator=rng.device, device=x.device) >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


def attention_dropout(module: nn.Module, rate: float,
                      rng: Optional[DropoutRNG]) -> Tuple[float, Optional[int]]:
    """(rate, seed) for ``dot_product_attention``: a fresh seed from ``rng``
    in train mode at a non-zero rate, else no dropout."""
    if not module.training or rate == 0.0:
        return 0.0, None
    if rng is None:
        raise ValueError("train-mode attention dropout needs a DropoutRNG")
    return rate, rng.next_seed()


class TorchBatchNorm(nn.Module):
    """torch.nn.BatchNorm1d over the last axis, statistics in fp32.

    Eval mode normalises with the running statistics. Train mode normalises
    with the biased batch statistics over every leading axis and updates the
    running ones in place with momentum 0.1 and the UNBIASED variance.
    ``row_valid`` (B,) restricts the batch statistics to the valid rows
    (a wrap-padded final batch), as ``d2r_tpu/models/layers.py:140-206``."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32, momentum: float = 0.1):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.momentum = momentum
        self.weight = _param(num_features)
        self.bias = _param(num_features)
        self.register_buffer("running_mean", torch.empty(num_features))
        self.register_buffer("running_var", torch.empty(num_features))

    def init_params(self, gen: torch.Generator) -> None:
        self.weight.data.fill_(1.0)
        self.bias.data.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor,
                row_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        x32 = x.float()
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            axes = tuple(range(x.ndim - 1))
            if row_valid is not None:
                w = row_valid.to(torch.float32).reshape((x.shape[0],) + (1,) * (x.ndim - 1))
                count = torch.sum(w) * math.prod(x.shape[1:-1])
                mean = torch.sum(x32 * w, dim=axes) / count
                var = torch.sum(w * torch.square(x32 - mean), dim=axes) / count
                unbiased_n = count / torch.clamp(count - 1.0, min=1.0)
            else:
                mean = torch.mean(x32, dim=axes)
                var = torch.mean(torch.square(x32 - mean), dim=axes)
                n = math.prod(x.shape[:-1])
                unbiased_n = n / max(n - 1, 1)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
                self.running_var.copy_((1 - m) * self.running_var + m * (var * unbiased_n))
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight + self.bias
        return y.to(self.dtype)


@torch.no_grad()
def init_weights(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Fill every parameter and buffer of ``model`` from ``gen``, module by
    module in registration order; the same generator state gives the same
    weights on any machine. Weights are made on the CPU, so build the model
    there and move it afterwards."""
    for m in model.modules():
        if hasattr(m, "init_params"):
            m.init_params(gen)
    return model
