"""SenticNet GCN refinement (counterpart of ``d2r_tpu/models/graph.py``),
applied to the text tower's output when ``use_sentic_graph`` is on and an
adjacency (``data/sentic.py``) is passed.

The reference's GraphConvolution: ``out = adj @ (x W) / (rowsum(adj) + 1)
+ b``, the bias added after the degree normalisation. The types are the
JAX package's: the adjacency is cast to the compute type, the product is
taken in fp32 and cast back, and the division by the fp32 degree promotes
(as ``jnp`` promotes bf16 / fp32), so under bf16 the output is fp32.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from d2r_tpu_torch.models.layers import TorchLinear, _param


class GraphConvolution(nn.Module):
    """``weight`` (a bias-free ``TorchLinear``) and ``bias``, the Flax
    module's names."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = TorchLinear(in_features, features, dtype=dtype, use_bias=False)
        self.bias = _param(features)

    def init_params(self, gen: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.weight.shape[1])
        self.bias.data.uniform_(-bound, bound, generator=gen)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        """x (B, L, D), adj (B, L, L)."""
        hidden = self.weight(x)
        denom = torch.sum(adj, dim=2, keepdim=True) + 1.0
        prod = torch.matmul(adj.to(self.dtype).float(), hidden.float()).to(self.dtype)
        return prod / denom + self.bias.to(self.dtype)
