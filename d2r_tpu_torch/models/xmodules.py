"""Cross-modal modules shared by the routing cells (counterpart of
``d2r_tpu/models/xmodules.py``): the 100x-temperature cross-modal attention,
the SGRAF attention-filtration pool, and BLOCK bilinear fusion as one
stacked einsum."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from d2r_tpu_torch.models.layers import TorchBatchNorm, TorchLinear
from d2r_tpu_torch.ops.losses import ccr_contrastive_loss
from d2r_tpu_torch.ops.norms import l1norm, l2norm, torch_style_normalize


class CrossModalAlignment(nn.Module):
    """Near-hard cross-modal attention: Q from text, K/V from image,
    ``softmax(temperature * q.k^T / sqrt(d))`` in fp32. Returns ``(rep,
    loss)``. At ``alpha != 0`` (with ``with_projections``) the loss is the
    CCR term of ``d2r_tpu/models/xmodules.py:57-72``: a reverse-attention
    stream ``softmax(temperature * (1 - attn))``, the two streams projected
    by ``fc_1``/``fc_2`` and held by :func:`ccr_contrastive_loss` against
    the text, all normalised; those two projections exist only then, as in
    the JAX module. At ``alpha == 0`` the loss is exactly 0 and nothing of
    it is computed."""

    def __init__(self, hidden_size: int, temperature: float = 100.0,
                 dtype: torch.dtype = torch.float32, alpha: float = 0.0,
                 margin: float = 0.1, with_projections: bool = True):
        super().__init__()
        self.hidden_size = hidden_size
        self.temperature = temperature
        self.alpha, self.margin = alpha, margin
        self.query = TorchLinear(hidden_size, hidden_size, dtype=dtype)
        self.key = TorchLinear(hidden_size, hidden_size, dtype=dtype)
        self.value = TorchLinear(hidden_size, hidden_size, dtype=dtype)
        self.with_loss = alpha != 0.0 and with_projections
        # the alpha == 0 loss, one tensor for every call (no launch a call)
        self.register_buffer("zero_loss", torch.zeros(()), persistent=False)
        if self.with_loss:
            self.fc_1 = TorchLinear(hidden_size, hidden_size, dtype=dtype)
            self.fc_2 = TorchLinear(hidden_size, hidden_size, dtype=dtype)

    def forward(self, text_emb: torch.Tensor, image_emb: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        q = self.query(text_emb)                                 # (B, L, D)
        k = self.key(image_emb)                                  # (B, S, D)
        v = self.value(image_emb)                                # (B, S, D)
        scores = torch.matmul(q, k.transpose(1, 2)).float() / math.sqrt(self.hidden_size)
        attn = torch.softmax(self.temperature * scores, dim=-1)
        rep = torch.matmul(attn.to(q.dtype), v)
        if not self.with_loss:
            return rep, self.zero_loss
        reverse_attn = torch.softmax(self.temperature * (1.0 - attn), dim=-1)
        reverse_rep = torch.matmul(reverse_attn.to(q.dtype), v)
        views = torch.stack([self.fc_1(rep), self.fc_2(reverse_rep)], dim=-2)  # (B, L, 2, D)
        loss = ccr_contrastive_loss(torch_style_normalize(views),
                                    torch_style_normalize(text_emb[:, :, None, :]),
                                    alpha=self.alpha, beta=0.0, margin=self.margin)
        return rep, loss


class AttentionFiltration(nn.Module):
    """SGRAF SAF pool: sigmoid(BN(Linear(sim_emb))) -> L1-normalised weights
    -> weighted sum -> L2 norm. In train mode the BatchNorm takes the batch
    statistics of the ``row_valid`` rows and updates its running ones."""

    def __init__(self, sim_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.attn_sim_w_kernel = nn.Parameter(torch.empty(sim_dim, 1))
        self.attn_sim_w_bias = nn.Parameter(torch.empty(1))
        self.bn = TorchBatchNorm(1, dtype=dtype)

    def init_params(self, gen: torch.Generator) -> None:
        r = math.sqrt(6.0) / math.sqrt(self.attn_sim_w_kernel.shape[0] + 1)
        self.attn_sim_w_kernel.data.uniform_(-r, r, generator=gen)
        self.attn_sim_w_bias.data.zero_()

    def forward(self, sim_emb: torch.Tensor,
                row_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, L+1, D) -> (B, D)."""
        scores = (torch.matmul(sim_emb.to(self.dtype), self.attn_sim_w_kernel.to(self.dtype))
                  + self.attn_sim_w_bias.to(self.dtype))         # (B, L+1, 1)
        scores = self.bn(scores, row_valid)
        weights = l1norm(torch.sigmoid(scores[..., 0]), dim=-1)  # (B, L+1)
        pooled = torch.einsum("bl,bld->bd", weights.float(), sim_emb.float())
        return l2norm(pooled.to(self.dtype), dim=-1)


class BlockFusion(nn.Module):
    """MUTAN/BLOCK bilinear pooling with the 20 per-chunk Linears stacked
    into one (chunks, size, size*rank) weight."""

    def __init__(self, input_dim: int, output_dim: int, mm_dim: int = 1600,
                 chunks: int = 20, rank: int = 15, dtype: torch.dtype = torch.float32):
        super().__init__()
        if mm_dim % chunks:
            raise ValueError("mm_dim must divide evenly into chunks")
        self.dtype = dtype
        self.mm_dim, self.chunks, self.rank = mm_dim, chunks, rank
        size = mm_dim // chunks
        self.linear0 = TorchLinear(input_dim, mm_dim, dtype=dtype)
        self.linear1 = TorchLinear(input_dim, mm_dim, dtype=dtype)
        self.merge_kernel0 = nn.Parameter(torch.empty(chunks, size, size * rank))
        self.merge_bias0 = nn.Parameter(torch.empty(chunks, size * rank))
        self.merge_kernel1 = nn.Parameter(torch.empty(chunks, size, size * rank))
        self.merge_bias1 = nn.Parameter(torch.empty(chunks, size * rank))
        self.linear_out = TorchLinear(mm_dim, output_dim, dtype=dtype)

    def init_params(self, gen: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.mm_dim // self.chunks)
        for p in (self.merge_kernel0, self.merge_bias0,
                  self.merge_kernel1, self.merge_bias1):
            p.data.uniform_(-bound, bound, generator=gen)

    def forward(self, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        b = x0.shape[0]
        size = self.mm_dim // self.chunks
        dt = self.dtype
        h0 = self.linear0(x0).view(b, self.chunks, size)
        h1 = self.linear1(x1).view(b, self.chunks, size)
        m0 = torch.einsum("bcs,csr->bcr", h0, self.merge_kernel0.to(dt)) + self.merge_bias0.to(dt)
        m1 = torch.einsum("bcs,csr->bcr", h1, self.merge_kernel1.to(dt)) + self.merge_bias1.to(dt)
        z = (m0 * m1).view(b, self.chunks, self.rank, size).sum(dim=2)
        z = torch.sqrt(torch.relu(z)) - torch.sqrt(torch.relu(-z))  # signed sqrt
        z = torch_style_normalize(z, dim=-1).reshape(b, self.mm_dim)
        return self.linear_out(z)
