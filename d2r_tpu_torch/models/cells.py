"""The six routing cells and the CMRC Refinement op (counterpart of
``d2r_tpu/models/cells.py``). Each cell owns a Router and returns
``(emb, path_prob)``: emb (B, L, D), path_prob (B, num_out_path).

Stream order within a routing layer is load-bearing (stream 0 feeds the skip
gate): ``CELL_NAMES``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from d2r_tpu_torch.config import D2RConfig
from d2r_tpu_torch.models.layers import BertPooler, QKVDense, TorchLinear
from d2r_tpu_torch.models.router import Router
from d2r_tpu_torch.models.xmodules import AttentionFiltration, CrossModalAlignment
from d2r_tpu_torch.ops.attention import dot_product_attention, merge_heads, split_heads
from d2r_tpu_torch.ops.norms import l2norm

CellOut = Tuple[torch.Tensor, torch.Tensor]

CELL_NAMES = ("ric", "glac", "imrc", "cmrc", "crcmc", "gesc")


def _router(cfg: D2RConfig, num_out_path: int, dtype) -> Router:
    return Router(cfg.embed_size, num_out_path, cfg.hid_router, dtype)


def _cma(cfg: D2RConfig, dtype) -> CrossModalAlignment:
    """The alignment of GLAC and CRCMC, with the config's CCR ``alpha``."""
    return CrossModalAlignment(cfg.embed_size, cfg.cma_temperature, dtype,
                               alpha=cfg.alpha, margin=cfg.margin)


def _linear(cfg: D2RConfig, dtype) -> TorchLinear:
    return TorchLinear(cfg.embed_size, cfg.embed_size, dtype=dtype)


class RectifiedIdentityCell(nn.Module):
    """ReLU pass-through."""

    def __init__(self, cfg: D2RConfig, num_out_path: int, dtype=torch.float32):
        super().__init__()
        self.router = _router(cfg, num_out_path, dtype)

    def forward(self, x: torch.Tensor) -> CellOut:
        return torch.relu(x), self.router(x)


class IntraModelReasoningCell(nn.Module):
    """Residual multi-head self-attention (no output projection, no
    LayerNorm) then a residual ReLU FFN. Its attention is one of the model's
    kernel sites: H = num_head_IMRC, D = embed_size / H."""

    def __init__(self, cfg: D2RConfig, num_out_path: int, dtype=torch.float32):
        super().__init__()
        d = cfg.embed_size
        self.num_heads = cfg.num_head_IMRC
        self.router = _router(cfg, num_out_path, dtype)
        self.sa_qkv = QKVDense(d, d, dtype)
        self.ffn_fc1 = TorchLinear(d, cfg.hid_IMRC, dtype=dtype)
        self.ffn_fc2 = TorchLinear(cfg.hid_IMRC, d, dtype=dtype)

    def forward(self, x: torch.Tensor) -> CellOut:
        path_prob = self.router(x)
        h = self.num_heads
        q, k, v = self.sa_qkv(x)
        ctx = dot_product_attention(split_heads(q, h), split_heads(k, h),
                                    split_heads(v, h),
                                    scale=(x.shape[-1] // h) ** -0.5)
        self_att = x + merge_heads(ctx)
        f = self.ffn_fc2(torch.relu(self.ffn_fc1(self_att)))
        return self_att + f, path_prob


class GlobalLocalAlignmentCell(nn.Module):
    """SGRAF-style global + local similarity filtration."""

    def __init__(self, cfg: D2RConfig, num_out_path: int, dtype=torch.float32):
        super().__init__()
        d = cfg.embed_size
        self.router = _router(cfg, num_out_path, dtype)
        self.cma = _cma(cfg, dtype)
        self.fc_sim_tranloc = _linear(cfg, dtype)
        self.fc_1 = _linear(cfg, dtype)
        self.text_cls_pool = BertPooler(d, dtype)
        self.image_cls_pool = BertPooler(d, dtype)
        self.fc_sim_tranglo = _linear(cfg, dtype)
        self.fc_2 = _linear(cfg, dtype)
        self.saf = AttentionFiltration(d, dtype)

    def forward(self, text: torch.Tensor, image: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> CellOut:
        path_prob = self.router(text)
        text_aware_image, _ = self.cma(text, image)     # the CCR loss is discarded
        sim_local = torch.square(text - text_aware_image)
        sim_local = self.fc_1(l2norm(self.fc_sim_tranloc(sim_local), dim=-1))
        sim_global = torch.square(self.text_cls_pool(text) - self.image_cls_pool(image))
        sim_global = self.fc_2(l2norm(self.fc_sim_tranglo(sim_global), dim=-1))
        sim_emb = torch.cat([sim_global[:, None, :], sim_local], dim=1)
        sim_emb = self.saf(sim_emb, valid)                        # (B, D)
        return sim_emb[:, None, :].expand(-1, text.shape[1], -1), path_prob


class Refinement(nn.Module):
    """FiLM-style cross-modal modulation."""

    def __init__(self, cfg: D2RConfig, dtype=torch.float32):
        super().__init__()
        # its own alignment: no CCR loss and no fc_1/fc_2, whatever alpha
        # (d2r_tpu/models/cells.py:136-139)
        self.cma = CrossModalAlignment(cfg.embed_size, cfg.cma_temperature, dtype,
                                       with_projections=False)
        self.fc_scale = _linear(cfg, dtype)
        self.fc_shift = _linear(cfg, dtype)
        self.fc_1 = _linear(cfg, dtype)
        self.fc_2 = _linear(cfg, dtype)

    def forward(self, text: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
        wei_context, _ = self.cma(text, image)
        scaling = torch.tanh(self.fc_scale(wei_context))
        shifting = self.fc_shift(wei_context)
        modu = self.fc_1(text * scaling + shifting)
        return self.fc_2(torch.relu(modu)) + text


class CrossModalRefinementCell(nn.Module):
    def __init__(self, cfg: D2RConfig, num_out_path: int, dtype=torch.float32):
        super().__init__()
        self.router = _router(cfg, num_out_path, dtype)
        self.refine = Refinement(cfg, dtype)

    def forward(self, text: torch.Tensor, image: torch.Tensor) -> CellOut:
        return self.refine(text, image), self.router(text)


class ContextRichCrossModalCell(nn.Module):
    """Two-round cross-modal attention; the second score product is NOT
    scaled before its softmax."""

    def __init__(self, cfg: D2RConfig, num_out_path: int, dtype=torch.float32):
        super().__init__()
        self.router = _router(cfg, num_out_path, dtype)
        self.cma = _cma(cfg, dtype)
        self.fc_mlp_1 = _linear(cfg, dtype)
        self.fc_mlp_2 = _linear(cfg, dtype)
        self.fc_1 = _linear(cfg, dtype)
        self.fc_2 = _linear(cfg, dtype)

    def forward(self, text: torch.Tensor, image: torch.Tensor) -> CellOut:
        path_prob = self.router(text)
        text_aware_image, _ = self.cma(text, image)     # the CCR loss is discarded
        q_state = torch.tanh(self.fc_mlp_1(text_aware_image))
        k_state = torch.tanh(self.fc_mlp_2(text))
        q = self.fc_1(q_state)
        k = self.fc_2(k_state)
        scores = torch.softmax(torch.matmul(q, k.transpose(1, 2)).float(), dim=-1)
        return q_state + torch.matmul(scores.to(q.dtype), k_state), path_prob


class GlobalEnhancedSemanticCell(nn.Module):
    """Gated global fusion; the gate is a softmax over the FEATURE axis."""

    def __init__(self, cfg: D2RConfig, num_out_path: int, dtype=torch.float32):
        super().__init__()
        self.router = _router(cfg, num_out_path, dtype)
        self.text_cls_pool = BertPooler(cfg.embed_size, dtype)
        self.image_cls_pool = BertPooler(cfg.embed_size, dtype)
        self.fc_mlp_0 = _linear(cfg, dtype)
        self.fc_mlp_2 = _linear(cfg, dtype)

    def forward(self, text: torch.Tensor, image: torch.Tensor) -> CellOut:
        path_prob = self.router(text)
        text_cls = self.text_cls_pool(text)
        image_cls = self.image_cls_pool(image)
        h = self.fc_mlp_2(torch.tanh(self.fc_mlp_0(text_cls + image_cls)))
        gate = torch.softmax(h, dim=-1)
        gate_out = gate * text_cls + (1.0 - gate) * image_cls
        return gate_out[:, None, :].expand(-1, text.shape[1], -1), path_prob
