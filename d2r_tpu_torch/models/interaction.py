"""Dynamic-routing fusion fabric (counterpart of
``d2r_tpu/models/interaction.py``).

Routing is soft: every cell runs, and each output stream is a gate-weighted
sum of the six cell outputs. The reference's quirks are kept:

* the skip gate compares the RAW (unnormalised) gate sums with the threshold
  1e-4;
* the final (num_out_path == 1) layer does not normalise the gates over
  cells; it divides by sum(skip gates) + sum(raw gates);
* the path signature joins the NORMALISED layer-0 and middle gates with the
  RAW final-layer gates: 6^2 * (DR_step - 1) + 6 values a sample;
* sim_paths = paths @ paths^T is a Gram matrix over the whole batch: under
  a data axis the path signatures of every data rank are gathered first.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from d2r_tpu_torch.config import D2RConfig
from d2r_tpu_torch.models.cells import (
    ContextRichCrossModalCell,
    CrossModalRefinementCell,
    GlobalEnhancedSemanticCell,
    GlobalLocalAlignmentCell,
    IntraModelReasoningCell,
    RectifiedIdentityCell,
)
from d2r_tpu_torch.models.layers import _Parallel
from d2r_tpu_torch.parallel.distributed import gather_rows

NUM_CELLS = 6


class DynamicRoutingLayer(nn.Module):
    """One routing layer: run the six cells, mix their outputs by the gates.

    ``streams=None`` marks layer 0, where every cell reads ``primary``;
    otherwise cell j reads stream j of the previous layer. ``context`` is the
    other modality's tower output at every depth.
    """

    def __init__(self, cfg: D2RConfig, num_out_path: int, dtype=torch.float32):
        super().__init__()
        self.num_out_path = num_out_path
        self.threshold = cfg.routing_threshold
        self.ric = RectifiedIdentityCell(cfg, num_out_path, dtype)
        self.glac = GlobalLocalAlignmentCell(cfg, num_out_path, dtype)
        self.imrc = IntraModelReasoningCell(cfg, num_out_path, dtype)
        self.cmrc = CrossModalRefinementCell(cfg, num_out_path, dtype)
        self.crcmc = ContextRichCrossModalCell(cfg, num_out_path, dtype)
        self.gesc = GlobalEnhancedSemanticCell(cfg, num_out_path, dtype)

    def forward(self, streams: Optional[torch.Tensor], primary: Optional[torch.Tensor],
                context: torch.Tensor, valid: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        eps = 1e-8
        inputs = [primary] * NUM_CELLS if streams is None else list(streams)
        outs = [
            self.ric(inputs[0]),
            self.glac(inputs[1], context, valid),
            self.imrc(inputs[2]),
            self.cmrc(inputs[3], context),
            self.crcmc(inputs[4], context),
            self.gesc(inputs[5], context),
        ]
        embs = torch.stack([e for e, _ in outs])                 # (6, B, L, D)
        raw = torch.stack([p for _, p in outs], dim=2)           # (B, O, 6)

        if self.num_out_path == 1:
            probs = raw[:, 0, :]                                 # (B, 6)
            gates = (probs < self.threshold / NUM_CELLS).to(probs.dtype)
            refs = torch.stack(inputs)                           # (6, B, L, D)
            mixed = torch.einsum("bj,jbld->bld", probs.float(), embs.float())
            skip = torch.einsum("bj,jbld->bld", gates.float(), refs.float())
            denom = (gates.sum(dim=-1) + probs.sum(dim=-1)).float()
            out = ((mixed + skip) / denom[:, None, None]).to(embs.dtype)
            return out[None], raw                                # (1,B,L,D), (B,1,6)

        gate_mask = (raw.sum(dim=-1) < self.threshold).to(raw.dtype)      # (B, O)
        norm = raw / (raw.sum(dim=-1, keepdim=True) + eps)                # (B, O, 6)
        mixed = torch.einsum("bij,jbld->ibld", norm.float(), embs.float())
        skip = torch.einsum("bi,bld->ibld", gate_mask.float(), embs[0].float())
        return (mixed + skip).to(embs.dtype), norm


class InteractionModule(_Parallel, nn.Module):
    """Routing pipeline of one branch. ``reversed_mode=False``: text is
    primary and image the context; ``True``: the other way round. ``valid``
    (B,) reaches every GLAC cell's train-mode BatchNorm. Returns the fused
    stream (B, L, D) and the (B, B) path-similarity Gram (global B under a
    data axis)."""

    def __init__(self, cfg: D2RConfig, reversed_mode: bool = False, dtype=torch.float32):
        super().__init__()
        if cfg.DR_step < 3:
            raise ValueError("DR_step must be >= 3 (the reference needs one middle layer)")
        self.reversed_mode = reversed_mode
        self.num_mid = cfg.DR_step - 2
        self.dynamic_itr_l0 = DynamicRoutingLayer(cfg, NUM_CELLS, dtype)
        for i in range(self.num_mid):
            self.add_module(f"dynamic_itr_l1_{i}", DynamicRoutingLayer(cfg, NUM_CELLS, dtype))
        self.dynamic_itr_l2 = DynamicRoutingLayer(cfg, 1, dtype)

    def forward(self, text: torch.Tensor, image: torch.Tensor,
                valid: Optional[torch.Tensor] = None):
        primary, context = (image, text) if self.reversed_mode else (text, image)
        batch = primary.shape[0]
        streams, paths_l0 = self.dynamic_itr_l0(None, primary, context, valid)
        pieces = [paths_l0.reshape(batch, -1)]
        for i in range(self.num_mid):
            streams, p = getattr(self, f"dynamic_itr_l1_{i}")(streams, None, context, valid)
            pieces.append(p.reshape(batch, -1))
        final_streams, paths_l2 = self.dynamic_itr_l2(streams, None, context, valid)
        pieces.append(paths_l2.reshape(batch, -1))
        paths = gather_rows(torch.cat(pieces, dim=-1).float(), self._data_group())
        return final_streams[0], torch.matmul(paths, paths.T)
