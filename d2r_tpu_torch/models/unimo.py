"""The full D2R network (counterpart of ``d2r_tpu/models/unimo.py``): the two
towers, one extra self-attention layer per branch, dynamic routing in both
directions, BLOCK fusion and the ``fc`` head, with CE plus the
negative-signed JS loss.

``model.train()`` is the JAX package's ``deterministic=False,
use_running_average=False``: dropout runs, drawing from the
:class:`~d2r_tpu_torch.models.layers.DropoutRNG` passed as ``rng``, and the
SAF BatchNorms use and update batch statistics over the ``valid`` rows.
``model.eval()`` is ``deterministic=True, use_running_average=True``.

Both routing branches consume the RAW tower outputs, not the self-attended
ones; the self-attended ones only feed the CLS Gram matrices of the JS loss.

With ``use_sentic_graph`` the text tower's output is refined by the
SenticNet GCN, ``text_out + relu(gcn(text_out, sentic_adj))``, before
anything reads it; as in the JAX package the step runs only when an
adjacency is passed, so a forward without one (the serving entry points
pass none) skips it. ``cfg.quant_train`` sets the quantized-training mode
of every ``TorchLinear`` and ``QKVDense`` of the model, the head included
(``ops/qdot.py``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from d2r_tpu_torch.config import D2RConfig, resolve_device
from d2r_tpu_torch.models.bert import BertEmbeddings, BertEncoder, BertLayer
from d2r_tpu_torch.models.graph import GraphConvolution
from d2r_tpu_torch.models.interaction import InteractionModule
from d2r_tpu_torch.models.layers import (
    BertPooler,
    DropoutRNG,
    LayerNorm,
    TorchLinear,
    init_weights,
)
from d2r_tpu_torch.models.vit import CLIPEncoderLayer, CLIPVisionEmbeddings, CLIPVisionEncoder
from d2r_tpu_torch.models.xmodules import BlockFusion
from d2r_tpu_torch.ops.attention import padding_key_bias
from d2r_tpu_torch.ops.losses import cross_entropy_loss, path_consistency_loss
from d2r_tpu_torch.ops.qdot import set_quant_mode


class D2RModel(nn.Module):
    def __init__(self, cfg: D2RConfig):
        super().__init__()
        cfg.check_supported()
        self.cfg = cfg
        dt = cfg.dtype
        tc, vc = cfg.text_config(), cfg.vision_config()
        self.vision_embeddings = CLIPVisionEmbeddings(vc, dt)
        self.vision_pre_layernorm = LayerNorm(vc.hidden_size, vc.layer_norm_eps, dt)
        self.text_embeddings = BertEmbeddings(tc, dt)
        # remat: the tower stacks only; remat_ffn_act: every BERT and CLIP
        # block, as the JAX step's policy reaches every tagged activation
        ffn = cfg.remat_ffn_act
        self.encoder_vision_layers = CLIPVisionEncoder(vc, dt, cfg.remat, ffn)
        self.encoder_text_layers = BertEncoder(tc, dt, cfg.remat, ffn)
        self.sentic_gcn = (GraphConvolution(tc.hidden_size, tc.hidden_size, dt)
                           if cfg.use_sentic_graph else None)
        self.self_text = BertLayer(tc, dt, ffn)
        self.text_cls_pool = BertPooler(tc.hidden_size, dt)
        self.self_vision = CLIPEncoderLayer(vc, dt, ffn)
        self.vision_cls_pool = BertPooler(vc.hidden_size, dt)
        self.itr_module = InteractionModule(cfg, reversed_mode=False, dtype=dt)
        self.Reversed_itr_module = InteractionModule(cfg, reversed_mode=True, dtype=dt)
        # both poolers use the TEXT width, the vision-side one included
        self.text_pool = BertPooler(tc.hidden_size, dt)
        self.vision_pool = BertPooler(tc.hidden_size, dt)
        self.block_fusion = BlockFusion(tc.hidden_size, tc.hidden_size, dtype=dt)
        set_quant_mode(self, cfg.quant_train)

    def forward(self, input_ids, attention_mask, token_type_ids, pixel_values,
                valid: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None,
                sentic_adj: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        c = self.cfg
        vision_emb = self.vision_pre_layernorm(self.vision_embeddings(pixel_values))
        key_bias = padding_key_bias(attention_mask)
        text_emb = self.text_embeddings(input_ids, token_type_ids, rng,
                                        attention_mask=attention_mask)

        vision_out = self.encoder_vision_layers(vision_emb, rng)
        text_out = self.encoder_text_layers(text_emb, key_bias, rng)
        if self.sentic_gcn is not None and sentic_adj is not None:
            text_out = text_out + torch.relu(self.sentic_gcn(text_out, sentic_adj))

        text_cls = self.text_cls_pool(self.self_text(text_out, key_bias, rng))
        vision_cls = self.vision_cls_pool(self.self_vision(vision_out, rng))

        text_stream, sim_paths = self.itr_module(text_out, vision_out, valid)
        vision_stream, rev_sim_paths = self.Reversed_itr_module(text_out, vision_out, valid)

        text_cls, vision_cls = text_cls.float(), vision_cls.float()
        js_loss = path_consistency_loss(
            sim_paths, text_cls @ text_cls.T, rev_sim_paths, vision_cls @ vision_cls.T,
            c.weight_js_1, c.weight_js_2, valid=valid)

        fused = self.block_fusion(self.text_pool(text_stream),
                                  self.vision_pool(vision_stream))
        return fused, js_loss


class D2RClassifier(nn.Module):
    """D2RModel plus the task head and CE loss. Returns
    ``(loss, logits, {"ce_loss", "js_loss"})``. ``valid`` (B,) masks
    wrap-padded rows out of the losses and the BatchNorm statistics; ``rng``
    feeds dropout in train mode; ``sentic_adj`` (B, L, L) feeds the SenticNet
    GCN of a ``use_sentic_graph`` model."""

    def __init__(self, cfg: D2RConfig):
        super().__init__()
        self.cfg = cfg
        self.model = D2RModel(cfg)
        tc = cfg.text_config()
        self.fc = TorchLinear(tc.hidden_size, cfg.num_classes, dtype=cfg.dtype)
        set_quant_mode(self.fc, cfg.quant_train)

    def forward(self, input_ids, attention_mask, token_type_ids, labels,
                pixel_values, valid: Optional[torch.Tensor] = None,
                rng: Optional[DropoutRNG] = None,
                sentic_adj: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
        pooled, js_loss = self.model(input_ids, attention_mask, token_type_ids,
                                     pixel_values, valid, rng, sentic_adj)
        logits = self.fc(pooled)
        ce = cross_entropy_loss(logits, labels, valid)
        return ce + js_loss, logits, {"ce_loss": ce, "js_loss": js_loss}


def build_model(cfg: D2RConfig, device="cuda", seed: int = 0) -> D2RClassifier:
    """A ``D2RClassifier`` with random weights from ``torch.Generator`` seeded
    with ``seed`` (made on the CPU, so the same on every machine), in eval
    mode on ``device``, parameters in fp32. Raises if ``device`` is CUDA and
    no GPU is present."""
    dev = resolve_device(device)
    model = D2RClassifier(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.eval().to(dev)
