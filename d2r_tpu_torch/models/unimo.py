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

Under a data axis (``parallel/mesh.py``) a forward takes this rank's rows
of the global batch and returns its rows' logits, while the losses are the
global batch's: the CLS rows and the ``valid`` mask are gathered over the
data group for the JS loss's Gram matrices (the path signatures in
``InteractionModule``), and the cross-entropy's sum and count are summed
over it. The model is built whole; ``parallel.mesh.shard_model`` cuts it
for a mesh, never the config alone.

``cfg.pipeline_stages`` runs the towers as pipelines (``models/pipeline.py``)
and ``cfg.seq_shard`` cuts their blocks' activations along the sequence
under a model axis (``models/bert.py``). ``cfg.fabric_shard`` under a model
axis (JAX ``d2r_tpu/models/unimo.py:111-127`` with
``d2r_tpu/parallel/mesh.py:210-239``): the routing fabric of a data row
runs on ``1/tp`` of its rows on each model rank, the fabric's modules
whole there (``shard_model`` leaves them unsplit), and its two streams are
gathered back over the model group. While it runs, what spans the batch
is taken over the fabric group (data x model): the SAF BatchNorm
statistics, the ``int8_all`` dW scales and the path signatures of the JS
loss's Gram matrices. A batch whose rows the model axis does not divide
runs the fabric whole, as JAX's constraint is then a no-op.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from d2r_tpu_torch.config import D2RConfig, resolve_device, serving_config
from d2r_tpu_torch.models.bert import BertEmbeddings, BertEncoder, BertLayer
from d2r_tpu_torch.models.graph import GraphConvolution
from d2r_tpu_torch.models.interaction import InteractionModule
from d2r_tpu_torch.models.layers import (
    BertPooler,
    DropoutRNG,
    LayerNorm,
    TorchLinear,
    _Parallel,
    init_weights,
)
from d2r_tpu_torch.models.vit import CLIPEncoderLayer, CLIPVisionEmbeddings, CLIPVisionEncoder
from d2r_tpu_torch.models.xmodules import BlockFusion
from d2r_tpu_torch.ops.attention import padding_key_bias
from d2r_tpu_torch.ops.losses import cross_entropy_loss, path_consistency_loss
from d2r_tpu_torch.ops.qdot import set_quant_mode
from d2r_tpu_torch.parallel.distributed import gather_rows, scatter_rows


class D2RModel(_Parallel, nn.Module):
    def __init__(self, cfg: D2RConfig):
        super().__init__()
        # built whole, in one process: ``shard_model`` checks the settings
        # against the world it cuts for
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
        layout = (cfg.pipeline_stages, cfg.pipeline_microbatches, cfg.seq_shard)
        self.encoder_vision_layers = CLIPVisionEncoder(vc, dt, cfg.remat, ffn, *layout)
        self.encoder_text_layers = BertEncoder(tc, dt, cfg.remat, ffn, *layout)
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

        text_stream, sim_paths, vision_stream, rev_sim_paths = self._fabric(
            text_out, vision_out, valid)

        group = self._data_group()
        text_cls = gather_rows(text_cls.float(), group)
        vision_cls = gather_rows(vision_cls.float(), group)
        if group is not None and valid is not None:
            valid = gather_rows(valid.to(torch.float32), group)
        js_loss = path_consistency_loss(
            sim_paths, text_cls @ text_cls.T, rev_sim_paths, vision_cls @ vision_cls.T,
            c.weight_js_1, c.weight_js_2, valid=valid)

        fused = self.block_fusion(self.text_pool(text_stream),
                                  self.vision_pool(vision_stream))
        return fused, js_loss

    def _fabric_group(self, rows: int):
        """The fabric group when ``fabric_shard`` spreads this batch's
        ``rows`` over the model ranks, else None."""
        mesh = self.mesh
        if (not self.cfg.fabric_shard or mesh is None or mesh.tp == 1
                or rows % mesh.tp):
            return None
        return mesh.fabric_group

    def _fabric(self, text_out, vision_out, valid):
        """Both routing branches: on this model rank's rows under
        ``fabric_shard`` (the streams gathered back), else on all."""
        fabric = self._fabric_group(text_out.shape[0])
        if fabric is None:
            text_stream, sim_paths = self.itr_module(text_out, vision_out, valid)
            vision_stream, rev = self.Reversed_itr_module(text_out, vision_out, valid)
            return text_stream, sim_paths, vision_stream, rev
        model_group = self.mesh.model_group
        text, vision = scatter_rows(text_out, model_group), scatter_rows(vision_out, model_group)
        rows = None
        if valid is not None:
            n = valid.shape[0] // self.mesh.tp
            rows = valid[self.mesh.model_index * n:(self.mesh.model_index + 1) * n]
        modules = [m for branch in (self.itr_module, self.Reversed_itr_module)
                   for m in branch.modules() if isinstance(m, _Parallel)]
        for m in modules:
            m.rows_group = fabric
        try:
            text_stream, sim_paths = self.itr_module(text, vision, rows)
            vision_stream, rev = self.Reversed_itr_module(text, vision, rows)
        finally:
            for m in modules:
                m.rows_group = None
        return (gather_rows(text_stream, model_group), sim_paths,
                gather_rows(vision_stream, model_group), rev)


class D2RClassifier(_Parallel, nn.Module):
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
        ce = cross_entropy_loss(logits, labels, valid, self._data_group())
        return ce + js_loss, logits, {"ce_loss": ce, "js_loss": js_loss}


def unpipelined(model: nn.Module) -> nn.Module:
    """``model`` (holding every block) with its towers run as one stack, in
    place, and its config's pipeline fields reset (``serving_config``):
    the same parameters and eval-forward math, any batch size."""
    for m in model.modules():
        if isinstance(m, (BertEncoder, CLIPVisionEncoder)):
            if any(not hasattr(m, f"layer_{i}") for i in range(m.num_layers)):
                raise ValueError("a stage rank's cut of the towers cannot run unpipelined")
            m.stages, m.microbatches = 1, 1
        if isinstance(getattr(m, "cfg", None), D2RConfig):
            m.cfg = serving_config(m.cfg)
    return model


def build_model(cfg: D2RConfig, device="cuda", seed: int = 0) -> D2RClassifier:
    """A ``D2RClassifier`` with random weights from ``torch.Generator`` seeded
    with ``seed`` (made on the CPU, so the same on every machine), in eval
    mode on ``device``, parameters in fp32. Raises if ``device`` is CUDA and
    no GPU is present."""
    dev = resolve_device(device)
    model = D2RClassifier(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.eval().to(dev)
