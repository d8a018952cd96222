"""Export the port's model as a torch-reference ``state_dict``: the port's
own copy of the JAX package's ``d2r_tpu/utils/export_torch.py`` key map
(``python -m d2r_tpu_torch.export --format torch``).

The map walks the Flax-layout variable tree that ``weights.to_jax_variables``
gives the port's model (the JAX package's names and layouts), so it needs no
naming scheme of its own, and writes the old PyTorch reference's keys: the
produced dict loads into the reference's ``UnimoModelF`` with
``strict=True``. It equals the JAX package's ``reference_state_dict`` of the
same tree key for key and bit for bit (``tests/test_torch_export.py``).

Key-space facts this module encodes (cited into the reference's sources):

* module attribute names: UnimoModelF {model, fc} (models/unimo_model.py:
  138-147); UnimoModel members incl. the ``vision_pre_layrnorm`` typo
  (models/modeling_unimo.py:741-786); UnimoEncoder ``vision_layers`` /
  ``text_layer`` (modeling_unimo.py:655-657); BertLayer
  attention.self/attention.output/intermediate/output (modeling_unimo.py:
  334-512); CLIPEncoderLayer self_attn.{q,k,v,out}_proj + mlp.fc1/fc2 +
  layer_norm1/2 (modeling_unimo.py:121-268); routing fabric names from
  models/DynamicInteraction.py:28-35,81-88, Cells.py, Router.py:14-16,
  SelfAttention.py:11-53, XModules.py:277-394,478-555, Refinement.py:86-132.
* persistent buffers live in a torch ``state_dict``: the two
  ``position_ids`` (modeling_unimo.py:108,288 — BertEmbeddings'
  ``token_type_ids`` buffer is ``persistent=False`` and is NOT exported,
  modeling_unimo.py:289-291) and every BatchNorm's
  running_mean/running_var/num_batches_tracked.
* dead-but-present parameters the reference constructs and never uses on
  the live path have no counterpart in the model; they are zero-filled
  (values provably never reach the logits): every BertIntermediate's
  ``fusion_dense`` (modeling_unimo.py:447 vs :453-456), UnimoModel's
  ``vision_post_layernorm`` (:743) and ``text_pooler`` (:786),
  InteractionModule's ``path_mapping``/``bn`` (InteractionModule.py:19-20,
  usage commented :50-52), and the CrossModalAlignment ``fc_1``/``fc_2``
  loss heads when the model never created them (alpha=0: they exist only
  when the CCR loss is live; the reference always constructs them,
  XModules.py:287-288, Refinement.py:94-95). LayerNorm/BatchNorm fills use
  the torch *defaults* (weight 1, bias 0, mean 0, var 1) rather than zeros
  so a later torch fine-tune that accidentally re-enables them starts from
  an identity transform, not a degenerate one.

Everything here is numpy; ``save_reference_checkpoint`` writes the file
with ``torch.save`` (loadable by the reference's ``torch.load`` at
modules/train.py:87-90,226-229).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from d2r_tpu_torch.weights import unpipeline_tower_layers, unstack_tower_layers

NUM_CELLS = 6  # hidden constant, ref: modeling_unimo.py:781-782


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


class _Sink:
    """Flat key -> array collector with exact-coverage bookkeeping."""

    def __init__(self):
        self.out: Dict[str, np.ndarray] = {}

    def put(self, key: str, value: np.ndarray) -> None:
        if key in self.out:
            raise ValueError(f"duplicate export key {key!r}")
        self.out[key] = value

    # -- primitive emitters (flax leaf conventions from tests/parity) ----
    def linear(self, key: str, tree: Dict[str, Any]) -> None:
        # flax kernel (in, out) -> torch weight (out, in)
        self.put(f"{key}.weight", _np(tree["kernel"]).T)
        self.put(f"{key}.bias", _np(tree["bias"]))

    def layernorm(self, key: str, tree: Dict[str, Any]) -> None:
        self.put(f"{key}.weight", _np(tree["scale"]))
        self.put(f"{key}.bias", _np(tree["bias"]))

    def embed(self, key: str, tree: Dict[str, Any]) -> None:
        self.put(f"{key}.weight", _np(tree["embedding"]))

    def qkv(self, prefix_q: str, prefix_k: str, prefix_v: str,
            tree: Dict[str, Any]) -> None:
        # fused head-aligned (in, 3, h) kernel / (3, h) bias -> 3 Linears
        kernel = _np(tree["kernel"])
        bias = _np(tree["bias"])
        for i, p in enumerate((prefix_q, prefix_k, prefix_v)):
            self.put(f"{p}.weight", kernel[:, i, :].T)
            self.put(f"{p}.bias", bias[i])

    # -- zero-fills for dead reference parameters -------------------------
    def dead_linear(self, key: str, out_f: int, in_f: int) -> None:
        self.put(f"{key}.weight", np.zeros((out_f, in_f), np.float32))
        self.put(f"{key}.bias", np.zeros((out_f,), np.float32))

    def dead_layernorm(self, key: str, dim: int) -> None:
        self.put(f"{key}.weight", np.ones((dim,), np.float32))
        self.put(f"{key}.bias", np.zeros((dim,), np.float32))

    def batchnorm(self, key: str, params: Dict[str, Any],
                  stats: Dict[str, Any]) -> None:
        self.put(f"{key}.weight", _np(params["scale"]))
        self.put(f"{key}.bias", _np(params["bias"]))
        self.put(f"{key}.running_mean", _np(stats["mean"]))
        self.put(f"{key}.running_var", _np(stats["var"]))
        self.put(f"{key}.num_batches_tracked", np.asarray(0, np.int64))

    def dead_batchnorm(self, key: str, dim: int) -> None:
        self.put(f"{key}.weight", np.ones((dim,), np.float32))
        self.put(f"{key}.bias", np.zeros((dim,), np.float32))
        self.put(f"{key}.running_mean", np.zeros((dim,), np.float32))
        self.put(f"{key}.running_var", np.ones((dim,), np.float32))
        self.put(f"{key}.num_batches_tracked", np.asarray(0, np.int64))


def _router(s: _Sink, key: str, tree: Dict[str, Any]) -> None:
    # ref: models/Router.py:14-16 (nn.Sequential indices 0 and 2)
    s.linear(f"{key}.mlp.0", tree["mlp_0"])
    s.linear(f"{key}.mlp.2", tree["mlp_2"])


def _pooler(s: _Sink, key: str, tree: Dict[str, Any]) -> None:
    s.linear(f"{key}.dense", tree["dense"])


def _cma(s: _Sink, key: str, tree: Dict[str, Any], hidden: int) -> None:
    """CrossModalAlignment (both the XModules and the Refinement-private
    flavor carry query/key/value + fc_1/fc_2; ref XModules.py:282-288,
    Refinement.py:90-95). fc_1/fc_2 feed only the discarded CCR loss — our
    module instantiates them only when alpha != 0, so zero-fill otherwise."""
    s.linear(f"{key}.query", tree["query"])
    s.linear(f"{key}.key", tree["key"])
    s.linear(f"{key}.value", tree["value"])
    for fc in ("fc_1", "fc_2"):
        if fc in tree:
            s.linear(f"{key}.{fc}", tree[fc])
        else:
            s.dead_linear(f"{key}.{fc}", hidden, hidden)


def _saf(s: _Sink, key: str, params: Dict[str, Any],
         stats: Dict[str, Any]) -> None:
    # AttentionFiltration, ref: XModules.py:366-394
    s.put(f"{key}.attn_sim_w.weight", _np(params["attn_sim_w_kernel"]).T)
    s.put(f"{key}.attn_sim_w.bias", _np(params["attn_sim_w_bias"]))
    s.batchnorm(f"{key}.bn", params["bn"], stats["bn"])


def _routing_layer(s: _Sink, key: str, params: Dict[str, Any],
                   stats: Dict[str, Any], hidden: int) -> None:
    """One DynamicInteraction layer: the 6 cells (ref:
    DynamicInteraction.py:28-35; cell internals Cells.py:30-255)."""
    # ric
    _router(s, f"{key}.ric.router", params["ric"]["router"])
    # imrc (SelfAttention block, ref: SelfAttention.py:11-70)
    imrc = params["imrc"]
    _router(s, f"{key}.imrc.router", imrc["router"])
    s.qkv(f"{key}.imrc.sa.att_layer.linears.0",
          f"{key}.imrc.sa.att_layer.linears.1",
          f"{key}.imrc.sa.att_layer.linears.2", imrc["sa_qkv"])
    s.linear(f"{key}.imrc.sa.feed_forward_layer.fc1", imrc["ffn_fc1"])
    s.linear(f"{key}.imrc.sa.feed_forward_layer.fc2", imrc["ffn_fc2"])
    # glac (ref: Cells.py:131-175)
    glac = params["glac"]
    _router(s, f"{key}.glac.router", glac["router"])
    _cma(s, f"{key}.glac.CrossModalAlignment", glac["cma"], hidden)
    s.linear(f"{key}.glac.fc_sim_tranloc", glac["fc_sim_tranloc"])
    s.linear(f"{key}.glac.fc_sim_tranglo", glac["fc_sim_tranglo"])
    s.linear(f"{key}.glac.fc_1", glac["fc_1"])
    s.linear(f"{key}.glac.fc_2", glac["fc_2"])
    _pooler(s, f"{key}.glac.text_cls_pool", glac["text_cls_pool"])
    _pooler(s, f"{key}.glac.image_cls_pool", glac["image_cls_pool"])
    _saf(s, f"{key}.glac.SAF_module", glac["saf"], stats["glac"]["saf"])
    # cmrc (ref: Cells.py:76-87 + Refinement.py:120-154)
    cmrc = params["cmrc"]
    _router(s, f"{key}.cmrc.router", cmrc["router"])
    refine = cmrc["refine"]
    s.linear(f"{key}.cmrc.refine.fc_scale", refine["fc_scale"])
    s.linear(f"{key}.cmrc.refine.fc_shift", refine["fc_shift"])
    s.linear(f"{key}.cmrc.refine.fc_1", refine["fc_1"])
    s.linear(f"{key}.cmrc.refine.fc_2", refine["fc_2"])
    _cma(s, f"{key}.cmrc.refine.CrossModalAlignment", refine["cma"], hidden)
    # crcmc (ref: Cells.py:222-255)
    crcmc = params["crcmc"]
    _router(s, f"{key}.crcmc.router", crcmc["router"])
    _cma(s, f"{key}.crcmc.CrossModalAlignment", crcmc["cma"], hidden)
    s.linear(f"{key}.crcmc.fc_mlp_1.0", crcmc["fc_mlp_1"])
    s.linear(f"{key}.crcmc.fc_mlp_2.0", crcmc["fc_mlp_2"])
    s.linear(f"{key}.crcmc.fc_1", crcmc["fc_1"])
    s.linear(f"{key}.crcmc.fc_2", crcmc["fc_2"])
    # gesc (ref: Cells.py:179-218)
    gesc = params["gesc"]
    _router(s, f"{key}.gesc.router", gesc["router"])
    _pooler(s, f"{key}.gesc.text_cls_pool", gesc["text_cls_pool"])
    _pooler(s, f"{key}.gesc.image_cls_pool", gesc["image_cls_pool"])
    s.linear(f"{key}.gesc.fc_mlp.0", gesc["fc_mlp_0"])
    s.linear(f"{key}.gesc.fc_mlp.2", gesc["fc_mlp_2"])


def _interaction_module(s: _Sink, key: str, params: Dict[str, Any],
                        stats: Dict[str, Any], hidden: int) -> None:
    _routing_layer(s, f"{key}.dynamic_itr_l0", params["dynamic_itr_l0"],
                   stats["dynamic_itr_l0"], hidden)
    mids = sorted((k for k in params if k.startswith("dynamic_itr_l1_")),
                  key=lambda k: int(k.rsplit("_", 1)[1]))
    for name in mids:
        i = int(name.rsplit("_", 1)[1])
        _routing_layer(s, f"{key}.dynamic_itr_l1.{i}", params[name],
                       stats[name], hidden)
    _routing_layer(s, f"{key}.dynamic_itr_l2", params["dynamic_itr_l2"],
                   stats["dynamic_itr_l2"], hidden)
    # dead members, ref: InteractionModule.py:18-20 (usage commented :50-52)
    dr_step = len(mids) + 2
    total_paths = NUM_CELLS ** 2 * (dr_step - 1) + NUM_CELLS
    path_hid = 128  # hidden constant, ref: modeling_unimo.py:781-782
    s.dead_linear(f"{key}.path_mapping", path_hid, total_paths)
    s.dead_batchnorm(f"{key}.bn", hidden)


def _bert_layer(s: _Sink, key: str, tree: Dict[str, Any],
                hidden: int, intermediate: int) -> None:
    # post-LN BERT block, ref: modeling_unimo.py:334-512
    s.qkv(f"{key}.attention.self.query", f"{key}.attention.self.key",
          f"{key}.attention.self.value", tree["attention_self"]["qkv"])
    s.linear(f"{key}.attention.output.dense",
             tree["attention_output"]["dense"])
    s.layernorm(f"{key}.attention.output.LayerNorm",
                tree["attention_output"]["LayerNorm"])
    s.linear(f"{key}.intermediate.dense", tree["intermediate_dense"])
    # trained-but-unused, ref: modeling_unimo.py:447 vs :453-456
    s.dead_linear(f"{key}.intermediate.fusion_dense", intermediate, hidden)
    s.linear(f"{key}.output.dense", tree["output_dense"])
    s.layernorm(f"{key}.output.LayerNorm", tree["output_LayerNorm"])


def _clip_layer(s: _Sink, key: str, tree: Dict[str, Any]) -> None:
    # pre-LN ViT block, ref: modeling_unimo.py:121-268
    s.layernorm(f"{key}.layer_norm1", tree["layer_norm1"])
    attn = tree["self_attn"]
    s.qkv(f"{key}.self_attn.q_proj", f"{key}.self_attn.k_proj",
          f"{key}.self_attn.v_proj", attn["qkv"])
    s.linear(f"{key}.self_attn.out_proj", attn["out_proj"])
    s.layernorm(f"{key}.layer_norm2", tree["layer_norm2"])
    s.linear(f"{key}.mlp.fc1", tree["mlp_fc1"])
    s.linear(f"{key}.mlp.fc2", tree["mlp_fc2"])


def _block_fusion(s: _Sink, key: str, tree: Dict[str, Any]) -> None:
    # MUTAN/BLOCK bilinear fusion, ref: XModules.py:478-555
    s.linear(f"{key}.linear0", tree["linear0"])
    s.linear(f"{key}.linear1", tree["linear1"])
    k0, b0 = _np(tree["merge_kernel0"]), _np(tree["merge_bias0"])
    k1, b1 = _np(tree["merge_kernel1"]), _np(tree["merge_bias1"])
    for i in range(k0.shape[0]):
        s.put(f"{key}.merge_linears0.{i}.weight", k0[i].T)
        s.put(f"{key}.merge_linears0.{i}.bias", b0[i])
        s.put(f"{key}.merge_linears1.{i}.weight", k1[i].T)
        s.put(f"{key}.merge_linears1.{i}.bias", b1[i])
    s.linear(f"{key}.linear_out", tree["linear_out"])


def _canonical_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Undo the scan_layers and pipeline relayouts so the tower layers are
    back at the per-layer {'layer_i': ...} naming the exporter walks."""
    return unstack_tower_layers(unpipeline_tower_layers(params))


def reference_state_dict(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A Flax-layout variable tree ({'params', 'batch_stats'}, as
    ``weights.to_jax_variables`` gives the port's model) -> a flat numpy
    dict keyed exactly like ``UnimoModelF().state_dict()`` of the reference
    (loadable with ``strict=True``)."""
    params = _canonical_params(variables["params"])
    stats = variables.get("batch_stats") or {}
    model_p, model_s = params["model"], stats.get("model", {})
    s = _Sink()

    hidden = int(_np(model_p["text_embeddings"]["LayerNorm"]["scale"]).shape[0])
    intermediate = int(
        _np(model_p["encoder_text_layers"]["layer_0"]["intermediate_dense"]
            ["bias"]).shape[0])

    # --- embeddings (ref: modeling_unimo.py:87-118,272-331) -------------
    emb = model_p["text_embeddings"]
    s.embed("model.text_embeddings.word_embeddings", emb["word_embeddings"])
    s.embed("model.text_embeddings.position_embeddings",
            emb["position_embeddings"])
    s.embed("model.text_embeddings.token_type_embeddings",
            emb["token_type_embeddings"])
    s.layernorm("model.text_embeddings.LayerNorm", emb["LayerNorm"])
    max_pos = _np(emb["position_embeddings"]["embedding"]).shape[0]
    s.put("model.text_embeddings.position_ids",
          np.arange(max_pos, dtype=np.int64)[None, :])

    vemb = model_p["vision_embeddings"]
    s.put("model.vision_embeddings.class_embedding",
          _np(vemb["class_embedding"]))
    # flax conv kernel (kh, kw, in, out) -> torch (out, in, kh, kw)
    s.put("model.vision_embeddings.patch_embedding.weight",
          _np(vemb["patch_embedding"]["kernel"]).transpose(3, 2, 0, 1))
    s.embed("model.vision_embeddings.position_embedding",
            vemb["position_embedding"])
    num_pos = _np(vemb["position_embedding"]["embedding"]).shape[0]
    s.put("model.vision_embeddings.position_ids",
          np.arange(num_pos, dtype=np.int64)[None, :])

    # pre-LN (live) + post-LN (dead), ref: modeling_unimo.py:742-743
    s.layernorm("model.vision_pre_layrnorm", model_p["vision_pre_layernorm"])
    s.dead_layernorm("model.vision_post_layernorm", hidden)

    # --- towers (ref: modeling_unimo.py:649-729) -------------------------
    for coll, ref_name, emit in (
            ("encoder_vision_layers", "vision_layers",
             lambda k, t: _clip_layer(s, k, t)),
            ("encoder_text_layers", "text_layer",
             lambda k, t: _bert_layer(s, k, t, hidden, intermediate))):
        tower = model_p[coll]
        names = sorted((k for k in tower if k.startswith("layer_")),
                       key=lambda n: int(n.split("_")[1]))
        for name in names:
            i = int(name.split("_")[1])
            emit(f"model.encoder.{ref_name}.{i}", tower[name])

    # --- extra per-branch blocks + poolers (modeling_unimo.py:751-754) --
    _bert_layer(s, "model.self_text.0", model_p["self_text"],
                hidden, intermediate)
    _clip_layer(s, "model.self_vision.0", model_p["self_vision"])
    _pooler(s, "model.text_cls_pool", model_p["text_cls_pool"])
    _pooler(s, "model.vision_cls_pool", model_p["vision_cls_pool"])
    _pooler(s, "model.text_pool", model_p["text_pool"])
    _pooler(s, "model.vision_pool", model_p["vision_pool"])
    # dead pooler, ref: modeling_unimo.py:786
    s.dead_linear("model.text_pooler.dense", hidden, hidden)

    # --- routing fabric (modeling_unimo.py:781-782) ----------------------
    _interaction_module(s, "model.itr_module", model_p["itr_module"],
                        model_s["itr_module"], hidden)
    _interaction_module(s, "model.Reversed_itr_module",
                        model_p["Reversed_itr_module"],
                        model_s["Reversed_itr_module"], hidden)

    # --- fusion + head (modeling_unimo.py:776; unimo_model.py:145) ------
    _block_fusion(s, "model.block_fusion", model_p["block_fusion"])
    s.linear("fc", params["fc"])
    return s.out


def save_reference_checkpoint(path: str, variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Write a ``best_model.pth``-style file the reference can
    ``torch.load`` + ``load_state_dict`` directly (ref: modules/train.py:
    87-90,215,226-229). Returns the exported numpy dict."""
    sd = reference_state_dict(variables)
    # np.array(copy=True) keeps every tensor contiguous and writable
    torch.save({k: torch.from_numpy(np.array(v, copy=True))
                for k, v in sd.items()}, path)
    return sd
