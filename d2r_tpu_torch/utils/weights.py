"""Pretrained towers from HuggingFace state dicts (counterpart of
``d2r_tpu/utils/weights.py:1-211``).

``bert.pt`` (a ``BertModel`` or ``RobertaModel`` state dict) and
``clip_vit.pt`` (``CLIPModel.vision_model``'s) are read with
``torch.load(weights_only=True)`` from a local directory; nothing is ever
downloaded. Make them once, on a machine with ``transformers``::

    torch.save(BertModel.from_pretrained(name).state_dict(), 'bert.pt')
    torch.save(CLIPModel.from_pretrained(name).vision_model.state_dict(),
               'clip_vit.pt')

The mapping tables are the JAX package's: HF keys to the Flax paths of the
two towers, with the three q/k/v Linears fused into one head-aligned
(in, 3, h) kernel, HF's ``pre_layrnorm`` spelling, and torch's (out, in)
Linears and OIHW conv turned into Flax's (in, out) and HWIO. The coverage
check is strict both ways: a mapped key missing from a file raises, and so
does a key of a file that nothing consumes and no whitelist names (the
pooler, the CLIP post-LayerNorm and the position/type-id buffers that older
``transformers`` save). RoBERTa goes through the BERT mapping; its text
config must say ``position_style="roberta"``.

:func:`load_pretrained_params` reuses the strict Flax loader: the model's
own tree (:func:`~d2r_tpu_torch.weights.to_jax_variables`), its tower
leaves replaced, loaded back in place (``load_jax_variables``), so the
parameters an optimizer already holds receive the weights. A model with
``scan_layers`` takes the scanned tree, and a pipelined one
(``pipeline_stages`` > 1, JAX ``d2r_tpu/utils/weights.py:191-200``) the
pipelined tree, each converted on its per-layer view.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Set, Tuple

import numpy as np
import torch
from torch import nn

from d2r_tpu_torch.weights import (
    load_jax_variables,
    pipeline_tower_layers,
    stack_tower_layers,
    to_jax_variables,
    unpipeline_tower_layers,
    unstack_tower_layers,
)

# keys of the files that the model never reads
CLIP_UNUSED_PREFIXES = ("post_layernorm.",)
BERT_UNUSED_PREFIXES = ("pooler.", "embeddings.position_ids", "embeddings.token_type_ids")


def _np(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy() if hasattr(t, "detach") else np.asarray(t)


def _set_in(tree: Dict[str, Any], path: Tuple[str, ...], value: np.ndarray,
            template: Dict[str, Any]) -> None:
    node, tnode = tree, template
    for p in path[:-1]:
        node = node.setdefault(p, {})
        tnode = tnode[p]
    expect = np.asarray(tnode[path[-1]])
    if expect.shape != value.shape:
        raise ValueError(f"shape mismatch at {'/'.join(path)}: "
                         f"{value.shape} vs template {expect.shape}")
    node[path[-1]] = value.astype(expect.dtype)


def _linear(dst: Tuple[str, ...], src: str):
    """torch Linear (out, in) -> Flax kernel (in, out)."""
    return [(dst + ("kernel",), src + ".weight", lambda w: _np(w).T),
            (dst + ("bias",), src + ".bias", _np)]


def _fused_qkv(dst: Tuple[str, ...], q: str, k: str, v: str):
    """Three torch Linears -> the fused (in, 3, h) kernel and (3, h) bias."""
    return [(dst + ("kernel",), (q + ".weight", k + ".weight", v + ".weight"),
             lambda qw, kw, vw: np.stack([_np(qw).T, _np(kw).T, _np(vw).T], axis=1)),
            (dst + ("bias",), (q + ".bias", k + ".bias", v + ".bias"),
             lambda qb, kb, vb: np.stack([_np(qb), _np(kb), _np(vb)]))]


def _layernorm(dst: Tuple[str, ...], src: str):
    return [(dst + ("scale",), src + ".weight", _np), (dst + ("bias",), src + ".bias", _np)]


def bert_mapping(num_layers: int):
    """(Flax path under ``model``, HF key or keys, converter) for a
    ``BertModel``/``RobertaModel`` state dict -> the text tower."""
    emb = ("text_embeddings",)
    m = [(emb + ("word_embeddings", "embedding"), "embeddings.word_embeddings.weight", _np),
         (emb + ("position_embeddings", "embedding"),
          "embeddings.position_embeddings.weight", _np),
         (emb + ("token_type_embeddings", "embedding"),
          "embeddings.token_type_embeddings.weight", _np)]
    m += _layernorm(emb + ("LayerNorm",), "embeddings.LayerNorm")
    for i in range(num_layers):
        dst, src = ("encoder_text_layers", f"layer_{i}"), f"encoder.layer.{i}"
        m += _fused_qkv(dst + ("attention_self", "qkv"), src + ".attention.self.query",
                        src + ".attention.self.key", src + ".attention.self.value")
        m += _linear(dst + ("attention_output", "dense"), src + ".attention.output.dense")
        m += _layernorm(dst + ("attention_output", "LayerNorm"),
                        src + ".attention.output.LayerNorm")
        m += _linear(dst + ("intermediate_dense",), src + ".intermediate.dense")
        m += _linear(dst + ("output_dense",), src + ".output.dense")
        m += _layernorm(dst + ("output_LayerNorm",), src + ".output.LayerNorm")
    return m


def clip_vision_mapping(num_layers: int):
    """The same for ``CLIPModel.vision_model``'s state dict -> the vision
    tower and the pre-LayerNorm (HF spells it ``pre_layrnorm``)."""
    m = [(("vision_embeddings", "class_embedding"), "embeddings.class_embedding", _np),
         (("vision_embeddings", "patch_embedding", "kernel"),
          "embeddings.patch_embedding.weight",
          lambda w: _np(w).transpose(2, 3, 1, 0)),          # OIHW -> HWIO
         (("vision_embeddings", "position_embedding", "embedding"),
          "embeddings.position_embedding.weight", _np)]
    m += _layernorm(("vision_pre_layernorm",), "pre_layrnorm")
    for i in range(num_layers):
        dst, src = ("encoder_vision_layers", f"layer_{i}"), f"encoder.layers.{i}"
        m += _fused_qkv(dst + ("self_attn", "qkv"), f"{src}.self_attn.q_proj",
                        f"{src}.self_attn.k_proj", f"{src}.self_attn.v_proj")
        m += _linear(dst + ("self_attn", "out_proj"), f"{src}.self_attn.out_proj")
        m += _layernorm(dst + ("layer_norm1",), src + ".layer_norm1")
        m += _layernorm(dst + ("layer_norm2",), src + ".layer_norm2")
        m += _linear(dst + ("mlp_fc1",), src + ".mlp.fc1")
        m += _linear(dst + ("mlp_fc2",), src + ".mlp.fc2")
    return m


def _apply_mapping(model_tree: Dict[str, Any], template: Dict[str, Any], mapping,
                   sd: Dict[str, Any], unused_prefixes) -> Set[str]:
    consumed: Set[str] = set()
    for dst, src, fn in mapping:
        srcs = src if isinstance(src, tuple) else (src,)
        for s in srcs:
            if s not in sd:
                raise KeyError(f"missing source key: {s}")
        _set_in(model_tree, dst, fn(*[sd[s] for s in srcs]), template)
        consumed.update(srcs)
    for k in sd:
        if k not in consumed and not any(k.startswith(p) for p in unused_prefixes):
            raise KeyError(f"unconsumed pretrained key (coverage check): {k}")
    return consumed


def convert_pretrained(params: Dict[str, Any], bert_state_dict: Dict[str, Any],
                       clip_vision_state_dict: Dict[str, Any], num_text_layers: int = 12,
                       num_vision_layers: int = 12) -> Dict[str, Any]:
    """A copy of the (unscanned) Flax params tree ``params`` of numpy
    arrays, its ``model`` towers replaced by the two state dicts'
    weights."""
    new = copy.deepcopy(params)
    _apply_mapping(new["model"], params["model"], bert_mapping(num_text_layers),
                   bert_state_dict, BERT_UNUSED_PREFIXES)
    _apply_mapping(new["model"], params["model"], clip_vision_mapping(num_vision_layers),
                   clip_vision_state_dict, CLIP_UNUSED_PREFIXES)
    return new


def load_pretrained_state_dicts(model: nn.Module, bert_state_dict: Dict[str, Any],
                                clip_vision_state_dict: Dict[str, Any]) -> nn.Module:
    """Set ``model``'s (a ``D2RClassifier``) two towers from the state
    dicts, in place; every other tensor keeps its value."""
    cfg = model.cfg
    variables = to_jax_variables(model)
    params = unstack_tower_layers(unpipeline_tower_layers(variables["params"]))
    params = convert_pretrained(params, bert_state_dict, clip_vision_state_dict,
                                cfg.text_config().num_hidden_layers,
                                cfg.vision_config().num_hidden_layers)
    if cfg.pipeline_stages > 1:
        params = pipeline_tower_layers(params, cfg.pipeline_stages)
    elif cfg.scan_layers:
        params = stack_tower_layers(params)
    return load_jax_variables(model, {**variables, "params": params})


def load_pretrained_params(pretrained_dir: str, model: nn.Module) -> nn.Module:
    """Load ``bert.pt`` and ``clip_vit.pt`` from ``pretrained_dir`` into
    ``model``'s towers in place (:func:`load_pretrained_state_dicts`)."""
    load = lambda name: torch.load(os.path.join(pretrained_dir, name), map_location="cpu",
                                   weights_only=True)
    return load_pretrained_state_dicts(model, load("bert.pt"), load("clip_vit.pt"))
