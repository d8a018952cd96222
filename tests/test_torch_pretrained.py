"""Fine-tuning from pretrained towers: the port's HF loaders
(``d2r_tpu_torch/utils/weights.py``) against the JAX package's, on the CPU.

Tiny ``BertModel``, ``RobertaModel`` and ``CLIPVisionModel`` are built from
config objects at ``tiny_test_config``'s tower widths (no download), and
their state dicts saved as ``bert.pt`` and ``clip_vit.pt``. From one random
Flax tree (numpy, seeded, shapes from ``eval_shape``):

- the port's ``load_pretrained_params`` into the tree's model gives exactly
  ``from_jax_variables`` of JAX's ``load_pretrained_params`` (BERT and
  RoBERTa, unscanned and ``scan_layers``), and the tower tensors equal the
  files' after the documented layout change (fused q/k/v rows, the conv
  unchanged);
- the logits agree within 1e-4;
- a key of a file that nothing reads, a missing key and a wrong shape
  raise;
- the weights land in the live parameters, which an optimizer already
  holds.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2r_tpu.config import tiny_test_config as jax_tiny_config
from d2r_tpu.data.dataset import synthetic_batch
from d2r_tpu.models.unimo import D2RClassifier as JaxClassifier
from d2r_tpu.utils.weights import load_pretrained_params as jax_load_pretrained_params
from d2r_tpu_torch.config import tiny_test_config
from d2r_tpu_torch.train.state import create_train_state
from d2r_tpu_torch.utils.weights import load_pretrained_params, load_pretrained_state_dicts
from d2r_tpu_torch.weights import from_jax_variables

transformers = pytest.importorskip("transformers")

INPUTS = ("input_ids", "attention_mask", "token_type_ids", "labels", "pixel_values")
TEXT = {"bert": "tiny-bert", "roberta": "tiny-roberta"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _state_dicts(kind):
    """(text, vision) HF state dicts at the tiny towers' widths, seeded."""
    from transformers import (BertConfig, BertModel, CLIPVisionConfig, CLIPVisionModel,
                              RobertaConfig, RobertaModel)
    cfg = tiny_test_config(bert_name=TEXT[kind])
    tc, vc = cfg.text_config(), cfg.vision_config()
    common = dict(vocab_size=tc.vocab_size, hidden_size=tc.hidden_size,
                  num_hidden_layers=tc.num_hidden_layers,
                  num_attention_heads=tc.num_attention_heads,
                  intermediate_size=tc.intermediate_size,
                  max_position_embeddings=tc.max_position_embeddings,
                  type_vocab_size=tc.type_vocab_size, layer_norm_eps=tc.layer_norm_eps,
                  pad_token_id=tc.pad_token_id)
    torch.manual_seed(3)
    text = (RobertaModel(RobertaConfig(**common)) if kind == "roberta"
            else BertModel(BertConfig(**common)))
    vision = CLIPVisionModel(CLIPVisionConfig(
        hidden_size=vc.hidden_size, num_hidden_layers=vc.num_hidden_layers,
        num_attention_heads=vc.num_attention_heads, intermediate_size=vc.intermediate_size,
        image_size=vc.image_size, patch_size=vc.patch_size))
    # HF's init leaves LayerNorms at 1/0 and biases at 0: move every tensor
    # so that a leaf landing in the wrong place shows
    sds = []
    for sd in (text.state_dict(), vision.vision_model.state_dict()):
        sds.append({k: v + 0.05 * torch.randn_like(v) if v.is_floating_point() else v
                    for k, v in sd.items()})
    return tuple(sds)


@pytest.fixture(scope="module")
def pretrained_dir(tmp_path_factory):
    dirs = {}
    for kind in TEXT:
        d = tmp_path_factory.mktemp(kind)
        text, vision = _state_dicts(kind)
        torch.save(text, d / "bert.pt")
        torch.save(vision, d / "clip_vit.pt")
        dirs[kind] = str(d)
    return dirs


def _configs(kind, scan):
    kw = dict(bert_name=TEXT[kind], scan_layers=scan, DR_step=3)
    return jax_tiny_config(**kw), tiny_test_config(**kw)


def _batch(cfg):
    tc = cfg.text_config()
    b = synthetic_batch(2, cfg.max_seq, cfg.vision_config().image_size,
                        vocab_size=tc.vocab_size, seed=0)
    if tc.position_style == "roberta":           # <s> first, <pad> past each length
        b["input_ids"] = np.where(b["attention_mask"] == 1, b["input_ids"], tc.pad_token_id)
        b["input_ids"][:, 0] = 0
    return {k: b[k] for k in INPUTS}


@functools.lru_cache(maxsize=None)
def _tree(kind, scan):
    jcfg, _ = _configs(kind, scan)
    shapes = jax.eval_shape(JaxClassifier(jcfg).init, jax.random.key(0),
                            *[jnp.asarray(v) for v in _batch(jcfg).values()])
    rng = np.random.default_rng(1)
    tree = jax.tree_util.tree_map(
        lambda s: (0.1 * rng.standard_normal(s.shape)).astype(np.float32), shapes)
    return {c: jax.tree_util.tree_map(np.asarray, tree[c]) for c in ("params", "batch_stats")}


@functools.lru_cache(maxsize=None)
def _loaded(kind, scan, pretrained_dir):
    """(JAX-loaded params, the port model from them, the port model loaded
    by the port)."""
    jcfg, tcfg = _configs(kind, scan)
    tree = _tree(kind, scan)
    jparams = jax_load_pretrained_params(pretrained_dir, jcfg, copy.deepcopy(tree["params"]))
    ref = from_jax_variables(tcfg, {"params": jparams, "batch_stats": tree["batch_stats"]})
    model = from_jax_variables(tcfg, copy.deepcopy(tree))
    load_pretrained_params(pretrained_dir, model)
    return jparams, ref, model


@pytest.mark.parametrize("scan", [False, True], ids=["unscanned", "scanned"])
@pytest.mark.parametrize("kind", sorted(TEXT))
def test_loaded_parameters_equal_jax_loader(kind, scan, pretrained_dir):
    _, ref, model = _loaded(kind, scan, pretrained_dir[kind])
    want, got = ref.state_dict(), model.state_dict()
    assert set(want) == set(got)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    # against the files themselves: q/k/v rows stacked, the conv unchanged
    text, vision = _state_dicts(kind)
    m = model.model
    qkv = m.encoder_text_layers.layer_1.attention_self.qkv
    assert torch.equal(qkv.weight, torch.cat(
        [text[f"encoder.layer.1.attention.self.{n}.weight"] for n in ("query", "key", "value")]))
    assert torch.equal(m.vision_embeddings.patch_embedding.weight,
                       vision["embeddings.patch_embedding.weight"])
    assert torch.equal(m.vision_pre_layernorm.weight, vision["pre_layrnorm.weight"])
    assert torch.equal(m.encoder_vision_layers.layer_0.mlp_fc1.weight,
                       vision["encoder.layers.0.mlp.fc1.weight"])
    # the fabric keeps the tree's values
    assert torch.equal(m.self_text.output_dense.bias, torch.from_numpy(
        _tree(kind, scan)["params"]["model"]["self_text"]["output_dense"]["bias"]))


@pytest.mark.parametrize("kind,scan", [("bert", False), ("roberta", True)],
                         ids=["bert-unscanned", "roberta-scanned"])
def test_logits_match_jax(kind, scan, pretrained_dir):
    jcfg, _ = _configs(kind, scan)
    jparams, _, model = _loaded(kind, scan, pretrained_dir[kind])
    batch = _batch(jcfg)
    jmodel = JaxClassifier(jcfg)
    run = jax.jit(lambda v, *a: jmodel.apply(v, *a, deterministic=True,
                                             use_running_average=True)[1])
    ref = run({"params": jparams, "batch_stats": _tree(kind, scan)["batch_stats"]},
              *[jnp.asarray(v) for v in batch.values()])
    with torch.no_grad():
        _, logits, _ = model(*[torch.as_tensor(v) for v in batch.values()])
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


@pytest.mark.parametrize("fault", ["unknown_key", "missing_key", "shape"])
def test_coverage_and_shape_checks_raise(fault):
    text, vision = (dict(sd) for sd in _state_dicts("bert"))
    # the whitelisted keys load: the pooler and CLIP's post-LayerNorm
    assert any(k.startswith("pooler.") for k in text)
    assert any(k.startswith("post_layernorm.") for k in vision)
    if fault == "unknown_key":
        vision["encoder.layers.0.rogue.weight"] = torch.zeros(1)
        match = "unconsumed pretrained key.*rogue"
    elif fault == "missing_key":
        del text["encoder.layer.1.attention.self.key.bias"]
        match = "missing source key: encoder.layer.1.attention.self.key.bias"
    else:
        text["embeddings.word_embeddings.weight"] = torch.zeros(3, 64)
        match = "shape mismatch at text_embeddings/word_embeddings/embedding"
    model = from_jax_variables(_configs("bert", False)[1], copy.deepcopy(_tree("bert", False)))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises((KeyError, ValueError), match=match):
        load_pretrained_state_dicts(model, text, vision)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_weights_land_in_the_parameters_the_optimizer_holds(pretrained_dir):
    _, tcfg = _configs("bert", False)
    state = create_train_state(tcfg, 10, device="cpu", seed=0)
    held = [p for g in state.optimizer.param_groups for p in g["params"]]
    load_pretrained_params(pretrained_dir["bert"], state.model)
    text, _ = _state_dicts("bert")
    emb = state.model.model.text_embeddings.word_embeddings.weight
    assert torch.equal(emb, text["embeddings.word_embeddings.weight"])
    assert any(p is emb for p in held)
