"""``d2r_tpu_torch.weights.from_jax_variables``: strict coverage and the
layout translations, on the JAX package's own variable trees (shapes from
``eval_shape`` of ``D2RClassifier.init``, values from a seeded numpy
generator), at ``tiny_test_config`` with DR_step 3 and 4."""

import copy
import functools
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from d2r_tpu.config import tiny_test_config as jax_tiny_config
from d2r_tpu.data.dataset import synthetic_batch
from d2r_tpu.models.unimo import D2RClassifier as JaxClassifier
from d2r_tpu_torch.config import tiny_test_config
from d2r_tpu_torch.weights import from_jax_variables

GEOMETRIES = [3, 4]   # DR_step at tiny widths


@functools.lru_cache(maxsize=None)
def _tree(dr_step):
    cfg = jax_tiny_config(DR_step=dr_step)
    vc = cfg.vision_config()
    b = synthetic_batch(2, cfg.max_seq, vc.image_size, vocab_size=cfg.text_config().vocab_size)
    args = [jnp.asarray(b[k]) for k in
            ("input_ids", "attention_mask", "token_type_ids", "labels", "pixel_values")]
    shapes = jax.eval_shape(JaxClassifier(cfg).init, jax.random.key(0), *args)
    rng = np.random.default_rng(dr_step)
    return _plain(jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes))


def _plain(tree):
    if isinstance(tree, Mapping):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def _variables(dr_step):
    return copy.deepcopy(_tree(dr_step))


@pytest.mark.parametrize("dr_step", GEOMETRIES)
def test_every_leaf_lands_once(dr_step):
    v = _variables(dr_step)
    model = from_jax_variables(tiny_test_config(DR_step=dr_step), v)
    n_leaves = len(jax.tree_util.tree_leaves(v))
    assert n_leaves == len(model.state_dict())
    assert not model.training


@pytest.mark.parametrize("dr_step", GEOMETRIES)
def test_layouts_are_translated(dr_step):
    v = _variables(dr_step)
    m = from_jax_variables(tiny_test_config(DR_step=dr_step), v)
    p, bs = v["params"]["model"], v["batch_stats"]["model"]
    # Dense (in, out) -> (out, in)
    np.testing.assert_array_equal(m.fc.weight.detach().numpy(), v["params"]["fc"]["kernel"].T)
    # QKVDense (in, 3, h) -> (3h, in): row j*h + c is kernel[:, j, c]
    k = p["encoder_text_layers"]["layer_1"]["attention_self"]["qkv"]["kernel"]
    w = m.model.encoder_text_layers.layer_1.attention_self.qkv.weight.detach().numpy()
    h = k.shape[2]
    np.testing.assert_array_equal(w[2 * h + 5], k[:, 2, 5])
    # conv HWIO -> OIHW
    ck = p["vision_embeddings"]["patch_embedding"]["kernel"]
    cw = m.model.vision_embeddings.patch_embedding.weight.detach().numpy()
    np.testing.assert_array_equal(cw, ck.transpose(3, 2, 0, 1))
    # LayerNorm scale -> weight; BN scale + running stats; the SAF and BLOCK
    # parameters keep their Flax names and layouts
    np.testing.assert_array_equal(m.model.vision_pre_layernorm.weight.detach().numpy(),
                                  p["vision_pre_layernorm"]["scale"])
    bn = m.model.itr_module.dynamic_itr_l0.glac.saf.bn
    np.testing.assert_array_equal(bn.running_var.numpy(),
                                  bs["itr_module"]["dynamic_itr_l0"]["glac"]["saf"]["bn"]["var"])
    np.testing.assert_array_equal(
        m.model.itr_module.dynamic_itr_l0.glac.saf.attn_sim_w_kernel.detach().numpy(),
        p["itr_module"]["dynamic_itr_l0"]["glac"]["saf"]["attn_sim_w_kernel"])
    np.testing.assert_array_equal(m.model.block_fusion.merge_kernel1.detach().numpy(),
                                  p["block_fusion"]["merge_kernel1"])
    np.testing.assert_array_equal(m.model.vision_embeddings.class_embedding.detach().numpy(),
                                  p["vision_embeddings"]["class_embedding"])


@pytest.mark.parametrize("dr_step", GEOMETRIES)
def test_missing_leaf_raises_and_names_the_port_key(dr_step):
    v = _variables(dr_step)
    del v["batch_stats"]["model"]["Reversed_itr_module"]["dynamic_itr_l2"]["glac"]["saf"]["bn"]["mean"]
    key = "model.Reversed_itr_module.dynamic_itr_l2.glac.saf.bn.running_mean"
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        from_jax_variables(tiny_test_config(DR_step=dr_step), v)


@pytest.mark.parametrize("dr_step", GEOMETRIES)
@pytest.mark.parametrize("where", ["new_module", "new_leaf"])
def test_extra_leaf_raises_and_names_the_flax_key(dr_step, where):
    v = _variables(dr_step)
    if where == "new_module":
        v["params"]["model"]["text_pooler"] = {"dense": {"kernel": np.zeros((64, 64), np.float32)}}
        key = "params/model/text_pooler/dense/kernel"
    else:
        v["params"]["model"]["self_text"]["output_LayerNorm"]["mean"] = np.zeros(64, np.float32)
        key = "params/model/self_text/output_LayerNorm/mean"
    with pytest.raises(KeyError, match=key):
        from_jax_variables(tiny_test_config(DR_step=dr_step), v)


@pytest.mark.parametrize("dr_step", GEOMETRIES)
def test_shape_mismatch_raises_and_names_the_key(dr_step):
    v = _variables(dr_step)
    v["params"]["model"]["text_pool"]["dense"]["bias"] = np.zeros(65, np.float32)
    with pytest.raises(ValueError, match="params/model/text_pool/dense/bias"):
        from_jax_variables(tiny_test_config(DR_step=dr_step), v)


def test_dr_step_mismatch_is_caught():
    """A DR_step=4 tree into a DR_step=3 port model leaves a routing layer
    with no module: named in the error."""
    with pytest.raises(KeyError, match="dynamic_itr_l1_1"):
        from_jax_variables(tiny_test_config(DR_step=3), _variables(4))


@functools.lru_cache(maxsize=None)
def _scanned_tree():
    """A JAX tree of ``scan_layers=True`` (each tower's blocks stacked under
    ``layers_scanned/layer``), random values."""
    cfg = jax_tiny_config(DR_step=3, scan_layers=True)
    vc = cfg.vision_config()
    b = synthetic_batch(2, cfg.max_seq, vc.image_size, vocab_size=cfg.text_config().vocab_size)
    args = [jnp.asarray(b[k]) for k in
            ("input_ids", "attention_mask", "token_type_ids", "labels", "pixel_values")]
    shapes = jax.eval_shape(JaxClassifier(cfg).init, jax.random.key(0), *args)
    rng = np.random.default_rng(5)
    return _plain(jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes))


def test_scanned_tree_lands_layer_by_layer():
    """Block i of a tower takes row i of every stacked leaf."""
    v = copy.deepcopy(_scanned_tree())
    m = from_jax_variables(tiny_test_config(DR_step=3, scan_layers=True), v)
    text = v["params"]["model"]["encoder_text_layers"]["layers_scanned"]["layer"]
    vision = v["params"]["model"]["encoder_vision_layers"]["layers_scanned"]["layer"]
    for i in range(2):
        k = text["attention_self"]["qkv"]["kernel"][i]
        np.testing.assert_array_equal(
            getattr(m.model.encoder_text_layers, f"layer_{i}").attention_self.qkv.weight
            .detach().numpy(), k.reshape(k.shape[0], -1).T)
        np.testing.assert_array_equal(
            getattr(m.model.encoder_vision_layers, f"layer_{i}").mlp_fc2.weight.detach().numpy(),
            vision["mlp_fc2"]["kernel"][i].T)


@pytest.mark.parametrize("scanned_tree", [True, False], ids=["into_unscanned", "into_scanned"])
def test_tree_layout_must_match_scan_layers(scanned_tree):
    """A scanned tree into a model without ``scan_layers`` has leaves with no
    module; an unscanned one into a model with it is refused."""
    v = copy.deepcopy(_scanned_tree() if scanned_tree else _tree(3))
    with pytest.raises(KeyError, match="layers_scanned"):
        from_jax_variables(tiny_test_config(DR_step=3, scan_layers=not scanned_tree), v)
