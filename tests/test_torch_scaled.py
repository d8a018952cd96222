"""The scaled configuration's slice on the CPU: RoBERTa embeddings and a
RoBERTa + 257-token vision model, the port against the JAX package.

D2R-large is RoBERTa-large + CLIP ViT-L/14: RoBERTa positions derived from
the attention mask, and 224/14 = 256 patches + CLS = 257 vision tokens, so
every vision-side attention site is outside K1's band and goes to K3. Here
the same shape of model runs at tiny widths: ``tiny-roberta`` (2 layers,
width 64, PAD id 1, a 66-row position table, one token type, eps 1e-5) and
a vision preset of 257 tokens (224/14, width 64, 2 layers, 4 heads),
registered in both packages by this file. One random Flax tree (shapes
from ``jax.eval_shape``, values from seeded numpy) loads into both.

Tolerances: embeddings atol 1e-6 (the same fp32 lookups and LayerNorm);
the whole model 1e-4 on logits and js_loss, as ``tests/test_torch_model.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2r_tpu import config as jconfig
from d2r_tpu.models.bert import BertEmbeddings as JaxEmbeddings
from d2r_tpu.models.unimo import D2RClassifier as JaxClassifier
from d2r_tpu_torch import config as tconfig
from d2r_tpu_torch.models.bert import BertEmbeddings
from d2r_tpu_torch.ops.kernels import flash_attention as tfl
from d2r_tpu_torch.ops.kernels import fused_attention as tfa
from d2r_tpu_torch.weights import from_jax_variables, load_jax_variables, to_jax_variables


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: beside the suite's other workers torch's
    default threads contend, and the tiny steps run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

VISION_257 = "tiny-vit-257"
INPUTS = ("input_ids", "attention_mask", "token_type_ids", "labels", "pixel_values")
PAD, FIRST = 1, 0          # RoBERTa's <pad> and <s>


def _register():
    for pkg in (jconfig, tconfig):
        pkg.register_vision_preset(VISION_257, lambda pkg=pkg: pkg.VisionEncoderConfig(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=128, image_size=224, patch_size=14))


def _ids(lengths, seq_len, vocab, seed):
    """RoBERTa-style ids: <s> first, random tokens, <pad> past each length."""
    rng = np.random.default_rng(seed)
    mask = (np.arange(seq_len)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    ids = np.where(mask == 1, rng.integers(5, vocab, size=mask.shape), PAD).astype(np.int32)
    ids[:, 0] = FIRST
    return ids, mask


def _fill(shapes, seed):
    """Seeded numpy values for a Flax shape tree: kernels at half the fan-in
    scale, LayerNorm scales near 1, positive BatchNorm variances, small
    rest (``tests/test_torch_model.py::random_variables``)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = str(getattr(path[-1], "key", path[-1]))
        n = rng.standard_normal(s.shape).astype(np.float32)
        if leaf == "kernel" or leaf.startswith("merge_kernel"):
            if len(s.shape) == 4:
                fan_in = np.prod(s.shape[:3])
            else:
                fan_in = s.shape[1 if leaf.startswith("merge") else 0]
            return 0.5 * n / np.sqrt(fan_in)
        if leaf == "scale":
            return 1.0 + 0.1 * n
        if leaf == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if leaf in ("class_embedding", "embedding"):
            return n
        return 0.1 * n

    return jax.tree_util.tree_map_with_path(lambda p, s: np.float32(fill(p, s)), shapes)


# ---- RoBERTa embeddings ------------------------------------------------------

def _embeddings(seq_len=16):
    tc = jconfig.D2RConfig(bert_name="tiny-roberta").text_config()
    jmod = JaxEmbeddings(tc)
    ids, mask = _ids([seq_len, 9, 4], seq_len, tc.vocab_size, seed=0)
    args = (jnp.asarray(ids), jnp.zeros_like(jnp.asarray(ids)))
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.key(0), *args,
                                              attention_mask=jnp.asarray(mask)))
    variables = _fill(shapes, seed=1)
    port = load_jax_variables(
        BertEmbeddings(tconfig.D2RConfig(bert_name="tiny-roberta").text_config()),
        jax.tree_util.tree_map(np.asarray, variables)).eval()
    return jmod, variables, port, ids, mask


def test_roberta_embeddings_match_jax():
    jmod, variables, port, ids, mask = _embeddings()
    ref, state = jmod.apply(variables, jnp.asarray(ids), jnp.zeros_like(jnp.asarray(ids)),
                            attention_mask=jnp.asarray(mask), capture_intermediates=True,
                            mutable=["intermediates"])
    t_ids, t_mask = torch.from_numpy(ids), torch.from_numpy(mask)
    positions = port.position_ids(t_ids, t_mask)
    # HF RoBERTa's create_position_ids_from_input_ids on the same ids
    not_pad = (ids != PAD).astype(np.int64)
    np.testing.assert_array_equal(positions.numpy(), np.cumsum(not_pad, 1) * not_pad + PAD)
    assert positions.max().item() == 16 + PAD and positions[2, 4:].eq(PAD).all()
    with torch.no_grad():
        got = port(t_ids, torch.zeros_like(t_ids), attention_mask=t_mask)
        looked_up = port.position_embeddings(positions)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    jpos = state["intermediates"]["position_embeddings"]["__call__"][0]
    np.testing.assert_allclose(looked_up.numpy(), np.asarray(jpos), atol=0, rtol=0)
    assert port.LayerNorm.eps == 1e-5 and port.token_type_embeddings.weight.shape[0] == 1


def test_roberta_positions_refuse_a_table_too_small_and_a_missing_mask():
    """seq_len + pad + 1 rows are needed: 64 fit the 66-row table, 65 do not.
    The check runs on the host, before any lookup."""
    port = BertEmbeddings(tconfig.D2RConfig(bert_name="tiny-roberta").text_config())
    ok = torch.ones(1, 64, dtype=torch.int32)
    assert port.position_ids(ok, ok).max().item() == 64 + PAD
    too_long = torch.ones(1, 65, dtype=torch.int32)
    with pytest.raises(ValueError, match="max_position_embeddings >= .* = 67, have 66"):
        port.position_ids(too_long, too_long)
    with pytest.raises(ValueError, match="needs the attention mask"):
        port.position_ids(ok, None)


# ---- the slice as a whole ----------------------------------------------------

@functools.lru_cache(maxsize=None)
def slice_runs():
    """(JAX variables, JAX outputs, port model, port outputs, the port's
    plain-version calls of K3 and K1) at DR_step 3, batch 2, fp32."""
    _register()
    kw = dict(bert_name="tiny-roberta", vit_name=VISION_257, DR_step=3)
    jcfg, cfg = jconfig.tiny_test_config(**kw), tconfig.tiny_test_config(**kw)
    assert cfg.vision_config().num_tokens == 257
    ids, mask = _ids([16, 7], jcfg.max_seq, jcfg.text_config().vocab_size, seed=2)
    rng = np.random.default_rng(3)
    batch = {"input_ids": ids, "attention_mask": mask, "token_type_ids": np.zeros_like(ids),
             "labels": np.array([0, 2], np.int32),
             "pixel_values": rng.integers(0, 256, (2, 3, 224, 224)).astype(np.uint8)}
    jmodel = JaxClassifier(jcfg)
    jargs = [jnp.asarray(batch[k]) for k in INPUTS]
    variables = _fill(jax.eval_shape(jmodel.init, jax.random.key(0), *jargs), seed=4)
    jout = jax.jit(lambda v, *a: jmodel.apply(v, *a, deterministic=True,
                                              use_running_average=True))(variables, *jargs)

    model = from_jax_variables(cfg, variables)
    counts = {"k3": 0, "k1": 0}
    k3_plain, k1_plain = tfl.flash_attention_plain, tfa.fused_attention_small_plain

    def counting(name, fn):
        def run(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return run

    tfl.flash_attention_plain = counting("k3", k3_plain)
    tfa.fused_attention_small_plain = counting("k1", k1_plain)
    try:
        with torch.no_grad():
            tout = model(*[torch.from_numpy(batch[k]) for k in INPUTS])
    finally:
        tfl.flash_attention_plain, tfa.fused_attention_small_plain = k3_plain, k1_plain
    return variables, jout, model, tout, counts


def test_scaled_slice_logits_and_js_loss_match_jax():
    _, (loss, logits, aux), _, (tloss, tlogits, taux), _ = slice_runs()
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(taux["js_loss"]), float(aux["js_loss"]), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(tloss), float(loss), atol=1e-4, rtol=0)


def test_scaled_slice_runs_k3_at_every_257_token_site():
    """2 vision layers + self_vision + 3 image-branch IMRC cells = 6 sites
    on K3 (its plain version on the CPU); the text side's 2 layers +
    self_text + 3 text-branch IMRC cells = 6 on K1."""
    counts = slice_runs()[4]
    assert counts == {"k3": 6, "k1": 6}


def test_scaled_weights_round_trip():
    """``from_jax_variables`` / ``to_jax_variables`` cover the RoBERTa
    tables (66 position rows, 1 token type) and the 257-row vision position
    table: the tree comes back leaf for leaf."""
    variables, _, model, _, _ = slice_runs()
    emb = model.model.text_embeddings
    assert emb.position_embeddings.weight.shape == (66, 64)
    assert emb.token_type_embeddings.weight.shape == (1, 64)
    assert model.model.vision_embeddings.position_embedding.weight.shape == (257, 64)
    back = to_jax_variables(model)
    ref = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(map(jax.tree_util.keystr, got)) == set(map(jax.tree_util.keystr, ref))
    ref = {jax.tree_util.keystr(k): v for k, v in ref.items()}
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(ref[jax.tree_util.keystr(k)]))
