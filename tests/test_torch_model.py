"""The port's model and serving path against the JAX package's, on the CPU.

One random Flax variable tree (numpy, seeded) is loaded into both packages
at ``tiny_test_config`` (2-layer towers, width 64). The JAX forward runs
jitted with ``deterministic=True, use_running_average=True`` and
``capture_intermediates``; the port records the same modules' outputs with
forward hooks. Every compared module (towers, the six cells of the first
and last routing layers, each routing layer, both InteractionModule
directions, the fusion and the head) must agree within atol 1e-4 in fp32, at
DR_step 3 and 4. The Predictor comparison covers padding into buckets,
chunking above the largest bucket, and bf16.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2r_tpu.config import tiny_test_config as jax_tiny_config
from d2r_tpu.data.dataset import synthetic_batch
from d2r_tpu.models.unimo import D2RClassifier as JaxClassifier
from d2r_tpu.serve import Predictor as JaxPredictor
from d2r_tpu_torch.config import tiny_test_config
from d2r_tpu_torch.serve import Predictor
from d2r_tpu_torch.weights import from_jax_variables

ATOL = 1e-4
INPUTS = ("input_ids", "attention_mask", "token_type_ids", "labels", "pixel_values")
BRANCHES = ("itr_module", "Reversed_itr_module")
CELLS = ("ric", "glac", "imrc", "cmrc", "crcmc", "gesc")
MODULES = (
    ["model/text_embeddings", "model/encoder_text_layers", "model/self_text",
     "model/vision_embeddings", "model/encoder_vision_layers", "model/self_vision",
     "model/block_fusion", "fc"]
    + [f"model/{b}" for b in BRANCHES]
    + [f"model/{b}/{layer}" for b in BRANCHES
       for layer in ("dynamic_itr_l0", "dynamic_itr_l1_0", "dynamic_itr_l2")]
    + [f"model/{b}/{layer}/{c}" for b in BRANCHES
       for layer in ("dynamic_itr_l0", "dynamic_itr_l2") for c in CELLS])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the tiny model's ops are too small to share, and
    beside the suite's other workers more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_variables(model, args, seed=0):
    """A Flax variable tree of ``model`` filled with seeded numpy values:
    kernels at half the fan-in scale, LayerNorm scales near 1, positive BN
    variances, small biases (so some router gates are 0 and the skip paths
    run). At the full fan-in scale the 100x-temperature cross-modal softmaxes
    meet near-ties, where the summation order alone moves a near-one-hot row
    by more than 1e-4."""
    shapes = jax.eval_shape(model.init, jax.random.key(0), *args)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = str(getattr(path[-1], "key", path[-1]))
        n = rng.standard_normal(s.shape).astype(np.float32)
        if leaf == "kernel" or leaf.startswith("merge_kernel"):
            if len(s.shape) == 4:                 # conv HWIO
                fan_in = np.prod(s.shape[:3])
            else:                                 # (in, ...) or merge (c, in, out)
                fan_in = s.shape[1 if leaf.startswith("merge") else 0]
            return 0.5 * n / np.sqrt(fan_in)
        if leaf == "scale":
            return 1.0 + 0.1 * n
        if leaf == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if leaf == "class_embedding":
            return n
        return 0.1 * n

    return jax.tree_util.tree_map_with_path(fill, shapes)


def batch(cfg, n, seed=0):
    vc = cfg.vision_config()
    b = synthetic_batch(n, cfg.max_seq, vc.image_size,
                        vocab_size=cfg.text_config().vocab_size, seed=seed)
    b["pixel_values"] = np.random.default_rng(seed).integers(
        0, 256, size=b["pixel_values"].shape).astype(np.uint8)
    return b


@functools.lru_cache(maxsize=None)
def forwards(dr_step):
    """(JAX intermediates by module path, JAX outputs, port outputs by module
    path, port outputs) for one shared random tree."""
    jcfg = jax_tiny_config(DR_step=dr_step)
    b = batch(jcfg, 4, seed=dr_step)
    valid = np.array([1, 1, 1, 0], bool)
    jmodel = JaxClassifier(jcfg)
    variables = random_variables(jmodel, [jnp.asarray(b[k]) for k in INPUTS], seed=dr_step)

    @jax.jit
    def run(v, *args):
        return jmodel.apply(v, *args, deterministic=True, use_running_average=True,
                            valid=jnp.asarray(valid), capture_intermediates=True,
                            mutable=["intermediates"])

    jout, state = run(variables, *[jnp.asarray(b[k]) for k in INPUTS])
    jinter = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state["intermediates"])[0]:
        keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        i = keys.index("__call__")
        jinter.setdefault("/".join(keys[:i]), []).append(np.asarray(leaf))

    model = from_jax_variables(tiny_test_config(DR_step=dr_step), variables)
    tinter = {}

    def hook(name):
        def record(_module, _args, out):
            flat = out if isinstance(out, tuple) else (out,)
            tinter[name] = [t.detach().numpy() for t in flat]
        return record

    for name in MODULES:
        model.get_submodule(name.replace("/", ".")).register_forward_hook(hook(name))
    with torch.no_grad():
        tout = model(*[torch.from_numpy(b[k]) for k in INPUTS], valid=torch.from_numpy(valid))
    return jinter, jout, tinter, tout


@pytest.mark.parametrize("dr_step", [3, 4])
@pytest.mark.parametrize("module", MODULES)
def test_module_outputs_match_jax(dr_step, module):
    jinter, _, tinter, _ = forwards(dr_step)
    ref, got = jinter[module], tinter[module]
    assert len(ref) == len(got), (len(ref), len(got))
    for r, g in zip(ref, got):
        assert r.shape == g.shape, (r.shape, g.shape)
        np.testing.assert_allclose(g, r, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dr_step", [3, 4])
def test_classifier_loss_logits_js_match_jax(dr_step):
    _, (loss, logits, aux), _, (tloss, tlogits, taux) = forwards(dr_step)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(tloss), float(loss), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(taux["js_loss"]), float(aux["js_loss"]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(taux["ce_loss"]), float(aux["ce_loss"]), atol=ATOL, rtol=0)


@functools.lru_cache(maxsize=None)
def predictors(compute_dtype):
    jcfg = jax_tiny_config(DR_step=4, compute_dtype=compute_dtype)
    b = batch(jcfg, 2)
    variables = random_variables(JaxClassifier(jcfg), [jnp.asarray(b[k]) for k in INPUTS], seed=5)
    jpred = JaxPredictor(jcfg, variables, batch_buckets=(2, 4))
    cfg = tiny_test_config(DR_step=4, compute_dtype=compute_dtype)
    tpred = Predictor(cfg, from_jax_variables(cfg, variables), batch_buckets=(2, 4),
                      device="cpu")
    return jpred, tpred


@pytest.mark.parametrize("compute_dtype,atol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_predictor_matches_jax(compute_dtype, atol):
    """Requests of 1, 3, 4 and 7 rows: padded into buckets 2 and 4, and 7
    chunked as 4 + 3. fp32 probabilities within 1e-5; bf16 within 3e-2 (the
    two packages round at different places)."""
    jpred, tpred = predictors(compute_dtype)
    if compute_dtype == "bfloat16":
        assert tpred.model.model.text_embeddings.word_embeddings.weight.dtype == torch.bfloat16
        assert tpred.model.model.vision_pre_layernorm.weight.dtype == torch.float32
    b = batch(tpred.cfg, 7, seed=11)
    for n in (1, 3, 4, 7):
        args = [b[k][:n] for k in ("input_ids", "attention_mask", "token_type_ids", "pixel_values")]
        ref, got = jpred.predict(*args), tpred.predict(*args)
        assert got["probs"].shape == (n, 3) and got["label"].shape == (n,)
        assert got["probs"].dtype == np.float32
        np.testing.assert_allclose(got["probs"].sum(-1), 1.0, atol=1e-5)
        np.testing.assert_allclose(got["probs"], np.asarray(ref["probs"], np.float32),
                                   atol=atol, rtol=0)


def test_predictor_rejects_long_sequences_and_seq_buckets():
    _, tpred = predictors("float32")
    b = batch(tpred.cfg, 1)
    too_long = np.zeros((1, tpred.seq_len + 1), np.int32)
    with pytest.raises(ValueError, match="exceeds the configured seq bucket"):
        tpred.predict(too_long, too_long, too_long, b["pixel_values"])
    with pytest.raises(ValueError, match="multiple seq_buckets"):
        Predictor(tpred.cfg, tpred.model, seq_buckets=(8, 16), device="cpu")


def test_predictor_warmup_and_bucket_rows_are_independent():
    """A row's answer does not depend on what else shares its bucket."""
    _, tpred = predictors("float32")
    tpred.warmup()
    b = batch(tpred.cfg, 4, seed=3)
    args = [b[k] for k in ("input_ids", "attention_mask", "token_type_ids", "pixel_values")]
    full = tpred.predict(*args)
    one = tpred.predict(*[a[:1] for a in args])
    np.testing.assert_allclose(one["probs"][0], full["probs"][0], atol=1e-6)
