"""Weight-only int8 of the port (``d2r_tpu_torch/quant.py``) against the JAX
package's ``d2r_tpu/quant.py``, on the CPU.

One seeded Flax tree (``tiny_test_config``, fp32) goes into both packages.
Codes and scales must equal JAX's bit for bit (the port's weights are the
transposed layouts), the quantized weights must be exactly the leaves that
``quantize_params`` picks, dequantized weights equal JAX's bit for bit in
fp32 and bf16 (int8 codes are exact in bf16), the stored bytes equal, and
``Predictor(quantize="int8")`` probabilities within 1e-4 of JAX's in fp32.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from d2r_tpu import quant as jquant
from d2r_tpu.config import tiny_test_config as jax_tiny_config
from d2r_tpu.serve import Predictor as JaxPredictor
from d2r_tpu_torch import quant
from d2r_tpu_torch.config import tiny_test_config
from d2r_tpu_torch.serve import Predictor
from d2r_tpu_torch.weights import _translate, from_jax_variables
from tests.test_torch_model import batch
from tests.test_torch_serve import KEYS, tiny_tree


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("shape", [(64, 48), (4, 3), (7, 2, 5), (4, 4, 3, 8)],
                         ids=["dense", "degenerate", "qkv", "conv"])
def test_quantize_array_matches_jax_on_transposed_weights(shape):
    """Flax puts output channels last, the port first. The (4, 3) case has a
    column of 1e-20 (the 1e-12 scale floor) and a column of amax 127."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal(shape).astype(np.float32)
    if shape == (4, 3):
        w[:, 1] = [127, 0, 0, 0]
        w[:, 2] = 1e-20
    ref = jquant.quantize_array(w)
    # the port's layout: output channels first, the rest in Flax's order reversed
    perm = tuple(range(w.ndim))[::-1]
    q, scale = quant.quantize_array(torch.from_numpy(np.ascontiguousarray(w.transpose(perm))))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy().transpose(perm), np.asarray(ref.q))
    np.testing.assert_array_equal(scale.numpy().transpose(perm), np.asarray(ref.scale))


@functools.lru_cache(maxsize=None)
def _tree():
    return tiny_tree(seed=3)


def _quantized_port(compute_dtype="float32"):
    cfg = tiny_test_config(compute_dtype=compute_dtype)
    return quant.quantize_model(from_jax_variables(cfg, _tree()))


def _jax_quantized():
    return flatten_dict(jquant.quantize_params(_tree()["params"]),
                        is_leaf=lambda _, v: isinstance(v, jquant.QuantLeaf))


def test_quantized_leaves_are_quantize_params_leaves():
    model = _quantized_port()
    got = {name.replace(".", "/") + "/kernel" for name, m in model.named_modules()
           if isinstance(m, quant.Int8Weight)}
    want = {"/".join(p) for p, v in _jax_quantized().items()
            if isinstance(v, jquant.QuantLeaf)}
    assert got == want and len(got) > 10
    for name, m in model.named_modules():
        if isinstance(m, quant.Int8Weight):
            assert "weight" not in m._parameters and m.weight_q.dtype == torch.int8


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_dequantized_weights_equal_jax(compute_dtype):
    """The port's at-use weight against ``QuantLeaf.dequant`` in the same
    compute type, in the port's layout: equal bit for bit."""
    model = _quantized_port(compute_dtype)
    jdtype = getattr(jnp, compute_dtype)
    leaves = _jax_quantized()
    n = 0
    for name, m in model.named_modules():
        if not isinstance(m, quant.Int8Weight):
            continue
        ref = np.asarray(leaves[tuple(name.split(".")) + ("kernel",)].dequant(jdtype))
        _, ref = _translate(m, "kernel", ref.astype(np.float32))
        got = m.weight
        assert got.dtype == getattr(torch, compute_dtype)
        np.testing.assert_array_equal(got.float().numpy(), ref)
        n += 1
    assert n > 10


@pytest.mark.parametrize("quantized", [False, True])
def test_quantized_bytes_equal_jax(quantized):
    params = _tree()["params"]
    cfg = tiny_test_config()
    model = from_jax_variables(cfg, _tree())
    if quantized:
        params = jquant.quantize_params(params)
        quant.quantize_model(model)
    assert quant.quantized_bytes(model) == jquant.quantized_bytes(params)


def test_int8_predictor_matches_jax_int8_predictor():
    """fp32, requests of 1 and 3 rows in buckets 2 and 4: probabilities
    within 1e-4 of the JAX ``Predictor(quantize="int8")``; labels agree
    with the unquantized port wherever its top probability leads by more
    than 0.1 (``tests/test_quant.py``'s rule)."""
    jcfg, cfg = jax_tiny_config(), tiny_test_config()
    jpred = JaxPredictor(jcfg, _tree(), batch_buckets=(2, 4), quantize="int8")
    tpred = Predictor(cfg, from_jax_variables(cfg, _tree()), batch_buckets=(2, 4),
                      device="cpu", quantize="int8")
    dense = Predictor(cfg, from_jax_variables(cfg, _tree()), batch_buckets=(2, 4),
                      device="cpu")
    b = batch(cfg, 3, seed=4)
    for n in (1, 3):
        args = [b[k][:n] for k in KEYS]
        ref, got = jpred.predict(*args), tpred.predict(*args)
        np.testing.assert_allclose(got["probs"], np.asarray(ref["probs"], np.float32),
                                   atol=1e-4, rtol=0)
        base = dense.predict(*args)
        top2 = np.sort(base["probs"], axis=-1)
        decisive = (top2[:, -1] - top2[:, -2]) > 0.1
        np.testing.assert_array_equal(got["label"][decisive], base["label"][decisive])


def test_int8_predictor_quantizes_before_the_compute_cast():
    """In bf16 the quantized weights keep their int8 codes and fp32 scales,
    the embeddings are cast to bf16, and the forward runs."""
    cfg = tiny_test_config(compute_dtype="bfloat16")
    pred = Predictor(cfg, from_jax_variables(cfg, _tree()), batch_buckets=(2,),
                     device="cpu", quantize="int8")
    inner = pred.model.model
    assert inner.text_embeddings.word_embeddings.weight.dtype == torch.bfloat16
    qkv = inner.encoder_text_layers.layer_0.attention_self.qkv
    assert isinstance(qkv, quant.Int8Weight) and qkv.weight_q.dtype == torch.int8
    assert qkv.weight_scale.dtype == torch.float32 and qkv.weight.dtype == torch.bfloat16
    b = batch(cfg, 2, seed=1)
    out = pred.predict(*[b[k] for k in KEYS])
    assert np.isfinite(out["probs"]).all() and out["probs"].shape == (2, 3)


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="only 'int8'"):
        quant.quantize_model(torch.nn.Linear(2, 2), mode="int4")
