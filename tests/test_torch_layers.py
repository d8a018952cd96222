"""The port's norms, losses and building-block layers against the JAX
package's, on the CPU in fp32. Inputs are made with numpy from a seed; each
Flax module's initialised variables are loaded into its port counterpart
with ``d2r_tpu_torch.weights.load_jax_variables``. Tolerance: atol 1e-5
(1e-6 for the elementwise ops), the same fp32 math in another order.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2r_tpu.models import layers as jl
from d2r_tpu.models.router import Router as JRouter
from d2r_tpu.ops import losses as jloss
from d2r_tpu.ops import norms as jnorms
from d2r_tpu_torch.models import layers as tl
from d2r_tpu_torch.models.router import Router as TRouter
from d2r_tpu_torch.ops import losses as tloss
from d2r_tpu_torch.ops import norms as tnorms
from d2r_tpu_torch.weights import load_jax_variables


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: beside the suite's other workers torch's
    default threads contend, and the tiny steps run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _x(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(port, ref, atol=1e-5):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


def _load(port_module, variables):
    return load_jax_variables(port_module, jax.tree_util.tree_map(np.asarray, variables))


def _init(module, *args, **kw):
    return module.init(jax.random.key(0), *[jnp.asarray(a) for a in args], **kw)


# ---- norms -----------------------------------------------------------------

def test_norms_match_jax():
    x = _x(4, 5, 8)
    x[0, 0] = 0.0                                 # a zero row: eps placement shows
    t = torch.from_numpy(x)
    _close(tnorms.l2norm(t), jnorms.l2norm(jnp.asarray(x)), 1e-6)
    _close(tnorms.l1norm(t, dim=1), jnorms.l1norm(jnp.asarray(x), axis=1), 1e-6)
    _close(tnorms.torch_style_normalize(t), jnorms.torch_style_normalize(jnp.asarray(x)), 1e-6)


# ---- losses ----------------------------------------------------------------

def test_kl_div_batchmean_matches_jax():
    p = np.abs(_x(4, 6, seed=1))
    p /= p.sum(-1, keepdims=True)
    p[0, 0] = 0.0                                 # 0 * log(0) = 0
    logq = np.log(np.full((4, 6), 1 / 6, np.float32))
    _close(tloss.kl_div_batchmean(torch.from_numpy(logq), torch.from_numpy(p)),
           jloss.kl_div_batchmean(jnp.asarray(logq), jnp.asarray(p)))


@pytest.mark.parametrize("case", ["plain", "valid", "all_valid", "underflow"])
def test_js_div_matches_jax(case):
    a, b = _x(5, 5, seed=2), _x(5, 5, seed=3)
    valid = None
    if case == "valid":
        valid = np.array([1, 1, 0, 1, 0], bool)
    if case == "all_valid":
        valid = np.ones(5, bool)
    if case == "underflow":                       # rows with exact zeros in p and q
        a, b = a * 300.0, b * 300.0
    port = tloss.js_div(torch.from_numpy(a), torch.from_numpy(b),
                        valid=None if valid is None else torch.from_numpy(valid))
    ref = jloss.js_div(jnp.asarray(a), jnp.asarray(b),
                       valid=None if valid is None else jnp.asarray(valid))
    assert np.isfinite(float(ref))
    _close(port, ref)


def test_path_consistency_and_cross_entropy_match_jax():
    mats = [_x(4, 4, seed=s) for s in range(4)]
    valid = np.array([1, 0, 1, 1], bool)
    _close(tloss.path_consistency_loss(*map(torch.from_numpy, mats), 0.1, 0.2,
                                       valid=torch.from_numpy(valid)),
           jloss.path_consistency_loss(*map(jnp.asarray, mats), 0.1, 0.2,
                                       valid=jnp.asarray(valid)))
    logits, labels = _x(4, 3, seed=5), np.array([0, 2, 1, 2], np.int32)
    for v in (None, valid):
        _close(tloss.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                        None if v is None else torch.from_numpy(v)),
               jloss.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                        None if v is None else jnp.asarray(v)))


# ---- layers ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["gelu", "gelu_new", "quick_gelu", "relu", "tanh"])
def test_activations_match_jax(name):
    x = _x(3, 17, scale=3.0)
    _close(tl.ACT2FN[name](torch.from_numpy(x)), jl.ACT2FN[name](jnp.asarray(x)), 1e-6)


@pytest.mark.parametrize("bias_init_value", [None, 1.5])
def test_torch_linear_matches_jax(bias_init_value):
    x = _x(2, 5, 12)
    jm = jl.TorchLinear(7, bias_init_value=bias_init_value)
    v = _init(jm, x)
    tm = _load(tl.TorchLinear(12, 7, bias_init_value=bias_init_value), v)
    _close(tm(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x)))
    if bias_init_value is not None:
        np.testing.assert_array_equal(tm.bias.detach().numpy(), 1.5)


def test_qkv_dense_matches_jax():
    x = _x(2, 5, 12)
    jm = jl.QKVDense(8)
    v = _init(jm, x)
    tm = _load(tl.QKVDense(12, 8), v)
    for port, ref in zip(tm(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x))):
        assert port.stride(-2) == 3 * 8           # views of one product
        _close(port, ref)


def test_bert_pooler_matches_jax():
    x = _x(3, 4, 16)
    jm = jl.BertPooler(16)
    v = _init(jm, x)
    _close(_load(tl.BertPooler(16), v)(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x)))


def test_layer_norm_matches_flax():
    x = _x(2, 6, 16, scale=4.0) + 3.0
    jm = fnn.LayerNorm(epsilon=1e-12)
    v = {"params": {"scale": _x(16, seed=1), "bias": _x(16, seed=2)}}
    _close(_load(tl.LayerNorm(16, 1e-12), v)(torch.from_numpy(x)),
           jm.apply(v, jnp.asarray(x)))


def test_batch_norm_eval_matches_jax():
    x = _x(3, 7, 1)
    jm = jl.TorchBatchNorm(1)
    v = {"params": {"scale": np.array([1.3], np.float32), "bias": np.array([-0.2], np.float32)},
         "batch_stats": {"mean": np.array([0.4], np.float32), "var": np.array([2.5], np.float32)}}
    _close(_load(tl.TorchBatchNorm(1), v).eval()(torch.from_numpy(x)),
           jm.apply(v, jnp.asarray(x), use_running_average=True))


def test_router_matches_jax():
    x = _x(3, 9, 16)
    jm = JRouter(num_out_path=6, hid=8)
    v = _init(jm, x)
    tm = _load(TRouter(16, 6, 8), v)
    _close(tm(torch.from_numpy(x)), jm.apply(v, jnp.asarray(x)))


def test_init_weights_is_seeded_and_in_family():
    a = tl.init_weights(TRouter(16, 6, 8), torch.Generator().manual_seed(3))
    b = tl.init_weights(TRouter(16, 6, 8), torch.Generator().manual_seed(3))
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    assert a.mlp_0.weight.abs().max() <= 16 ** -0.5
    assert torch.all(a.mlp_2.bias == 1.5)
