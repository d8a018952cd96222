"""The port's attention (d2r_tpu_torch/ops) against the JAX package's, on
the CPU, in fp32.

The JAX side runs its short-sequence Pallas kernel in interpret mode, as
tests/test_fused_attention_small.py does, and its einsum dispatch path. The
port's CPU path is the kernel's plain version. Shapes are small analogues of
the model's three site geometries: BERT (padding bias), CLIP (ragged
L = S = 10, like 50) and IMRC (D = 24, a head width that is not a power of
two, like 48). Tolerance: atol 1e-5 (same fp32 math, different summation
order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2r_tpu.ops import attention as jattn
from d2r_tpu.ops.kernels.fused_attention import fused_attention_small as jfused
from d2r_tpu_torch.ops import attention as tattn
from d2r_tpu_torch.ops.kernels import fused_attention as tfa


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: beside the suite's other workers torch's
    default threads contend, and the tiny steps run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

ATOL = 1e-5

# name: (B, L, S, H, D, key bias)
GEOMETRIES = {
    "bert": (2, 16, 16, 3, 16, True),
    "clip_ragged": (3, 10, 10, 3, 16, False),
    "imrc_odd_width": (3, 10, 10, 4, 24, False),
    "cross_lengths_bias": (2, 12, 9, 2, 8, True),
}


def _inputs(b, l, s, h, d, with_bias, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, l, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, h, d)).astype(np.float32)
    v = rng.standard_normal((b, s, h, d)).astype(np.float32)
    bias = None
    if with_bias:
        lengths = rng.integers(s // 2, s + 1, size=(b, 1))
        mask = (np.arange(s)[None, :] < lengths).astype(np.int32)
        bias = np.array(jattn.padding_key_bias(jnp.asarray(mask)))
    return q, k, v, bias


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_fused_attention_small_matches_jax_interpret(geom):
    q, k, v, bias = _inputs(*GEOMETRIES[geom])
    scale = q.shape[-1] ** -0.5
    ref = jfused(_j(q), _j(k), _j(v), _j(bias), scale, interpret=True)
    out = tfa.fused_attention_small(_t(q), _t(k), _t(v), _t(bias), scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_dot_product_attention_matches_jax(geom):
    q, k, v, bias = _inputs(*GEOMETRIES[geom], seed=1)
    ref = jattn.dot_product_attention(_j(q), _j(k), _j(v), key_bias=_j(bias))
    out = tattn.dot_product_attention(_t(q), _t(k), _t(v), key_bias=_t(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


@pytest.mark.parametrize("l", [160, 256])
def test_long_sequences_take_plain_math_on_cpu(l):
    """Above K1's 128 the CPU runs K3's plain version (the scale before the
    product, p in fp32), which matches JAX's XLA path in fp32; K1 is not
    used."""
    q, k, v, bias = _inputs(1, l, l, 2, 8, True, seed=2)
    before = tfa.fused_attention_small.launches
    ref = jattn.dot_product_attention(_j(q), _j(k), _j(v), key_bias=_j(bias))
    out = tattn.dot_product_attention(_t(q), _t(k), _t(v), key_bias=_t(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    assert tfa.fused_attention_small.launches == before


def test_strided_qkv_views_match_contiguous():
    """q, k, v as views of one (B, L, 3, H*D) projection, as QKVDense returns
    them: same result as contiguous copies."""
    rng = np.random.default_rng(3)
    b, l, h, d = 2, 10, 4, 24
    qkv = torch.from_numpy(rng.standard_normal((b, l, 3, h * d)).astype(np.float32))
    q, k, v = (tattn.split_heads(qkv[:, :, i], h) for i in range(3))
    assert q.stride(1) == 3 * h * d and not q.is_contiguous()
    out = tfa.fused_attention_small(q, k, v, None, d ** -0.5)
    ref = tfa.fused_attention_small(q.contiguous(), k.contiguous(), v.contiguous(),
                                    None, d ** -0.5)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def test_padding_key_bias_and_heads_match_jax():
    mask = np.array([[1, 1, 0, 0], [1, 0.7, 1, 0]], np.float32)  # int cast: 0.7 -> 0
    np.testing.assert_array_equal(
        tattn.padding_key_bias(torch.from_numpy(mask)).numpy(),
        np.asarray(jattn.padding_key_bias(jnp.asarray(mask))))
    x = np.arange(2 * 3 * 12, dtype=np.float32).reshape(2, 3, 12)
    split = tattn.split_heads(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(split.numpy(), np.asarray(jattn.split_heads(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(tattn.merge_heads(split).numpy(), x)


def test_plain_dropout_is_seeded_and_mean_preserving():
    """The plain version's dropout (the kernels' Philox bits): post-softmax,
    scaled by 1/(1-rate), bits fixed by the seed. With v = 1 every output is
    a row sum of dropped-out probabilities, whose mean is 1."""
    q, k, v, bias = _inputs(8, 16, 16, 2, 8, True, seed=4)
    q, k, bias = _t(q), _t(k), _t(bias)
    v = torch.ones(8, 16, 2, 8)
    run = lambda seed: tfa.fused_attention_small(q, k, v, bias, 8 ** -0.5,
                                                 dropout_rate=0.5, dropout_seed=seed)
    o1, o2, o3 = run(1234), run(1234), run(999)
    assert torch.equal(o1, o2)
    assert not torch.equal(o1, o3)
    assert abs(o1.mean().item() - 1.0) < 0.1


def test_gate():
    q = torch.zeros(1, 64, 12, 64)
    assert tfa.supports_fused_small(q, torch.zeros(1, 50, 12, 64))
    assert tfa.supports_fused_small(torch.zeros(1, 64, 16, 48), torch.zeros(1, 64, 16, 48))
    assert not tfa.supports_fused_small(q, torch.zeros(1, 129, 12, 64))
    assert not tfa.supports_fused_small(torch.zeros(1, 8, 1, 136), torch.zeros(1, 8, 1, 136))
