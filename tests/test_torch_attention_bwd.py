"""The port's fused-attention backward (K2's plain version) and dropout bits,
on the CPU, in fp32.

The JAX side differentiates ``d2r_tpu``'s ``fused_attention_small`` with
its Pallas kernels in interpret mode, as
``tests/test_fused_attention_small.py`` does; both sides take the same numpy
inputs and the same numpy cotangent. Tolerances: atol 2e-5 / rtol 1e-4 on
dq, dk, dv and dbias (the JAX test's, same fp32 math in another summation
order).

Dropout bits cannot match JAX's, so the port's Philox bits are tested by
their properties and by Random123's known-answer vectors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

ATOL, RTOL = 2e-5, 1e-4

# name: (B, L, S, H, D, key bias); odd batches and lengths
GEOMETRIES = {
    "odd_bias": (3, 7, 9, 2, 8, True),
    "odd_no_bias": (3, 7, 9, 2, 8, False),
    "bert_like": (2, 16, 16, 3, 16, True),
    "imrc_like": (1, 10, 10, 4, 24, False),
}


def _inputs(b, l, s, h, d, with_bias, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, l, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, h, d)).astype(np.float32)
    v = rng.standard_normal((b, s, h, d)).astype(np.float32)
    g = rng.standard_normal((b, l, h, d)).astype(np.float32)
    bias = None
    if with_bias:
        lengths = rng.integers(s // 2, s + 1, size=(b, 1))
        bias = ((1.0 - (np.arange(s)[None, :] < lengths)) * -10000.0
                + 0.5 * rng.standard_normal((b, s))).astype(np.float32)
    return q, k, v, bias, g


def _jax_grads(q, k, v, bias, g):
    scale = q.shape[-1] ** -0.5
    args = [jnp.asarray(x) for x in (q, k, v)]
    if bias is None:
        f = lambda q_, k_, v_: jfused(q_, k_, v_, None, scale, interpret=True)
    else:
        args.append(jnp.asarray(bias))
        f = lambda q_, k_, v_, b_: jfused(q_, k_, v_, b_, scale, interpret=True)
    _, vjp = jax.vjp(f, *args)
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _close(got, ref, name):
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=ATOL, rtol=RTOL,
                               err_msg=f"d{name}")


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_plain_backward_matches_jax_interpret(geom):
    q, k, v, bias, g = _inputs(*GEOMETRIES[geom])
    ref = _jax_grads(q, k, v, bias, g)
    t = lambda x: None if x is None else torch.from_numpy(x)
    got = tfa.fused_attention_small_bwd_plain(t(q), t(k), t(v), t(bias), t(g),
                                              q.shape[-1] ** -0.5)
    for a, r, name in zip(got, ref, "qkvb"):
        _close(a, r, name)
    assert got[3].dtype == torch.float32 and got[3].shape == (q.shape[0], k.shape[1])


@pytest.mark.parametrize("geom", ["odd_bias", "imrc_like"])
def test_autograd_function_matches_jax_interpret(geom):
    """Autograd through ``fused_attention_small`` on CPU tensors: the
    ``FusedAttention`` function, plain forward and plain backward."""
    q, k, v, bias, g = _inputs(*GEOMETRIES[geom], seed=1)
    ref = _jax_grads(q, k, v, bias, g)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    if bias is not None:
        leaves.append(torch.from_numpy(bias).requires_grad_())
    out = tfa.fused_attention_small(*leaves[:3], leaves[3] if bias is not None else None,
                                    q.shape[-1] ** -0.5)
    out.backward(torch.from_numpy(g))
    for leaf, r, name in zip(leaves, ref, "qkvb"):
        _close(leaf.grad, r, name)


@pytest.mark.parametrize("geom", ["bert_like", "odd_bias"])
def test_bf16_rounding_matches_jax_interpret(geom):
    """The yardstick of bf16 K2's share check on the card: in bf16 the
    plain version keeps the JAX kernel's rounding points (pd rounded before
    dv, d(logits) before dq and dk, ``fused_attention.py:136, :151``), so
    at most 1% of its dq, dk, dv differ from the interpret-mode kernel's at
    all, while the control that leaves both unrounded differs in at least
    10% of each. The max error alone cannot tell the two apart."""
    q, k, v, bias, g = _inputs(*GEOMETRIES[geom], seed=3)
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)
    qt, kt, vt, gt = (bf(x) for x in (q, k, v, g))
    scale = q.shape[-1] ** -0.5
    jq, jk, jv, jg = (jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (qt, kt, vt, gt))
    f = lambda q_, k_, v_, b_: jfused(q_, k_, v_, b_, scale, interpret=True)
    _, vjp = jax.vjp(f, jq, jk, jv, jnp.asarray(bias))
    ref = [torch.from_numpy(np.array(x.astype(jnp.float32))) for x in vjp(jg)]
    got = tfa.fused_attention_small_bwd_plain(qt, kt, vt, torch.from_numpy(bias), gt, scale)
    # on fp32 copies of the inputs nothing is rounded before the products
    control = tfa.fused_attention_small_bwd_plain(qt.float(), kt.float(), vt.float(),
                                                  torch.from_numpy(bias), gt.float(), scale)
    for name, a, c, r in zip(("dq", "dk", "dv"), got, control, ref):
        c = c.to(torch.bfloat16)
        assert a.dtype == torch.bfloat16
        share = (a.float() != r).float().mean().item()
        control_share = (c.float() != r).float().mean().item()
        assert share <= 0.01 and control_share >= 0.10, (name, share, control_share)
    _close(got[3], ref[3], "b")


def test_bwd_wrapper_routes_cpu_to_plain_and_drops_dbias_on_request():
    q, k, v, bias, g = (torch.from_numpy(x) for x in _inputs(*GEOMETRIES["odd_bias"], seed=2))
    before = tfa.fused_attention_small_bwd.launches
    full = tfa.fused_attention_small_bwd(q, k, v, bias, g, 0.3)
    part = tfa.fused_attention_small_bwd(q, k, v, bias, g, 0.3, need_dbias=False)
    ref = tfa.fused_attention_small_bwd_plain(q, k, v, bias, g, 0.3)
    assert part[3] is None and tfa.fused_attention_small_bwd.launches == before
    for a, b_, r in zip(full, part[:3], ref):
        assert torch.equal(a, r) and torch.equal(b_, r)
    assert torch.equal(full[3], ref[3])


# ---- Philox dropout bits ------------------------------------------------

# Random123's known-answer vectors for philox4x32-10: counter, key, output
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,expected", PHILOX_KAT)
def test_philox_known_answers(counter, key, expected):
    assert tuple(int(w) for w in tfa.philox4x32_10(counter, key)) == expected


def test_keep_mask_is_philox_at_the_documented_counter():
    """Element (b, h, i, j) is word j % 4 of Philox at (j // 4, i, h, b)."""
    seed = 0x1234_5678_9ABC_DEF0
    mask = tfa.dropout_keep_mask(seed, 2, 3, 5, 11, 0.3)
    t = tfa.keep_threshold(0.3)
    for b, h, i, j in ((0, 0, 0, 0), (1, 2, 4, 10), (1, 0, 3, 7), (0, 1, 2, 5)):
        words = tfa.philox4x32_10((j // 4, i, h, b), (seed & 0xFFFFFFFF, seed >> 32))
        assert bool(mask[b, h, i, j]) == (int(words[j % 4]) >= t)


def test_keep_mask_is_seeded_and_uses_all_64_seed_bits():
    m = lambda seed: tfa.dropout_keep_mask(seed, 2, 3, 16, 16, 0.5)
    assert torch.equal(m(77), m(77))
    assert not torch.equal(m(77), m(78))
    assert not torch.equal(m(77), m(77 + 2 ** 32))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_share_is_within_three_sigma(rate):
    mask = tfa.dropout_keep_mask(2024, 8, 12, 64, 64, rate)
    n = mask.numel()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(mask.float().mean().item() - (1 - rate)) <= 3 * sigma


def test_keep_mask_does_not_depend_on_batch_or_shape():
    """A row's bits are the same inside a larger batch, more heads or more
    keys: the counter is (j // 4, i, h, b), not a position in a grid."""
    small = tfa.dropout_keep_mask(5, 2, 3, 7, 10, 0.25)
    big = tfa.dropout_keep_mask(5, 6, 4, 9, 13, 0.25)
    assert torch.equal(small, big[:2, :3, :7, :10])


def test_dropout_v_ones_identity_sum_dv_equals_sum_out():
    """With v = 1 every output element is a row sum of dropped-out
    probabilities, and sum(dv) under d(sum out) sums the same pd: equal only
    if forward and backward drew the same mask."""
    q, k, _, bias, _ = (None if x is None else torch.from_numpy(x)
                        for x in _inputs(4, 16, 16, 2, 8, True, seed=3))
    v = torch.ones(4, 16, 2, 8, requires_grad=True)
    out = tfa.fused_attention_small(q, k, v, bias, 8 ** -0.5, dropout_rate=0.5,
                                    dropout_seed=1234)
    out.sum().backward()
    np.testing.assert_allclose(v.grad.sum().item(), out.sum().item(), rtol=1e-5)
    assert abs(out.mean().item() - 1.0) < 0.1
    nodrop = tfa.fused_attention_small(q, k, v.detach(), bias, 8 ** -0.5)
    assert not torch.equal(out.detach(), nodrop)


def test_dropout_backward_matches_autograd_through_plain_forward():
    """K2's plain version with dropout against autograd through K1's plain
    version with the same seed."""
    q, k, v, bias, g = (torch.from_numpy(x) for x in _inputs(3, 7, 9, 2, 8, True, seed=4))
    leaves = [x.clone().requires_grad_() for x in (q, k, v, bias)]
    out = tfa.fused_attention_small_plain(*leaves, 0.35, dropout_rate=0.2, dropout_seed=99)
    ref = torch.autograd.grad(out, leaves, g)
    got = tfa.fused_attention_small_bwd_plain(q, k, v, bias, g, 0.35, 0.2, 99)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=ATOL, rtol=RTOL)


def test_attention_dispatch_drops_out_only_with_a_seed():
    q, k, v, bias, _ = (torch.from_numpy(x) for x in _inputs(2, 8, 8, 2, 8, True, seed=5))
    plain = tattn.dot_product_attention(q, k, v, key_bias=bias)
    assert torch.equal(tattn.dot_product_attention(q, k, v, key_bias=bias,
                                                   dropout_rate=0.3), plain)
    dropped = tattn.dot_product_attention(q, k, v, key_bias=bias, dropout_rate=0.3,
                                          dropout_seed=8)
    assert torch.equal(dropped, tfa.fused_attention_small_plain(q, k, v, bias, 8 ** -0.5,
                                                                0.3, 8))
    assert not torch.equal(dropped, plain)


@pytest.mark.parametrize("rate,seed", [(1.0, 1), (-0.1, 1), (0.1, None), (0.1, -3)])
def test_bad_dropout_arguments_raise(rate, seed):
    x = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError):
        tfa.fused_attention_small(x, x, x, None, 1.0, dropout_rate=rate, dropout_seed=seed)
