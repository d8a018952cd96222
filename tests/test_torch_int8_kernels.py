"""The plain versions of the port's int8 kernels against the JAX package, on
the CPU: the quantize and rescale passes of int8 training
(``d2r_tpu_torch/ops/kernels/quantize.py``, kernels ``csrc/quantize.cu``)
and the W8A16 product of int8 serving (``ops/kernels/w8a16.py``, kernel
``csrc/w8a16_linear.cu``). Inputs are made with numpy from a seed.

- quantize, by rows and by columns (codes transposed, the layout
  ``torch._int_mm`` takes), fp32 and bf16: codes and scales equal
  ``d2r_tpu.ops.qdot._quantize`` bit for bit, on rows and columns that are
  all zero, hold exact .5 ties (scale 1), reach the +-127 clamp, and are
  not a multiple of 16 long;
- rescale: equal to ``d2r_tpu.ops.qdot._int8_matmul`` bit for bit (the
  forward's row-then-column order) and to its dW epilogue (column then
  row), into fp32 and bf16;
- W8A16: within 1e-5 (fp32) and 1e-2 (bf16) of max(1, max |ref|) of
  ``QuantLeaf.dequant`` + ``jnp.dot`` at the Linear, fused-QKV (one scale a
  hidden unit for q, k and v) and patch-conv (``lax.conv`` with stride =
  kernel) layouts; the dequantized weight bit for bit. The sums run in
  another order in each framework; bf16 rounds once at the end, so an
  output may land one bf16 ulp (2^-8 of its size) apart;
- the split-K choice of the kernel's wrapper covers K exactly.

The card holds each kernel against these plain versions
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2r_tpu import quant as jquant
from d2r_tpu.ops import qdot as jqdot
from d2r_tpu_torch import quant
from d2r_tpu_torch.models.layers import QKVDense, TorchLinear
from d2r_tpu_torch.models.vit import PatchConv
from d2r_tpu_torch.ops import qdot
from d2r_tpu_torch.ops.kernels import quantize as qk
from d2r_tpu_torch.ops.kernels import w8a16

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
W8A16_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _as_torch(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return t.float().numpy() if t.is_floating_point() else t.numpy()


def _adversarial(shape, seed: int) -> np.ndarray:
    """Normal values with, along the rows and along the columns: an all-zero
    slice, a slice of exact .5 ties at scale 1 (amax 127), and each slice's
    amax and its negation (the +-127 codes)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    r, c = shape
    x[0] = 0.0
    x[:, 0] = 0.0
    ties = np.array([127.0, 0.5, -0.5, 1.5, 2.5, -3.5, 126.5, -127.0], np.float32)
    x[1, 1:] = np.resize(ties, c - 1)
    x[1:, 1] = np.resize(ties, r - 1)
    x[2, 2], x[3, 2] = 7.25, -7.25
    return x


@pytest.mark.parametrize("shape", [(64, 48), (9, 37)], ids=["k48", "k37"])
@pytest.mark.parametrize("axis", ["rows", "cols"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantize_matches_jax(dtype, axis, shape):
    jdt, tdt = DTYPES[dtype]
    x = _adversarial(shape, seed=sum(shape))
    xt = _as_torch(x, tdt)
    jq, js = jqdot._quantize(jnp.asarray(x).astype(jdt), -1 if axis == "rows" else 0)
    if axis == "rows":
        got = [qk.quantize_rows_plain(xt), qk.quantize_rows(xt), qdot.quantize_rows(xt),
               qk.quantize_rows(xt, qk.row_amax(xt))]
        want_q, want_s = np.asarray(jq), np.asarray(js)
    else:
        got = [qk.quantize_cols_plain(xt, qk.col_amax_plain(xt)), qdot.quantize_cols(xt)]
        want_q, want_s = np.ascontiguousarray(np.asarray(jq).T), np.asarray(js)
    assert (want_q == 127).any() and (want_q == -127).any()
    for q, s in got:
        assert q.dtype == torch.int8 and s.dtype == torch.float32 and q.is_contiguous()
        np.testing.assert_array_equal(q.numpy(), want_q)
        np.testing.assert_array_equal(s.numpy(), want_s)
    # the all-zero row or column: codes 0 (its scale 1/127 is JAX's above)
    assert not got[0][0][0].numpy().any()


@pytest.mark.parametrize("layout", ["forward", "dw"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rescale_matches_jax_int8_matmul(dtype, layout):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    m, k, n = 33, 40, 24
    x = rng.standard_normal((m, k)).astype(np.float32)
    if layout == "forward":
        # JAX: x (M, K) @ w (K, N), scales per row of x then per column of w
        w = rng.standard_normal((k, n)).astype(np.float32)
        want = jqdot._int8_matmul(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt))
        xt, wt = _as_torch(x, tdt), _as_torch(w.T, tdt)
        qx, sx = qdot.quantize_rows(xt)
        qw, sw = qdot.quantize_rows(wt)
        y = qdot.int_mm(qx, qw)
        got = qk.rescale(y, sx, sw.t(), tdt)
        assert torch.equal(got, qk.rescale_plain(y, sx, sw.t(), tdt))
        np.testing.assert_array_equal(_as_numpy(got), np.asarray(want.astype(jdt), np.float32))
        return
    # JAX's int8_all dW: (K, N) = qx^T qg, times sx^T (per k) then sg (per n);
    # the port's (N, K) is its transpose: per column k first, then per row n
    g = rng.standard_normal((m, n)).astype(np.float32)
    xj, gj = jnp.asarray(x).astype(jdt), jnp.asarray(g).astype(jdt)
    qxj, sxj = jqdot._quantize(xj, 0)
    qgj, sgj = jqdot._quantize(gj, 0)
    dw = jax.lax.dot_general(qxj, qgj, (((0,), (0,)), ((), ())),
                             preferred_element_type=jnp.int32)
    want = (dw.astype(jnp.float32) * sxj.T * sgj[0]).astype(jdt)
    qx, sx = qdot.quantize_cols(_as_torch(x, tdt))
    qg, sg = qdot.quantize_cols(_as_torch(g, tdt))
    got = qk.rescale(qdot.int_mm(qg, qx), sx, sg.t(), tdt)
    np.testing.assert_array_equal(_as_numpy(got), np.asarray(want, np.float32).T)


def _close(got: torch.Tensor, want: np.ndarray, dtype: str) -> None:
    got = _as_numpy(got)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= W8A16_TOL[dtype], err


@pytest.mark.parametrize("layout", ["linear", "qkv", "patch_conv"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_w8a16_plain_matches_jax_dequant_dot(dtype, layout):
    """The port's plain W8A16 on the JAX package's codes and scales (in the
    port's layouts) against ``QuantLeaf.dequant`` + ``jnp.dot`` / ``lax.conv``."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(11)
    k, hidden = 40, 12
    if layout == "patch_conv":
        b, c, p, out = 2, 3, 4, 8
        img = rng.standard_normal((b, c, 3 * p, 2 * p)).astype(np.float32)
        kernel = rng.standard_normal((p, p, c, out)).astype(np.float32) * 0.3   # HWIO
        leaf = jquant.quantize_array(kernel)
        want = jax.lax.conv_general_dilated(
            jnp.asarray(img.transpose(0, 2, 3, 1)).astype(jdt), leaf.dequant(jdt), (p, p),
            "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.float32).astype(jdt)             # (B, h, w, out)
        conv = PatchConv(c, out, p, dtype=tdt)
        conv.weight.data = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
        quant.quantize_model(torch.nn.Sequential(conv))
        np.testing.assert_array_equal(conv.weight_q.numpy(),
                                      np.asarray(leaf.q).transpose(3, 2, 0, 1))
        got = conv(_as_torch(img, torch.float32))                         # (B, out, h, w)
        _close(got.permute(0, 2, 3, 1), np.asarray(want, np.float32), dtype)
        return
    x = rng.standard_normal((5, 7, k)).astype(np.float32)
    if layout == "linear":
        n = 24
        kernel = rng.standard_normal((k, n)).astype(np.float32) * 0.2     # Flax (in, out)
        module = TorchLinear(k, n, dtype=tdt)
        module.weight.data = torch.from_numpy(kernel.T.copy())
    else:
        n = 3 * hidden
        kernel = rng.standard_normal((k, 3, hidden)).astype(np.float32) * 0.2   # Flax (in, 3, h)
        module = QKVDense(k, hidden, dtype=tdt)
        module.weight.data = torch.from_numpy(kernel.reshape(k, n).T.copy())
    bias = rng.standard_normal(n).astype(np.float32)
    module.bias.data = torch.from_numpy(bias)
    leaf = jquant.quantize_array(kernel)
    w = leaf.dequant(jdt).reshape(k, n)
    want = (jnp.dot(jnp.asarray(x).astype(jdt), w, preferred_element_type=jnp.float32)
            + jnp.asarray(bias).astype(jdt).astype(jnp.float32)).astype(jdt)
    quant.quantize_model(torch.nn.Sequential(module))
    # the dequantized weight: JAX's bit for bit
    np.testing.assert_array_equal(_as_numpy(module.weight), np.asarray(w, np.float32).T)
    got = module(_as_torch(x, tdt))
    if layout == "qkv":
        got = torch.cat(got, dim=-1)
    _close(got, np.asarray(want, np.float32), dtype)
    # the wrapper's plain version is the module's product on the CPU
    scale = module.weight_scale.reshape(-1)
    assert scale.numel() == (hidden if layout == "qkv" else n)
    plain = w8a16.w8a16_linear_plain(_as_torch(x, tdt).reshape(-1, k), module.weight_q, scale,
                                     scale.numel(), module.bias.to(tdt))
    assert torch.equal(got.reshape(-1, n), plain)


@pytest.mark.parametrize("m,n,k", [(64, 768, 768), (64, 768, 3072), (50, 2304, 768),
                                   (2048, 3072, 768), (512, 768, 768), (5, 3, 37),
                                   (4096, 768, 3072), (1, 768, 768), (9, 6, 768),
                                   (512, 768, 3072), (2048, 768, 768)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_w8a16_split_covers_k(dtype, m, n, k):
    """Products of at most GEMV_M rows take the warp-a-column body, unsplit;
    else every split holds at least one k-step and together they hold all
    of them, and only a grid of fewer tiles than half the SMs is split."""
    tile, splits, per = w8a16.tiling(m, n, k, dtype, sms=132)
    steps = -(-k // w8a16.K_STEP[dtype])
    if m <= w8a16.GEMV_M:
        assert (tile, splits, per) == (2, 1, steps)
        return
    if dtype == torch.float32 or m <= w8a16.SMALL_M:
        assert tile == 0
    assert 1 <= splits <= w8a16.MAX_SPLITS
    assert (splits - 1) * per < steps <= splits * per
    em, en = {0: (64, 64), 1: (128, 128), 3: (128, 256)}[tile]
    tiles = -(-m // em) * -(-n // en)
    assert splits == 1 or (2 * tiles < 132 and tiles * (splits - 1) < 132)
