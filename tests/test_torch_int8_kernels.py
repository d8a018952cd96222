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
- the W8A16 kernel's dequantize (``codes_to_float2``, ``dequant_bf16x2``),
  written out in integer and bit-view tensor ops, gives
  ``w8a16.dequantize``'s bits for every code and a sweep of scales;
- the column amax kernel's order (row lanes, then a fixed tree, then the
  row bands in rank order), modelled in tensor ops, gives
  ``col_amax_plain``'s values, NaN and all-zero columns included;
- the tiling of the kernel's wrapper covers (M, N) with its tiles and K
  with its splits at every site of D2R-base and D2R-large and the
  training shapes;
- the rows quantize kernel's launch shape (``quantize.rows_tiling``)
  takes every row with its lanes and every element once, at the sites
  and at rows of one element up to past 256 lanes' registers, and its
  quotient corrected from the reciprocal (``codes16``), modelled in
  tensor ops, gives the plain codes.

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
    if r > 3:
        x[2, 2], x[3, 2] = 7.25, -7.25
    return x


# (3, 1030) and (2, 4100): widths where the rows kernel's launch shapes
# branch (a ragged last unit; fp32 past a warp's registers), few rows
@pytest.mark.parametrize("shape", [(64, 48), (9, 37), (3, 1030), (2, 4100)],
                         ids=["k48", "k37", "k1030", "k4100"])
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


# (M, N, K): D2R-base's bf16 serving sites at buckets 1 / 8 / 32 (BERT rows
# 64 a post: the attention out, FFN in and out, the QKV; CLIP-B/32 50 a
# post and its 49-patch conv), D2R-large's (RoBERTa-large 64 a post, CLIP
# ViT-L/14 257 a post, widths 1024 / 4096), products of one row a post,
# training shapes (batch 64 by 64 rows), an odd shape, a ragged grid
SPLIT_CASES = sorted({
    *((rows * b, n, k) for b in (1, 8, 32)
      for rows, n, k in ((64, 768, 768), (64, 3072, 768), (64, 768, 3072), (64, 2304, 768),
                         (50, 768, 768), (50, 3072, 768), (50, 768, 3072), (50, 2304, 768),
                         (49, 768, 3072), (64, 1024, 1024), (64, 4096, 1024),
                         (64, 1024, 4096), (64, 3072, 1024), (257, 1024, 1024),
                         (257, 4096, 1024), (257, 1024, 4096), (257, 3072, 1024),
                         (1, 768, 768), (1, 1024, 1024))),
    (4096, 768, 3072), (4096, 3072, 768), (2048, 768, 768), (5, 3, 37), (9, 6, 768),
    (300, 77, 200)})


@pytest.mark.parametrize("m,n,k", SPLIT_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_w8a16_split_covers_k(dtype, m, n, k):
    """Products of at most GEMV_M rows take the warp-a-column body, unsplit;
    above that fp32 takes 64 x 64 tiles and bf16 a wgmma body of
    ``WGMMA_TILES``. Every split holds at least one k-step and together
    they hold all of them, only a grid of fewer tiles than half the SMs is
    split, never past the SMs, a bf16 grid a power of two ways. The bf16
    launch as the kernel walks it (``w8a16.schedule``): every (token,
    feature) tile is computed once, by one block (unsplit: a persistent
    block of at most the SMs times the blocks an SM holds walks its tiles
    in a fixed order) or by one cluster whose splits, taken in split
    order, hold every k-step once, in order; every output lies in one
    tile."""
    tile, splits, per, blocks = w8a16.tiling(m, n, k, dtype, sms=132)
    steps = -(-k // w8a16.K_STEP[dtype])
    if m <= w8a16.GEMV_M:
        assert (tile, splits, per) == (2, 1, steps)
        return
    if dtype == torch.float32:
        assert tile == 0
        features, tokens = 64, 64
    else:
        tokens, kgroups, per_sm = w8a16.WGMMA_TILES[tile]
        features = 64
        assert tokens in (64, 128, 256) and kgroups in (1, 2) and per_sm in (1, 2)
    grid = (-(-m // tokens), -(-n // features))
    assert grid[0] * tokens >= m and grid[1] * features >= n
    assert 1 <= splits <= w8a16.MAX_SPLITS
    assert (splits - 1) * per < steps <= splits * per
    tiles = grid[0] * grid[1]
    assert splits == 1 or (2 * tiles < 132 and tiles * (splits - 1) < 132)
    if dtype == torch.float32:
        return
    assert splits & (splits - 1) == 0
    assert blocks == (tiles if splits > 1 else min(tiles, 132 * per_sm))
    work = w8a16.schedule(m, n, k, tile, splits, per, blocks)
    assert len(work) == blocks * splits
    seen = {}
    for block in work:
        assert block, "a block with no tile"
        for t0, f0, ks in block:
            assert t0 % tokens == 0 and f0 % features == 0 and t0 < m and f0 < n
            seen.setdefault((t0, f0), []).append(ks)
    assert len(seen) == tiles
    for parts in seen.values():
        assert len(parts) == splits and all(parts)
        assert sum(parts, []) == list(range(steps))
        # within a split, the k-groups (the kernel's ``mine`` steps kw, kw +
        # KW, ... of a warpgroup) take every step once
        for ks in parts:
            mine = [(len(ks) - kw + kgroups - 1) // kgroups if len(ks) > kw else 0
                    for kw in range(kgroups)]
            groups = [[kw + i * kgroups for i in range(count)] for kw, count in enumerate(mine)]
            assert sorted(sum(groups, [])) == list(range(len(ks)))
    # each output (token, feature) in exactly one tile
    covered = torch.zeros((grid[0] * tokens, grid[1] * features), dtype=torch.int32)
    for t0, f0 in seen:
        covered[t0:t0 + tokens, f0:f0 + features] += 1
    assert bool((covered[:m, :n] == 1).all())


def _byte_perm(x: torch.Tensor, y: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """CUDA's ``__byte_perm(x, y, sel)`` on int64 tensors holding 32-bit
    words: result byte i is byte ``(sel >> 4 i) & 7`` of (y:x), x's bytes
    0-3 (selectors below 8, no sign replication)."""
    both = (x & 0xFFFFFFFF) | ((y & 0xFFFFFFFF) << 32)
    out = torch.zeros_like(both)
    for i in range(4):
        b = (both >> (8 * ((sel >> (4 * i)) & 7))) & 0xFF
        out |= b << (8 * i)
    return out


def _dequant_bf16x2_bits(pairs: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``csrc/w8a16_linear.cu``'s ``codes_to_float2`` and ``dequant_bf16x2``
    (the GEMV and mma.sync bodies) in integer and bit-view ops: ``pairs``
    int32 holds two codes in bits 0-15 (code 0 low); returns the kernel's
    bf16x2 word, int32 (code 0's bf16 in the low half)."""
    u = pairs ^ 0x8080
    # __byte_perm(u, 0x4B000000, 0x7650 / 0x7651): 0x4B0000uu, the float 2^23 + uu
    f0 = (0x4B000000 | (u & 0xFF)).view(torch.float32) - 8388736.0
    f1 = (0x4B000000 | ((u >> 8) & 0xFF)).view(torch.float32) - 8388736.0
    # __byte_perm(f0, f1, 0x7632): each float's high half, the code's exact bf16
    hi = lambda f: (f.view(torch.int32) >> 16) & 0xFFFF
    s2 = scale.to(torch.bfloat16).float()
    # __hmul2 in bf16: the product of two bf16 is exact in fp32, rounded once
    w0 = (hi(f0).to(torch.int16).view(torch.bfloat16).float() * s2).to(torch.bfloat16)
    w1 = (hi(f1).to(torch.int16).view(torch.bfloat16).float() * s2).to(torch.bfloat16)
    as_u16 = lambda w: w.view(torch.int16).to(torch.int32) & 0xFFFF
    return as_u16(w0) | (as_u16(w1) << 16)


def _bf16_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """The float value of the bf16 in bits 0-15 of an int64 tensor."""
    return ((bits & 0xFFFF) << 16).to(torch.int32).view(torch.float32)


def _dequant_pair_bits(chunks: torch.Tensor, t4: torch.Tensor, half: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """The wgmma body's conversion in integer and bit-view ops: from a
    16-byte chunk of a code row (``chunks`` int64 (n, 4), its four
    little-endian words), the pair a thread of quad lane ``t4`` picks
    (``__byte_perm`` of words 0-1, or 2-3 for ``half`` 1, by the selector
    ``pick``), then ``dequant_pair``: (0x4300 | c & 127) - (0x4300 | c &
    128) in bf16 (exact), times bf16(s) rounded once. Returns int32 bf16x2
    words."""
    pick = 0x1100 * (2 * t4 + 1) + 0x11 * (2 * t4)
    lo_word = torch.where(half == 1, chunks[:, 2], chunks[:, 0])
    hi_word = torch.where(half == 1, chunks[:, 3], chunks[:, 1])
    v = _byte_perm(lo_word, hi_word, pick)
    a = (v & 0x007F007F) | 0x43004300
    b = (v & 0x00800080) | 0x43004300
    s2 = scale.to(torch.bfloat16).float()
    words = []
    for shift in (0, 16):
        q = _bf16_of_bits(a >> shift) - _bf16_of_bits(b >> shift)   # exact, |q| <= 128
        assert bool((q == q.to(torch.bfloat16).float()).all())
        w = (q * s2).to(torch.bfloat16)
        words.append(w.view(torch.int16).to(torch.int32) & 0xFFFF)
    return words[0] | (words[1] << 16)


@pytest.mark.parametrize("body", ["gemv_mma_sync", "wgmma"])
def test_w8a16_register_dequantize_matches_dequantize_bits(body):
    """Every pair of codes (all 65,536) under a sweep of scales: the
    kernel's register dequantize gives ``dequantize``'s bf16 bits, the plain
    path's ``q.to(bf16) * s.to(bf16)``. The GEMV and mma.sync bodies
    convert through floats (``dequant_bf16x2``); the wgmma body picks each
    pair out of a 16-byte chunk with a byte permute (every quad lane, both
    halves of the chunk, the other bytes random codes) and converts it as
    a difference of two bf16 (``dequant_pair``)."""
    codes = torch.arange(-128, 128, dtype=torch.int32)
    c0, c1 = torch.meshgrid(codes, codes, indexing="ij")
    c0, c1 = c0.reshape(-1), c1.reshape(-1)
    pairs = (c0 & 0xFF) | ((c1 & 0xFF) << 8)
    scales = torch.cat([torch.tensor([1 / 127, 1.0, 2.0 ** -20, 3.0e-3, 0.0]),
                        torch.logspace(-30, 30, 41), torch.rand(16) * 2e-3 + 1e-4])
    q = torch.stack([c0, c1], dim=1).to(torch.int8)                 # (65536, 2)
    if body == "wgmma":
        n = c0.numel()
        gen = torch.Generator().manual_seed(5)
        t4 = torch.arange(n) % 4
        half = (torch.arange(n) // 4) % 2
        raw = torch.randint(0, 256, (n, 16), generator=gen, dtype=torch.int64)
        at = 8 * half + 2 * t4                        # the pair's byte in the chunk
        raw[torch.arange(n), at] = (c0 & 0xFF).long()
        raw[torch.arange(n), at + 1] = (c1 & 0xFF).long()
        chunks = (raw.view(n, 4, 4) << torch.tensor([0, 8, 16, 24])).sum(-1)
    for s in scales:
        want = w8a16.dequantize(q, s.reshape(1), 1, torch.bfloat16)
        want_bits = ((want[:, 0].view(torch.int16).to(torch.int32) & 0xFFFF)
                     | ((want[:, 1].view(torch.int16).to(torch.int32) & 0xFFFF) << 16))
        got = (_dequant_bf16x2_bits(pairs, s) if body == "gemv_mma_sync"
               else _dequant_pair_bits(chunks, t4, half, s))
        assert torch.equal(got, want_bits), float(s)


def _nan_max(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``csrc/quantize.cu``'s nan_max: v where v > m or v is NaN, else m."""
    return torch.where((v > m) | v.isnan(), v, m)


def _col_amax_model(x: torch.Tensor) -> torch.Tensor:
    """``amax_cols_kernel``'s order in tensor ops: each row lane folds its
    rows of a 256-row band in order, the row lanes of a warp merge by a
    butterfly (lane xor 1, 2, ...), the block's 8 warps in order; then (the
    last block of a column tile to finish, whichever it is) four runs of
    bands g, g + 4, ... each folded in order, and the runs in order."""
    r, c = x.shape
    per_row = 64 // (16 // x.element_size())
    lanes = 256 // per_row
    in_warp = 32 // per_row
    rows_per_band = 256
    bands = []
    a = x.abs().float()
    for b in range(-(-r // rows_per_band)):
        part = torch.zeros((lanes, c))
        for lane in range(lanes):
            for row in range(b * rows_per_band + lane, min(r, (b + 1) * rows_per_band), lanes):
                part[lane] = _nan_max(part[lane], a[row])
        warps = part.view(8, in_warp, c)
        o = 1
        while o < in_warp:
            warps = _nan_max(warps, warps[:, torch.arange(in_warp) ^ o])
            o *= 2
        band = warps[0, 0]
        for w in range(1, 8):
            band = _nan_max(band, warps[w, 0])
        bands.append(band)
    if len(bands) == 1:
        return bands[0][None]
    runs = []
    for g in range(4):
        run = torch.zeros(c)
        for band in bands[g::4]:
            run = _nan_max(run, band)
        runs.append(run)
    merged = runs[0]
    for run in runs[1:]:
        merged = _nan_max(merged, run)
    return merged[None]


def _codes_by_reciprocal_model(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``csrc/quantize.cu``'s ``code_by_reciprocal`` in fp32 tensor ops:
    rint(v * (1 / s)) away from rounding boundaries, rint(v / s) near them
    (within 2^-10 of a half-integer) and where 1 / s is not finite."""
    r = torch.reciprocal(s)
    t = v * r
    exact = torch.round(v / s)
    near = (t - torch.floor(t) - 0.5).abs() < 2.0 ** -10
    q = torch.where(near | ~torch.isfinite(r).expand_as(t), exact, torch.round(t))
    return torch.clamp(q, -127, 127).to(torch.int8)


def _codes16_model(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The rows kernel's ``codes16`` for rows whose |v| <= amax, in tensor
    ops: y = v * r in fp32 for r = 1 / s (correctly rounded), two
    corrections y + r * (v - s * y), the residual exact (in fp64, as an FMA
    computes it) and the sum rounded to fp32 once, then rint; where s is
    not a normal float (r may not be finite), rint(v / s) (``code_of``)."""
    r = torch.reciprocal(s)
    y = v * r
    for _ in range(2):
        e = v.double() - s.double() * y.double()
        y = (y.double() + r.double() * e).float()
    normal = (s >= torch.finfo(torch.float32).tiny) & torch.isfinite(r)
    return torch.clamp(torch.round(torch.where(normal, y, v / s)), -127, 127).to(torch.int8)


@pytest.mark.parametrize("axis", ["cols", "rows"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_codes_by_reciprocal_model_matches_plain(dtype, axis):
    """The codes passes' multiply-by-reciprocal paths give the plain codes
    bit for bit: the column pass's ``code_by_reciprocal`` (with its exact
    fallback), by columns and by rows, and the rows pass's corrected
    quotient (``codes16``) from a row's own amax and a group's: normal
    values, exact .5 ties, values one ulp either side of a tie and 2^-16 to
    2^-15 from one, at scales of many sizes, the slice's amax among them
    (the +-127 codes)."""
    tdt = DTYPES[dtype][1]
    g = torch.Generator().manual_seed(5)
    amax = torch.cat([torch.tensor([127.0, 1.0, 3.0, 1e-3, 7.25, 1e-30, 1e30, 2.0 ** -126]),
                      torch.rand(24, generator=g) * 10 ** torch.randint(-6, 6, (24,),
                                                                           generator=g)])
    x = (torch.rand((512, amax.numel()), generator=g) * 2 - 1) * amax
    scale = torch.where(amax > 0, amax, torch.ones_like(amax)) / torch.full_like(amax, 127.0)
    halves = (torch.arange(-127, 127) + 0.5)[:, None] * scale
    # values 2^-16 to 2^-15 either side of a tie
    edges = [(torch.arange(-127, 127) + 0.5 + d)[:, None] * scale
             for d in (2.0 ** -16, -2.0 ** -16, 1.6 * 2.0 ** -16, -1.6 * 2.0 ** -16,
                       1.1 * 2.0 ** -15, -1.1 * 2.0 ** -15)]
    x = torch.cat([x, amax[None], -amax[None], halves, torch.nextafter(halves, halves * 2),
                   torch.nextafter(halves, torch.zeros_like(halves)), *edges]).to(tdt).float()
    if axis == "cols":
        want, _ = qk.quantize_cols_plain(x, amax[None])
        got = _codes_by_reciprocal_model(x, scale[None]).t().contiguous()
    else:
        x = x.t().contiguous()
        want, _ = qk.quantize_rows_plain(x, amax[:, None])
        got = _codes_by_reciprocal_model(x, scale[:, None])
        # the rows kernel's quotient (codes16), from the row's own amax and
        # from a group's above it
        own_codes, own_scale = qk.quantize_rows_plain(x)
        assert torch.equal(_codes16_model(x, own_scale), own_codes)
        group = torch.maximum(amax, x.abs().amax(1)) * 1.7
        group_codes, group_scale = qk.quantize_rows_plain(x, group[:, None])
        assert torch.equal(_codes16_model(x, group_scale), group_codes)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(4096, 40), (3072, 24), (37, 5), (700, 9)],
                         ids=["r4096", "r3072", "r37", "r700"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_col_amax_kernel_order_matches_plain(dtype, shape):
    """The column amax merged in the kernel's order equals ``col_amax_plain``
    on columns that hold a NaN (kept) and are all zero (amax 0, then scale
    1/127 and codes 0), at 16, 12, 3 and 1 bands, the last one ragged."""
    tdt = DTYPES[dtype][1]
    x = _as_torch(_adversarial(shape, seed=sum(shape)), tdt)
    x[shape[0] // 2, 2] = float("nan")
    x[0, 3] = float("nan")
    got, want = _col_amax_model(x), qk.col_amax_plain(x)
    assert got.isnan()[0, 2] and got.isnan()[0, 3] and got[0, 0] == 0
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    _, scale = qk.quantize_cols_plain(x, got)
    assert scale[0, 0] == torch.tensor(1.0) / torch.tensor(127.0)


# the rows quantize's sites (chip_smoke.QUANT_ROW_SITES): activations of a
# D2R-base step at batch 64 and CLIP-B's, and the weights of its products
ROW_SITES = [(4096, 768), (4096, 3072), (3200, 768), (2304, 768), (3072, 768), (768, 3072),
             (768, 768)]
# one row; fewer rows than a block holds; K of a ragged unit, of one unit,
# past a warp's registers, past 256 lanes' units at three a lane, and past
# 256 lanes' registers (segments)
ROW_EDGES = [(1, 768), (1, 5), (5, 37), (3, 5), (3, 1030), (2, 4100), (2, 13000), (3, 70001)]


def _rows_cover(r, k, t):
    """How often the rows kernel's threads, in launch shape ``t``, take each
    row and each element of a row, by the kernel's index math: thread th of
    block b holds row b (block / lanes) + th / lanes as lane j = th % lanes,
    and a lane's units are seg lanes units + j + i lanes (16 elements each)
    for each segment seg and i < units."""
    rows_a_block = t.block // t.lanes
    th = np.arange(-(-r // rows_a_block) * t.block)
    row = th // t.block * rows_a_block + th % t.block // t.lanes
    lane = th % t.block % t.lanes
    live = row < r
    rows = np.bincount(row[live], minlength=r)
    seg = np.arange(t.segments)[:, None, None]
    i = np.arange(t.units)[None, :, None]
    unit = seg * t.lanes * t.units + np.arange(t.lanes)[None, None, :] + i * t.lanes
    e = (16 * unit[..., None] + np.arange(16)).ravel()
    return rows, np.bincount(e[e < k], minlength=k), lane[live]


@pytest.mark.parametrize("r,k", ROW_SITES + ROW_EDGES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_rows_tiling_covers_each_row_once(dtype, r, k):
    """``quantize.rows_tiling``'s launch shape takes every row with exactly
    its lanes and every element of a row exactly once; holds the row in
    registers (one segment, each element read once) wherever 256 lanes'
    registers hold it; gives a lane at most three units where 256 lanes
    allow; and at the sites takes the shape that ``quantize_sweep.py``
    timed within 0.2 us of the fastest on the card."""
    t = qk.rows_tiling(k, dtype)
    most = qk.REGISTER_UNITS[dtype]
    assert 1 <= t.units <= most and t.lanes & (t.lanes - 1) == 0
    assert t.block == max(qk.MIN_BLOCK, t.lanes) and t.block <= qk.MAX_LANES
    rows, elements, lanes = _rows_cover(r, k, t)
    assert (rows == t.lanes).all() and (np.bincount(lanes, minlength=t.lanes) == r).all()
    assert (elements == 1).all()
    units = -(-k // qk.UNIT)
    want = qk.LANE_UNITS
    if units <= qk.MAX_LANES * want:
        assert t.segments == 1 and t.units <= want and t.units * t.lanes >= units
        assert t.lanes == 1 or (t.lanes // 2) * want < units
    elif units <= qk.MAX_LANES * most:
        assert t.segments == 1 and t.lanes == qk.MAX_LANES
    else:
        assert (t.lanes, t.units, t.segments) == (qk.MAX_LANES, most,
                                                  -(-units // (qk.MAX_LANES * most)))
    fastest = {(4096, 768): (3, 16), (4096, 3072): (3, 64), (3200, 768): (3, 16),
               (2304, 768): (3, 16), (3072, 768): (3, 16), (768, 3072): (3, 64),
               (768, 768): (3, 16)}
    if (r, k) in fastest:
        assert (t.units, t.lanes) == fastest[(r, k)]
