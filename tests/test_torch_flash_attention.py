"""K3, the long-context attention kernel, on the CPU: the port's plain
version and autograd function against the JAX package's kernel, and the
dispatch that sends a site to it.

The JAX side runs ``flash_attention_forward`` in Pallas interpret mode, as
``tests/test_flash_attention.py`` does, on (B, H, L, D); the port takes the
same numpy inputs transposed to (B, L, H, D). Shapes: the 257-token CLIP-L
site at a small batch, a multi-tile grid with L != S and a narrow head, and
a short query against a long key set; each with and without a
(1 - mask) * -10000 padding bias. Tolerances: fp32 atol 2e-5 (the kernel's
online softmax against one softmax, as the JAX test allows); bf16 atol
2e-2 (one bf16 ulp of outputs below 2, rounded once on each side);
gradients (the custom VJP's XLA twin against the port's plain twin) atol
1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2r_tpu.ops.kernels.flash_attention import flash_attention as jflash
from d2r_tpu.ops.kernels.flash_attention import flash_attention_forward
from d2r_tpu_torch.ops import attention as tattn
from d2r_tpu_torch.ops.kernels import flash_attention as tfl
from d2r_tpu_torch.ops.kernels import fused_attention as tfa


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: beside the suite's other workers torch's
    default threads contend, and the tiny steps run many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# (B, H, L, S, D)
SHAPES = [(1, 2, 257, 257, 64), (1, 1, 200, 333, 8), (2, 2, 64, 300, 16)]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(b, h, l, s, d, with_bias, seed):
    """q (B, H, L, D), k and v (B, H, S, D), and a padding bias (B, S)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, l, d)).astype(np.float32)
    k = rng.standard_normal((b, h, s, d)).astype(np.float32)
    v = rng.standard_normal((b, h, s, d)).astype(np.float32)
    bias = None
    if with_bias:
        lengths = rng.integers(s // 3, s + 1, size=(b, 1))
        mask = (np.arange(s)[None, :] < lengths).astype(np.float32)
        bias = (1.0 - mask) * -10000.0
    return q, k, v, bias


def _port(x, dtype=torch.float32):
    """(B, H, N, D) numpy -> (B, N, H, D) tensor."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3))).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_interpret(shape, with_bias, dtype):
    b, h, l, s, d = shape
    q, k, v, bias = _inputs(*shape, with_bias, seed=sum(shape))
    scale = d ** -0.5
    jd = jnp.dtype(dtype)
    ref = flash_attention_forward(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                                  None if bias is None else jnp.asarray(bias), scale,
                                  interpret=True)
    td = getattr(torch, dtype)
    out = tfl.flash_attention(_port(q, td), _port(k, td), _port(v, td),
                              None if bias is None else torch.from_numpy(bias), scale)
    assert out.dtype == td and out.shape == (b, l, h, d)
    got = out.float().numpy().transpose(0, 2, 1, 3)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=TOL[dtype], rtol=0)


def _wgmma_key_blocks(s):
    """The wgmma body's key blocks as (first key, width): 64 keys each, and
    the last block's live keys rounded up to 16, a narrow wgmma (keys
    256-271 at S = 257)."""
    full = s // 64 * 64
    return [(j0, 64) for j0 in range(0, full, 64)] + (
        [(full, -(-(s - full) // 16) * 16)] if s > full else [])


def _tensor_core_arithmetic(q, k, v, bias, scale, split=True, tile=64):
    """The bf16 K3 kernel's arithmetic in plain tensor ops, on (B, N, H, D)
    bf16 tensors; returns acc / l in fp32, before the one cast. Per key
    block: fp32 sums of the bf16 products, scaled afterwards, plus the
    bias, keys past S at -inf; the online softmax in fp32 with m from
    -1e30; p split into bf16 hi = bf16(p) and lo = bf16(p - hi), both
    through p.V into one fp32 accumulator. ``tile``: the blocks, tiles of
    that many keys (the mma.sync body's 64, a ragged last tile masked to
    its full width) or a list of (first key, width) (the wgmma body's,
    ``_wgmma_key_blocks``). ``split=False`` rounds p to bf16 once instead
    (K1's rounding), the contrast the tolerance has to see."""
    qf, kf, vf = (x.float() for x in (q, k, v))
    b, l, h, d = q.shape
    m = torch.full((b, h, l, 1), -1e30)
    lsum = torch.zeros((b, h, l, 1))
    acc = torch.zeros((b, h, l, d))
    blocks = tile if isinstance(tile, list) else [(j0, tile) for j0 in range(0, k.shape[1], tile)]
    for j0, width in blocks:
        kt, vt = kf[:, j0:j0 + width], vf[:, j0:j0 + width]
        s = torch.einsum("blhd,bshd->bhls", qf, kt) * scale
        if bias is not None:
            s = s + bias[:, None, None, j0:j0 + width]
        absent = width - kt.shape[1]     # keys past S in the block: -inf, zero rows of V
        s = torch.nn.functional.pad(s, (0, absent), value=-float("inf"))
        vt = torch.nn.functional.pad(vt, (0, 0, 0, 0, 0, absent))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p, c = torch.exp(s - m_new), torch.exp(m - m_new)
        lsum = lsum * c + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        pv = torch.einsum("bhls,bshd->bhld", hi, vt)
        if split:
            pv = pv + torch.einsum("bhls,bshd->bhld", (p - hi).to(torch.bfloat16).float(), vt)
        acc = acc * c + pv
        m = m_new
    return (acc / lsum).permute(0, 2, 1, 3)


@pytest.mark.parametrize("with_bias", [False, True])
def test_tensor_core_rounding_matches_jax_interpret(with_bias):
    """What the bf16 kernel computes (scale after the bf16 product, p as
    bf16 hi + lo) against JAX's kernel in interpret mode at the 257-token
    site, over the mma.sync body's 64-key tiles (the last one masked to
    64): within 1e-4 of its fp32 result before the cast (JAX's kernel on
    the same bf16 values held in fp32), and within K3's tolerance, 4e-3 of
    max(1, max |ref|), of its bf16 output after it. Rounding p to bf16 once
    misses the first bound. The measure that holds the kernel's rounding on
    the card, the share of bf16 outputs that differ at all from the plain
    version's, stays within 1% for this arithmetic (against the port's
    plain version and JAX's kernel alike) and exceeds it for p rounded once
    and for the card's control, K1's plain version."""
    _check_tensor_core_rounding(with_bias, tile=64)


@pytest.mark.parametrize("with_bias", [False, True])
def test_wgmma_rounding_matches_jax_interpret(with_bias):
    """The same bounds over the wgmma body's key blocks: 64 keys each and
    a narrow last block of 16 (keys 256-271, 257-271 absent)."""
    _check_tensor_core_rounding(with_bias, tile=_wgmma_key_blocks(257))


def _check_tensor_core_rounding(with_bias, tile):
    b, h, l, s, d = 2, 2, 257, 257, 64
    q, k, v, bias = _inputs(b, h, l, s, d, with_bias, seed=41)
    scale = d ** -0.5
    jb = None if bias is None else jnp.asarray(bias)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    ref_cast = np.asarray(flash_attention_forward(jq, jk, jv, jb, scale, interpret=True),
                          np.float32)
    ref_fp32 = np.asarray(flash_attention_forward(
        *(x.astype(jnp.float32) for x in (jq, jk, jv)), jb, scale, interpret=True))
    tq, tk, tv = (_port(x, torch.bfloat16) for x in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias)
    to_bhld = lambda x: x.float().numpy().transpose(0, 2, 1, 3)

    pre = _tensor_core_arithmetic(tq, tk, tv, tb, scale, tile=tile)
    assert np.abs(to_bhld(pre) - ref_fp32).max() <= 1e-4
    size = max(1.0, np.abs(ref_cast).max())
    assert np.abs(to_bhld(pre.to(torch.bfloat16)) - ref_cast).max() <= 4e-3 * size
    once = _tensor_core_arithmetic(tq, tk, tv, tb, scale, split=False, tile=tile)
    assert np.abs(to_bhld(once) - ref_fp32).max() > 1e-4

    share = lambda x, y: float(np.mean(to_bhld(x) != y))
    plain = tfl.flash_attention_plain(tq, tk, tv, tb, scale).float().numpy().transpose(0, 2, 1, 3)
    assert share(pre.to(torch.bfloat16), plain) <= 0.01
    assert share(pre.to(torch.bfloat16), ref_cast) <= 0.01
    assert share(once.to(torch.bfloat16), plain) > 0.01
    assert share(tfa.fused_attention_small_plain(tq, tk, tv, tb, scale), plain) > 0.01


def test_wgmma_key_blocks_end_in_a_narrow_block():
    assert _wgmma_key_blocks(257) == [(0, 64), (64, 64), (128, 64), (192, 64), (256, 16)]
    assert _wgmma_key_blocks(256)[-1] == (192, 64)
    assert _wgmma_key_blocks(1) == [(0, 16)]
    assert _wgmma_key_blocks(300)[-1] == (256, 48)


def _views(b, l, s, h, d, dtype, row_pad=0, offset=0):
    """q, k, v as the card's checks make them (chip_smoke.k3_inputs): at
    L = S strided views of one (B, L, 3 H D + row_pad) tensor, else q of a
    (B, L, 2 H D + row_pad) one and k, v of a (B, S, 2 H D + row_pad) one;
    ``offset`` elements into the buffer (off 16-byte alignment when it is
    not a multiple of 8)."""
    hd = h * d

    def buf(n, parts):
        flat = torch.zeros(offset + b * n * (parts * hd + row_pad), dtype=dtype)
        return flat[offset:].view(b, n, parts * hd + row_pad)

    view = lambda x, i, n: x[:, :, i * hd:(i + 1) * hd].view(b, n, h, d)
    if l == s:
        qkv = buf(l, 3)
        return tuple(view(qkv, i, l) for i in range(3))
    qx, kv = buf(l, 2), buf(s, 2)
    return view(qx, 0, l), view(kv, 0, s), view(kv, 1, s)


# name: (B, L, S, H, D, type, row pad, offset, body): the main-path site
# and every K3_SHAPES edge of chip_smoke.py, with the bounds of the rule
BODY_CASES = {
    "clip_l": (2, 257, 257, 16, 64, torch.bfloat16, 0, 0, "wgmma"),
    "clip_l_fp32": (2, 257, 257, 16, 64, torch.float32, 0, 0, "fp32"),
    "row_pad": (2, 257, 257, 4, 64, torch.bfloat16, 4, 0, "mma_sync"),
    "d37_odd": (2, 70, 90, 4, 37, torch.bfloat16, 0, 0, "mma_sync"),
    "s1": (2, 100, 1, 4, 64, torch.bfloat16, 0, 0, "wgmma"),
    "l17_bias": (3, 17, 300, 4, 64, torch.bfloat16, 0, 0, "wgmma"),
    "ragged_bias_d48": (2, 200, 333, 2, 48, torch.bfloat16, 0, 0, "mma_sync"),
    "d128": (2, 257, 257, 2, 128, torch.bfloat16, 0, 0, "mma_sync"),
    "long_d128": (1, 1024, 1024, 1, 128, torch.bfloat16, 0, 0, "mma_sync"),
    "wide_d256": (2, 300, 300, 1, 256, torch.bfloat16, 0, 0, "mma_sync"),
    "wide_d320": (2, 257, 257, 1, 320, torch.bfloat16, 0, 0, "wide"),
    "wide_d320_fp32": (2, 257, 257, 1, 320, torch.float32, 0, 0, "wide"),
    "misaligned": (2, 257, 257, 2, 64, torch.bfloat16, 0, 4, "mma_sync"),
    "aligned_offset": (2, 257, 257, 2, 64, torch.bfloat16, 0, 8, "wgmma"),
    "most_keys_d64": (1, 100, 640, 1, 64, torch.bfloat16, 0, 0, "wgmma"),
    "too_many_keys_d64": (1, 100, 641, 1, 64, torch.bfloat16, 0, 0, "mma_sync"),
    "d32": (2, 257, 257, 2, 32, torch.bfloat16, 0, 0, "mma_sync"),
}


@pytest.mark.parametrize("case", list(BODY_CASES))
def test_body_for_picks_by_type_shape_and_alignment(case):
    """Which body of the kernel takes a launch is a rule on type, shape and
    alignment: ``wgmma`` for bf16 views TMA can describe (16-byte aligned
    bases, strides in multiples of 8 elements) at D = 64 whose K and V fit
    in shared memory, ``mma_sync`` for the other bf16 views up to
    D = 256, ``fp32`` for fp32 up to D = 256, ``wide`` above."""
    b, l, s, h, d, dtype, row_pad, offset, body = BODY_CASES[case]
    q, k, v = _views(b, l, s, h, d, dtype, row_pad, offset)
    assert tfl.body_for(q, k, v) == body
    assert body in tfl.BODIES


def test_a_forced_body_on_the_cpu_runs_the_plain_version():
    """``body`` picks among the card's bodies; a CPU tensor still takes the
    plain version, whatever it names."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 70, 2, 64)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    ref = tfl.flash_attention_plain(q, k, v, None, 0.125)
    for body in tfl.BODIES:
        torch.testing.assert_close(tfl.flash_attention(q, k, v, None, 0.125, body=body), ref,
                                   atol=0, rtol=0)


def test_gradient_matches_jax_custom_vjp():
    b, h, l, s, d = SHAPES[0]
    q, k, v, bias = _inputs(b, h, l, s, d, True, seed=7)
    g = np.random.default_rng(8).standard_normal((b, h, l, d)).astype(np.float32)
    scale = d ** -0.5
    jbias = jnp.asarray(bias)
    _, vjp = jax.vjp(lambda q_, k_, v_: jflash(q_, k_, v_, jbias, scale),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    refs = vjp(jnp.asarray(g))
    leaves = [_port(x).requires_grad_() for x in (q, k, v)]
    out = tfl.flash_attention(*leaves, torch.from_numpy(bias), scale)
    out.backward(_port(g))
    for name, leaf, ref in zip(("dq", "dk", "dv"), leaves, refs):
        np.testing.assert_allclose(leaf.grad.numpy().transpose(0, 2, 1, 3), np.asarray(ref),
                                   atol=1e-5, rtol=0, err_msg=name)


def test_bf16_gradient_matches_jax_custom_vjp():
    """bf16 at the CLIP-L shape (B 2, H 4, 257 tokens, D 64) with a bias:
    at most 1% of dq, dk and dv may differ from JAX's custom VJP (the
    ``_xla_attention`` twin) at all. The control, K2's plain backward, which
    rounds d(logits) to bf16 before dq and dk, must move at least 10% of dq
    and of dk; dv does not depend on d(logits)."""
    b, h, l, s, d = 2, 4, 257, 257, 64
    q, k, v, bias = _inputs(b, h, l, s, d, True, seed=7)
    g = np.random.default_rng(8).standard_normal((b, h, l, d)).astype(np.float32)
    scale = d ** -0.5
    bf16 = lambda x: jnp.asarray(x, jnp.bfloat16)
    _, vjp = jax.vjp(lambda q_, k_, v_: jflash(q_, k_, v_, jnp.asarray(bias), scale),
                     bf16(q), bf16(k), bf16(v))
    refs = [np.asarray(r.astype(jnp.float32)) for r in vjp(bf16(g))]
    leaves = [_port(x, torch.bfloat16).requires_grad_() for x in (q, k, v)]
    tfl.flash_attention(*leaves, torch.from_numpy(bias), scale).backward(_port(g, torch.bfloat16))
    control = tfa.fused_attention_small_bwd_plain(
        *(x.detach() for x in leaves), torch.from_numpy(bias), _port(g, torch.bfloat16),
        scale, 0.0, None)
    to_bhld = lambda x: x.float().numpy().transpose(0, 2, 1, 3)
    for name, leaf, ctrl, ref in zip(("dq", "dk", "dv"), leaves, control, refs):
        assert np.mean(to_bhld(leaf.grad) != ref) <= 0.01, name
        if name != "dv":
            assert np.mean(to_bhld(ctrl) != ref) >= 0.10, name


def test_backward_differentiates_the_twin_and_gives_no_bias_gradient():
    """The backward is the plain twin's gradient (the einsum path at rate
    0: p rounded to q's type, the scale after the product), not the
    forward's, and the bias gets None, as the JAX custom VJP returns."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 150, 2, 8)).astype(np.float32))
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    bias = torch.zeros(2, 150, requires_grad=True)
    g = torch.from_numpy(rng.standard_normal((2, 150, 2, 8)).astype(np.float32)).bfloat16()
    tfl.flash_attention(q, k, v, bias, 0.3).backward(g)
    twin = [x.detach().requires_grad_() for x in (q, k, v)]
    tfa.fused_attention_small_plain(*twin, None, 0.3).backward(g)
    for got, ref in zip((q, k, v), twin):
        assert got.grad.dtype == torch.bfloat16
        torch.testing.assert_close(got.grad, ref.grad, atol=0, rtol=0)
    assert bias.grad is None


def test_strided_qkv_views_match_contiguous():
    rng = np.random.default_rng(3)
    b, l, h, d = 2, 140, 3, 24
    qkv = torch.from_numpy(rng.standard_normal((b, l, 3, h * d)).astype(np.float32))
    q, k, v = (tattn.split_heads(qkv[:, :, i], h) for i in range(3))
    assert not q.is_contiguous()
    out = tfl.flash_attention(q, k, v, None, d ** -0.5)
    ref = tfl.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), None, d ** -0.5)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def _counting(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **kw: calls.append(1) or fn(*a, **kw))
    return calls


@pytest.mark.parametrize("l,s,d", [(257, 257, 16), (64, 200, 16), (200, 64, 16),
                                   (8, 8, 136), (300, 300, 256)])
def test_dispatch_sends_long_sites_without_dropout_to_k3(monkeypatch, l, s, d):
    """Outside K1's band (L or S above 128, or D above 128) and no dropout:
    K3's function, which on the CPU runs its plain version."""
    rng = np.random.default_rng(l + s + d)
    q = torch.from_numpy(rng.standard_normal((1, l, 2, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, s, 2, d)).astype(np.float32))
    k3 = _counting(monkeypatch, tfl, "flash_attention_plain")
    k1 = _counting(monkeypatch, tfa, "fused_attention_small_plain")     # K1 on the CPU
    plain = _counting(monkeypatch, tattn, "fused_attention_small_plain")
    out = tattn.dot_product_attention(q, k, k, dropout_rate=0.1)   # eval: no seed, no dropout
    assert (len(k3), len(k1), len(plain)) == (1, 0, 0)
    torch.testing.assert_close(out, tfl.flash_attention_plain(q, k, k, None, d ** -0.5),
                               atol=0, rtol=0)


@pytest.mark.parametrize("l,d", [(200, 16), (8, 136)])
def test_dispatch_sends_dropout_outside_k1_to_the_plain_math(monkeypatch, l, d):
    """Dropout outside K1's band (L above 128, or D above 128): the einsum
    math of the dispatch's last branch, as the JAX package's XLA path."""
    rng = np.random.default_rng(l + d)
    k3 = _counting(monkeypatch, tfl, "flash_attention_plain")
    plain = _counting(monkeypatch, tattn, "fused_attention_small_plain")
    x = torch.from_numpy(rng.standard_normal((1, l, 2, d)).astype(np.float32))
    tattn.dot_product_attention(x, x, x, dropout_rate=0.1, dropout_seed=3)
    assert (len(k3), len(plain)) == (0, 1)


def test_k3_refuses_devices_without_a_kernel():
    q = torch.empty(1, 200, 2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tattn.dot_product_attention(q, q, q)
    for d in (1, 256, 264, 512):     # K3 takes any head width, as JAX's does
        assert tfl.supports_flash(torch.empty(1, 4, 1, d))


@pytest.mark.parametrize("d", [264, 512])
def test_heads_wider_than_k3_raise_off_the_cpu_and_run_plain_on_it(monkeypatch, d):
    """D above 256 without dropout (the wide body of the kernel on the
    card): K3's plain twin on the CPU, equal to the JAX kernel within fp32
    atol 2e-5; off the CPU the site reaches K3's wrapper (a device with no
    kernel raises there, where the CUDA launch would run on the card)."""
    with pytest.raises(ValueError, match="flash_attention: no kernel for device meta"):
        wide = torch.empty(1, 300, 1, d, device="meta")
        tattn.dot_product_attention(wide, wide, wide)
    q, k, v, bias = _inputs(1, 2, 9, 13, d, True, seed=d)
    calls = _counting(monkeypatch, tfl, "flash_attention_plain")
    out = tattn.dot_product_attention(_port(q, torch.float32), _port(k, torch.float32),
                                      _port(v, torch.float32),
                                      key_bias=torch.from_numpy(bias))
    assert len(calls) == 1 and out.shape == (1, 9, 2, d)
    ref = flash_attention_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(bias), d ** -0.5, interpret=True)
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 1, 3), np.asarray(ref), atol=2e-5)
