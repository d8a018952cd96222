"""The port's CUDA kernels on the card: K1 (forward, with and without
dropout), K2 (backward, at the sites and at the edges of its bf16 tiling)
and K3 (long-context forward) against their plain versions, their
``torch.library`` custom ops under ``opcheck``, and the serving, export,
training and eval paths launching them at every attention site. Every
test is marked ``cuda`` and skips itself where ``torch.cuda.is_available()``
is false.

Tolerances: K1 as in chip_smoke (fp32 1e-5, bf16 2e-2 absolute); K2 scaled
by the output's magnitude, fp32 1e-5 and bf16 2e-2 of max(1, max |ref|)
(one bf16 ulp at |x| is 2^-8 |x|), and in bf16 at most 1% of dq, dk, dv
differing from the plain version at all, where the control with pd and
d(logits) left unrounded differs in more; K3 as in chip_smoke, fp32 1e-5
absolute and bf16 4e-3 of max(1, max |ref|), one ulp of outputs in
[0.5, 1). That bound does not tell K3's rounding (p fp32 into p.V, which
the bf16 kernel carries as p = hi + lo) from K1's (p rounded to bf16); the
share of outputs that differ from the plain version at all does (at most
1% for K3 in bf16). K3's wgmma body runs at the CLIP-L site at every batch
of the main path, under capture, and refuses what it cannot take.

This file imports neither JAX nor ``d2r_tpu``, because the GPU machine has
no JAX; ``tests/conftest.py`` does, so run it there without the conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import json
import os

import pytest
import torch

from d2r_tpu_torch.ops import attention as tattn
from d2r_tpu_torch.ops.kernels import flash_attention as tfl
from d2r_tpu_torch.ops.kernels import fused_attention as tfa


def _seed(device, seed, site=3):
    """A kernel's dropout seed on ``device``: ``seed`` in a device buffer and
    a site ordinal (None stays None)."""
    return None if seed is None else tfa.DropoutSeed(tfa.seed_tensor(seed, device), site)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_cuda_kernel_matches_plain(cuda, dtype, tol):
    """K1 against its plain version at the four site geometries and odd
    batches, on strided QKV views, with and without bias."""
    g = torch.Generator(device=cuda).manual_seed(0)
    for b, l, h, d, with_bias in ((3, 64, 12, 64, True), (2, 50, 12, 64, False),
                                  (1, 64, 16, 48, False), (5, 50, 16, 48, True),
                                  (2, 128, 2, 128, True), (1, 7, 3, 8, True)):
        qkv = torch.randn((b, l, 3, h * d), generator=g, device=cuda).to(dtype)
        q, k, v = (qkv[:, :, i].view(b, l, h, d) for i in range(3))
        bias = None
        if with_bias:
            lengths = torch.randint(1, l + 1, (b, 1), generator=g, device=cuda)
            bias = tattn.padding_key_bias(torch.arange(l, device=cuda)[None] < lengths)
        before = tfa.fused_attention_small.launches
        out = tfa.fused_attention_small(q, k, v, bias, d ** -0.5)
        torch.cuda.synchronize()
        assert tfa.fused_attention_small.launches == before + 1
        ref = tfa.fused_attention_small_plain(q, k, v, bias, d ** -0.5)
        assert out.shape == q.shape and out.is_contiguous()
        assert (out.float() - ref.float()).abs().max().item() <= tol, (b, l, h, d)


@pytest.mark.cuda
def test_cuda_wrapper_raises_instead_of_falling_back(cuda):
    """Forward and backward: fp16 and unreadable strides raise, on the card
    no plain version runs."""
    q = torch.randn(2, 8, 2, 16, device=cuda)
    t = q.transpose(1, 2)                     # (B, H, L, D) memory seen as (B, L, H, D)
    with pytest.raises(ValueError, match="head stride"):
        tfa.fused_attention_small(t, t, t, None, 0.25)
    with pytest.raises(TypeError):
        tfa.fused_attention_small(q.half(), q.half(), q.half(), None, 0.25)
    with pytest.raises(ValueError, match="head stride"):
        tfa.fused_attention_small_bwd(t, t, t, None, q, 0.25)
    h = q.half()
    with pytest.raises(TypeError):
        tfa.fused_attention_small_bwd(h, h, h, None, h, 0.25, dropout_rate=0.1, dropout_seed=1)
    with pytest.raises(TypeError):                 # a g of another type than q
        tfa.fused_attention_small_bwd(q, q, q, None, h, 0.25)
    long = torch.randn(1, 256, 2, 16, device=cuda)
    lt = long.transpose(1, 2)
    with pytest.raises(ValueError, match="head stride"):
        tfl.flash_attention(lt, lt, lt, None, 0.25)
    with pytest.raises(TypeError):
        tfl.flash_attention(long.half(), long.half(), long.half(), None, 0.25)


def _tiny_predictors(cuda, quantize=None, compute_dtype="float32", buckets=(2, 4)):
    """A tiny DR_step=4 model behind a CPU and a card Predictor, and a
    request of 3 rows (one with padding)."""
    import copy

    import numpy as np

    from d2r_tpu_torch.config import tiny_test_config
    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.serve import Predictor
    cfg = tiny_test_config(DR_step=4, compute_dtype=compute_dtype)
    model = build_model(cfg, device="cpu", seed=0)
    cpu = Predictor(cfg, copy.deepcopy(model), batch_buckets=buckets, device="cpu",
                    quantize=quantize)
    gpu = Predictor(cfg, model, batch_buckets=buckets, device=cuda, quantize=quantize)
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 128, size=(3, cfg.max_seq)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 9:] = 0
    pixels = rng.integers(0, 256, size=(3, 3, 32, 32)).astype(np.uint8)
    return cpu, gpu, (ids, mask, np.zeros_like(ids), pixels)


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", [None, "int8"])
def test_cuda_predictor_launches_k1_at_every_site(cuda, quantize):
    """A tiny DR_step=4 model: 3 text + 3 vision + 2 x 4 IMRC sites = 14
    K1 launches a forward. The first request of a bucket runs the eager
    forward once and captures it (14 + 14 host calls); replays make none.
    The card's fp32 probabilities match the CPU's, int8 too."""
    import numpy as np
    cpu, gpu, args = _tiny_predictors(cuda, quantize)
    tfa.fused_attention_small.launches = 0
    got = gpu.predict(*args)
    assert tfa.fused_attention_small.launches == 28
    again = gpu.predict(*args)
    assert tfa.fused_attention_small.launches == 28
    np.testing.assert_array_equal(again["probs"], got["probs"])
    ref = cpu.predict(*args)
    np.testing.assert_allclose(got["probs"], ref["probs"], atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cuda_replay_equals_eager_bit_for_bit(cuda, compute_dtype):
    """At every bucket the replayed probabilities equal the eager forward's
    on the same static buffers, bit for bit, and one graph is captured a
    (bucket, pixel dtype): uint8 at warmup, float32 at its first request."""
    import numpy as np
    _, gpu, (ids, mask, tt, pixels) = _tiny_predictors(cuda, compute_dtype=compute_dtype)
    gpu.warmup()
    assert set(gpu.graphs) == {(2, np.dtype(np.uint8)), (4, np.dtype(np.uint8))}
    for n in (1, 3):
        g = gpu.graph(gpu._bucket(n))
        gpu._stage(g, (ids[:n], mask[:n], tt[:n], pixels[:n]))
        replayed = gpu._replay(g, n)
        eager = gpu._forward(*g.inputs)[:n].cpu().numpy()
        np.testing.assert_array_equal(replayed, eager)
    gpu.predict(ids, mask, tt, pixels.astype(np.float32))
    gpu.predict(ids[:1], mask[:1], tt[:1], pixels[:1])
    assert set(gpu.graphs) == {(2, np.dtype(np.uint8)), (4, np.dtype(np.uint8)),
                               (4, np.dtype(np.float32))}


@pytest.mark.cuda
def test_cuda_predictor_never_runs_the_eager_path_after_warmup(cuda, monkeypatch):
    """After warmup, requests of every bucket (and one chunked over two)
    replay graphs only."""
    import numpy as np
    _, gpu, (ids, mask, tt, pixels) = _tiny_predictors(cuda)
    gpu.warmup()

    def eager(*_):
        raise AssertionError("the eager forward ran after warmup")

    monkeypatch.setattr(gpu, "_forward", eager)
    for n in (1, 2, 3):
        out = gpu.predict(ids[:n], mask[:n], tt[:n], pixels[:n])
        assert out["probs"].shape == (n, 3)
    rep = lambda x: np.concatenate([x, x])
    assert gpu.predict(rep(ids), rep(mask), rep(tt), rep(pixels))["probs"].shape == (6, 3)


@pytest.mark.cuda
def test_cuda_capture_while_another_thread_replays(cuda):
    """A server's reload: one thread captures a new predictor's graphs while
    another keeps replaying the old one. Every replay gives the first
    answer, bit for bit, and the new predictor agrees with the old."""
    import threading

    import numpy as np
    _, old, args = _tiny_predictors(cuda)
    old.warmup()
    first = old.predict(*args)["probs"]
    stop, results, errors = threading.Event(), [], []

    def serve():
        try:
            while not stop.is_set():
                results.append(old.predict(*args)["probs"])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    t = threading.Thread(target=serve)
    t.start()
    try:
        _, new, _ = _tiny_predictors(cuda)
        new.warmup()
        fresh = new.predict(*args)["probs"]
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    assert len(results) > 1 and all(np.array_equal(r, first) for r in results)
    np.testing.assert_array_equal(fresh, first)


GEOMETRIES = ((3, 64, 12, 64, True), (2, 50, 12, 64, False), (1, 64, 16, 48, False),
              (5, 50, 16, 48, True), (2, 128, 2, 128, True), (1, 7, 3, 8, True))
K2_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _qkv(cuda, dtype, b, l, h, d, with_bias, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn((b, l, 3, h * d), generator=g, device=cuda).to(dtype)
    q, k, v = (qkv[:, :, i].view(b, l, h, d) for i in range(3))
    bias = None
    if with_bias:
        lengths = torch.randint(1, l + 1, (b, 1), generator=g, device=cuda)
        bias = tattn.padding_key_bias(torch.arange(l, device=cuda)[None] < lengths)
    grad = torch.randn((b, l, h, d), generator=g, device=cuda).to(dtype)
    return q, k, v, bias, grad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_cuda_dropout_forward_matches_plain(cuda, dtype, tol):
    """K1 with dropout against the plain version with the same seed: the
    masks are the same Philox bits."""
    for i, (b, l, h, d, with_bias) in enumerate(GEOMETRIES):
        q, k, v, bias, _ = _qkv(cuda, dtype, b, l, h, d, with_bias, seed=i)
        for rate, seed in ((0.1, 7), (0.5, 2 ** 40 + 3)):
            seed = _seed(cuda, seed)
            out = tfa.fused_attention_small(q, k, v, bias, d ** -0.5, rate, seed)
            torch.cuda.synchronize()
            ref = tfa.fused_attention_small_plain(q, k, v, bias, d ** -0.5, rate, seed)
            assert (out.float() - ref.float()).abs().max().item() <= tol, (b, l, h, d, rate)


def _check_k2(q, k, v, bias, g, rate, seed, shape):
    """K2 twice (dbias on the first call only, when there is a bias)
    against its plain version: shapes, the same bits, the error, dbias and,
    in bf16, the share of outputs that differ against the unrounded
    control's."""
    d = q.shape[-1]
    before = tfa.fused_attention_small_bwd.launches
    got = tfa.fused_attention_small_bwd(q, k, v, bias, g, d ** -0.5, rate, seed)
    again = tfa.fused_attention_small_bwd(q, k, v, bias, g, d ** -0.5, rate, seed,
                                          need_dbias=False)
    torch.cuda.synchronize()
    assert tfa.fused_attention_small_bwd.launches == before + 2
    assert again[3] is None
    ref = tfa.fused_attention_small_bwd_plain(q, k, v, bias, g, d ** -0.5, rate, seed)
    # on fp32 copies of the inputs pd and d(logits) stay unrounded
    control = tfa.fused_attention_small_bwd_plain(q.float(), k.float(), v.float(), bias,
                                                  g.float(), d ** -0.5, rate, seed)
    for name, x, y, z, c in zip(("dq", "dk", "dv"), got, again, ref, control):
        c = c.to(q.dtype)
        assert x.shape == z.shape and x.dtype == z.dtype and x.is_contiguous()
        assert torch.equal(x, y), name
        tol = K2_TOL[q.dtype] * max(1.0, z.float().abs().max().item())
        assert (x.float() - z.float()).abs().max().item() <= tol, (name, shape, rate)
        if q.dtype == torch.bfloat16:
            share = (x != z).float().mean().item()
            assert share <= 0.01, (name, shape, rate, share)
            if k.shape[1] > 1:   # with one key d(logits) is 0 and p is 1
                assert (c != z).float().mean().item() > 0.01, (name, shape, rate)
    tol = 1e-4 * max(1.0, ref[3].abs().max().item())
    assert (got[3] - ref[3]).abs().max().item() <= tol, ("dbias", shape, rate)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_matches_plain(cuda, dtype):
    """K2 against its plain version with and without dropout, dbias on
    request, the same bits on a second run (no atomics in dq, dk, dv), and
    in bf16 the JAX kernel's rounding points: at most 1% of the outputs
    differ from the plain version, where dropping the rounding of pd and
    d(logits) differs in more."""
    for i, (b, l, h, d, with_bias) in enumerate(GEOMETRIES):
        q, k, v, bias, g = _qkv(cuda, dtype, b, l, h, d, with_bias, seed=10 + i)
        for rate, seed in ((0.0, None), (0.1, 11)):
            _check_k2(q, k, v, bias, g, rate, _seed(cuda, seed), (b, l, h, d))


@pytest.mark.cuda
def test_cuda_dropout_v_ones_identity(cuda):
    """tests/test_fused_attention_small.py's TPU dropout test on the card:
    seeded, mean-preserving, and K2 regenerates K1's mask (sum dv = sum out)."""
    q, k, _, bias, _ = _qkv(cuda, torch.float32, 8, 16, 2, 8, True, seed=3)
    v = torch.ones(8, 16, 2, 8, device=cuda, requires_grad=True)
    run = lambda s: tfa.fused_attention_small(q, k, v, bias, 8 ** -0.5, 0.5, _seed(cuda, s))
    o1, o2, o3 = run(1234), run(1234), run(999)
    assert torch.equal(o1, o2) and not torch.equal(o1, o3)
    assert abs(o1.mean().item() - 1.0) < 0.1
    o1.sum().backward()
    torch.testing.assert_close(v.grad.sum(), o1.sum(), rtol=1e-3, atol=0)


@pytest.mark.cuda
def test_cuda_train_step_launches_k1_and_k2_at_every_site(cuda):
    """A tiny DR_step=4 model, one train step: 3 text + 3 vision + 2 x 4
    IMRC sites = 14 K1 and 14 K2 launches. With dropout off the card's loss
    and fc gradient match the CPU's in fp32."""
    import copy
    import dataclasses

    import numpy as np

    from d2r_tpu_torch import config as tconfig
    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.train.state import create_train_state, make_train_step
    tc = dataclasses.replace(tconfig.tiny_test_config().text_config(),
                             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    tconfig.register_text_preset("tiny-bert-dropout-0", lambda: tc)
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 128, size=(4, 16)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 9:] = 0
    ids *= mask
    batch = dict(input_ids=ids, attention_mask=mask, token_type_ids=np.zeros_like(ids),
                 labels=np.array([0, 1, 2, 1], np.int32),
                 pixel_values=rng.standard_normal((4, 3, 32, 32)).astype(np.float32))
    step = make_train_step()
    for name in ("tiny-bert", "tiny-bert-dropout-0"):
        cfg = tconfig.tiny_test_config(DR_step=4, bert_name=name)
        model = build_model(cfg, device="cpu", seed=0)
        gpu = create_train_state(cfg, 10, device=cuda, model=copy.deepcopy(model))
        tfa.fused_attention_small.launches = tfa.fused_attention_small_bwd.launches = 0
        gpu, m = step(gpu, batch, 3)
        torch.cuda.synchronize()
        assert tfa.fused_attention_small.launches == 14
        assert tfa.fused_attention_small_bwd.launches == 14
        assert torch.isfinite(m["loss"]).item()
        if name == "tiny-bert-dropout-0":
            cpu = create_train_state(cfg, 10, device="cpu", model=model)
            cpu, ref = step(cpu, batch, 3)
            assert abs(m["loss"].item() - ref["loss"].item()) <= 1e-4
            torch.testing.assert_close(gpu.model.fc.weight.grad.cpu(), cpu.model.fc.weight.grad,
                                       atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 4e-3)])
def test_cuda_k3_matches_plain(cuda, dtype, tol):
    """K3 against its plain version on strided views at L != S with a
    padding bias (a ragged last key tile, D not a multiple of 32), at the
    257-token site without one, and at heads wider than K1 takes (D = 136
    and the widest, 256); one launch each through the dispatch. In bf16 at
    most 1% of the outputs differ from the plain version's at all, where
    K1's plain version (p rounded to bf16 once) differs in more: the max
    error cannot tell the two roundings apart, this share can."""
    g = torch.Generator(device=cuda).manual_seed(0)
    for b, l, s, h, d, with_bias in ((2, 150, 300, 3, 40, True), (2, 257, 257, 4, 64, False),
                                     (1, 120, 300, 2, 136, True), (1, 300, 300, 2, 256, True)):
        qx = torch.randn((b, l, 2, h * d), generator=g, device=cuda).to(dtype)
        kv = torch.randn((b, s, 2, h * d), generator=g, device=cuda).to(dtype)
        q = qx[:, :, 0].view(b, l, h, d)
        k, v = (kv[:, :, i].view(b, s, h, d) for i in range(2))
        bias = None
        if with_bias:
            lengths = torch.randint(1, s + 1, (b, 1), generator=g, device=cuda)
            bias = tattn.padding_key_bias(torch.arange(s, device=cuda)[None] < lengths)
        before = tfl.flash_attention.launches
        out = tattn.dot_product_attention(q, k, v, key_bias=bias)
        torch.cuda.synchronize()
        assert tfl.flash_attention.launches == before + 1
        ref = tfl.flash_attention_plain(q, k, v, bias, d ** -0.5)
        assert out.shape == q.shape and out.is_contiguous() and out.dtype == dtype
        err = (out.float() - ref.float()).abs().max().item()
        size = max(1.0, ref.float().abs().max().item()) if dtype == torch.bfloat16 else 1.0
        assert err <= tol * size, (b, l, s, h, d, err)
        if dtype == torch.bfloat16:
            once = tfa.fused_attention_small_plain(q, k, v, bias, d ** -0.5)
            share = (out != ref).float().mean().item()
            assert share <= 0.01 < (once != ref).float().mean().item(), (b, l, s, h, d, share)


def _views(cuda, dtype, b, l, s, h, d, with_bias, seed, pad=0):
    """q of a (B, L, 2*H*D + pad) tensor, k and v of a (B, S, 2*H*D + pad)
    one, all strided views, and a padding bias over the S keys. A pad that
    is not a multiple of 8 makes rows that 16-byte copies cannot stage."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    hd = h * d
    qx = torch.randn((b, l, 2 * hd + pad), generator=g, device=cuda).to(dtype)
    kv = torch.randn((b, s, 2 * hd + pad), generator=g, device=cuda).to(dtype)
    q = qx[:, :, :hd].view(b, l, h, d)
    k, v = (kv[:, :, i * hd:(i + 1) * hd].view(b, s, h, d) for i in range(2))
    bias = None
    if with_bias:
        lengths = torch.randint(1, s + 1, (b, 1), generator=g, device=cuda)
        bias = tattn.padding_key_bias(torch.arange(s, device=cuda)[None] < lengths)
    return q, k, v, bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_cuda_k1_tile_edges(cuda, dtype, tol):
    """K1 at the edges of the bf16 tensor-core tiling: D = 40 (not a
    multiple of 16), 7 query rows against 128 keys with a bias (with and
    without dropout), the largest tile L = S = D = 128, L = S = 1, and the
    views that only element loads stage: D = 37 (odd-width stores too) and
    rows 4 elements longer than the heads' fused width."""
    for i, (b, l, s, h, d, with_bias, pad) in enumerate(
            ((3, 64, 64, 5, 40, True, 0), (2, 7, 128, 3, 64, True, 0),
             (2, 128, 128, 2, 128, True, 0), (4, 1, 1, 3, 64, False, 0),
             (3, 50, 50, 4, 37, True, 0), (2, 64, 64, 3, 64, True, 4))):
        q, k, v, bias = _views(cuda, dtype, b, l, s, h, d, with_bias, seed=20 + i, pad=pad)
        for rate, seed in ((0.0, None),) + (((0.1, 5),) if l == 7 else ()):
            seed = _seed(cuda, seed)
            before = tfa.fused_attention_small.launches
            out = tfa.fused_attention_small(q, k, v, bias, d ** -0.5, rate, seed)
            torch.cuda.synchronize()
            assert tfa.fused_attention_small.launches == before + 1
            ref = tfa.fused_attention_small_plain(q, k, v, bias, d ** -0.5, rate, seed)
            assert out.shape == q.shape and out.is_contiguous()
            err = (out.float() - ref.float()).abs().max().item()
            assert err <= tol, (b, l, s, h, d, rate, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_k2_tile_edges(cuda, dtype):
    """K2 at K1's edges of the bf16 tiling, with and without dropout: D = 40
    (not a multiple of 16), 7 query rows against 128 keys (warps with keys
    but no rows), the largest tile and shared memory L = S = D = 128, L = S
    = 1, and the views that only element loads stage: D = 37 (odd-width
    stores too) and rows 4 elements longer than the heads' fused width;
    dbias wherever there is a bias."""
    for i, (b, l, s, h, d, with_bias, pad) in enumerate(
            ((3, 64, 64, 5, 40, True, 0), (2, 7, 128, 3, 64, True, 0),
             (2, 128, 128, 2, 128, True, 0), (4, 1, 1, 3, 64, False, 0),
             (3, 50, 50, 4, 37, True, 0), (2, 64, 64, 3, 64, True, 4))):
        q, k, v, bias = _views(cuda, dtype, b, l, s, h, d, with_bias, seed=40 + i, pad=pad)
        g = torch.randn(q.shape, generator=torch.Generator(device=cuda).manual_seed(50 + i),
                        device=cuda).to(dtype)
        for rate, seed in ((0.0, None), (0.1, 9)):
            _check_k2(q, k, v, bias, g, rate, _seed(cuda, seed), (b, l, s, h, d, pad))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 4e-3)])
def test_cuda_k3_tile_edges(cuda, dtype, tol):
    """K3 at the edges of the bf16 tiling: L = 17 (one warp with 1 live row
    of 16, the other three with none) against a ragged key tile with a
    bias, a single key, and the views that only element loads stage: D = 37
    (odd-width stores too) and rows 4 elements longer than the heads' fused
    width."""
    for i, (b, l, s, h, d, with_bias, pad) in enumerate(
            ((3, 17, 300, 4, 64, True, 0), (2, 100, 1, 4, 64, False, 0),
             (2, 70, 90, 3, 37, True, 0), (2, 257, 257, 2, 64, False, 4))):
        q, k, v, bias = _views(cuda, dtype, b, l, s, h, d, with_bias, seed=30 + i, pad=pad)
        before = tfl.flash_attention.launches
        out = tfl.flash_attention(q, k, v, bias, d ** -0.5)
        torch.cuda.synchronize()
        assert tfl.flash_attention.launches == before + 1
        ref = tfl.flash_attention_plain(q, k, v, bias, d ** -0.5)
        err = (out.float() - ref.float()).abs().max().item()
        size = max(1.0, ref.float().abs().max().item()) if dtype == torch.bfloat16 else 1.0
        assert err <= tol * size, (b, l, s, h, d, err)


def _clip_l_views(cuda, b, seed, l=257, h=16, d=64):
    """q, k, v at the CLIP-L site: strided bf16 views of one fused (B, L,
    3 H D) QKV tensor, as the vision tower's projection gives them."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn((b, l, 3 * h * d), generator=g, device=cuda).bfloat16()
    return tuple(qkv[:, :, i * h * d:(i + 1) * h * d].view(b, l, h, d) for i in range(3))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8, 16, 32])
def test_cuda_k3_wgmma_body_at_the_clip_l_site(cuda, b):
    """The wgmma body at the CLIP-L geometry (L = S = 257, H 16, D 64) on
    the strided QKV views, at the serving buckets and the training batch:
    ``body_for`` picks it, one launch, within K3's bf16 tolerance of the
    plain version, and at most 1% of the outputs differ from the plain
    version's at all where K1's rounding (p rounded once) moves more."""
    q, k, v = _clip_l_views(cuda, b, seed=60 + b)
    scale = 64 ** -0.5
    assert tfl.body_for(q, k, v) == "wgmma"
    before = tfl.flash_attention.launches
    out = tfl.flash_attention(q, k, v, None, scale)
    torch.cuda.synchronize()
    assert tfl.flash_attention.launches == before + 1
    ref = tfl.flash_attention_plain(q, k, v, None, scale)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 4e-3 * max(1.0, ref.float().abs().max().item()), (b, err)
    once = tfa.fused_attention_small_plain(q, k, v, None, scale)
    share = (out != ref).float().mean().item()
    assert share <= 0.01 < (once != ref).float().mean().item(), (b, share)


@pytest.mark.cuda
def test_cuda_k3_wgmma_replay_equals_eager(cuda):
    """A captured and replayed launch of the wgmma body (with a key bias)
    equals the eager launch bit for bit, and stays so after other launches
    of K3 at other shapes."""
    q, k, v = _clip_l_views(cuda, 4, seed=70)
    lengths = torch.tensor([[257], [100], [5], [200]], device=cuda)
    bias = tattn.padding_key_bias(torch.arange(257, device=cuda)[None] < lengths)
    run = lambda: tfl.flash_attention(q, k, v, bias, 0.125)
    eager = run()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    tfl.flash_attention(*_clip_l_views(cuda, 2, seed=71, l=100), None, 0.125)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


@pytest.mark.cuda
def test_cuda_k3_refused_body_raises(cuda):
    """A body the launch's type, shape or alignment cannot take raises, and
    no other body runs in its place: the wgmma body on rows 4 elements
    longer than the heads' width (off 16 bytes), at D = 37, and past its
    keys; the fp32 body on bf16; the mma.sync body on fp32."""
    q, k, v, _ = _views(cuda, torch.bfloat16, 2, 257, 257, 2, 64, False, seed=72, pad=4)
    odd = _views(cuda, torch.bfloat16, 2, 70, 90, 2, 37, False, seed=73)[:3]
    long = _views(cuda, torch.bfloat16, 1, 64, 656, 1, 64, False, seed=74)[:3]
    fine = _clip_l_views(cuda, 1, seed=75, h=2)
    for (a, b, c), body in (((q, k, v), "wgmma"), (odd, "wgmma"), (long, "wgmma"),
                            (fine, "fp32"), (tuple(x.float() for x in fine), "mma_sync")):
        assert tfl.body_for(a, b, c) != body
        before = tfl.flash_attention.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            tfl.flash_attention(a, b, c, None, 0.125, body=body)
        assert tfl.flash_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("d", [264, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_dispatch_raises_for_heads_wider_than_k3(cuda, d, dtype):
    """D above 256 without dropout: the dispatch launches K3 (its wide
    body), one launch, equal to the plain version within K3's tolerances
    (fp32 1e-5; bf16 4e-3 of max(1, max |ref|))."""
    x = torch.randn(1, 300, 1, d, device=cuda).to(dtype)
    before = tfl.flash_attention.launches
    out = tattn.dot_product_attention(x, x, x)
    assert tfl.flash_attention.launches == before + 1
    ref = tfl.flash_attention_plain(x, x, x, None, d ** -0.5)
    tol = 1e-5 if dtype == torch.float32 else 4e-3 * max(1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "int8_all"])
@pytest.mark.parametrize("shape", [(4096, 768, 3072), (5, 37, 3)], ids=["ffn", "odd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_quant_dot_matches_cpu(cuda, mode, shape, dtype):
    """``quant_dot`` through ``torch._int_mm`` on the card against the CPU on
    the same operands, at a BERT FFN shape and at an odd one that takes the
    padding: the forward bit for bit (the integer product is exact), and the
    backward: ``int8_all``'s bit for bit, ``int8``'s float product within
    1e-5 of its largest value in fp32 (TF32 off)."""
    from d2r_tpu_torch.ops import qdot
    m, k, n = shape
    g = torch.Generator().manual_seed(m + k + n)
    x, w, ct = (torch.randn(s, generator=g).to(dtype) for s in ((m, k), (n, k), (m, n)))
    out = []
    for dev in ("cpu", cuda):
        xd, wd = (t.to(dev, copy=True).requires_grad_() for t in (x, w))
        y = qdot.quant_dot(xd, wd, mode)
        y.backward(ct.to(dev))
        out.append([t.detach().cpu().float() for t in (y, xd.grad, wd.grad)])
    (y0, dx0, dw0), (y1, dx1, dw1) = out
    assert torch.equal(y1, y0)
    for a, b in ((dx1, dx0), (dw1, dw0)):
        if mode == "int8_all":
            assert torch.equal(a, b)
        elif dtype == torch.float32:
            assert (a - b).abs().max() <= 1e-5 * b.abs().max()


@pytest.mark.cuda
def test_cuda_sentic_logits_match_cpu(cuda):
    """The tiny sentic model's fp32 logits with an adjacency, card against
    CPU, within 1e-3 as chip_smoke's phase 5 holds them."""
    from d2r_tpu_torch.config import tiny_test_config
    from d2r_tpu_torch.data.dataset import synthetic_batch
    from d2r_tpu_torch.data.sentic import batched_affective_adjacency, load_sentic_lexicon
    from d2r_tpu_torch.models.unimo import build_model
    cfg = tiny_test_config(use_sentic_graph=True)
    b = synthetic_batch(4, cfg.max_seq, cfg.vision_config().image_size,
                        vocab_size=cfg.text_config().vocab_size)
    b["sentic_adj"] = batched_affective_adjacency(
        ["happy day", "sad and terrible storm", "love it", "zzz"], load_sentic_lexicon(),
        cfg.max_seq)
    logits = []
    for dev in ("cpu", cuda):
        model = build_model(cfg, device=dev, seed=0)
        with torch.no_grad():
            out = model(**{k: torch.as_tensor(v).to(dev) for k, v in b.items()
                           if k in ("input_ids", "attention_mask", "token_type_ids", "labels",
                                    "pixel_values", "sentic_adj")})
        logits.append(out[1].float().cpu())
    assert (logits[1] - logits[0]).abs().max() <= 1e-3


# ---- the train step as one program ---------------------------------------

def _adamw_groups(device, sizes, mu_dtype, seed):
    """Two lr groups of fp32 tensors of ``sizes`` (p, g, mu, nu, base lr),
    random values from ``seed``, mu in ``mu_dtype``."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    rnd = lambda n: torch.randn(n, generator=g)
    groups = []
    for part, lr in ((sizes[::2], 1e-3), (sizes[1::2], 5e-2)):
        ps = [rnd(n).to(device) for n in part]
        groups.append((ps, [rnd(n).to(device) for n in part],
                       [(rnd(n) * 0.1).to(device, mu_dtype) for n in part],
                       [(rnd(n) ** 2 * 0.01).to(device) for n in part], lr))
    return groups


@pytest.mark.cuda
@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
def test_cuda_adamw_kernel_equals_its_twin(cuda, mu_dtype):
    """The AdamW kernel against its plain twin on the same tensors, bit for
    bit: odd sizes (one element, three, 1023, 2^14 + 1, 2^25 + 7: a
    tensor over many blocks of the persistent grid) in two lr groups, three
    steps through a fractional warmup (1.5 of 4 steps), with the count and
    the schedule on the card."""
    from d2r_tpu_torch.ops.kernels import adamw
    sizes = (1, 3, 1023, (1 << 14) + 1, (1 << 25) + 7)
    hp, sch = adamw.hyper((0.9, 0.999), 1e-8, 1e-2), adamw.schedule(1.5, 4)
    kernel_groups = _adamw_groups(cuda, sizes, mu_dtype, seed=0)
    twin_groups = [tuple([t.clone() for t in x] if isinstance(x, list) else x for x in grp)
                   for grp in kernel_groups]
    count_k = torch.zeros((), device=cuda)
    count_t = torch.zeros((), device=cuda)
    before, table = adamw.adamw_update.launches, None
    for _ in range(3):
        table = adamw.adamw_update(kernel_groups, count_k, hp, sch, table)
        adamw.adamw_plain(twin_groups, count_t, hp, sch)
    torch.cuda.synchronize()
    assert adamw.adamw_update.launches == before + 3
    assert float(count_k) == float(count_t) == 3.0
    for got, want in zip(kernel_groups, twin_groups):
        for a, b in zip(got[:4], want[:4]):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and torch.equal(x, y), (x.numel(), x.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_hidden_dropout_equals_plain(cuda, dtype):
    """The hidden-dropout kernel against its plain version, bit for bit,
    forward and backward (the same mask regenerated), at a BERT hidden
    state's shape and an odd size; two sites differ."""
    from d2r_tpu_torch.ops.kernels import dropout as tdrop
    for shape in ((8, 64, 768), (3, 5, 7)):
        x = torch.randn(shape, device=cuda).to(dtype).requires_grad_()
        seed = _seed(cuda, 2 ** 63 + 11, site=4)
        y = tdrop.hidden_dropout(x, 0.1, seed)
        y.backward(torch.ones_like(y))
        ref = tdrop.hidden_dropout_plain(x.detach(), 0.1, seed)
        assert torch.equal(y.detach(), ref)
        assert torch.equal(x.grad, tdrop.hidden_dropout_plain(torch.ones_like(x), 0.1, seed))
        other = tdrop.hidden_dropout(x.detach(), 0.1, seed._replace(site=5))
        assert not torch.equal(other, y.detach())


@pytest.mark.cuda
@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
def test_cuda_adamw_kernel_on_a_flat_buffer_at_odd_offsets(cuda, mu_dtype):
    """Every stream's tensors cut end to end from one flat buffer (4-byte
    offsets, numel % 4 in {1, 2, 3}): the kernel's scalar body for the
    tensors off alignment and the ragged ends, bit for bit against the twin
    after three steps through the fractional warmup."""
    from d2r_tpu_torch.ops.kernels import adamw
    sizes = (1, 6, 7, 1025, 4098, 65539, (1 << 18) + 3)
    hp, sch = adamw.hyper((0.9, 0.999), 1e-8, 1e-2), adamw.schedule(1.5, 4)
    g = torch.Generator(device="cpu").manual_seed(1)
    flats = [torch.randn(sum(sizes), generator=g) for _ in range(4)]
    flats = [flats[0], flats[1], (flats[2] * 0.1).to(mu_dtype), flats[3] ** 2 * 0.01]
    starts = [sum(sizes[:i]) for i in range(len(sizes))]
    views = [[f.to(cuda)[a:a + n] for a, n in zip(starts, sizes)] for f in flats]
    assert any(v.data_ptr() % 16 for v in views[0])
    kernel_groups = [tuple(v[::2] for v in views) + (1e-3,),
                     tuple(v[1::2] for v in views) + (5e-2,)]
    twin_groups = [tuple([t.clone() for t in x] if isinstance(x, list) else x for x in grp)
                   for grp in kernel_groups]
    count_k, count_t = torch.zeros((), device=cuda), torch.zeros((), device=cuda)
    table = None
    for _ in range(3):
        table = adamw.adamw_update(kernel_groups, count_k, hp, sch, table)
        adamw.adamw_plain(twin_groups, count_t, hp, sch)
    torch.cuda.synchronize()
    assert table.scalar_elements > 0
    assert float(count_k) == float(count_t) == 3.0
    for got, want in zip(kernel_groups, twin_groups):
        for a, b in zip(got[:4], want[:4]):
            for x, y in zip(a, b):
                assert torch.equal(x, y), (x.numel(), x.data_ptr() % 16, x.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_hidden_dropout_adversarial_inputs(cuda, dtype):
    """The hidden-dropout kernel bit for bit against its plain version,
    forward and backward, on views 2 (bf16), 4 and 8 bytes off 16-byte
    alignment, at sizes with n % 16 in {1, 4, 7, 12}, and under a slice
    layout whose seg is 4 mod 8 (a thread's two Philox groups in two rows),
    whose outputs are also the whole tensor's."""
    from d2r_tpu_torch.ops.kernels import dropout as tdrop
    seed = _seed(cuda, 2 ** 33 + 17, site=5)
    size = torch.empty((), dtype=dtype).element_size()
    cases = []
    for off in ((2, 4, 8) if dtype == torch.bfloat16 else (4, 8)):
        flat = torch.randn(2, 4 * 64 * 768 + 16, device=cuda).to(dtype)
        x, g = (f[off // size:off // size + 4 * 64 * 768].view(4, 64, 768) for f in flat)
        assert x.data_ptr() % 16 == off
        cases.append((x.detach().requires_grad_(), g, None))
    for r in (1, 4, 7, 12):
        x, g = torch.randn(2, 16 * 1001 + r, device=cuda).to(dtype)
        cases.append((x.clone().requires_grad_(), g, None))
    whole = torch.randn(301, 24, device=cuda).to(dtype)
    part = whole[:, 12:].contiguous()
    cases.append((part.clone().requires_grad_(), torch.randn_like(part), (12, 24, 12)))
    for x, g, layout in cases:
        y = tdrop.hidden_dropout(x, 0.1, seed, layout)
        y.backward(g)
        assert torch.equal(y.detach(), tdrop.hidden_dropout_plain(x.detach(), 0.1, seed, layout))
        assert torch.equal(x.grad, tdrop.hidden_dropout_plain(g, 0.1, seed, layout))
    assert torch.equal(y.detach(), tdrop.hidden_dropout(whole, 0.1, seed)[:, 12:])


def _step_config(dropout: bool, **kw):
    import dataclasses

    from d2r_tpu_torch import config as tconfig
    tc = tconfig.tiny_test_config().text_config()
    if not dropout:
        tc = dataclasses.replace(tc, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    name = "tiny-bert" if dropout else "tiny-bert-dropout-0"
    tconfig.register_text_preset(name, lambda: tc)
    return tconfig.tiny_test_config(DR_step=4, bert_name=name, lr=1e-3, warmup_ratio=0.3,
                                    **kw)


def _batches(n, size=4, seed=0):
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(5, 128, size=(size, 16)).astype(np.int32)
        mask = (np.arange(16)[None] < rng.integers(4, 17, size=(size, 1))).astype(np.int32)
        out.append(dict(input_ids=ids * mask, attention_mask=mask,
                        token_type_ids=np.zeros_like(ids),
                        labels=rng.integers(0, 3, size=size).astype(np.int32),
                        pixel_values=rng.standard_normal((size, 3, 32, 32)).astype(np.float32)))
    return out


def _eager_run(state, batches, seed):
    """The eager step on the card, the captured step's yardstick."""
    from d2r_tpu_torch.train import state as st
    losses = []
    for b in batches:
        losses.append(st._eager_step(state, b, seed, False)["loss"])
        state.step += 1
    return losses


@pytest.mark.cuda
@pytest.mark.parametrize("dropout", [False, True], ids=["dropout_off", "dropout_on"])
def test_cuda_replayed_steps_equal_eager_steps(cuda, dropout):
    """Six train steps of a tiny model through ``make_train_step`` (two
    eager warm-up steps, then the capture and four replays) against six
    eager steps from the same weights, with dropout off and on: the losses
    and every parameter agree within 1e-5 of each leaf's max |value|
    (atomics in the embeddings' and K2's dbias backward reorder sums); the
    replayed steps launch no kernel wrapper from the host, and run under
    ``set_sync_debug_mode("error")``."""
    import copy

    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.ops.kernels import adamw
    from d2r_tpu_torch.train import state as st
    cfg = _step_config(dropout)
    model = build_model(cfg, device="cpu", seed=0)
    batches = _batches(6)
    ref = st.create_train_state(cfg, 10, device=cuda, model=copy.deepcopy(model))
    ref_losses = _eager_run(ref, batches, 5)
    got = st.create_train_state(cfg, 10, device=cuda, model=copy.deepcopy(model))
    step = st.make_train_step()
    losses = []
    for i, b in enumerate(batches):
        if i == st.WARMUP_STEPS + 1:     # captured: replays from here on
            before = (tfa.fused_attention_small.launches, adamw.adamw_update.launches)
            torch.cuda.set_sync_debug_mode("error")
        got, m = step(got, b, 5)
        losses.append(m["loss"])
    torch.cuda.set_sync_debug_mode(0)
    assert (tfa.fused_attention_small.launches, adamw.adamw_update.launches) == before
    assert got.step == ref.step == 6
    assert set(got.captured.programs) and all(
        "step" in p.graphs for p in got.captured.programs.values())
    for a, b in zip(losses, ref_losses):
        assert abs(float(a) - float(b)) <= 1e-5 * max(1.0, abs(float(b))), (losses, ref_losses)
    for (n, p), q in zip(got.model.named_parameters(), ref.model.parameters()):
        assert (p - q).abs().max().item() <= 1e-5 * q.abs().max().clamp_min(1e-30).item(), n
    assert float(got.optimizer.count) == float(ref.optimizer.count) == 6


@pytest.mark.cuda
def test_cuda_captured_multi_and_accum_steps_equal_eager(cuda):
    """``make_multi_step`` replays the single step's graph, every step's
    loss its own (not the last one's); ``make_accum_step`` replays a
    microbatch graph a microbatch and the apply graph; both against the
    eager steps from the same weights, dropout on."""
    import copy

    import numpy as np

    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.train import state as st
    cfg = _step_config(True)
    model = build_model(cfg, device="cpu", seed=1)
    batches = _batches(8, seed=1)
    stacked = lambda bs: {k: np.stack([b[k] for b in bs]) for k in bs[0]}
    got = st.create_train_state(cfg, 10, device=cuda, model=copy.deepcopy(model))
    ref = st.create_train_state(cfg, 10, device=cuda, model=copy.deepcopy(model))
    _, m = st.make_multi_step(4)(got, stacked(batches[:4]), 7)
    _, m2 = st.make_multi_step(4)(got, stacked(batches[4:]), 7)
    ref_losses = _eager_run(ref, batches, 7)
    got_losses = m["losses"].tolist() + m2["losses"].tolist()
    np.testing.assert_allclose(got_losses, [float(x) for x in ref_losses], rtol=1e-5, atol=1e-6)
    assert len(set(got_losses)) == 8

    acc = st.create_train_state(cfg, 10, device=cuda, model=copy.deepcopy(model))
    acc_ref = st.create_train_state(cfg, 10, device=cuda, model=copy.deepcopy(model))
    accum = st.make_accum_step(2)
    for i in range(4):
        micro = batches[2 * i:2 * i + 2]
        _, m = accum(acc, stacked(micro), 7)
        want = st._eager_accum(acc_ref, micro, 7, False)["loss"]
        acc_ref.step += 1
        assert abs(float(m["loss"]) - float(want)) <= 1e-5 * max(1.0, abs(float(want)))
    assert any(k[0] == "accum" for k in acc.captured.programs)
    for p, q in zip(acc.model.parameters(), acc_ref.model.parameters()):
        assert (p - q).abs().max().item() <= 1e-5 * q.abs().max().clamp_min(1e-30).item()


@pytest.mark.cuda
def test_cuda_captured_debug_nans_raises_before_the_update(cuda):
    """With ``debug_nans`` the captured step is a forward/backward graph,
    the host check and an apply graph: a NaN batch after the capture raises
    and leaves the parameters and the count as they were."""
    import numpy as np

    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.train import state as st
    cfg = _step_config(False)
    state = st.create_train_state(cfg, 10, device=cuda, model=build_model(cfg, "cpu", seed=2))
    step = st.make_train_step(debug_nans=True)
    batches = _batches(4, seed=2)
    for b in batches[:3]:
        step(state, b, 1)
    bad = dict(batches[3], pixel_values=np.full_like(batches[3]["pixel_values"], np.nan))
    before = [p.detach().clone() for p in state.model.parameters()]
    with pytest.raises(FloatingPointError, match="debug_nans: step 3"):
        step(state, bad, 1)
    assert state.step == 3 and float(state.optimizer.count) == 3
    assert all(torch.equal(p, q) for p, q in zip(state.model.parameters(), before))
    assert {"fb", "apply"} <= set(next(iter(state.captured.programs.values())).graphs)


@pytest.mark.cuda
def test_cuda_custom_ops_pass_opcheck(cuda):
    """``torch.library.opcheck`` on K1, K2 and K3's custom ops: schema,
    fake implementation against the kernel (shapes, types, strides) and
    dispatch, with and without dropout and bias."""
    g = torch.Generator(device=cuda).manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.randn((2, 50, 3, 4 * 32), generator=g, device=cuda).to(dtype)
        q, k, v = (qkv[:, :, i].view(2, 50, 4, 32) for i in range(3))
        bias = tattn.padding_key_bias(torch.arange(50, device=cuda)[None] < torch.tensor(
            [[50], [20]], device=cuda))
        seed = tfa.seed_tensor(11, cuda)
        gout = torch.randn((2, 50, 4, 32), generator=g, device=cuda).to(dtype)
        for b, rate in ((None, 0.0), (bias, 0.1)):
            torch.library.opcheck(torch.ops.d2r_torch.fused_attention_fwd.default,
                                  (q, k, v, b, 0.125, rate, seed if rate else None, 3))
            for need in (True, False):
                torch.library.opcheck(torch.ops.d2r_torch.fused_attention_bwd.default,
                                      (q, k, v, b, gout, 0.125, rate, seed if rate else None,
                                       3, need))
            torch.library.opcheck(torch.ops.d2r_torch.flash_attention_fwd.default,
                                  (q, k, v, b, 0.125))


def _plain_attention_einsums(program):
    return sum(1 for n in program.graph.nodes if n.op == "call_function"
               and str(n.target) == "aten.einsum.default"
               and n.args[0] in ("blhd,bshd->bhls", "bhls,bshd->blhd"))


@pytest.mark.cuda
def test_cuda_exported_program_holds_k1_and_replays_equal_to_predictor(cuda, tmp_path):
    """A tiny DR_step=4 model exported on the card: each bucket's program
    holds the K1 op at its 14 sites and no plain einsum attention; loaded
    with the same weights, its replay in the bucket graph equals
    ``Predictor``'s replay bit for bit, and a loader on the card refuses a
    program exported for the CPU."""
    import copy

    import numpy as np

    from d2r_tpu_torch import export as texport
    _, gpu, args = _tiny_predictors(cuda, compute_dtype="bfloat16")
    cfg = gpu.cfg
    from d2r_tpu_torch.models.unimo import build_model
    model = build_model(cfg, device="cpu", seed=0)
    out = str(tmp_path / "art")
    manifest = texport.export_predictor(cfg, model, out, batch_buckets=(2, 4),
                                        platforms=("cpu", "cuda"))
    assert manifest["platforms"] == ["cpu", "cuda"]
    loaded = texport.load_exported(out, copy.deepcopy(model))
    tfa.fused_attention_small.launches = 0
    loaded.warmup()
    assert tfa.fused_attention_small.launches == 2 * 14 * 2
    for b in (2, 4):
        program = loaded.programs[b]
        k1 = [n for n in program.graph.nodes
              if n.target is torch.ops.d2r_torch.fused_attention_fwd.default]
        assert len(k1) == 14 and _plain_attention_einsums(program) == 0
        cpu_program = torch.export.load(os.path.join(out, manifest["files"][str(b)]["cpu"]))
        assert _plain_attention_einsums(cpu_program) == 2 * 14
    for n in (1, 3):
        got, want = loaded.predict(*(x[:n] for x in args)), gpu.predict(*(x[:n] for x in args))
        np.testing.assert_array_equal(got["probs"], want["probs"])
    with open(os.path.join(out, "manifest.json")) as f:
        only_cpu = dict(json.load(f), platforms=["cpu"])
    with open(os.path.join(out, "manifest.json"), "w") as f:
        json.dump(only_cpu, f)
    with pytest.raises(ValueError, match="export on the card"):
        texport.load_exported(out, copy.deepcopy(model))


@pytest.mark.cuda
def test_cuda_replayed_eval_equals_eager_after_steps_and_restore(cuda, tmp_path):
    """Three different batches through ``make_eval_step`` on the card (the
    eager warm-up, the capture, a replay): each batch's kept loss and logits
    equal its eager forward bit for bit, read after all three ran, so no
    replay overwrote an earlier batch's; again after a train step and after
    ``restore_checkpoint``; one eval graph, its wrappers called twice."""
    import types

    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.train import checkpoint as tckpt
    from d2r_tpu_torch.train import state as st
    cfg = _step_config(dropout=True)
    path = str(tmp_path / "best_model")
    tckpt.save_checkpoint(path, types.SimpleNamespace(model=build_model(cfg, device="cpu",
                                                                        seed=0)))
    state = tckpt.restore_checkpoint(path, st.create_train_state(cfg, 10, device=cuda))
    batches = _batches(3, seed=7)
    step = st.make_eval_step()

    def check():
        with torch.no_grad():
            ref = [st._eager_eval(state, b) for b in batches]
        got = [step(state, b) for b in batches]
        for g, r in zip(got, ref):
            assert torch.equal(g["loss"], r["loss"]) and torch.equal(g["logits"], r["logits"])
        return ref

    tfa.fused_attention_small.launches = 0
    first = check()
    evals = [k for k in state.captured.programs if k[0] == "eval"]
    assert len(evals) == 1 and "eval" in state.captured.programs[evals[0]].graphs
    # the eager references: 3 x 14; make_eval_step: the warm-up and the capture
    assert tfa.fused_attention_small.launches == 3 * 14 + 2 * 14
    state, _ = st.make_train_step()(state, batches[0], 5)
    moved = check()
    assert not torch.equal(moved[0]["logits"], first[0]["logits"])
    tckpt.restore_checkpoint(path, state)
    again = check()
    assert all(torch.equal(a["logits"], b["logits"]) for a, b in zip(first, again))


@pytest.mark.cuda
def test_cuda_pipelined_replayed_steps_equal_eager_steps(cuda):
    """A tiny model whose towers run as two pipeline stages over two
    microbatches in one process: six steps through ``make_train_step``
    (two eager warm-up steps, then the capture and four replays) against
    six eager steps from the same weights, dropout on: the losses and every
    parameter within 1e-5 of each leaf's max |value|, and the replays launch
    no wrapper from the host."""
    import copy

    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.train import state as st
    cfg = _step_config(True, pipeline_stages=2)
    model = build_model(cfg, device="cpu", seed=0)
    batches = _batches(6)
    ref = st.create_train_state(cfg, 10, device=cuda, model=copy.deepcopy(model))
    ref_losses = _eager_run(ref, batches, 5)
    got = st.create_train_state(cfg, 10, device=cuda, model=copy.deepcopy(model))
    step = st.make_train_step()
    losses = []
    for i, b in enumerate(batches):
        if i == st.WARMUP_STEPS + 1:
            before = tfa.fused_attention_small.launches
        got, m = step(got, b, 5)
        losses.append(m["loss"])
    assert tfa.fused_attention_small.launches == before
    assert all("step" in p.graphs for p in got.captured.programs.values())
    for a, b in zip(losses, ref_losses):
        assert abs(float(a) - float(b)) <= 1e-5 * max(1.0, abs(float(b))), (losses, ref_losses)
    for (n, p), q in zip(got.model.named_parameters(), ref.model.parameters()):
        assert (p - q).abs().max().item() <= 1e-5 * q.abs().max().clamp_min(1e-30).item(), n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_quant_dot_under_two_gloo_ranks_is_one_process_s_bits(cuda, dtype):
    """``quant_dot`` split over the model group of two gloo ranks on the
    card, along K and along N, both modes: the forward and the quantized
    backward equal one process's bits (``tests/test_torch_parallel_ranks.py
    ::qdot_rank``)."""
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import test_torch_parallel_ranks as ranks

    from d2r_tpu_torch.parallel.launch import spawn
    for r in spawn(ranks.qdot_rank, 2, (dtype, "cuda")):
        for mode, sides in r.items():
            for side, checks in sides.items():
                assert all(checks), (mode, side, checks)


# (M, N, K, period, bias): W8A16 at D2R-base's serving sites at buckets 1,
# 8 and 32 (BERT rows 64 a post: FFN in and out, the QKV with one scale a
# hidden unit; the patch conv's 49 patches a post), a 50-row CLIP product,
# an odd shape that 16-byte copies cannot stage, one row and eight (the
# warp-a-column body), a ragged grid, and one row a post at bucket 32
W8A16_SITES = ((64, 3072, 768, 3072, True), (64, 768, 3072, 768, True),
               (64, 2304, 768, 768, True), (49, 768, 3072, 768, False),
               (64, 768, 768, 768, True), (1, 768, 768, 768, True))
W8A16_CASES = (*((rows * b, n, k, period, with_bias) for b in (1, 8, 32)
                 for rows, n, k, period, with_bias in W8A16_SITES),
               (50, 768, 768, 768, True), (5, 3, 37, 3, True), (1, 768, 768, 768, True),
               (8, 6, 768, 6, True), (300, 77, 200, 77, False), (32, 768, 768, 768, True))
# shapes for every wgmma body and split called directly: a site, a ragged
# grid with K not a multiple of the 64-deep step, bucket 8's patch conv, and
# a grid of tiles ragged in tokens and features that persistent blocks walk
# several tiles each
W8A16_BODY_CASES = ((64, 3072, 768, 3072, True), (130, 200, 1040, 100, True),
                    (392, 768, 3072, 768, False), (1000, 2312, 768, 2312, True))
W8A16_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _w8a16_inputs(cuda, m, n, k, period, with_bias, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=cuda).to(dtype)
    q = torch.randint(-127, 128, (n, k), generator=g, device=cuda).to(torch.int8)
    scale = torch.rand((period,), generator=g, device=cuda) * 0.02 + 1e-3
    bias = torch.randn((n,), generator=g, device=cuda).to(dtype) if with_bias else None
    return x, q, scale, bias


def _w8a16_body(x, q, scale, period, bias, body, splits, blocks=None):
    """The bf16 kernel launched directly with ``body`` and K cut into
    ``splits``; unsplit, ``blocks`` persistent blocks (at most one a tile)
    walk the tiles (by default at most the SMs times the body's blocks an
    SM)."""
    from d2r_tpu_torch.ops.kernels import w8a16
    m, k = x.shape
    n = q.shape[0]
    steps = -(-k // w8a16.K_STEP[x.dtype])
    per = -(-steps // splits)
    tokens, _, per_sm = w8a16.WGMMA_TILES[body]
    tiles = -(-m // tokens) * -(-n // 64)
    blocks = min(tiles, w8a16._sm_count(x.device) * per_sm if blocks is None else blocks)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = w8a16._kernel()(1, body, x.data_ptr(), x.stride(0), q.data_ptr(), scale.data_ptr(),
                          period, None if bias is None else bias.data_ptr(), out.data_ptr(), m,
                          n, k, -(-steps // per), per, blocks,
                          torch.cuda.current_stream().cuda_stream)
    assert err == 0, (body, splits, blocks, err)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_w8a16_matches_plain(cuda, dtype):
    """The W8A16 kernel against its plain version (the dequantized weight,
    then ``F.linear``) at every serving site of buckets 1, 8 and 32 and the
    edge shapes, within 1e-5 (fp32) / 1e-2 (bf16) of max(1, max |ref|):
    the sums run in another order, and bf16 rounds once at the end. A view
    of x with a row stride gives the contiguous input's bits; so does one
    off 16-byte alignment, except where the shape takes a wgmma body,
    which hands such a view to the 64 x 64 mma.sync body: that sums in
    another order, within the same tolerance. In bf16 every wgmma body
    under one, two and three splits of K, called directly, is within the
    tolerance too, and unsplit gives the same bits whether one, three or
    the default number of persistent blocks walk the tiles."""
    from d2r_tpu_torch.ops.kernels import w8a16
    for m, n, k, period, with_bias in W8A16_CASES:
        x, q, scale, bias = _w8a16_inputs(cuda, m, n, k, period, with_bias, dtype)
        before = w8a16.w8a16_linear.launches
        out = w8a16.w8a16_linear(x, q, scale, period, bias)
        torch.cuda.synchronize()
        assert w8a16.w8a16_linear.launches == before + 1
        ref = w8a16.w8a16_linear_plain(x, q, scale, period, bias)
        assert out.shape == ref.shape and out.dtype == dtype
        tol = W8A16_TOL[dtype] * max(1.0, ref.float().abs().max().item())
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= tol, (m, n, k, err)
        wide = torch.zeros((m, k + 8), dtype=dtype, device=cuda)
        wide[:, :k] = x
        assert torch.equal(w8a16.w8a16_linear(wide[:, :k], q, scale, period, bias), out)
        off = torch.zeros(m * k + 1, dtype=dtype, device=cuda)
        off[1:] = x.reshape(-1)
        got = w8a16.w8a16_linear(off[1:].view(m, k), q, scale, period, bias)
        if w8a16.tiling(m, n, k, dtype)[0] in w8a16.WGMMA_TILES:
            assert (got.float() - ref.float()).abs().max().item() <= tol, (m, n, k)
        else:
            assert torch.equal(got, out), (m, n, k)
    if dtype != torch.bfloat16:
        return
    for m, n, k, period, with_bias in W8A16_BODY_CASES:
        x, q, scale, bias = _w8a16_inputs(cuda, m, n, k, period, with_bias, dtype, seed=1)
        ref = w8a16.w8a16_linear_plain(x, q, scale, period, bias).float()
        tol = W8A16_TOL[dtype] * max(1.0, ref.abs().max().item())
        for body in w8a16.WGMMA_TILES:
            for splits in (1, 2, 3):
                got = _w8a16_body(x, q, scale, period, bias, body, splits)
                torch.cuda.synchronize()
                err = (got.float() - ref).abs().max().item()
                assert err <= tol, (m, n, k, body, splits, err)
                if splits == 1:
                    for blocks in (1, 3):
                        walked = _w8a16_body(x, q, scale, period, bias, body, 1, blocks)
                        assert torch.equal(walked, got), (m, n, k, body, blocks)


@pytest.mark.cuda
def test_cuda_w8a16_captured_equals_eager_and_raises_instead_of_falling_back(cuda):
    """Captured W8A16 launches replay the eager launches' bits at every
    bf16 serving site of buckets 1, 8 and 32 (their bodies and splits as
    the wrapper picks them, split-K included) and for every wgmma body
    under two splits and unsplit on a persistent grid of 5 blocks, again
    after eager launches of other shapes between two replays (a
    persistent launch leaves no state behind); fp16, a CPU scale and a
    period that does not divide N raise."""
    from d2r_tpu_torch.ops.kernels import w8a16
    assert w8a16.tiling(64, 768, 3072, torch.bfloat16)[1] > 1
    inputs = [_w8a16_inputs(cuda, m, n, k, period, with_bias, torch.bfloat16, seed=i)
              for i, (m, n, k, period, with_bias) in enumerate(W8A16_CASES[:18])]
    x0, q0, scale0, bias0 = inputs[0]
    run = lambda: ([w8a16.w8a16_linear(x, q, s, s.numel(), b) for x, q, s, b in inputs]
                   + [_w8a16_body(x0, q0, scale0, scale0.numel(), bias0, body, 2)
                      for body in w8a16.WGMMA_TILES]
                   + [_w8a16_body(x0, q0, scale0, scale0.numel(), bias0, body, 1, 5)
                      for body in w8a16.WGMMA_TILES])
    eager = run()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    graph.replay()
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(captured, eager)):
        assert torch.equal(a, b), i
    for x, q, s, b in reversed(inputs):
        w8a16.w8a16_linear(x[: x.shape[0] // 2 + 9], q, s, s.numel(), b)
    graph.replay()
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(captured, eager)):
        assert torch.equal(a, b), i
    x, q, scale, bias = inputs[1]
    for bad in ((x.half(), q, scale, 768), (x, q, scale.cpu(), 768), (x, q, scale[:7], 7)):
        with pytest.raises((TypeError, ValueError)):
            w8a16.w8a16_linear(*bad)


# quantize shapes: the BERT FFN activation, its weight, and odd ones (K not a
# multiple of 16, fewer rows than a block, rows and columns past the
# column passes' 128 x 64 and 64-column tiles)
QUANT_SHAPES = ((4096, 768), (3072, 768), (5, 37), (37, 5), (33, 24), (4097, 771), (257, 130))


def _quant_input(cuda, shape, dtype, seed):
    """Normal values with an all-zero row and column, .5 ties at scale 1 and
    the +-127 codes (as tests/test_torch_int8_kernels.py makes them)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=cuda) * 3
    x[0] = 0
    x[:, 0] = 0
    ties = torch.tensor([127.0, 0.5, -0.5, 1.5, 2.5, -3.5, 126.5, -127.0], device=cuda)
    x[1, 1:] = ties.repeat(shape[1])[:shape[1] - 1]
    x[1:, 1] = ties.repeat(shape[0])[:shape[0] - 1]
    return x.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_quantize_and_rescale_equal_plain(cuda, dtype):
    """The quantize kernels (rows in one launch and as amax + codes; columns,
    codes transposed) and the rescale kernel (both scale orders, a padded
    int32 view, fp32 and bf16 out) equal their plain versions bit for bit,
    eager and inside a captured graph. The column passes keep a NaN: a
    column holding one has a NaN amax (scale 1/127, as the plain version's
    amax > 0 test gives it), and every other code and scale equals the
    plain version's, on contiguous, row-strided and misaligned views."""
    from d2r_tpu_torch.ops import qdot
    from d2r_tpu_torch.ops.kernels import quantize as qk
    for i, shape in enumerate(QUANT_SHAPES):
        x = _quant_input(cuda, shape, dtype, i)

        def run():
            rows = qk.quantize_rows(x)
            rows2 = qk.quantize_rows(x, qk.row_amax(x))
            cols = qk.quantize_cols(x, qk.col_amax(x))
            y = qdot.int_mm(rows[0], rows[0])
            outs = [qk.rescale(y, rows[1], rows[1].t(), t) for t in (torch.float32, dtype)]
            outs.append(qk.rescale(y, rows[1].t(), rows[1], dtype))
            return [*rows, *rows2, *cols, *outs]

        eager = run()
        want = [*qk.quantize_rows_plain(x), *qk.quantize_rows_plain(x),
                *qk.quantize_cols_plain(x, qk.col_amax_plain(x))]
        y = qdot.int_mm(want[0], want[0])
        want += [qk.rescale_plain(y, want[1], want[1].t(), t) for t in (torch.float32, dtype)]
        want.append(qk.rescale_plain(y, want[1].t(), want[1], dtype))
        assert y.stride(0) >= y.shape[1]
        for got, ref in zip(eager, want):
            assert got.dtype == ref.dtype and torch.equal(got, ref), shape
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            run()
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = run()
        graph.replay()
        torch.cuda.synchronize()
        for got, ref in zip(captured, want):
            assert torch.equal(got, ref), shape
    for shape in ((4097, 771), (37, 5), (4096, 768)):
        x = _quant_input(cuda, shape, dtype, 7)
        x[shape[0] // 2, 2] = float("nan")
        views = {"contiguous": x}
        wide = torch.zeros((shape[0], shape[1] + 8), dtype=dtype, device=cuda)
        wide[:, :shape[1]] = x
        views["row stride"] = wide[:, :shape[1]]
        flat = torch.zeros(x.numel() + 1, dtype=dtype, device=cuda)
        flat[1:] = x.reshape(-1)
        views["misaligned"] = flat[1:].view(shape)
        want_amax = qk.col_amax_plain(x)
        want_codes, want_scale = qk.quantize_cols_plain(x, want_amax)
        keep = ~x.isnan().t()
        for name, v in views.items():
            amax = qk.col_amax(v)
            codes, scale = qk.quantize_cols(v, amax)
            torch.cuda.synchronize()
            assert amax[0, 2].isnan() and torch.equal(amax.isnan(), want_amax.isnan()), name
            assert torch.equal(amax.nan_to_num(), want_amax.nan_to_num()), name
            assert torch.equal(scale, want_scale), name
            assert torch.equal(codes[keep], want_codes[keep]), name


def _rows_input(cuda, shape, dtype, seed):
    """Normal values; the last row holds .5 ties at scale 1 and the +-127
    codes, and the first (of two or more) is all zero."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=cuda) * 3
    ties = torch.tensor([127.0, 0.5, -0.5, 1.5, 2.5, -3.5, 126.5, -127.0], device=cuda)
    x[-1] = ties.repeat(-(-shape[1] // 8))[:shape[1]]
    if shape[0] > 1:
        x[0] = 0
    return x.to(dtype)


def _nan_equal(a, b):
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())


def _rows_uses(v, tiling=None):
    """The rows kernel's three uses on ``v``: one launch, the amax alone,
    the codes from the plain amax (as an all-reduce would hand it over);
    with ``tiling``, launched in that shape."""
    from d2r_tpu_torch.ops.kernels import quantize as qk
    if tiling is None:
        return (*qk.quantize_rows(v), qk.row_amax(v),
                *qk.quantize_rows(v, qk.row_amax_plain(v)))
    r, k = v.shape
    out = [torch.empty((r, k), dtype=torch.int8, device=v.device),
           torch.empty((r, 1), dtype=torch.float32, device=v.device),
           torch.empty((r, 1), dtype=torch.float32, device=v.device),
           torch.empty((r, k), dtype=torch.int8, device=v.device),
           torch.empty((r, 1), dtype=torch.float32, device=v.device)]
    qk._launch_rows(v, None, None, out[0], out[1], tiling)
    qk._launch_rows(v, None, out[2], None, None, tiling)
    qk._launch_rows(v, qk.row_amax_plain(v), None, out[3], out[4], tiling)
    return out


def _rows_agree(got, x, what):
    """``got`` (:func:`_rows_uses`) against the plain versions on ``x``:
    the amax NaN-aware, the scales bit for bit, the codes bit for bit except
    at a NaN element (whose cast the plain version leaves to the
    platform)."""
    from d2r_tpu_torch.ops.kernels import quantize as qk
    torch.cuda.synchronize()
    codes, scale = qk.quantize_rows_plain(x)
    keep = ~x.isnan()
    for got_codes, got_scale in ((got[0], got[1]), (got[3], got[4])):
        assert torch.equal(got_scale, scale), what
        assert torch.equal(got_codes[keep], codes[keep]), what
    assert _nan_equal(got[2], qk.row_amax_plain(x)), what


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_quantize_rows_adversarial_inputs(cuda, dtype):
    """The rows kernel in its three uses (one launch, the amax alone, the
    codes from a given amax) equals its plain version bit for bit: in every
    body (units a lane 1 to the register limit, lanes a row 1 to 256, a
    segmented row) launched directly; in the shape ``rows_tiling`` picks at
    K % 8 in {1, ..., 7}, K past a warp's registers in fp32, R = 1 and
    rows fewer than a block's; on row-strided views and views 2, 4 and 8
    bytes off alignment; on a row holding a NaN and an all-zero row; on
    every finite bf16 value (the rows' own amax, and a group's); eager and
    inside a captured graph."""
    from d2r_tpu_torch.ops.kernels import quantize as qk
    most = qk.REGISTER_UNITS[dtype]
    for units in range(1, most + 1):
        for lanes in (1, 4, 32, 64, 256):
            x = _rows_input(cuda, (5, 16 * units * lanes - 3), dtype, units + lanes)
            t = qk.RowsTiling(units, lanes, max(lanes, 64), 1)
            _rows_agree(_rows_uses(x, t), x, t)
    x = _rows_input(cuda, (3, 2000), dtype, 1)
    _rows_agree(_rows_uses(x, qk.RowsTiling(1, 32, 64, 4)), x, "four segments")
    shapes = [(33, 96 + r) for r in range(1, 8)]
    shapes += [(1, 768), (1, 5), (3, 1030), (2, 4100), (7, 3072), (3, 70001), (257, 130),
               (4097, 771), (4096, 768)]
    for i, shape in enumerate(shapes):
        x = _rows_input(cuda, shape, dtype, 20 + i)
        if shape[0] > 3:
            x[3, shape[1] // 2] = float("nan")
        views = {"contiguous": x}
        wide = torch.zeros((shape[0], shape[1] + 8), dtype=dtype, device=cuda)
        wide[:, :shape[1]] = x
        views["row stride"] = wide[:, :shape[1]]
        for nbytes in (2, 4, 8):
            if nbytes % x.element_size() == 0:
                off = nbytes // x.element_size()
                flat = torch.zeros(x.numel() + off, dtype=dtype, device=cuda)
                flat[off:] = x.reshape(-1)
                views[f"{nbytes} bytes off"] = flat[off:].view(shape)
        for name, v in views.items():
            _rows_agree(_rows_uses(v), x, (shape, name, qk.rows_tiling(shape[1], dtype)))
    # every finite bf16 value, ordered by size, each 16 rows of 256 shuffled
    # among themselves (a row spans ~16 binades): coarse values whose
    # quotients land on and beside rounding boundaries, in both types; the
    # codes from the rows' own amax and from a group's above it
    values = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    values = values[torch.isfinite(values)].float()
    values = values[values.abs().argsort()][: values.numel() // 4096 * 4096].view(-1, 4096)
    g = torch.Generator().manual_seed(0)
    values = torch.stack([b[torch.randperm(4096, generator=g)] for b in values])
    x = values.view(-1, 256).to(cuda, dtype)
    _rows_agree(_rows_uses(x), x, "every finite bf16 value")
    group = x.float().abs().amax(1, keepdim=True) * 1.7
    codes, scale = qk.quantize_rows(x, group)
    want_codes, want_scale = qk.quantize_rows_plain(x, group)
    assert torch.equal(codes, want_codes) and torch.equal(scale, want_scale)
    x = _rows_input(cuda, (4096, 768), dtype, 3)
    x[5, 7] = float("nan")
    small = _rows_input(cuda, (3, 1030), dtype, 4)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        _rows_uses(x), _rows_uses(small[:, 1:])
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = _rows_uses(x), _rows_uses(small[:, 1:])
    graph.replay()
    _rows_agree(captured[0], x, "captured")
    _rows_agree(captured[1], small[:, 1:], "captured, off alignment")


@pytest.mark.cuda
def test_cuda_int8_ops_pass_opcheck(cuda):
    """``torch.library.opcheck`` on the W8A16, quantize and rescale ops."""
    from d2r_tpu_torch.ops.kernels import quantize as qk
    from d2r_tpu_torch.ops.kernels import w8a16  # noqa: F401 (registers d2r_torch::w8a16_linear)
    for dtype in (torch.float32, torch.bfloat16):
        x, q, scale, bias = _w8a16_inputs(cuda, 50, 96, 64, 32, True, dtype)
        torch.library.opcheck(torch.ops.d2r_torch.w8a16_linear.default, (x, q, scale, bias, 32))
        torch.library.opcheck(torch.ops.d2r_torch.w8a16_linear.default, (x, q, scale, None, 32))
        torch.library.opcheck(torch.ops.d2r_torch.row_amax.default, (x,))
        torch.library.opcheck(torch.ops.d2r_torch.quantize_rows.default, (x, None))
        amax = qk.col_amax(x)
        torch.library.opcheck(torch.ops.d2r_torch.col_amax.default, (x,))
        torch.library.opcheck(torch.ops.d2r_torch.quantize_cols.default, (x, amax))
        y = torch.randint(-1000, 1000, (50, 96), device=cuda, dtype=torch.int32)
        torch.library.opcheck(torch.ops.d2r_torch.rescale.default,
                              (y, scale.new_ones(50, 1), scale.new_ones(1, 96), dtype))


@pytest.mark.cuda
def test_cuda_int8_predictor_and_export_run_w8a16_at_every_module(cuda, tmp_path):
    """A tiny int8 model: every quantized module launches W8A16 once a
    forward (twice a bucket at warmup: eager and capture), replays equal
    the eager forward bit for bit, and the exported int8 program holds one
    W8A16 op node a module and replays equal to ``Predictor``."""
    import copy

    import numpy as np

    from d2r_tpu_torch import export as texport
    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.ops.kernels import w8a16
    from d2r_tpu_torch.quant import Int8Weight
    _, gpu, args = _tiny_predictors(cuda, quantize="int8", compute_dtype="bfloat16")
    modules = sum(isinstance(m, Int8Weight) for m in gpu.model.modules())
    w8a16.w8a16_linear.launches = 0
    gpu.warmup()
    assert w8a16.w8a16_linear.launches == 2 * modules * 2
    for n in (1, 3):
        g = gpu.graph(gpu._bucket(n))
        gpu._stage(g, tuple(x[:n] for x in args))
        np.testing.assert_array_equal(gpu._replay(g, n), gpu._forward(*g.inputs)[:n].cpu().numpy())
    model = build_model(gpu.cfg, device="cpu", seed=0)
    out = str(tmp_path / "art")
    texport.export_predictor(gpu.cfg, model, out, batch_buckets=(2, 4), quantize="int8")
    loaded = texport.load_exported(out, copy.deepcopy(model))
    loaded.warmup()
    for b in (2, 4):
        nodes = [n for n in loaded.programs[b].graph.nodes
                 if n.target is torch.ops.d2r_torch.w8a16_linear.default]
        assert len(nodes) == modules
    for n in (1, 3):
        got, want = loaded.predict(*(x[:n] for x in args)), gpu.predict(*(x[:n] for x in args))
        np.testing.assert_array_equal(got["probs"], want["probs"])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2), (2,)], ids=["tp2", "dp2"])
def test_cuda_int8_mesh_predictor_matches_one_process(cuda, shape):
    """``Predictor(mesh=..., quantize="int8")`` over two gloo ranks on the
    card: each rank's W8A16 products on its local slices of the codes and
    scales (the model axis) or on its rows (the data axis); the
    probabilities within ``QUANT_LOGITS_TOL`` (1e-2) of one process's int8
    ``Predictor``, labels equal (``tests/test_torch_parallel_ranks.py::
    int8_serve_rank``)."""
    import sys

    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import test_torch_parallel_ranks as ranks

    from d2r_tpu_torch.parallel.launch import spawn
    for r in spawn(ranks.int8_serve_rank, 2, (shape, "cuda")):
        assert np.abs(r["mesh"] - r["one"]).max() <= 1e-2, (r["mesh"], r["one"])
        assert np.array_equal(r["mesh"].argmax(-1), r["one"].argmax(-1))
