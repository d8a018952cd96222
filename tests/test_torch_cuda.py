"""The port's CUDA kernels on the card: K1 (forward, with and without
dropout), K2 (backward, at the sites and at the edges of its bf16 tiling)
and K3 (long-context forward) against their plain versions, and the
serving and training paths launching them at every attention site. Every
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
1% for K3 in bf16).

This file imports neither JAX nor ``d2r_tpu``, because the GPU machine has
no JAX; ``tests/conftest.py`` does, so run it there without the conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import pytest
import torch

from d2r_tpu_torch.ops import attention as tattn
from d2r_tpu_torch.ops.kernels import flash_attention as tfl
from d2r_tpu_torch.ops.kernels import fused_attention as tfa


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
            _check_k2(q, k, v, bias, g, rate, seed, (b, l, h, d))


@pytest.mark.cuda
def test_cuda_dropout_v_ones_identity(cuda):
    """tests/test_fused_attention_small.py's TPU dropout test on the card:
    seeded, mean-preserving, and K2 regenerates K1's mask (sum dv = sum out)."""
    q, k, _, bias, _ = _qkv(cuda, torch.float32, 8, 16, 2, 8, True, seed=3)
    v = torch.ones(8, 16, 2, 8, device=cuda, requires_grad=True)
    run = lambda s: tfa.fused_attention_small(q, k, v, bias, 8 ** -0.5, 0.5, s)
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
            _check_k2(q, k, v, bias, g, rate, seed, (b, l, s, h, d, pad))


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


@pytest.mark.cuda
def test_cuda_dispatch_raises_for_heads_wider_than_k3(cuda):
    """D above 256 without dropout: no kernel takes it, and the card runs
    no plain version in its place."""
    x = torch.randn(1, 300, 1, 264, device=cuda)
    before = tfl.flash_attention.launches
    with pytest.raises(NotImplementedError, match="no kernel of the port"):
        tattn.dot_product_attention(x, x, x)
    assert tfl.flash_attention.launches == before


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
