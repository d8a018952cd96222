#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``d2r_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure exits non-zero without the final ``ok`` line:

1. The card's name and power limit (``nvidia-smi``), then the build of every
   CUDA kernel of the port from ``d2r_tpu_torch/csrc`` (one ``nvcc`` per
   source, in parallel), with the build time and the ptxas report.
2. Each kernel against its plain PyTorch version on the card, at the shapes
   of the main path (batch 32): K1 at the BERT (L=S=64, H=12, D=64, random
   padding bias), CLIP (50/50, H12, D64) and IMRC (64/64 and 50/50, H16,
   D48) sites, in fp32 (TF32 off; max abs error <= 1e-5) and bf16 (<= 2e-2,
   one bf16 ulp of outputs below 2 plus the rounding of p). q, k and v are
   strided views of one (B, L, 3, H*D) tensor, as the QKV projection gives
   them. Times from CUDA events (L2-warm, inputs under 50 MB): the kernel,
   its plain version and ``scaled_dot_product_attention`` as a yardstick.
3. The main path at full width: ``D2RClassifier`` with
   ``D2RConfig(DR_step=4, max_seq=64, compute_dtype="bfloat16")``
   (BERT-base + CLIP ViT-B/32, 768 wide, 12+1 layers a tower), random
   weights from a seeded ``torch.Generator``, behind
   ``Predictor(batch_buckets=(1, 8, 32))``: warmup, then requests of 1, 3,
   8, 20 and 40 rows (uint8 pixels, made with numpy from a seed), then the
   per-bucket latency. Launch counts are set to 0 just before and read just
   after: K1 must launch exactly 34 times per bucket-sized forward. Then a
   torch.profiler trace of 3 forwards at buckets 1 and 32: kernels per
   forward, device busy time and idle share, K1's share, the top kernels.
4. The same model in fp32 (TF32 off), batch 2, on the CPU through the plain
   path and on the card through the kernel: logits within 1e-3.
5. Training at full width, ``bench.py``'s recipe: the same D2R-base, batch
   64, bf16 compute, fp32 parameters, AdamW at the reference's four groups
   (``d2r_tpu_torch.train.state``), on a batch made with numpy the way
   ``synthetic_batch`` makes it (PAD ids included): 3 warm-up steps and 10
   timed ones (CUDA events, median). Counts set to 0 before, read after: K1
   and K2 must each launch 34 times a step. The loss is finite, every
   parameter and every BatchNorm running buffer has moved, and the PAD
   embedding row got an exactly zero gradient (AdamW's decoupled weight
   decay still shrinks it, as in the reference). Then a torch.profiler
   trace of one step.
6. One train step of D2R-base in fp32 (TF32 off), batch 2, dropout off
   through a registered dropout-0 preset, two ill-conditioned spots of the
   random weights moved off (see the phase), on the CPU (plain path) and on the card (K1/K2):
   loss within 1e-4; the gradients of ``fc``, one BERT ``qkv``, one CLIP
   ``qkv``, one IMRC ``sa_qkv`` and one SAF BatchNorm within 1e-3 of each
   leaf's max |grad|; the updated parameters of those leaves and the
   BatchNorm running statistics agree too. Beside it, the same step on the
   card with every attention site through the plain versions: the kernels'
   own share of the difference.

Phase 2 also holds K1 with dropout (rate 0.1 at the BERT site, 0.5 at the
CLIP site, batch 64) against its plain version with the same seed (same
Philox bits, so the same tolerances), and K2 against its plain version at
the four site geometries, batch 64, fp32 and bf16, at rate 0 and, at the
BERT site, 0.1, with dbias from a bias that requires grad there; K2 runs
twice and must give the same bits. With v = 1, sum(dv) = sum(out) checks
that K2 regenerates K1's mask. Times: K2, its plain version, SDPA's
backward through autograd as the yardstick, and K2's bound (bytes of q, k,
v, g, dq, dk, dv at 3.35 TB/s against 10*B*H*L*S*D operations at the
type's peak).

It prints one ``kernels`` JSON line (K1 and K2; ``launches`` counts the
serving and training runs of phases 3 and 5), the card line, and last
``{"ok": true, "device": {...}}``. The full report also goes to
``chiprun_out/chip_smoke.json``.
"""

import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}  # CUDA-core fp32; dense bf16
BUCKETS = (1, 8, 32)
REQUESTS = (1, 3, 8, 20, 40)
K1_SITES_PER_FORWARD = 34
# (name, L=S, H, D, key bias): the four K1 geometries of the main path
K1_SITES = (("bert", 64, 12, 64, True), ("clip", 50, 12, 64, False),
            ("imrc_text", 64, 16, 48, False), ("imrc_image", 50, 16, 48, False))
K1_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# K2: scaled by max(1, max |ref|), one bf16 ulp at |x| being 2^-8 |x|
K2_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TRAIN_BATCH = 64
WARMUP_STEPS, TIMED_STEPS = 3, 10


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters=50, warmup=5):
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build(report):
    from d2r_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    reports = build.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] {len(build.SOURCES)} kernel source(s) in {report['build_s']:.1f} s")
    for name, out in reports.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {name}: {line.strip()}")


def k1_inputs(b, l, h, d, with_bias, dtype, seed):
    """q, k, v as strided views of one (B, L, 3, H*D) tensor, plus a padding
    bias made the way padding_key_bias makes it."""
    import torch
    from d2r_tpu_torch.ops.attention import padding_key_bias
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, l, 3, h * d), generator=g, device="cuda").to(dtype)
    q, k, v = (qkv[:, :, i].view(b, l, h, d) for i in range(3))
    bias = None
    if with_bias:
        lengths = torch.randint(4, l + 1, (b, 1), generator=g, device="cuda")
        mask = (torch.arange(l, device="cuda")[None, :] < lengths).int()
        bias = padding_key_bias(mask)
    return q, k, v, bias


def k1_bound(b, l, s, h, d, dtype_name, with_bias):
    item = 4 if dtype_name == "float32" else 2
    nbytes = (2 * b * l * h * d + 2 * b * s * h * d) * item + (b * s * 4 if with_bias else 0)
    ops = 4 * b * h * l * s * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(report):
    import torch
    import torch.nn.functional as F
    from d2r_tpu_torch.ops.kernels import fused_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows, failures = [], []
    b = 32
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for i, (site, l, h, d, with_bias) in enumerate(K1_SITES):
            q, k, v, bias = k1_inputs(b, l, h, d, with_bias, dtype, seed=100 + i)
            scale = d ** -0.5
            out = fa.fused_attention_small(q, k, v, bias, scale)
            torch.cuda.synchronize()
            ref = fa.fused_attention_small_plain(q, k, v, bias, scale)
            err = (out.float() - ref.float()).abs().max().item()
            if not (err <= K1_TOL[dtype_name] and torch.isfinite(out).all().item()):
                failures.append(f"K1 {site} {dtype_name}: max abs err {err}")
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            mask = None if bias is None else bias.to(dtype)[:, None, None, :]
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale)
            bound_ms, bound_by = k1_bound(b, l, l, h, d, dtype_name, with_bias)
            rows.append({
                "site": site, "dtype": dtype_name, "B": b, "L": l, "S": l, "H": h, "D": d,
                "max_abs_err": err,
                # an independent cross-check, not a pass criterion
                "sdpa_max_abs_diff": (out.float() - sdpa().transpose(1, 2).float()).abs().max().item(),
                "ms": cuda_time_ms(lambda: fa.fused_attention_small(q, k, v, bias, scale)),
                "plain_ms": cuda_time_ms(lambda: fa.fused_attention_small_plain(q, k, v, bias, scale)),
                "library_ms": cuda_time_ms(sdpa),
                "bound_ms": bound_ms, "bound_by": bound_by})
            r = rows[-1]
            log(f"[K1] {site:10s} {dtype_name:8s} B{b} L=S={l} H{h} D{d}: err {err:.3g} "
                f"(vs sdpa {r['sdpa_max_abs_diff']:.3g}) "
                f"kernel {r['ms'] * 1e3:.2f} us, plain {r['plain_ms'] * 1e3:.2f} us, "
                f"sdpa {r['library_ms'] * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us ({bound_by})")
    report["k1_sites"] = rows
    report["k1_dropout"] = k1_dropout_checks(failures)
    report["k2_sites"] = k2_checks(failures)
    report["dropout_identity"] = dropout_identity(failures)
    if failures:
        raise AssertionError("; ".join(failures))


def k1_dropout_checks(failures):
    """K1 with dropout against its plain version (same seed, same bits), at
    the training batch: rate 0.1 at the BERT site, 0.5 at the CLIP site."""
    import torch
    import torch.nn.functional as F
    from d2r_tpu_torch.ops.kernels import fused_attention as fa
    rows, b = [], TRAIN_BATCH
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for (site, l, h, d, with_bias), rate in ((K1_SITES[0], 0.1), (K1_SITES[1], 0.5)):
            q, k, v, bias = k1_inputs(b, l, h, d, with_bias, dtype, seed=200)
            scale, seed = d ** -0.5, 2 ** 40 + 17
            run = lambda: fa.fused_attention_small(q, k, v, bias, scale, rate, seed)
            out = run()
            torch.cuda.synchronize()
            ref = fa.fused_attention_small_plain(q, k, v, bias, scale, rate, seed)
            err = (out.float() - ref.float()).abs().max().item()
            kept = fa.dropout_keep_mask(seed, b, h, l, l, rate, "cuda").float().mean().item()
            if not (err <= K1_TOL[dtype_name] and torch.isfinite(out).all().item()):
                failures.append(f"K1 dropout {site} {dtype_name}: max abs err {err}")
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            mask = None if bias is None else bias.to(dtype)[:, None, None, :]
            bound_ms, bound_by = k1_bound(b, l, l, h, d, dtype_name, with_bias)
            rows.append({
                "site": site, "dtype": dtype_name, "B": b, "L": l, "H": h, "D": d,
                "rate": rate, "max_abs_err": err, "ms": cuda_time_ms(run),
                "plain_ms": cuda_time_ms(lambda: fa.fused_attention_small_plain(
                    q, k, v, bias, scale, rate, seed)),
                "library_ms": cuda_time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, dropout_p=rate, scale=scale)),
                "bound_ms": bound_ms, "bound_by": bound_by})
            r = rows[-1]
            log(f"[K1 dropout] {site:5s} {dtype_name:8s} B{b} rate {rate}: err {err:.3g}, "
                f"keep share {kept:.4f}, kernel {r['ms'] * 1e3:.2f} us, plain "
                f"{r['plain_ms'] * 1e3:.2f} us, sdpa {r['library_ms'] * 1e3:.2f} us, "
                f"bound {bound_ms * 1e3:.2f} us")
    return rows


def k2_bound(b, l, s, h, d, dtype_name):
    item = 4 if dtype_name == "float32" else 2
    nbytes = (4 * b * l * h * d + 3 * b * s * h * d) * item   # q, g, dq; k, v, dk, dv
    ops = 10 * b * h * l * s * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k2_checks(failures):
    """K2 against its plain version at the four site geometries, batch 64,
    fp32 and bf16, rate 0 and (BERT) 0.1; dbias at the BERT site; the same
    bits on a second run. Times against SDPA's backward."""
    import torch
    import torch.nn.functional as F
    from d2r_tpu_torch.ops.kernels import fused_attention as fa
    rows, b = [], TRAIN_BATCH
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        cases = [(site, 0.0) for site in K1_SITES] + [(K1_SITES[0], 0.1)]
        for i, ((site, l, h, d, with_bias), rate) in enumerate(cases):
            q, k, v, bias = k1_inputs(b, l, h, d, with_bias, dtype, seed=300 + i)
            g = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(i),
                            device="cuda").to(dtype)
            scale, seed = d ** -0.5, (12345 if rate else None)
            need_dbias = with_bias
            run = lambda: fa.fused_attention_small_bwd(q, k, v, bias, g, scale, rate, seed,
                                                       need_dbias=need_dbias)
            got, again = run(), run()
            torch.cuda.synchronize()
            ref = fa.fused_attention_small_bwd_plain(q, k, v, bias, g, scale, rate, seed)
            errs, ok = {}, True
            for name, x, y, z in zip(("dq", "dk", "dv"), got, again, ref):
                errs[name] = (x.float() - z.float()).abs().max().item()
                tol = K2_TOL[dtype_name] * max(1.0, z.float().abs().max().item())
                ok = ok and errs[name] <= tol and torch.equal(x, y)
            if need_dbias:
                errs["dbias"] = (got[3] - ref[3]).abs().max().item()
                ok = ok and errs["dbias"] <= 1e-4 * max(1.0, ref[3].abs().max().item())
            if not ok:
                failures.append(f"K2 {site} {dtype_name} rate {rate}: errs {errs}")
            qt, kt, vt = (x.detach().transpose(1, 2).contiguous().requires_grad_()
                          for x in (q, k, v))
            mask = None if bias is None else bias.to(dtype)[:, None, None, :]
            out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                 dropout_p=rate, scale=scale)
            gt = g.transpose(1, 2).contiguous()
            sdpa_bwd = lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)
            bound_ms, bound_by = k2_bound(b, l, l, h, d, dtype_name)
            rows.append({
                "site": site, "dtype": dtype_name, "B": b, "L": l, "H": h, "D": d,
                "rate": rate, "dbias": need_dbias, "max_abs_err": max(errs.values()),
                "errs": errs, "ms": cuda_time_ms(run),
                "plain_ms": cuda_time_ms(lambda: fa.fused_attention_small_bwd_plain(
                    q, k, v, bias, g, scale, rate, seed)),
                "library_ms": cuda_time_ms(sdpa_bwd),
                "bound_ms": bound_ms, "bound_by": bound_by})
            r = rows[-1]
            log(f"[K2] {site:10s} {dtype_name:8s} B{b} rate {rate}: errs "
                f"{ {k_: float(f'{v_:.3g}') for k_, v_ in errs.items()} }, "
                f"kernel {r['ms'] * 1e3:.2f} us, plain {r['plain_ms'] * 1e3:.2f} us, "
                f"sdpa bwd {r['library_ms'] * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
                f"({bound_by})")
    return rows


def dropout_identity(failures):
    """With v = 1: sum(dv) = sum(out) only if K2 drew K1's mask."""
    import torch
    from d2r_tpu_torch.ops.kernels import fused_attention as fa
    q, k, _, bias = k1_inputs(8, 64, 12, 64, True, torch.float32, seed=400)
    v = torch.ones_like(q).requires_grad_()
    out = fa.fused_attention_small(q, k, v, bias, 0.125, 0.5, 1234)
    out.sum().backward()
    a, b = v.grad.sum().item(), out.sum().item()
    log(f"[K1/K2 dropout identity] sum(dv) {a:.6f}, sum(out) {b:.6f}")
    if not abs(a - b) <= 1e-3 * abs(b):
        failures.append(f"dropout identity: sum(dv) {a} != sum(out) {b}")
    return {"sum_dv": a, "sum_out": b}


def make_requests(cfg, seed=0):
    import numpy as np
    rng = np.random.default_rng(seed)
    tc, vc = cfg.text_config(), cfg.vision_config()
    out = []
    for n in REQUESTS:
        lengths = rng.integers(4, cfg.max_seq + 1, size=n)
        mask = (np.arange(cfg.max_seq)[None, :] < lengths[:, None]).astype(np.int32)
        ids = rng.integers(5, tc.vocab_size, size=(n, cfg.max_seq)).astype(np.int32) * mask
        ids[:, 0] = 2
        pixels = rng.integers(0, 256, size=(n, 3, vc.image_size, vc.image_size)).astype(np.uint8)
        out.append((ids, mask, np.zeros_like(ids), pixels))
    return out


def phase_main_path(report):
    import numpy as np
    import torch
    from d2r_tpu_torch.config import D2RConfig
    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.ops.kernels import fused_attention as fa
    from d2r_tpu_torch.serve import Predictor

    cfg = D2RConfig(DR_step=4, max_seq=64, compute_dtype="bfloat16")
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    pred = Predictor(cfg, model, batch_buckets=BUCKETS, device="cuda")
    log(f"[main] D2R-base bf16 built in {time.perf_counter() - t0:.1f} s "
        f"({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M parameters)")
    requests = make_requests(cfg)

    fa.fused_attention_small.launches = 0
    forwards = 0
    t0 = time.perf_counter()
    pred.warmup()
    forwards += len(BUCKETS)
    log(f"[main] warmup of buckets {BUCKETS}: {time.perf_counter() - t0:.1f} s")
    for ids, mask, tt, pixels in requests:
        n = ids.shape[0]
        out = pred.predict(ids, mask, tt, pixels)
        forwards += math.ceil(n / BUCKETS[-1])
        probs = out["probs"]
        assert probs.shape == (n, cfg.num_classes), probs.shape
        assert out["label"].shape == (n,), out["label"].shape
        assert np.isfinite(probs).all(), "non-finite probabilities"
        assert np.abs(probs.sum(-1) - 1.0).max() <= 1e-3, probs.sum(-1)
        log(f"[main] request of {n:2d} rows: labels {np.bincount(out['label'], minlength=3).tolist()}, "
            f"max prob {probs.max():.4f}")

    latency = {}
    vc = cfg.vision_config()
    for b in BUCKETS:
        ids, mask, tt, _ = requests[-1]
        dev = lambda x: torch.from_numpy(x[:b]).cuda()
        args = (dev(ids), dev(mask), dev(tt),
                torch.randint(0, 256, (b, 3, vc.image_size, vc.image_size),
                              dtype=torch.uint8, device="cuda"))
        ms = []
        for _ in range(7):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            pred._forward(*args)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        forwards += 7
        e2e = []
        for _ in range(5):
            t0 = time.perf_counter()
            pred.predict(ids[:b], mask[:b], tt[:b], requests[-1][3][:b])
            e2e.append((time.perf_counter() - t0) * 1e3)
        forwards += 5
        latency[b] = {"forward_ms_median": float(np.median(ms)), "forward_ms": ms,
                      "predict_ms_median": float(np.median(e2e))}
        log(f"[main] bucket {b:2d}: forward {np.median(ms):.2f} ms (CUDA events, median of 7), "
            f"predict {np.median(e2e):.2f} ms (host clock, median of 5)")
    launches = fa.fused_attention_small.launches
    report["main"] = {"forwards": forwards, "k1_launches": launches, "latency": latency}
    log(f"[main] K1 launches {launches} over {forwards} forwards")
    assert launches == K1_SITES_PER_FORWARD * forwards, (
        f"K1 launched {launches} times, expected {K1_SITES_PER_FORWARD} x {forwards}")

    for b in (1, BUCKETS[-1]):
        ids, mask, tt, _ = requests[-1]
        args = [torch.from_numpy(x[:b]).cuda() for x in (ids, mask, tt)]
        args.append(torch.randint(0, 256, (b, 3, vc.image_size, vc.image_size),
                                  dtype=torch.uint8, device="cuda"))
        report["main"][f"profile_b{b}"] = prof = profile_forwards(pred, args)
        log(f"[profile] bucket {b:2d}: " + json.dumps(prof))
    return launches


def profile_forwards(pred, args, n=3):
    """Device busy share and kernel time by name over ``n`` back-to-back
    bucket forwards."""
    return device_profile(lambda: pred._forward(*args), n, "forward")


def device_profile(fn, n, unit):
    """Device busy share and kernel time by name over ``n`` back-to-back
    calls of ``fn``, from torch.profiler's CUDA kernel events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.elapsed_us() > 0
                and not getattr(e, "is_user_annotation", False)):   # e.g. Optimizer.step
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    if not spans:
        return {"device_time": "not measured (no CUDA events in the trace)"}
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy, cur_s, cur_e = busy + cur_e - cur_s, s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    k1 = sum(v for k, v in by_name.items() if "fused_attention_fwd" in k)
    k2 = sum(v for k, v in by_name.items() if "fused_attention_bwd" in k)
    return {f"{unit}s": n, f"kernels_per_{unit}": len(spans) / n,
            f"window_ms_per_{unit}": window / n / 1e3,
            f"device_busy_ms_per_{unit}": busy / n / 1e3,
            "device_idle_share": 1.0 - busy / window,
            f"k1_ms_per_{unit}": k1 / n / 1e3, f"k2_ms_per_{unit}": k2 / n / 1e3,
            f"top_kernels_ms_per_{unit}": {k[:60]: v / n / 1e3 for k, v in top}}


def phase_card_vs_cpu(report):
    import copy
    import numpy as np
    import torch
    from d2r_tpu_torch.config import D2RConfig
    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.ops.kernels import fused_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = D2RConfig(DR_step=4, max_seq=64, compute_dtype="float32")
    cpu_model = build_model(cfg, device="cpu", seed=1)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    ids, mask, tt, pixels = (x[:2] for x in make_requests(cfg, seed=7)[1])
    args = [torch.from_numpy(x) for x in (ids, mask, tt, np.zeros(2, np.int64), pixels)]
    before = fa.fused_attention_small.launches
    with torch.inference_mode():
        _, cpu_logits, cpu_aux = cpu_model(*args)
        _, gpu_logits, gpu_aux = gpu_model(*(a.cuda() for a in args))
    launched = fa.fused_attention_small.launches - before
    err = (gpu_logits.cpu() - cpu_logits).abs().max().item()
    js_err = abs(gpu_aux["js_loss"].item() - cpu_aux["js_loss"].item())
    report["card_vs_cpu"] = {"logits_max_abs_err": err, "js_loss_abs_err": js_err,
                             "k1_launches": launched}
    log(f"[cpu-vs-card] fp32 D2R-base batch 2: logits max abs err {err:.3g}, "
        f"js_loss err {js_err:.3g}, K1 launches on the card {launched}")
    assert launched == K1_SITES_PER_FORWARD, launched
    assert torch.isfinite(cpu_logits).all() and err <= 1e-3, err


def synthetic_batch(batch_size, max_seq, image_size, vocab_size, seed, num_classes=3):
    """``d2r_tpu/data/dataset.py::synthetic_batch``'s draws, in its order:
    random lengths (ids past them are PAD, id 0), [CLS] first, random
    labels, normal pixels."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lengths = rng.integers(4, max_seq + 1, size=batch_size)
    input_ids = rng.integers(5, vocab_size, size=(batch_size, max_seq)).astype(np.int32)
    attention_mask = (np.arange(max_seq)[None, :] < lengths[:, None]).astype(np.int32)
    input_ids *= attention_mask
    input_ids[:, 0] = 2
    return {"input_ids": input_ids, "attention_mask": attention_mask,
            "token_type_ids": np.zeros((batch_size, max_seq), np.int32),
            "labels": rng.integers(0, num_classes, size=batch_size).astype(np.int32),
            "pixel_values": rng.normal(size=(batch_size, 3, image_size, image_size)
                                       ).astype(np.float32)}


def phase_train(report):
    """D2R-base at bench.py's recipe on the card: warm-up, timed steps, the
    launch counts, what moved, one profiled step."""
    import numpy as np
    import torch
    from d2r_tpu_torch.config import D2RConfig
    from d2r_tpu_torch.ops.kernels import fused_attention as fa
    from d2r_tpu_torch.train.state import create_train_state, make_train_step

    cfg = D2RConfig(DR_step=4, max_seq=64, batch_size=TRAIN_BATCH, compute_dtype="bfloat16")
    t0 = time.perf_counter()
    state = create_train_state(cfg, total_steps=1000, device="cuda", seed=0)
    model = state.model
    vc = cfg.vision_config()
    batch = {k: torch.from_numpy(v).cuda() for k, v in synthetic_batch(
        TRAIN_BATCH, cfg.max_seq, vc.image_size, cfg.text_config().vocab_size, seed=0).items()}
    initial = {n: p.detach().clone() for n, p in model.named_parameters()}
    initial.update({n: b.detach().clone() for n, b in model.named_buffers() if "running" in n})
    log(f"[train] D2R-base, batch {TRAIN_BATCH}, bf16 compute, fp32 parameters: state "
        f"built in {time.perf_counter() - t0:.1f} s; "
        f"{int((batch['input_ids'] == 0).sum())} PAD ids in the batch")
    step = make_train_step()

    fa.fused_attention_small.launches = fa.fused_attention_small_bwd.launches = 0
    losses, step_ms = [], []
    t0 = time.perf_counter()
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, metrics = step(state, batch, 1)
        end.record()
        losses.append(metrics["loss"])
        if i >= WARMUP_STEPS:
            torch.cuda.synchronize()
            step_ms.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k2 = fa.fused_attention_small.launches, fa.fused_attention_small_bwd.launches
    steps = WARMUP_STEPS + TIMED_STEPS
    losses = [float(x) for x in losses]
    med = float(np.median(step_ms))
    out = {"batch": TRAIN_BATCH, "steps": steps, "k1_launches": k1, "k2_launches": k2,
           "losses": losses, "step_ms": step_ms, "step_ms_median": med,
           "samples_per_s": TRAIN_BATCH / (med / 1e3), "wall_s": wall,
           "g_copies": fa.fused_attention_small_bwd.g_copies,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    report["train"] = out
    log(f"[train] {steps} steps: K1 {k1} and K2 {k2} launches; losses "
        f"{[round(x, 4) for x in losses]}")
    log(f"[train] step {med:.2f} ms (CUDA events, median of {TIMED_STEPS}), "
        f"{out['samples_per_s']:.1f} samples/s, peak memory {out['peak_mem_gb']:.1f} GB")
    assert k1 == K1_SITES_PER_FORWARD * steps, f"K1 launched {k1}, expected 34 x {steps}"
    assert k2 == K1_SITES_PER_FORWARD * steps, f"K2 launched {k2}, expected 34 x {steps}"
    assert all(math.isfinite(x) for x in losses), losses

    still = [n for n, p in list(model.named_parameters()) + list(model.named_buffers())
             if n in initial and torch.equal(p, initial[n])]
    pad_grad = model.model.text_embeddings.word_embeddings.weight.grad[0]
    out["unchanged"] = still
    out["pad_row_grad_max"] = pad_grad.abs().max().item()
    log(f"[train] unchanged parameters and BatchNorm buffers: {still}; PAD row grad "
        f"max |g| {out['pad_row_grad_max']}")
    assert not still, f"did not move: {still}"
    assert out["pad_row_grad_max"] == 0.0

    out["profile"] = prof = device_profile(lambda: step(state, batch, 1), 1, "step")
    log("[profile] train step: " + json.dumps(prof))
    return k1, k2


def phase_train_card_vs_cpu(report):
    """One fp32 train step of D2R-base, batch 2, dropout off, on the CPU
    (plain path) and on the card (K1/K2)."""
    import copy
    import dataclasses
    import torch
    from d2r_tpu_torch import config as tconfig
    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.models.xmodules import CrossModalAlignment
    from d2r_tpu_torch.ops import attention as tattn
    from d2r_tpu_torch.ops.kernels import fused_attention as fa
    from d2r_tpu_torch.train.state import create_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tc = dataclasses.replace(tconfig.bert_base_config(), hidden_dropout_prob=0.0,
                             attention_probs_dropout_prob=0.0)
    tconfig.register_text_preset("bert-base-uncased-dropout-0", lambda: tc)
    cfg = tconfig.D2RConfig(DR_step=4, max_seq=64, compute_dtype="float32", warmup_ratio=0.0,
                            bert_name="bert-base-uncased-dropout-0")
    cpu_model = build_model(cfg, device="cpu", seed=1)
    # Two spots where the model itself turns fp32 rounding into gradient
    # noise, moved off for this check. BLOCK fusion's merge biases go to
    # [1, ~1.1], keeping the fused products z off 0, where the signed square
    # root's derivative 1/(2 sqrt|z|) is unbounded (tests/test_torch_train.py).
    # The cross-modal alignments' query and key weights shrink 10x: at the
    # full fan-in init their 100x-temperature softmaxes are near one-hot and
    # meet near-ties. Without this, the fabric's gradients are too noisy for
    # a 1e-3 comparison between any two devices, with or without the kernels.
    with torch.no_grad():
        fusion = cpu_model.model.block_fusion
        for bias in (fusion.merge_bias0, fusion.merge_bias1):
            bias.abs_().add_(1.0)
        for m in cpu_model.modules():
            if isinstance(m, CrossModalAlignment):
                m.query.weight.mul_(0.1)
                m.key.weight.mul_(0.1)
    gpu = create_train_state(cfg, 100, device="cuda", model=copy.deepcopy(cpu_model))
    plain = create_train_state(cfg, 100, device="cuda", model=copy.deepcopy(cpu_model))
    cpu = create_train_state(cfg, 100, device="cpu", model=cpu_model)
    batch = synthetic_batch(2, cfg.max_seq, cfg.vision_config().image_size,
                            cfg.text_config().vocab_size, seed=7)
    step = make_train_step()
    before = (fa.fused_attention_small.launches, fa.fused_attention_small_bwd.launches)
    gpu, gm = step(gpu, batch, 0)
    torch.cuda.synchronize()
    launched = (fa.fused_attention_small.launches - before[0],
                fa.fused_attention_small_bwd.launches - before[1])
    t0 = time.perf_counter()
    cpu, cm = step(cpu, batch, 0)
    cpu_s = time.perf_counter() - t0
    # the kernels' own share of the difference: the same step on the card
    # with every attention site through the plain versions (autograd)
    dispatch = tattn.fused_attention_small
    tattn.fused_attention_small = (lambda q, k, v, bias, scale, rate=0.0, seed=None:
                                   fa.fused_attention_small_plain(q, k, v, bias, scale, rate, seed))
    try:
        plain, _ = step(plain, batch, 0)
    finally:
        tattn.fused_attention_small = dispatch
    pp = dict(plain.model.named_parameters())
    loss_err = abs(gm["loss"].item() - cm["loss"].item())
    leaves = ("fc.weight", "model.encoder_text_layers.layer_0.attention_self.qkv.weight",
              "model.encoder_vision_layers.layer_0.self_attn.qkv.weight",
              "model.itr_module.dynamic_itr_l0.imrc.sa_qkv.weight",
              "model.itr_module.dynamic_itr_l0.glac.saf.bn.weight")
    gp, cp = dict(gpu.model.named_parameters()), dict(cpu.model.named_parameters())
    out = {"loss_abs_err": loss_err, "launches": launched, "cpu_step_s": cpu_s, "leaves": {}}
    ok = loss_err <= 1e-4 and launched == (K1_SITES_PER_FORWARD,) * 2
    for name in leaves:
        ref, got = cp[name].grad, gp[name].grad.cpu()
        rel = ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()
        plain_rel = ((got - pp[name].grad.cpu()).abs().max()
                     / ref.abs().max().clamp_min(1e-30)).item()
        # one Adam step moves an element by at most lr * (1 + wd |p|); where
        # the two gradients differ in sign (|g| within rounding of 0) the
        # updates differ by up to twice that
        lr = next(g["lr"] for g in cpu.optimizer.param_groups if any(p is cp[name] for p in g["params"]))
        dp = (gp[name].detach().cpu() - cp[name].detach()).abs()
        moved = (dp > 1e-3 * lr).float().mean().item()
        out["leaves"][name] = {"grad_rel_err": rel, "kernels_vs_plain_on_card_rel_err": plain_rel,
                               "param_max_abs_diff": dp.max().item(),
                               "param_share_beyond_1e-3_lr": moved, "lr": lr}
        ok = ok and rel <= 1e-3 and dp.max().item() <= 2.5 * lr and moved <= 0.01
    gb, cb = dict(gpu.model.named_buffers()), dict(cpu.model.named_buffers())
    out["running_stats_max_abs_err"] = max(
        (gb[n].cpu() - cb[n]).abs().max().item() for n in cb if "running" in n)
    ok = ok and out["running_stats_max_abs_err"] <= 1e-4
    report["train_card_vs_cpu"] = out
    log(f"[train cpu-vs-card] fp32 D2R-base batch 2, dropout off: loss err {loss_err:.3g}, "
        f"launches K1/K2 {launched}, running stats err {out['running_stats_max_abs_err']:.3g}, "
        f"CPU step {cpu_s:.1f} s")
    for name, r in out["leaves"].items():
        log(f"[train cpu-vs-card]   {name}: grad rel err {r['grad_rel_err']:.3g} "
            f"(card, K1/K2 against plain attention: "
            f"{r['kernels_vs_plain_on_card_rel_err']:.3g}), "
            f"param max diff {r['param_max_abs_diff']:.3g} (lr {r['lr']:.3g}), "
            f"share beyond 1e-3 lr {r['param_share_beyond_1e-3_lr']:.2e}")
    assert ok, "train step card against CPU out of tolerance"


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to drive", file=sys.stderr)
        return 2
    import d2r_tpu_torch  # noqa: F401  (fails when run outside the repo)

    report = {"card": card_line()}
    log(f"[card] {report['card']}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    phases = [("build", phase_build), ("kernels", phase_kernels),
              ("main_path", phase_main_path), ("card_vs_cpu", phase_card_vs_cpu),
              ("train", phase_train), ("train_card_vs_cpu", phase_train_card_vs_cpu)]
    failed = []
    main_launches = train_launches = None
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            got = fn(report)
        except Exception as e:  # noqa: BLE001 - report every phase, then fail
            failed.append(name)
            log(f"[{name}] FAILED: {type(e).__name__}: {e}")
            if name == "build":
                break
            continue
        if name == "main_path":
            main_launches = got
        if name == "train":
            train_launches = got
        log(f"[{name}] ok in {time.perf_counter() - t0:.1f} s")

    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    if failed:
        log(f"chip_smoke: failed phases {failed}")
        return 1

    # times at the most frequent site of each path (K1: serving, B=32, rate 0;
    # K2: training, B=64, rate 0.1); the error over every check of the kernel
    k1 = next(r for r in report["k1_sites"] if r["site"] == "bert" and r["dtype"] == "bfloat16")
    k2 = next(r for r in report["k2_sites"]
              if r["site"] == "bert" and r["dtype"] == "bfloat16" and r["rate"] > 0)
    k1_err = max(r["max_abs_err"] for r in report["k1_sites"] + report["k1_dropout"])
    row = lambda r: {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    print(json.dumps({"kernels": [
        {"name": "fused_attention_fwd", "route": "cuda",
         "source": "d2r_tpu_torch/csrc/fused_attention_fwd.cu",
         "replaces": "d2r_tpu/ops/kernels/fused_attention.py:65",
         "launches": main_launches + train_launches[0], "max_abs_err": k1_err, **row(k1)},
        {"name": "fused_attention_bwd", "route": "cuda",
         "source": "d2r_tpu_torch/csrc/fused_attention_bwd.cu",
         "replaces": "d2r_tpu/ops/kernels/fused_attention.py:101",
         "launches": train_launches[1],
         "max_abs_err": max(r["max_abs_err"] for r in report["k2_sites"]), **row(k2)}]}))
    print(report["card"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
