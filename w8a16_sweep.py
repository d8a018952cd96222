"""Every bf16 W8A16 body and split at chip_smoke.py's sites, on the card.

For each site of ``chip_smoke.W8A16_SITES`` at each bucket of
``chip_smoke.W8A16_BUCKETS`` (those of more than one row), every ``wgmma`` body of ``w8a16.WGMMA_TILES`` (token width, blocks an
SM) under each split of K that leaves no split empty (unsplit, on the
persistent grid the wrapper would give it): the error against the plain
version (as chip_smoke holds it, within 1e-2 of max(1, max |plain|)) and
the card's time alone (``chip_smoke.device_time_ms``), beside ``F.linear``
on the bf16 weight and the body and split that ``w8a16.tiling`` picks,
and the wrapper's own time. The tiling rule is read off this table and
off ``--probe``, which builds the kernel with its clock probe
(``-DD2R_W8_PROBE``) and prints, for every body unsplit at every site, the
SM clocks a tile spends before its first products are issued, on each
later step, on its epilogue, and between tiles, read by the kernel itself
(medians over blocks; first tiles apart): ``w8a16.STEP_CLOCKS`` and
``TILE_CLOCKS``. Run on the card from the repo root:

    python3 w8a16_sweep.py [--out chiprun_out/w8a16_sweep.json]

It prints one line a (site, body, split) and the best of each site, and
writes every row to the JSON file.

``--forward`` builds D2R-base's int8 ``Predictor`` (random weights, seed
0) and prints, at each bucket, every (M, N, K) the W8A16 wrapper is
called with in one eager forward, how many times, and each shape's time
through the wrapper beside ``F.linear`` on the bf16 weight (the card
alone): where a forward's W8A16 time goes.

``--sites LABEL`` instead times, at the same sites, the product as the
wrapper runs it (``w8a16.w8a16_linear``) and ``F.linear``, and the
column quantize (``col_amax`` then ``quantize_cols``) at x (4096, 768)
and (4096, 3072) bf16, on the card alone, one JSON line each. It uses only
entry points that earlier trees of the port have too, so it can time
another checkout's kernels: run it from that checkout's root with
``PYTHONPATH`` set to it, in turns with this tree's (A, B, B, A) in one
call.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import chip_smoke as cs

SPLITS = (1, 2, 3, 4, 6, 8)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="chiprun_out/w8a16_sweep.json")
    parser.add_argument("--sites", metavar="LABEL", default=None)
    parser.add_argument("--probe", action="store_true")
    parser.add_argument("--forward", action="store_true")
    args = parser.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("w8a16_sweep: no CUDA device", file=sys.stderr)
        return 2
    if args.sites is not None:
        return sites(args.sites)
    if args.probe:
        return probe()
    if args.forward:
        return forward()
    from d2r_tpu_torch.ops.kernels import build, w8a16
    report = build.build_all(["w8a16_linear"])
    for line in report.get("w8a16_linear", "").splitlines():
        if any(w in line for w in ("Function properties", "registers", "spill", "arning",
                                   "wgmma", "error")):
            print("[build]", line.strip())
    print(cs.card_line())
    kernel = w8a16._kernel()
    sms = w8a16._sm_count(torch.device("cuda"))
    rows, best = [], {}
    # every site of more than one row (the wgmma bodies against the GEMV
    # body's rows too)
    cases = [(site, b, rows_a_post * b, n, k, period)
             for b in cs.W8A16_BUCKETS for site, rows_a_post, n, k, period in cs.W8A16_SITES
             if rows_a_post * b > 1]
    for i, (site, b, m, n, k, period) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(300 + i)
        x = torch.randn((m, k), generator=g, device="cuda").bfloat16()
        q = torch.randint(-127, 128, (n, k), generator=g, device="cuda").to(torch.int8)
        scale = torch.rand((period,), generator=g, device="cuda") * 2e-3 + 1e-4
        bias = torch.randn((n,), generator=g, device="cuda").bfloat16()
        ref = w8a16.w8a16_linear_plain(x, q, scale, period, bias).float()
        denom = ref.abs().max().clamp_min(1.0).item()
        weight = w8a16.dequantize(q, scale, period, torch.bfloat16)
        library_ms = cs.device_time_ms(lambda: F.linear(x, weight, bias))
        wrapper_ms = cs.device_time_ms(lambda: w8a16.w8a16_linear(x, q, scale, period, bias))
        pick = w8a16.tiling(m, n, k, torch.bfloat16, sms)
        steps = -(-k // 64)
        seen = set()
        for body in w8a16.WGMMA_TILES:
            for want in SPLITS:
                per = -(-steps // min(want, steps))
                splits = -(-steps // per)
                tokens, _, per_sm = w8a16.WGMMA_TILES[body]
                tiles = -(-m // tokens) * -(-n // 64)
                if (body, splits) in seen or (splits > 1 and tiles * splits > 2 * sms * per_sm):
                    continue
                seen.add((body, splits))
                blocks = tiles if splits > 1 else min(tiles, sms * per_sm)
                out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
                stream = torch.cuda.current_stream().cuda_stream

                def run():
                    err = kernel(1, body, x.data_ptr(), x.stride(0), q.data_ptr(),
                                 scale.data_ptr(), period, bias.data_ptr(), out.data_ptr(), m, n,
                                 k, splits, per, blocks, stream)
                    if err:
                        raise RuntimeError(f"cudaError {err}")

                run()
                torch.cuda.synchronize()
                err = (out.float() - ref).abs().max().item() / denom
                ms = cs.device_time_ms(run)
                r = {"site": site, "bucket": b, "M": m, "N": n, "K": k, "body": body,
                     "tile": w8a16.WGMMA_TILES[body], "splits": splits, "per": per,
                     "blocks": blocks,
                     "err_over_max": err, "device_ms": ms, "f_linear_device_ms": library_ms,
                     "wrapper_device_ms": wrapper_ms, "tiling": list(pick)}
                rows.append(r)
                print(f"{site:10s} b{b:<2d} {m}x{k}->{n} body {body} "
                      f"{w8a16.WGMMA_TILES[body]} splits {splits}x{per} blocks {blocks}: err "
                      f"{err:.3g} {ms * 1e3:.2f} us (F.linear {library_ms * 1e3:.2f})", flush=True)
                if err > 1e-2:
                    print(f"  ^ DISAGREES with the plain version", flush=True)
                key = (site, b)
                if err <= 1e-2 and (key not in best or ms < best[key]["device_ms"]):
                    best[key] = r
    for (site, b), r in best.items():
        picked = next((x for x in rows if (x["site"], x["bucket"], x["body"], x["splits"])
                       == (site, b, r["tiling"][0], r["tiling"][1])), None)
        r["tiling_device_ms"] = picked["device_ms"] if picked else None
        print(f"best {site:10s} b{b:<2d}: body {r['body']} splits {r['splits']} "
              f"{r['device_ms'] * 1e3:.2f} us; tiling {r['tiling']} (the wrapper) "
              f"{r['wrapper_device_ms'] * 1e3:.2f} us; "
              f"F.linear {r['f_linear_device_ms'] * 1e3:.2f} us")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": cs.card_line(), "rows": rows}, f, indent=1)
    bad = [r for r in rows if r["err_over_max"] > 1e-2]
    print(json.dumps({"configs": len(rows), "disagree": len(bad)}))
    return 1 if bad else 0


def probe() -> int:
    """Clocks inside the kernel (module docstring), one JSON line a (site,
    body)."""
    import ctypes
    import statistics
    import subprocess
    import torch
    from d2r_tpu_torch.ops.kernels import build, w8a16
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    so = os.path.join(build.BUILD_DIR, "libw8a16_linear_probe.so")
    out = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DD2R_W8_PROBE", "-o", so,
                          os.path.join(build.CSRC, "w8a16_linear.cu")],
                         capture_output=True, text=True)
    if out.returncode != 0:
        print(out.stdout, out.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(so)
    fn = lib.d2r_w8a16_linear
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, i, p, ctypes.c_longlong, p, p, i, p, p, i, i, i, i, i, i, p]
    read = lib.d2r_w8a16_probe
    read.argtypes = [p, i]
    sms = w8a16._sm_count(torch.device("cuda"))
    card = cs.card_line()
    cases = [(site, b, rows_a_post * b, n, k, period)
             for b in cs.W8A16_BUCKETS for site, rows_a_post, n, k, period in cs.W8A16_SITES
             if rows_a_post * b > w8a16.GEMV_M]
    for site, b, m, n, k, period in cases:
        g = torch.Generator(device="cuda").manual_seed(300)
        x = torch.randn((m, k), generator=g, device="cuda").bfloat16()
        q = torch.randint(-127, 128, (n, k), generator=g, device="cuda").to(torch.int8)
        scale = torch.rand((period,), generator=g, device="cuda") * 2e-3 + 1e-4
        res = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
        steps = -(-k // 64)
        for body, (tokens, _, per_sm) in w8a16.WGMMA_TILES.items():
            tiles = -(-m // tokens) * -(-n // 64)
            blocks = min(tiles, sms * per_sm)
            for _ in range(3):
                err = fn(1, body, x.data_ptr(), k, q.data_ptr(), scale.data_ptr(), period, None,
                         res.data_ptr(), m, n, k, 1, steps, blocks,
                         torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            clk = (ctypes.c_longlong * (blocks * 32))()
            if err or read(ctypes.cast(clk, ctypes.c_void_p), blocks * 32):
                print(f"probe launch or read failed at {site} body {body}", file=sys.stderr)
                return 1
            first, later, per_step, epi, between = [], [], [], [], []
            for blk in range(blocks):
                t = [clk[blk * 32 + j] for j in range(32)]
                mine = min(8, len(range(blk, tiles, blocks)))
                for it in range(mine):
                    t0, t1, t2, t3 = t[4 * it: 4 * it + 4]
                    (first if it == 0 else later).append(t1 - t0)
                    if steps > 1:
                        per_step.append((t2 - t1) / (steps - 1))
                    epi.append(t3 - t2)
                    if it + 1 < mine:
                        between.append(t[4 * it + 4] - t3)
            med = lambda v: statistics.median(v) if v else None
            print(json.dumps({"card": card, "site": site, "bucket": b, "M": m, "N": n, "K": k,
                              "body": body, "tokens": tokens, "tiles": tiles, "blocks": blocks,
                              "first_tile_fill_clocks": med(first),
                              "later_tile_fill_clocks": med(later),
                              "step_clocks": med(per_step), "epilogue_clocks": med(epi),
                              "between_tiles_clocks": med(between)}), flush=True)
    return 0


def forward() -> int:
    """One int8 forward's W8A16 calls by shape at each bucket (module
    docstring), one JSON line a (bucket, shape) and one a bucket."""
    import collections
    import torch
    import torch.nn.functional as F
    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.ops.kernels import w8a16
    from d2r_tpu_torch.serve import Predictor
    cfg = cs.model_config("base", compute_dtype="bfloat16")
    pred = Predictor(cfg, build_model(cfg, device="cuda", seed=0), batch_buckets=cs.BUCKETS,
                     device="cuda", quantize="int8")
    calls = []
    op = w8a16.w8a16_linear_op

    def counted(x, q, scale, bias, period):
        calls.append((x.shape[0], q.shape[0], x.shape[1], period, bias is not None))
        return op(x, q, scale, bias, period)

    w8a16.w8a16_linear_op = counted
    ids, mask, tt, pixels = cs.make_requests(cfg)[-1]
    card = cs.card_line()
    for b in cs.BUCKETS:
        calls.clear()
        pred._forward(*pred._padded((ids[:b], mask[:b], tt[:b], pixels[:b]), b))
        total = {"w8a16_us": 0.0, "f_linear_us": 0.0}
        for (m, n, k, period, has_bias), count in collections.Counter(calls).most_common():
            x = torch.randn((m, k), device="cuda").bfloat16()
            q = torch.randint(-127, 128, (n, k), device="cuda").to(torch.int8)
            scale = torch.rand((period,), device="cuda") * 2e-3 + 1e-4
            bias = torch.randn((n,), device="cuda").bfloat16() if has_bias else None
            weight = w8a16.dequantize(q, scale, period, torch.bfloat16)
            us = cs.device_time_ms(lambda: op(x, q, scale, bias, period)) * 1e3
            lin = cs.device_time_ms(lambda: F.linear(x, weight, bias)) * 1e3
            total["w8a16_us"] += count * us
            total["f_linear_us"] += count * lin
            print(json.dumps({"card": card, "bucket": b, "M": m, "N": n, "K": k, "calls": count,
                              "tiling": list(w8a16.tiling(m, n, k, torch.bfloat16)),
                              "w8a16_us": us, "f_linear_us": lin}), flush=True)
        print(json.dumps({"card": card, "bucket": b, "calls": len(calls), **total}), flush=True)
    w8a16.w8a16_linear_op = op
    return 0


def sites(label: str) -> int:
    """The wrapper's product and the column quantize at the sites, alone."""
    import torch
    import torch.nn.functional as F
    from d2r_tpu_torch.ops.kernels import quantize as qk
    from d2r_tpu_torch.ops.kernels import w8a16
    card = cs.card_line()
    cases = [(site, b, rows_a_post * b, n, k, period)
             for b in cs.W8A16_BUCKETS for site, rows_a_post, n, k, period in cs.W8A16_SITES]
    for i, (site, b, m, n, k, period) in enumerate(cases):
        g = torch.Generator(device="cuda").manual_seed(300 + i)
        x = torch.randn((m, k), generator=g, device="cuda").bfloat16()
        q = torch.randint(-127, 128, (n, k), generator=g, device="cuda").to(torch.int8)
        scale = torch.rand((period,), generator=g, device="cuda") * 2e-3 + 1e-4
        bias = torch.randn((n,), generator=g, device="cuda").bfloat16()
        weight = w8a16.dequantize(q, scale, period, torch.bfloat16)
        print(json.dumps({"tree": label, "card": card, "site": site, "bucket": b,
                          "M": m, "N": n, "K": k,
                          "w8a16_us": cs.device_time_ms(
                              lambda: w8a16.w8a16_linear(x, q, scale, period, bias)) * 1e3,
                          "f_linear_us": cs.device_time_ms(
                              lambda: F.linear(x, weight, bias)) * 1e3}), flush=True)
    for shape in ((4096, 768), (4096, 3072)):
        x = torch.randn(shape, device="cuda").bfloat16()
        amax = qk.col_amax(x)
        print(json.dumps({"tree": label, "card": card, "quantize_cols": list(shape),
                          "amax_plus_codes_us": cs.device_time_ms(
                              lambda: qk.quantize_cols(x, qk.col_amax(x))) * 1e3,
                          "amax_us": cs.device_time_ms(lambda: qk.col_amax(x)) * 1e3,
                          "codes_us": cs.device_time_ms(
                              lambda: qk.quantize_cols(x, amax)) * 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
