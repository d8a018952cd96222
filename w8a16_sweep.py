"""Every bf16 W8A16 body and split at chip_smoke.py's sites, on the card.

For each site of ``chip_smoke.W8A16_SITES`` at each bucket of
``chip_smoke.W8A16_BUCKETS`` (and the products of one row a post at bucket
32), every ``wgmma`` body of ``w8a16.WGMMA_TILES`` under each split of K
that leaves no split empty: the error against the plain version (as
chip_smoke holds it, within 1e-2 of max(1, max |plain|)) and the card's
time alone (``chip_smoke.device_time_ms``), beside ``F.linear`` on the
bf16 weight and the body and split that ``w8a16.tiling`` picks. The
tiling rule is read off this table. Run on the card from the repo root:

    python3 w8a16_sweep.py [--out chiprun_out/w8a16_sweep.json]

It prints one line a (site, body, split) and the best of each site, and
writes every row to the JSON file.

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
# the products of one row a post (the pooler and the fabric's projections)
# at bucket 32
EXTRA = (("row_a_post", 1, 768, 768, 768),)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="chiprun_out/w8a16_sweep.json")
    parser.add_argument("--sites", metavar="LABEL", default=None)
    args = parser.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("w8a16_sweep: no CUDA device", file=sys.stderr)
        return 2
    if args.sites is not None:
        return sites(args.sites)
    from d2r_tpu_torch.ops.kernels import build, w8a16
    report = build.build_all(["w8a16_linear"])
    for line in report.get("w8a16_linear", "").splitlines():
        if any(w in line for w in ("Function properties", "registers", "spill", "arning",
                                   "wgmma", "error")):
            print("[build]", line.strip())
    print(cs.card_line())
    kernel = w8a16._kernel()
    rows, best = [], {}
    cases = [(site, b, rows_a_post * b, n, k, period)
             for b in cs.W8A16_BUCKETS for site, rows_a_post, n, k, period in cs.W8A16_SITES]
    cases += [(site, 32, r * 32, n, k, p) for site, r, n, k, p in EXTRA]
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
        pick = w8a16.tiling(m, n, k, torch.bfloat16)
        steps = -(-k // 64)
        seen = set()
        for body in w8a16.WGMMA_TILES:
            for want in SPLITS:
                per = -(-steps // min(want, steps))
                splits = -(-steps // per)
                if (body, splits) in seen:
                    continue
                seen.add((body, splits))
                out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
                stream = torch.cuda.current_stream().cuda_stream

                def run():
                    err = kernel(1, body, x.data_ptr(), x.stride(0), q.data_ptr(),
                                 scale.data_ptr(), period, bias.data_ptr(), out.data_ptr(), m, n,
                                 k, splits, per, stream)
                    if err:
                        raise RuntimeError(f"cudaError {err}")

                run()
                torch.cuda.synchronize()
                err = (out.float() - ref).abs().max().item() / denom
                ms = cs.device_time_ms(run)
                r = {"site": site, "bucket": b, "M": m, "N": n, "K": k, "body": body,
                     "tile": w8a16.WGMMA_TILES[body], "splits": splits, "per": per,
                     "err_over_max": err, "device_ms": ms, "f_linear_device_ms": library_ms,
                     "tiling": list(pick)}
                rows.append(r)
                print(f"{site:10s} b{b:<2d} {m}x{k}->{n} body {body} "
                      f"{w8a16.WGMMA_TILES[body]} splits {splits}x{per}: err {err:.3g} "
                      f"{ms * 1e3:.2f} us (F.linear {library_ms * 1e3:.2f})", flush=True)
                if err > 1e-2:
                    print(f"  ^ DISAGREES with the plain version", flush=True)
                key = (site, b)
                if err <= 1e-2 and (key not in best or ms < best[key]["device_ms"]):
                    best[key] = r
    for (site, b), r in best.items():
        picked = next((x for x in rows if (x["site"], x["bucket"], x["body"], x["splits"])
                       == (site, b, r["tiling"][0], r["tiling"][1])), None)
        print(f"best {site:10s} b{b:<2d}: body {r['body']} splits {r['splits']} "
              f"{r['device_ms'] * 1e3:.2f} us; tiling {r['tiling']} "
              f"{picked['device_ms'] * 1e3 if picked else float('nan'):.2f} us; "
              f"F.linear {r['f_linear_device_ms'] * 1e3:.2f} us")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": cs.card_line(), "rows": rows}, f, indent=1)
    bad = [r for r in rows if r["err_over_max"] > 1e-2]
    print(json.dumps({"configs": len(rows), "disagree": len(bad)}))
    return 1 if bad else 0


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
