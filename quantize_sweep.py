"""The rows quantize of int8 training at chip_smoke.py's sites, on the card.

For each site of ``chip_smoke.QUANT_ROW_SITES`` (bf16, and fp32 at the FFN
sites), every launch shape of the rows kernel that holds the row in
registers with at most half its lanes' units empty, under every block
size: codes and scales against the plain version (bit for bit) and the
card's time alone (``chip_smoke.device_time_ms``), beside the shape that
``quantize.rows_tiling`` picks. The rule is read off this table. Run on the
card from the repo root:

    python3 quantize_sweep.py [--out chiprun_out/quantize_sweep.json]

It prints one line a (site, shape) and the best of each site, and writes
every row to the JSON file.

``--sites LABEL`` instead times, at the same sites, the rows quantize as
the wrapper runs it in its three uses (one launch; the amax alone; the
codes from a given amax), on the card alone, one JSON line a site; with
``--steps`` it then runs phase 18's ten bf16 steps of D2R-base at batch 64
in each ``quant_train`` mode (``chip_smoke.int8_steps``) and prints each
mode's replayed step ms and its kernels a replayed step. It uses only entry
points that earlier trees of the port have too, so it can time another
checkout's kernels: copy this script and ``chip_smoke.py`` into that
checkout, run it from its root with ``PYTHONPATH`` set to it, in turns with
this tree's (A, B, B, A) in one call.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import chip_smoke as cs


BLOCKS = (32, 64, 128, 256)   # threads a block the kernel takes


def candidates(r, k, dtype):
    """Every launch shape that holds the row in registers (one segment)
    with at most half its lanes' unit slots empty, under every block size
    that holds a row."""
    from d2r_tpu_torch.ops.kernels import quantize as qk
    units = -(-k // qk.UNIT)
    lanes = 1
    while lanes <= qk.MAX_LANES:
        n = -(-units // lanes)
        if n <= qk.REGISTER_UNITS[dtype] and (lanes == 1 or n * lanes < 2 * units):
            for block in BLOCKS:
                if block >= lanes:
                    yield qk.RowsTiling(n, lanes, block, 1)
        lanes *= 2


def sweep_inputs(r, k, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((r, k), generator=g, device="cuda") * 3
    x[0] = 0     # an all-zero row
    return x.to(dtype)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="chiprun_out/quantize_sweep.json")
    parser.add_argument("--sites", metavar="LABEL", default=None)
    parser.add_argument("--steps", action="store_true")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("quantize_sweep: no CUDA device", file=sys.stderr)
        return 2
    if args.sites is not None:
        return sites(args.sites, args.steps)
    from d2r_tpu_torch.ops.kernels import build
    from d2r_tpu_torch.ops.kernels import quantize as qk
    lines = build.build_all(["quantize"]).get("quantize", "").splitlines()
    for i, line in enumerate(lines):   # each rows body's registers and spills
        if "quantize_rows" in line and "entry function" in line:
            print("[build]", " ".join(x.strip() for x in lines[i:i + 4]))
    print(cs.card_line())
    rows, best = [], {}
    for i, (site, r, k, dtypes) in enumerate(cs.QUANT_ROW_SITES):
        for dtype in dtypes:
            dt = getattr(torch, dtype)
            x = sweep_inputs(r, k, dt, 400 + i)
            want_q, want_s = qk.quantize_rows_plain(x)
            pick = qk.rows_tiling(k, dt)
            for t in candidates(r, k, dt):
                codes = torch.empty((r, k), dtype=torch.int8, device="cuda")
                scale = torch.empty((r, 1), dtype=torch.float32, device="cuda")

                def run():
                    qk._launch_rows(x, None, None, codes, scale, t)

                run()
                torch.cuda.synchronize()
                equal = bool(torch.equal(codes, want_q) and torch.equal(scale, want_s))
                ms = cs.device_time_ms(run)
                row = {"site": site, "R": r, "K": k, "dtype": dtype, "tiling": list(t),
                       "picked": t == pick, "equal": equal, "device_ms": ms,
                       "bound_ms": cs.rows_bound_ms(r, k, dtype)}
                rows.append(row)
                print(f"{site:10s} ({r}, {k}) {dtype:8s} units {t.units} lanes {t.lanes:3d} "
                      f"block {t.block:3d}: {'==' if equal else 'DIFFERS from'} plain, "
                      f"{ms * 1e3:.2f} us{' (the rule)' if t == pick else ''}", flush=True)
                key = (site, dtype)
                if equal and (key not in best or ms < best[key]["device_ms"]):
                    best[key] = row
    for (site, dtype), b in best.items():
        picked = next(x for x in rows if (x["site"], x["dtype"]) == (site, dtype) and x["picked"])
        print(f"best {site:10s} {dtype:8s}: {b['tiling']} {b['device_ms'] * 1e3:.2f} us; "
              f"rule {picked['tiling']} {picked['device_ms'] * 1e3:.2f} us; bound "
              f"{b['bound_ms'] * 1e3:.2f} us")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": cs.card_line(), "rows": rows}, f, indent=1)
    bad = [r for r in rows if not r["equal"]]
    print(json.dumps({"configs": len(rows), "differ": len(bad)}))
    return 1 if bad else 0


def sites(label: str, steps: bool) -> int:
    """The wrapper's rows quantize at the sites, alone; then, with
    ``steps``, phase 18's steps."""
    import torch
    from d2r_tpu_torch.ops.kernels import quantize as qk
    card = cs.card_line()
    for i, (site, r, k, dtypes) in enumerate(cs.QUANT_ROW_SITES):
        for dtype in dtypes:
            x = sweep_inputs(r, k, getattr(torch, dtype), 400 + i)
            amax = qk.row_amax(x)
            print(json.dumps({
                "tree": label, "card": card, "site": site, "R": r, "K": k, "dtype": dtype,
                "rows_us": cs.device_time_ms(lambda: qk.quantize_rows(x)) * 1e3,
                "amax_us": cs.device_time_ms(lambda: qk.row_amax(x)) * 1e3,
                "codes_from_amax_us": cs.device_time_ms(lambda: qk.quantize_rows(x, amax)) * 1e3,
                "bound_us": cs.rows_bound_ms(r, k, dtype) * 1e3}), flush=True)
    if steps:
        runs, _ = cs.int8_steps({})
        for mode, r in runs.items():
            print(json.dumps({"tree": label, "card": card, "mode": mode,
                              "step_ms_median": r["step_ms_median"], "step_ms": r["step_ms"],
                              "replay": {k: v for k, v in r["replay"].items()
                                         if k != "kernel_calls_per_step"}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
