"""K3's bf16 bodies at the 257-token site of D2R-large, on the card.

At the CLIP-L geometry (L = S = 257, H = 16, D = 64, the strided views of
a fused QKV projection, no bias) at the serving buckets and the training
batch (B = 1, 8, 16, 32), every bf16 body the kernel offers through its C
code (``flash_attention.BODIES``: the ``mma_sync`` body, the ``wgmma``
body as ``body_for`` runs it, and each of its four variants: 1 or 2 tiles
a warpgroup takes of a unit, the rows past the last full tile on the
ragged warps or in a last tile): the error against the plain version and
the share of outputs that differ from it at all (as chip_smoke holds K3),
and the card's time alone (``chip_smoke.device_time_ms``), each body timed twice
in turns (A B C ... C B A), beside SDPA's. The launcher's choice of
variant is read off this table. Run on the card from the repo root:

    python3 k3_sweep.py [--out chiprun_out/k3_sweep.json] [--lib LIBRARY.so]

(``--lib``: the launches go through a library built from another version
of the source, to time it against this one in one call.)

``--check`` instead builds the kernel with ``-DD2R_MBAR_TRAP`` (a barrier
wait that never ends traps rather than hanging the card) and runs every
bf16 body and variant on the edge shapes of the tiling against the plain
version: one line a (shape, body), and the launches each body refuses.

``--probe`` builds the kernel with its clock probe (``-DD2R_K3_PROBE``)
and prints, for each wgmma variant at each batch, SM clocks read by the
kernel itself (medians over blocks, of each block's first unit and each
warpgroup's first tile there): from the block's start until the unit's q
tiles land; per burst of products the wait for K and V, for the products
(q.K_j^T and the previous block's p.V), and the softmax and split; the
tile from q landed to its store issued; the load
warp's loads of the unit issued; the ragged warps' rows, and their first
row's scores, block softmax, p.V and the rest.

``--trace LABEL`` builds D2R-large's bf16 ``Predictor`` (random weights,
seed 0), captures every bucket, and prints one JSON line a bucket: K3's
kernels and ms a forward in a traced replay (``chip_smoke.device_profile``,
three replays) and the replay's ms (CUDA events, median of 7). It uses
only entry points that earlier trees of the port have too, so it can time
another checkout: copy this script into that checkout, run it from its
root with ``PYTHONPATH`` set to it, in turns with this tree's (A, B, B, A)
in one call.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import chip_smoke as cs

SITE = (257, 257, 16, 64)              # L, S, H, D of the CLIP-L site
BATCHES = (1, 8, 16, 32)


def _variant_name(v: int) -> str:
    """The wgmma body's variant v (1-4; C code 3 + v): tiles a warpgroup
    takes of a unit, and the rows past the last full tile on the ragged
    warps or in a last tile."""
    t, warps = 1 + ((v - 1) >> 1), (v - 1) & 1
    return f"wgmma_t{t}_{'warps' if warps else 'tile'}"


# the bf16 bodies by C code: mma.sync, the wgmma body as body_for runs it,
# and its four variants
CODES = {"mma_sync": 0, "wgmma": 3, **{_variant_name(v): 3 + v for v in range(1, 5)}}
# (B, L, S, H, D, key bias, row pad): the edges of the wgmma tiling
CHECK_SHAPES = ((2, 257, 257, 16, 64, False, 0), (2, 257, 257, 4, 64, True, 0),
                (3, 17, 300, 4, 64, True, 0), (2, 100, 1, 4, 64, False, 0),
                (2, 64, 64, 2, 64, True, 0), (2, 65, 70, 2, 64, True, 0),
                (2, 68, 200, 2, 64, False, 0), (2, 70, 90, 2, 64, True, 0),
                (1, 1000, 300, 2, 64, True, 0), (1, 100, 640, 2, 64, True, 0),
                (3, 333, 257, 5, 64, True, 0), (2, 257, 257, 4, 128, True, 0),
                (2, 257, 257, 4, 64, False, 4))


def compare(out, ref, once):
    """Error over max(1, max |ref|), and the shares of outputs that differ
    from the plain version: the kernel's and the control's (p rounded
    once)."""
    size = max(1.0, ref.float().abs().max().item())
    return {"err": (out.float() - ref.float()).abs().max().item() / size,
            "diff_share": (out != ref).float().mean().item(),
            "control_diff_share": (once != ref).float().mean().item()}


def _use_library(path: str) -> None:
    """Every launch below goes through the kernel library at ``path`` (a
    build of another version of the source, for timing one against
    another)."""
    import ctypes
    from d2r_tpu_torch.ops.kernels import flash_attention as fl
    fn = ctypes.CDLL(os.path.abspath(path)).d2r_flash_attention_fwd
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn.argtypes = [i, i, p, p, p, p, p, i, i, i, i, i, ll, ll, ll, ll, ll, ll, f, p]
    fn.restype = ctypes.c_int
    fl._fn[:] = [fn]


def sweep(out_path: str, lib: str = "") -> int:
    import torch
    import torch.nn.functional as F
    from d2r_tpu_torch.ops.kernels import build
    from d2r_tpu_torch.ops.kernels import flash_attention as fl
    from d2r_tpu_torch.ops.kernels import fused_attention as fa
    if lib:
        _use_library(lib)
    else:
        report = build.build_all(["flash_attention_fwd"])
        for line in report.get("flash_attention_fwd", "").splitlines():
            if any(w in line for w in ("Function properties", "registers", "spill", "arning",
                                       "wgmma", "error")):
                print("[build]", line.strip())
    card = cs.card_line()
    print(card)
    l, s, h, d = SITE
    rows, bad = [], 0
    for b in BATCHES:
        q, k, v, _ = cs.k3_inputs(b, l, s, h, d, False, torch.bfloat16, seed=500)
        scale = d ** -0.5
        ref = fl.flash_attention_plain(q, k, v, None, scale)
        once = fa.fused_attention_small_plain(q, k, v, None, scale)
        row = {"B": b, "L": l, "S": s, "H": h, "D": d, "body_for": fl.body_for(q, k, v),
               "bodies": {}}
        for name, code in CODES.items():
            out = fl._launch(q, k, v, None, scale, code)
            torch.cuda.synchronize()
            row["bodies"][name] = c = compare(out, ref, once)
            if not (c["err"] <= cs.K3_TOL["bfloat16"]
                    and c["diff_share"] <= cs.K3_BF16_DIFF_SHARE < c["control_diff_share"]):
                bad += 1
                print(f"  ^ B{b} {name} DISAGREES with the plain version: {c}", flush=True)
        order = list(CODES) + list(reversed(CODES))
        for name in order:
            code = CODES[name]
            ms = cs.device_time_ms(lambda: fl._launch(q, k, v, None, scale, code))
            row["bodies"][name].setdefault("device_ms", []).append(ms)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        row["sdpa_device_ms"] = cs.device_time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale))
        row["bound_ms"], row["bound_by"] = cs.k1_bound(b, l, s, h, d, "bfloat16", False)
        rows.append(row)
        for name, c in row["bodies"].items():
            print(f"B{b:<2d} {name:16s} err {c['err']:.3g} diff share {c['diff_share']:.4f} "
                  f"(control {c['control_diff_share']:.3f}); "
                  + " / ".join(f"{t * 1e3:.2f}" for t in c["device_ms"]) + " us", flush=True)
        print(f"B{b:<2d} sdpa {row['sdpa_device_ms'] * 1e3:.2f} us, bound "
              f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}); body_for {row['body_for']}",
              flush=True)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    print(json.dumps({"batches": len(rows), "disagree": bad}))
    return 1 if bad else 0


def check() -> int:
    import ctypes
    import subprocess
    import torch
    from d2r_tpu_torch.ops.kernels import build
    from d2r_tpu_torch.ops.kernels import flash_attention as fl
    from d2r_tpu_torch.ops.kernels import fused_attention as fa
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    so = os.path.join(build.BUILD_DIR, "libflash_attention_fwd_trap.so")
    out = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DD2R_MBAR_TRAP", "-o", so,
                          os.path.join(build.CSRC, "flash_attention_fwd.cu")],
                         capture_output=True, text=True)
    for line in (out.stdout + out.stderr).splitlines():
        if any(w in line for w in ("Function properties", "registers", "spill", "arning",
                                   "wgmma", "error")):
            print("[build]", line.strip())
    if out.returncode != 0:
        print(out.stdout, out.stderr, file=sys.stderr)
        return 1
    fn = ctypes.CDLL(so).d2r_flash_attention_fwd
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn.argtypes = [i, i, p, p, p, p, p, i, i, i, i, i, ll, ll, ll, ll, ll, ll, f, p]
    fn.restype = ctypes.c_int
    fl._fn[:] = [fn]     # every launch below goes through the trap build
    print(cs.card_line())
    bad = 0
    for n, (b, l, s, h, d, with_bias, pad) in enumerate(CHECK_SHAPES):
        q, k, v, bias = cs.k3_inputs(b, l, s, h, d, with_bias, torch.bfloat16, seed=700 + n,
                                     row_pad=pad)
        scale = d ** -0.5
        ref = fl.flash_attention_plain(q, k, v, bias, scale)
        once = fa.fused_attention_small_plain(q, k, v, bias, scale)
        picked = fl.body_for(q, k, v)
        for name, code in CODES.items():
            try:
                out = fl._launch(q, k, v, bias, scale, code)
                torch.cuda.synchronize()
            except RuntimeError as e:
                print(f"B{b} L{l} S{s} H{h} D{d} bias {with_bias} pad {pad}: {name} refused "
                      f"({e})", flush=True)
                if name in ("mma_sync", picked):
                    bad += 1
                continue
            c = compare(out, ref, once)
            ok = (c["err"] <= cs.K3_TOL["bfloat16"] and c["diff_share"] <= cs.K3_BF16_DIFF_SHARE
                  and (s == 1 or c["control_diff_share"] > cs.K3_BF16_DIFF_SHARE))
            bad += not ok
            print(f"B{b} L{l} S{s} H{h} D{d} bias {with_bias} pad {pad} (body_for {picked}): "
                  f"{name:16s} err {c['err']:.3g} diff share {c['diff_share']:.4f} (control "
                  f"{c['control_diff_share']:.3f}){'' if ok else '  DISAGREES'}", flush=True)
    print(json.dumps({"shapes": len(CHECK_SHAPES), "disagree": bad}))
    return 1 if bad else 0


def probe() -> int:
    """Clocks inside the kernel (module docstring), one line a (batch,
    variant)."""
    import ctypes
    import statistics
    import subprocess
    import torch
    from d2r_tpu_torch.ops.kernels import build
    from d2r_tpu_torch.ops.kernels import flash_attention as fl
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    so = os.path.join(build.BUILD_DIR, "libflash_attention_fwd_probe.so")
    out = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DD2R_K3_PROBE", "-o", so,
                          os.path.join(build.CSRC, "flash_attention_fwd.cu")],
                         capture_output=True, text=True)
    if out.returncode != 0:
        print(out.stdout, out.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(so)
    fn = lib.d2r_flash_attention_fwd
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn.argtypes = [i, i, p, p, p, p, p, i, i, i, i, i, ll, ll, ll, ll, ll, ll, f, p]
    read = lib.d2r_k3_probe
    read.argtypes = [p, i]
    fl._fn[:] = [fn]
    print(cs.card_line())
    l, s, h, d = SITE
    med = lambda xs: statistics.median(xs) if xs else float("nan")
    n = 1024 * 64
    clk = (ctypes.c_longlong * n)()
    for b in BATCHES:
        q, k, v, _ = cs.k3_inputs(b, l, s, h, d, False, torch.bfloat16, seed=500)
        for name, code in CODES.items():
            if code < 4:
                continue
            for _ in range(3):
                lib.d2r_k3_probe_clear()
                fl._launch(q, k, v, None, d ** -0.5, code)
            torch.cuda.synchronize()
            if read(ctypes.cast(clk, ctypes.c_void_p), n):
                print("probe read failed", file=sys.stderr)
                return 1
            land, tile, loads, ragged = [], [], [], []
            rag_parts = [[] for _ in range(4)]   # scores, block softmax, p.V, the rest
            bursts = [[[] for _ in range(3)] for _ in range(6)]
            for c in range(1024):
                t = clk[c * 64:(c + 1) * 64]
                if t[0] <= 0:
                    continue
                if t[28] > 0:
                    loads.append(t[28] - t[0])
                if t[61] > 0 and t[60] > 0:
                    ragged.append(t[61] - t[60])
                    if min(t[29], t[30], t[31]) > 0:
                        for e, (x, y) in enumerate(((60, 29), (29, 30), (30, 31), (31, 61))):
                            rag_parts[e].append(t[y] - t[x])
                for w in (0, 32):
                    if t[w + 1] <= 0 or t[w + 27] <= 0:
                        continue
                    land.append(t[w + 1] - t[w])
                    tile.append(t[w + 27] - t[w + 1])
                    prev = t[w + 1]
                    for j in range(6):
                        m = t[w + 2 + 4 * j:w + 6 + 4 * j]
                        if min(m[0], m[2], m[3]) <= 0:
                            continue
                        bursts[j][0].append(m[0] - prev)
                        bursts[j][1].append(m[2] - m[0])
                        bursts[j][2].append(m[3] - m[2])
                        prev = m[3]
            row = {"B": b, "variant": name, "card": cs.card_line(),
                   "q_landed": med(land), "loads_issued": med(loads), "tile": med(tile),
                   "ragged_rows": med(ragged),
                   "ragged_first_row": dict(zip(("scores", "block_softmax", "pv", "rest"),
                                                map(med, rag_parts))),
                   "bursts": [{"kv_wait": med(x[0]), "products": med(x[1]),
                               "softmax_split": med(x[2])} for x in bursts]}
            print(json.dumps(row), flush=True)
    return 0


def trace(label: str) -> int:
    import torch
    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.serve import Predictor
    cfg = cs.model_config("large", compute_dtype="bfloat16")
    model = build_model(cfg, device="cuda", seed=0)
    pred = Predictor(cfg, model, batch_buckets=cs.BUCKETS, device="cuda")
    pred.warmup()
    ids, mask, tt, pixels = cs.make_requests(cfg)[-1]
    card = cs.card_line()
    for b in cs.BUCKETS:
        g = pred.graph(b)
        pred._stage(g, (ids[:b], mask[:b], tt[:b], pixels[:b]))
        prof = cs.device_profile(g.graph.replay, 3, "forward")
        torch.cuda.synchronize()
        print(json.dumps({"label": label, "card": card, "bucket": b,
                          "replay_ms": cs.replay_ms(g.graph),
                          **{k: prof.get(k) for k in (
                              "k3_kernels_per_forward", "k3_ms_per_forward",
                              "kernels_per_forward", "device_busy_ms_per_forward",
                              "device_idle_share")}}), flush=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="chiprun_out/k3_sweep.json")
    parser.add_argument("--check", action="store_true")
    parser.add_argument("--trace", metavar="LABEL", default=None)
    parser.add_argument("--probe", action="store_true")
    parser.add_argument("--lib", default="", help="time this prebuilt kernel library instead")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k3_sweep: no CUDA device", file=sys.stderr)
        return 2
    if args.check:
        return check()
    if args.trace is not None:
        return trace(args.trace)
    if args.probe:
        return probe()
    return sweep(args.out, args.lib)


if __name__ == "__main__":
    sys.exit(main())
