#!/usr/bin/env python3
"""Where two runs of the port's training CLI in one process part, on the card.

    python3 bisect_cli_runs.py                 # every variant
    python3 bisect_cli_runs.py --variant default

The command is the one ``chip_smoke.py``'s extras phase runs twice and
compares: ``python -m d2r_tpu_torch.cli`` at ``run.sh``'s recipe (D2R-base,
batch 64, bf16) with ``--auto_resume``, one epoch on
``write_fake_dataset(**chip_smoke.EXTRAS_DATA)`` (two train steps, a dev
and a test pass). Each variant runs in a process of its own and calls the
CLI twice there. After every train step the trainer's parameters, their
gradients and the BatchNorm buffers are copied to the host; the second
run's copies are held to the first run's at the same step, and the eval
outputs likewise. A variant reports the first step where anything differs,
what ran there (eager or replayed: the K1 host calls of the step), and the
tensors that differ there in the model's order, with their largest
difference and the share of elements that differ.

Variants: ``default``; ``cudnn_deterministic`` (``torch.backends.cudnn.
deterministic = True``: cuDNN's deterministic algorithms only, which
covers the patch conv's backward); ``deterministic``
(``torch.use_deterministic_algorithms(True)`` with
``CUBLAS_WORKSPACE_CONFIG=:4096:8``: an operation without a deterministic
implementation raises, naming itself). The JSON report goes to
``chiprun_out/bisect_cli_runs.json``; the last line of the output is its
summary.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

VARIANTS = ("default", "cudnn_deterministic", "deterministic")
ROOT = os.path.join("build", "bisect_cli_runs")
OUT = os.path.join("chiprun_out", "bisect_cli_runs.json")
# the tensors listed at the first differing step
LISTED = 40


def compare(a, b):
    """{key: (max |a - b|, share of elements that differ)} over the keys
    whose tensors are not equal bit for bit."""
    out = {}
    for key, x in a.items():
        y = b[key]
        if x.dtype != y.dtype or x.shape != y.shape:
            out[key] = (float("inf"), 1.0)
        elif not _same_bits(x, y):
            d = (x.double() - y.double()).abs()
            out[key] = (float(d.max()), float((d > 0).double().mean()))
    return out


def _same_bits(x, y):
    import torch
    if x.is_floating_point():
        width = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
        return bool(torch.equal(x.view(width), y.view(width)))
    return bool(torch.equal(x, y))


def run_variant(name):
    import torch
    if name == "cudnn_deterministic":
        torch.backends.cudnn.deterministic = True
    elif name == "deterministic":
        torch.use_deterministic_algorithms(True)
    import chip_smoke as c
    from d2r_tpu_torch import cli
    from d2r_tpu_torch.data.dataset import write_fake_dataset
    from d2r_tpu_torch.ops.kernels import build
    from d2r_tpu_torch.ops.kernels import fused_attention as fa
    from d2r_tpu_torch.train import trainer as trainer_mod

    build.build_all()
    root = os.path.join(ROOT, name)
    shutil.rmtree(root, ignore_errors=True)
    paths = write_fake_dataset(os.path.join(root, "data"), **c.EXTRAS_DATA)
    flags = c.TRAINER_RECIPE + [
        "--num_epochs", "1", "--train_json", paths["train"], "--dev_json", paths["dev"],
        "--test_json", paths["test"], "--img_dir", paths["img_dir"], "--steps_per_dispatch", "1",
        "--auto_resume"]

    runs = [[], []]       # per run: (kind, label, tensors) after each step and eval
    current = {"run": 0}

    def record(kind, label, tensors):
        torch.cuda.synchronize()
        runs[current["run"]].append((kind, label, {k: v.detach().to("cpu", copy=True)
                                                   for k, v in tensors.items()}))
        if current["run"] == 1:
            # hold the first run's copy only until the second run has its own
            ref = runs[0][len(runs[1]) - 1]
            diffs = compare(ref[2], runs[1][-1][2])
            runs[1][-1] = (kind, label, diffs)
            runs[0][len(runs[1]) - 1] = (ref[0], ref[1], None)

    make_train_step, make_eval_step = trainer_mod.make_train_step, trainer_mod.make_eval_step

    def train_step_recorded(debug_nans=False):
        step = make_train_step(debug_nans)

        def wrapped(state, batch, seed):
            k1 = fa.fused_attention_small.launches
            state, metrics = step(state, batch, seed)
            kind = "eager or capture" if fa.fused_attention_small.launches > k1 else "replay"
            tensors = {}
            for n, p in state.model.named_parameters():
                tensors["param " + n] = p
                if p.grad is not None:
                    tensors["grad " + n] = p.grad
            for n, b in state.model.named_buffers():
                tensors["buffer " + n] = b
            tensors["loss"] = metrics["loss"]
            record("train step", kind, tensors)
            return state, metrics

        return wrapped

    def eval_step_recorded():
        step = make_eval_step()

        def wrapped(*args, **kwargs):
            out = step(*args, **kwargs)
            items = out.items() if isinstance(out, dict) else enumerate(
                out if isinstance(out, (tuple, list)) else (out,))
            record("eval", "", {f"eval {k}": v for k, v in items if isinstance(v, torch.Tensor)})
            return out

        return wrapped

    trainer_mod.make_train_step = train_step_recorded
    trainer_mod.make_eval_step = eval_step_recorded
    result = {"variant": name, "flags": flags}
    try:
        for i in range(2):
            current["run"] = i
            t0 = time.perf_counter()
            cli.main(list(flags) + ["--save_path", os.path.join(root, f"run{i}"),
                                    "--metrics_jsonl", os.path.join(root, f"run{i}.jsonl")])
            result[f"run{i}_s"] = time.perf_counter() - t0
    except Exception as e:  # noqa: BLE001 - a deterministic-mode refusal names the op
        result["error"] = f"{type(e).__name__}: {e}"[:3000]
        return result
    finally:
        trainer_mod.make_train_step, trainer_mod.make_eval_step = make_train_step, make_eval_step
        shutil.rmtree(root, ignore_errors=True)
    events = []
    for i, ((kind, label, _), (_, _, diffs)) in enumerate(zip(runs[0], runs[1])):
        events.append({"event": i, "what": kind, "ran": label, "differing_tensors": len(diffs),
                       "max_abs_diff": max((d[0] for d in diffs.values()), default=0.0)})
    result["events"] = events
    result["runs_equal"] = all(e["differing_tensors"] == 0 for e in events)
    first = next((i for i, e in enumerate(events) if e["differing_tensors"]), None)
    result["first_differing_event"] = first
    if first is not None:
        diffs = runs[1][first][2]
        result["first_differing_tensors"] = [
            {"tensor": k, "max_abs_diff": d[0], "differing_share": d[1]}
            for k, d in list(diffs.items())[:LISTED]]
        kinds = {}
        for k in diffs:
            kinds[k.split(" ")[0]] = kinds.get(k.split(" ")[0], 0) + 1
        result["first_differing_kinds"] = kinds
    return result


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", choices=VARIANTS, default=None)
    ap.add_argument("--json", default=None, help="where a single variant writes its result")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("bisect_cli_runs: no CUDA device", file=sys.stderr)
        return 2
    if args.variant is not None:
        result = run_variant(args.variant)
        path = args.json or OUT
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
        return 0
    os.makedirs("chiprun_out", exist_ok=True)
    report = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), "torch": torch.__version__}
    for name in VARIANTS:
        path = os.path.join(ROOT, f"{name}.json")
        os.makedirs(ROOT, exist_ok=True)
        env = dict(os.environ)
        if name == "deterministic":
            env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, __file__, "--variant", name, "--json", path],
                              env=env)
        with open(path) as f:
            result = json.load(f) if proc.returncode == 0 else {"rc": proc.returncode}
        result["wall_s"] = time.perf_counter() - t0
        report[name] = result
        print(f"[bisect] {name}: " + json.dumps(
            {k: result.get(k) for k in ("runs_equal", "first_differing_event", "events",
                                       "first_differing_kinds", "error", "wall_s")}),
            flush=True)
        if result.get("first_differing_tensors"):
            for t in result["first_differing_tensors"][:12]:
                print(f"[bisect] {name}:   {t}", flush=True)
    with open(OUT, "w") as f:
        json.dump(report, f, indent=1)
    shutil.rmtree(ROOT, ignore_errors=True)
    print(json.dumps({v: {"runs_equal": report[v].get("runs_equal"),
                          "first_differing_event": report[v].get("first_differing_event"),
                          "error": report[v].get("error")} for v in VARIANTS}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
