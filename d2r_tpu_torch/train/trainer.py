"""Training loop (counterpart of ``d2r_tpu/train/trainer.py``).

The JAX package's ``Trainer`` over the port's steps (``train/state.py``):
train steps grouped ``steps_per_dispatch`` at a time (``make_multi_step``),
or ``grad_accum_steps`` microbatches an optimizer step
(``make_accum_step``); loss scalars kept on the device and fetched once a
log window; dev evaluation from ``eval_begin_epoch`` with the best dev
weighted-F1 model saved (``>=``, ties re-save) and reloaded for test;
``patience`` counted from the last strict improvement; ``metrics_jsonl``
records; ``auto_resume`` from a full-state checkpoint at every epoch
boundary; ``write_path`` predictions; ``profile_dir`` (a ``torch.profiler``
trace of the second dispatch); ``tensorboard_dir``.

Auto-resume is exact: the data order is pinned to the epoch number
(``DataLoader.set_epoch``), the dropout seed of a step is
``fold_in(seed + 1, step)`` and the checkpoint holds the optimizer and
schedule, so an interrupted run that resumes gives the uninterrupted run's
bits.

The port builds its model from the config alone, so unlike the JAX trainer
it takes no shape-init batch from the loader before training.

Besides the JAX package's metrics, the trainer times what it waits on, in
``timings`` and the ``summary`` record: each dispatch's time a step (CUDA
events on the card, the host clock on the CPU), the host's wait for each
batch from the loader, each dev evaluation, each best-model save and its
bytes (with ``async_checkpoint``: the save's host copy, and the bytes of the
best model once its writes are awaited before the test reload).

``async_checkpoint`` writes the best model from the save thread of
``train/checkpoint.py``; the trainer awaits it before the test reload, at
each resume point and when training ends. ``debug_nans`` checks every
step's loss and gradients (``train/state.py``). ``prng_impl`` is accepted
under both of the JAX package's names: the port draws Philox bits either
way, and on one card threefry's promise of sharding-stable bits holds
trivially.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from d2r_tpu_torch.config import D2RConfig, resolve_device, save_config_json
from d2r_tpu_torch.train import checkpoint as ckpt
from d2r_tpu_torch.train.metrics import get_four_metrics
from d2r_tpu_torch.train.state import (
    create_train_state,
    make_accum_step,
    make_eval_step,
    make_multi_step,
    make_train_step,
)


class _DispatchTimer:
    """Time a step of each dispatch: CUDA events around it on the card
    (read once, at the end), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.spans = []

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, started, steps: int) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.spans.append((started, ev, steps))
        else:
            self.spans.append(((time.perf_counter() - started) * 1e3, None, steps))

    def step_ms(self):
        if self.cuda and self.spans:
            torch.cuda.synchronize()
        return [(a.elapsed_time(b) if b is not None else a) / k for a, b, k in self.spans]


class Trainer:
    """The JAX package's ``Trainer`` on one device: ``device`` is "cuda"
    (the kernels) unless the caller asks for "cpu" (the plain path). A
    ``model`` given is trained as it is; otherwise one is built from ``cfg``
    with random weights from ``cfg.seed``."""

    def __init__(
        self,
        train_data=None,
        dev_data=None,
        test_data=None,
        model: Optional[torch.nn.Module] = None,
        cfg: D2RConfig = None,
        logger: Optional[logging.Logger] = None,
        cleanup_output: bool = False,
        device="cuda",
    ):
        self.train_data = train_data
        self.dev_data = dev_data
        self.test_data = test_data
        cfg.check_supported()  # a model given was built without this cfg's check
        self.model = model
        self.cfg = cfg
        self.device = resolve_device(device)
        self.logger = logger or logging.getLogger(__name__)
        self.writer = None
        if cfg.tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.writer = SummaryWriter(cfg.tensorboard_dir)
            except Exception as e:  # noqa: BLE001 - observability is optional
                self.logger.warning(
                    "--tensorboard_dir: SummaryWriter unavailable (%r); "
                    "continuing without", e)
        self.cleanup_output = cleanup_output

        self.step = 0
        self.best_dev_metric = 0.0
        self.best_dev_epoch = None
        # --patience: epoch of the last STRICT dev-F1 improvement (a tie
        # re-saves the best model but must not reset patience)
        self.last_improve_epoch = None
        self.grad_accum = max(int(cfg.grad_accum_steps or 1), 1)
        if train_data is not None:
            steps_per_epoch = len(train_data)
            if self.grad_accum > 1:  # the LR schedule counts OPTIMIZER steps
                steps_per_epoch = -(-steps_per_epoch // self.grad_accum)
            self.train_num_steps = steps_per_epoch * cfg.num_epochs
        else:
            self.train_num_steps = 1
        self._train_step = make_train_step(cfg.debug_nans)
        self._multi_steps = {}  # K -> K-step function
        self._accum_steps = {}  # K -> K-microbatch accumulation step
        self._eval_step = make_eval_step()
        self.state = None
        self.timings = {"step_ms": [], "loader_wait_ms": [], "eval_ms": [],
                        "checkpoint_save_ms": [], "checkpoint_bytes": []}

    # ------------------------------------------------------------------
    def init_state(self):
        """The train state: ``self.model`` (or a fresh model from
        ``cfg.seed``) on the trainer's device, with the 4-group AdamW and a
        schedule over ``train_num_steps``."""
        self.state = create_train_state(self.cfg, total_steps=self.train_num_steps,
                                        device=self.device, seed=self.cfg.seed,
                                        model=self.model)
        self.model = self.state.model
        return self.state

    # ------------------------------------------------------------------
    def train(self) -> Dict[str, float]:
        cfg = self.cfg
        self.logger.info("***** Running training *****")
        self.logger.info("  Num instance = %d", len(self.train_data) * cfg.batch_size)
        self.logger.info("  Num epoch = %d", cfg.num_epochs)
        self.logger.info("  Batch size = %d", cfg.batch_size)
        self.logger.info("  Learning rate = %s", cfg.lr)
        self.logger.info("  Evaluate begin = %d", cfg.eval_begin_epoch)

        if cfg.load_path is not None:
            # fail on a flags-vs-checkpoint mismatch before building anything
            ckpt.check_checkpoint_geometry(cfg.load_path, cfg)
        will_resume = False
        if cfg.auto_resume and cfg.save_path is not None:
            if ckpt.load_resume_meta(cfg.save_path) is not None:
                ckpt.check_checkpoint_geometry(cfg.save_path, cfg)
                will_resume = True
        if self.state is None:
            self.init_state()
        if cfg.load_path is not None:
            if will_resume:
                self.logger.info(
                    "auto_resume state found at %s; skipping the --load_path "
                    "restore from %s", cfg.save_path, cfg.load_path)
            else:
                self.logger.info("Loading model from %s", cfg.load_path)
                ckpt.restore_checkpoint(cfg.load_path, self.state)
                self.logger.info("Load model successful!")

        start_epoch = 1
        if cfg.auto_resume and cfg.save_path is not None:
            start_epoch = self._maybe_resume()

        dropout_seed = cfg.seed + 1
        t_start = time.time()
        seen = 0
        window_losses = []  # DEVICE loss tensors pending fetch
        last_log_step = 0
        timer = _DispatchTimer(self.device)

        def flush_log(epoch):
            # one device->host transfer for the whole window
            nonlocal window_losses, last_log_step
            if not window_losses:
                return
            losses = torch.cat([x.reshape(-1).float() for x in window_losses]).cpu().numpy()
            avg = float(losses.mean())
            self.logger.info("epoch %d step %d loss:%.5f", epoch, self.step, avg)
            if self.writer:
                self.writer.add_scalar("train_loss", avg, self.step)
            self._emit_metrics({"kind": "train_window", "epoch": epoch,
                                "step": self.step, "loss": avg})
            window_losses = []
            last_log_step = self.step

        # --profile_dir: a torch.profiler trace of the SECOND dispatch (the
        # first one builds the kernels and warms the allocator)
        profile_state = {"count": 0, "prof": None, "wrote": False}

        def maybe_trace_dispatch(after: bool):
            if not cfg.profile_dir:
                return
            if not after and profile_state["count"] == 1:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                profile_state["prof"] = torch.profiler.profile(activities=acts)
                profile_state["prof"].start()
            elif after:
                profile_state["count"] += 1
                prof = profile_state["prof"]
                if prof is not None:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize()
                    prof.stop()
                    os.makedirs(cfg.profile_dir, exist_ok=True)
                    prof.export_chrome_trace(os.path.join(cfg.profile_dir, "trace.json"))
                    profile_state["prof"], profile_state["wrote"] = None, True
                    self.logger.info("Wrote profile trace to %s", cfg.profile_dir)

        def dispatch(buf, epoch):
            """Run len(buf) train steps (or one accumulated step)."""
            nonlocal seen
            maybe_trace_dispatch(after=False)
            k = len(buf)
            for b in buf:
                seen += int(np.sum(np.asarray(b.get("valid", cfg.batch_size))))
            started = timer.start()
            if self.grad_accum > 1 or k > 1:
                stacked = {key: np.stack([b[key] for b in buf]) for key in buf[0]}
            if self.grad_accum > 1:
                # one OPTIMIZER step from k microbatches; a short final group
                # gets its own k
                if k not in self._accum_steps:
                    self._accum_steps[k] = make_accum_step(k, cfg.debug_nans)
                self.state, metrics = self._accum_steps[k](self.state, stacked, dropout_seed)
                window_losses.append(metrics["loss"])
                self.step += 1
            elif k == 1:
                self.state, metrics = self._train_step(self.state, buf[0], dropout_seed)
                window_losses.append(metrics["loss"])
                self.step += 1
            else:
                if k not in self._multi_steps:
                    self._multi_steps[k] = make_multi_step(k, cfg.debug_nans)
                self.state, metrics = self._multi_steps[k](self.state, stacked, dropout_seed)
                window_losses.append(metrics["losses"])
                self.step += k
            timer.stop(started, 1 if self.grad_accum > 1 else k)
            maybe_trace_dispatch(after=True)
            if self.step - last_log_step >= cfg.log_steps:
                flush_log(epoch)

        # with accumulation each dispatch is one optimizer step over
        # grad_accum microbatches; otherwise K independent steps a dispatch
        steps_per_dispatch = (self.grad_accum if self.grad_accum > 1
                              else max(int(cfg.steps_per_dispatch), 1))
        for epoch in range(start_epoch, cfg.num_epochs + 1):
            if hasattr(self.train_data, "set_epoch"):
                # epoch k always shuffles with seed + k (exact auto-resume)
                self.train_data.set_epoch(epoch)
            buf = []
            batches = iter(self.train_data)
            while True:
                t0 = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    break
                self.timings["loader_wait_ms"].append((time.perf_counter() - t0) * 1e3)
                buf.append(batch)
                if len(buf) == steps_per_dispatch:
                    dispatch(buf, epoch)
                    buf = []
            if buf:
                dispatch(buf, epoch)
            flush_log(epoch)

            if epoch >= cfg.eval_begin_epoch:
                self.evaluate(epoch)

            stop_early = (cfg.patience > 0 and self.last_improve_epoch is not None
                          and epoch - self.last_improve_epoch >= cfg.patience)
            if cfg.auto_resume and cfg.save_path is not None:
                self._save_resume(epoch, early_stopped=stop_early)
            if stop_early:
                self.logger.info(
                    "Early stop at epoch %d: dev F1 has not improved since epoch "
                    "%d (patience %d)", epoch, self.last_improve_epoch, cfg.patience)
                self._emit_metrics({"kind": "early_stop", "epoch": epoch,
                                    "last_improve_epoch": self.last_improve_epoch,
                                    "best_dev_epoch": self.best_dev_epoch})
                break

        elapsed = time.time() - t_start
        self.timings["step_ms"] = timer.step_ms()
        self.logger.info("training throughput: %.2f samples/sec", seen / max(elapsed, 1e-9))
        self._emit_metrics({
            "kind": "summary",
            "samples_per_sec": seen / max(elapsed, 1e-9),
            "steps": self.step, "elapsed_s": elapsed,
            "best_dev_epoch": self.best_dev_epoch,
            "best_dev_f1": self.best_dev_metric,
            **self.timings,
        })
        if cfg.profile_dir and not profile_state["wrote"]:
            self.logger.warning(
                "--profile_dir %s: no trace captured; training ran only %d "
                "dispatch(es) and the profiler skips the first. Lower "
                "steps_per_dispatch or add data so at least two dispatches run.",
                cfg.profile_dir, profile_state["count"])

        # the best checkpoint's test pass
        result = {}
        if cfg.save_path is not None and self.best_dev_epoch is not None:
            best = os.path.join(cfg.save_path, "best_model")
            ckpt.wait_for_async_saves()     # the best save may still be in flight
            if cfg.async_checkpoint:
                self.timings["checkpoint_bytes"].append(ckpt.checkpoint_bytes(best))
            ckpt.restore_checkpoint(best, self.state)
            if self.test_data is not None:
                result = self.test(cfg.num_epochs)
        elif self.test_data is not None:
            result = self.test(cfg.num_epochs)

        if self.cleanup_output and cfg.save_path is not None:
            # the reference deletes its output directory after test
            shutil.rmtree(cfg.save_path, ignore_errors=True)
        return result

    # ------------------------------------------------------------------
    def _maybe_resume(self) -> int:
        """Restore an interrupted run from save_path/resume; returns the
        epoch to start from (1 when there is nothing to resume)."""
        cfg = self.cfg
        meta = ckpt.load_resume_meta(cfg.save_path)
        if meta is None:
            return 1
        for field, mine in (("seed", cfg.seed), ("num_epochs", cfg.num_epochs),
                            ("train_num_steps", self.train_num_steps),
                            ("freeze_towers", cfg.freeze_towers),
                            ("optimizer_impl", cfg.optimizer_impl)):
            theirs = meta.get(field, mine)
            if theirs != mine:
                self.logger.warning(
                    "auto_resume: %s changed across the interruption (checkpoint "
                    "%r vs flags %r); continuing, but the run is no longer "
                    "equivalent to an uninterrupted one", field, theirs, mine)
        ckpt.restore_resume_checkpoint(cfg.save_path, self.state, meta)
        self.step = int(meta.get("trainer_step", 0))
        self.best_dev_metric = float(meta.get("best_dev_metric", 0.0))
        self.best_dev_epoch = meta.get("best_dev_epoch")
        self.last_improve_epoch = meta.get("last_improve_epoch")
        completed = int(meta["epoch"])
        if meta.get("early_stopped"):
            self.logger.info(
                "Auto-resume: run at %s early-stopped at epoch %d; skipping to "
                "the test pass", cfg.save_path, completed)
            return cfg.num_epochs + 1
        self.logger.info(
            "Auto-resume: restored %d completed epoch(s) from %s (step %d, best "
            "dev F1 %.5f at epoch %s); continuing at epoch %d", completed,
            cfg.save_path, self.step, self.best_dev_metric, self.best_dev_epoch,
            completed + 1)
        return completed + 1

    def _save_resume(self, epoch: int, early_stopped: bool = False) -> None:
        """Checkpoint the FULL train state at an epoch boundary. The
        config.json that guards it is written before the meta publishes."""
        cfg = self.cfg
        # an epoch boundary is a durability point: the resume meta must not
        # name an epoch whose best-model save could still be lost
        ckpt.wait_for_async_saves()
        save_config_json(cfg, os.path.join(cfg.save_path, "config.json"))
        ckpt.save_resume_checkpoint(cfg.save_path, self.state, {
            "epoch": epoch,
            "trainer_step": self.step,
            "best_dev_metric": self.best_dev_metric,
            "best_dev_epoch": self.best_dev_epoch,
            "seed": cfg.seed,
            "num_epochs": cfg.num_epochs,
            "train_num_steps": self.train_num_steps,
            "early_stopped": early_stopped,
            "last_improve_epoch": self.last_improve_epoch,
            "freeze_towers": cfg.freeze_towers,
            "optimizer_impl": cfg.optimizer_impl,
        })

    # ------------------------------------------------------------------
    def _emit_metrics(self, record: Dict) -> None:
        """--metrics_jsonl: append one JSON line."""
        path = self.cfg.metrics_jsonl
        if not path:
            return
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "a", encoding="utf-8") as f:
            f.write(json.dumps({"ts": time.time(), **record}) + "\n")

    # ------------------------------------------------------------------
    def _run_eval(self, data: Iterable):
        """Returns (metrics_dict, true_labels, pred_labels). The loss sums
        the batches' losses, each masked by ``valid`` in the model, so a
        wrap-padded final batch counts its valid rows only. Losses and logits
        stay on the device until the loop ends, then come back in one
        transfer each."""
        t0 = time.perf_counter()
        losses, logits, rows = [], [], []
        for batch in data:
            valid = np.asarray(batch.get("valid", np.ones(len(batch["labels"]), bool)))
            out = self._eval_step(self.state, batch)
            losses.append(out["loss"].float())
            logits.append(out["logits"])
            rows.append((np.asarray(batch["labels"]), valid))
        total_loss = 0.0
        true_labels, pred_labels = [], []
        if losses:
            total_loss = float(np.asarray(torch.stack(losses).cpu(), dtype=np.float64).sum())
            preds_all = torch.cat(logits).float().cpu().numpy().argmax(-1)
            off = 0
            for labels, valid in rows:
                preds = preds_all[off:off + len(labels)]
                off += len(labels)
                true_labels.extend(labels[valid].tolist())
                pred_labels.extend(preds[valid].tolist())
        m = get_four_metrics(true_labels, pred_labels, average="weighted",
                             num_classes=self.cfg.num_classes)
        m["loss"] = total_loss
        self.timings["eval_ms"].append((time.perf_counter() - t0) * 1e3)
        return m, true_labels, pred_labels

    def _write_predictions(self, true_labels, pred_labels) -> None:
        """--write_path: the test predictions as JSON."""
        if not self.cfg.write_path:
            return
        os.makedirs(os.path.dirname(self.cfg.write_path) or ".", exist_ok=True)
        with open(self.cfg.write_path, "w", encoding="utf-8") as f:
            json.dump({"true_labels": true_labels, "pred_labels": pred_labels}, f)
        self.logger.info("Wrote predictions to %s", self.cfg.write_path)

    def _report(self, name: str, epoch: int, m: Dict[str, float]) -> Dict[str, float]:
        result = {"eval_accuracy": m["accuracy"], "precision": m["precision"],
                  "recall": m["recall"], "f_score": m["f_score"],
                  "global_step": epoch, "loss": m["loss"]}
        self.logger.info("***** %s Eval results *****", name.capitalize())
        for key in sorted(result):
            self.logger.info("  %s = %s", key, result[key])
        self._emit_metrics({"kind": name, "epoch": epoch, **result})
        if self.writer:
            for k in ("eval_accuracy", "precision", "recall", "f_score", "loss"):
                self.writer.add_scalar(f"{name}/{k}", result[k], epoch)
        return result

    def evaluate(self, epoch: int) -> Dict[str, float]:
        """Dev eval and best-F1 checkpointing."""
        self.logger.info("***** Running evaluate *****")
        m, _, _ = self._run_eval(self.dev_data)
        result = self._report("dev", epoch, m)
        if self.last_improve_epoch is None or m["f_score"] > self.best_dev_metric:
            self.last_improve_epoch = epoch
        if m["f_score"] >= self.best_dev_metric:
            self.logger.info("Get better performance at epoch %d", epoch)
            self.best_dev_epoch = epoch
            self.best_dev_metric = m["f_score"]
            if self.cfg.save_path is not None:
                best = os.path.join(self.cfg.save_path, "best_model")
                t0 = time.perf_counter()
                ckpt.save_checkpoint(best, self.state, include_opt_state=self.cfg.save_opt_state,
                                     async_save=self.cfg.async_checkpoint)
                self.timings["checkpoint_save_ms"].append((time.perf_counter() - t0) * 1e3)
                if not self.cfg.async_checkpoint:
                    self.timings["checkpoint_bytes"].append(ckpt.checkpoint_bytes(best))
                # the geometry guard that --load_path and serving read
                save_config_json(self.cfg, os.path.join(self.cfg.save_path, "config.json"))
                self.logger.info("Save best model at %s", self.cfg.save_path)
        return result

    def test(self, epoch: int) -> Dict[str, float]:
        self.logger.info("***** Running testing *****")
        m, true_labels, pred_labels = self._run_eval(self.test_data)
        self._write_predictions(true_labels, pred_labels)
        result = self._report("test", epoch, m)
        if self.writer:
            self.writer.flush()
        return result
