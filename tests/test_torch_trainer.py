"""The port's trainer, checkpoints, metrics and CLI against the JAX
package's, on the CPU, fp32, at ``tiny_test_config`` with the dropout-0
text preset registered on both sides (as ``tests/test_torch_train.py``).

- End to end: both ``Trainer``s, from one random Flax tree (built from
  ``eval_shape``; the port loads it with ``from_jax_variables``), train two
  epochs on a class-conditional fabricated split (as
  ``tests/parity/test_e2e_f1_agreement.py`` builds one), keep the best dev
  model and test it. Dev and test predictions and every epoch's dev
  weighted-F1 are equal; every log window's mean train loss agrees within
  ``WINDOW_LOSS_RTOL`` relative (measured: at most 2.5e-4, and the dev and
  test losses 2.4e-4; the two trajectories part by fp32 rounding). The JAX trainer
  runs one step a dispatch, the port two (its ``make_multi_step``), so the
  windows of ``log_steps`` = 2 steps line up. The ``metrics_jsonl`` records
  carry JAX's keys for every kind and ``--write_path`` JAX's JSON schema.
- ``get_four_metrics`` equals JAX's.
- Checkpoints: a round trip gives identical logits and optimizer state; a
  geometry mismatch raises; an Orbax directory raises.
- A wrap-padded eval batch's losses equal the ragged batch's; a train step
  on uint8 pixels equals one on host-normalised float32 pixels; with
  ``grad_accum_steps`` the schedule counts optimizer steps; a missing
  TensorBoard warns and training goes on.
- Auto-resume after a simulated kill equals the uninterrupted run bit for
  bit (dropout on, shuffled data).
- Patience stops at the JAX trainer's epochs (the cases of
  ``tests/test_trainer_features.py``).
- CLI: JAX's flags and defaults (only ``--device`` differs), the same
  config fields, every refused flag raises naming itself, and the verify
  recipe at tiny size trains, saves (and writes its ``--profile_dir``
  trace) and restores bit for bit.
"""

import copy
import dataclasses
import json
import logging
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2r_tpu import cli as jcli
from d2r_tpu import config as jconfig
from d2r_tpu.models.unimo import D2RClassifier as JaxClassifier
from d2r_tpu.train import metrics as jmetrics
from d2r_tpu.train import optimizer as joptim
from d2r_tpu.train.state import TrainState as JaxTrainState
from d2r_tpu.train.trainer import Trainer as JaxTrainer
from d2r_tpu_torch import cli as tcli
from d2r_tpu_torch import config as tconfig
from d2r_tpu_torch.data import dataset as tdata
from d2r_tpu_torch.data import image as timage
from d2r_tpu_torch.models.unimo import D2RClassifier
from d2r_tpu_torch.train import checkpoint as tckpt
from d2r_tpu_torch.train import metrics as tmetrics
from d2r_tpu_torch.train.state import create_train_state, make_eval_step, make_train_step
from d2r_tpu_torch.train.trainer import Trainer
from d2r_tpu_torch.weights import from_jax_variables
from tests.test_torch_train import INPUTS, _random_tree

NODROP = "tiny-bert-dropout-0"
B, L = 8, 16
N_TRAIN, N_DEV, N_TEST = 64, 16, 16
WINDOW_LOSS_RTOL = 1e-3


def _nodrop(pkg):
    tc = pkg.tiny_test_config().text_config()
    return dataclasses.replace(tc, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


jconfig.register_text_preset(NODROP, lambda: _nodrop(jconfig))
tconfig.register_text_preset(NODROP, lambda: _nodrop(tconfig))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the tiny model's ops are too small to share, and
    beside the suite's other workers more threads only contend (a tiny
    step takes 0.2 s on one, seconds on eight under load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _split(rng, n):
    """Class-conditional: label k draws its tokens from a k-specific band
    and shifts the pixel mean, so a few steps learn it."""
    labels = np.arange(n) % 3
    ids = np.zeros((n, L), np.int32)
    mask = np.ones((n, L), np.int32)
    for i, lab in enumerate(labels):
        lo = 5 + 40 * lab
        ids[i] = rng.integers(lo, lo + 38, size=L)
        length = int(rng.integers(10, L + 1))
        mask[i, length:] = 0
        ids[i, length:] = 0
        ids[i, 0] = 2
    pix = rng.normal(size=(n, 3, 32, 32)).astype(np.float32)
    pix += (labels[:, None, None, None] - 1.0).astype(np.float32) * 0.7
    return {"input_ids": ids, "attention_mask": mask,
            "token_type_ids": np.zeros((n, L), np.int32),
            "labels": labels.astype(np.int32), "pixel_values": pix,
            "valid": np.ones(n, bool)}


def _batches(split):
    n = len(split["labels"])
    return [{k: v[i:i + B] for k, v in split.items()} for i in range(0, n, B)]


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """Both trainers, two epochs, from one init. lr 1e-3 and a head rate
    (fc_lr) of 1e-2: at the recipe's 5e-2 the tiny model's predictions swing
    between classes for the whole 16 steps and never learn the split."""
    root = tmp_path_factory.mktemp("e2e")
    rng = np.random.default_rng(0)
    train, dev, test = (_batches(_split(rng, n)) for n in (N_TRAIN, N_DEV, N_TEST))
    common = dict(bert_name=NODROP, batch_size=B, max_seq=L, num_epochs=2, lr=1e-3, fc_lr=1e-2,
                  warmup_ratio=0.1, DR_step=3)
    out = {}
    for name, pkg, dispatch in (("jax", jconfig, 1), ("port", tconfig, 2)):
        d = root / name
        out[name] = {"dir": d, "cfg": pkg.tiny_test_config(
            **common, steps_per_dispatch=dispatch, save_path=str(d / "out"),
            metrics_jsonl=str(d / "metrics.jsonl"), write_path=str(d / "pred.json"))}
    jcfg, tcfg = out["jax"]["cfg"], out["port"]["cfg"]
    jmodel = JaxClassifier(jcfg)
    tree = _random_tree(jmodel, {k: train[0][k] for k in INPUTS})
    log = logging.getLogger("e2e")

    jt = JaxTrainer(train_data=train, dev_data=dev, test_data=test, model=jmodel, cfg=jcfg,
                    logger=log)
    jt.state = JaxTrainState.create(
        apply_fn=jmodel.apply, params=jax.tree_util.tree_map(jnp.asarray, tree["params"]),
        tx=joptim.make_optimizer(jcfg, jt.train_num_steps),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, tree["batch_stats"]))
    jt.train()
    out["jax"]["dev_eval"] = jt._run_eval(dev)

    tt = Trainer(train_data=train, dev_data=dev, test_data=test, cfg=tcfg, logger=log,
                 model=from_jax_variables(tcfg, copy.deepcopy(tree)), device="cpu")
    tt.train()
    out["port"]["dev_eval"] = tt._run_eval(dev)
    for side in out.values():
        side["records"] = [json.loads(x) for x in open(side["cfg"].metrics_jsonl)]
        side["pred"] = json.load(open(side["cfg"].write_path))
    return out


def _kind(records, kind):
    return [r for r in records if r["kind"] == kind]


def test_e2e_predictions_and_dev_f1_equal_jax(e2e):
    jax_side, port = e2e["jax"], e2e["port"]
    assert port["pred"] == jax_side["pred"]                  # test, after best reload
    assert len(port["pred"]["pred_labels"]) == N_TEST
    jm, jtrue, jpred = jax_side["dev_eval"]
    tm, ttrue, tpred = port["dev_eval"]
    assert (ttrue, tpred) == (jtrue, jpred)
    assert tm["f_score"] == jm["f_score"]
    jdev, tdev = _kind(jax_side["records"], "dev"), _kind(port["records"], "dev")
    assert [r["f_score"] for r in tdev] == [r["f_score"] for r in jdev]
    assert tdev[-1]["f_score"] > 0.6                           # the split was learned
    for a, b in zip(tdev, jdev):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=WINDOW_LOSS_RTOL)


def test_e2e_window_losses_agree_with_jax(e2e):
    jw = _kind(e2e["jax"]["records"], "train_window")
    tw = _kind(e2e["port"]["records"], "train_window")
    assert [(r["epoch"], r["step"]) for r in tw] == [(r["epoch"], r["step"]) for r in jw]
    assert len(tw) == 2 * N_TRAIN // B // 2
    np.testing.assert_allclose([r["loss"] for r in tw], [r["loss"] for r in jw],
                               rtol=WINDOW_LOSS_RTOL, atol=0)


def test_e2e_records_carry_jax_keys(e2e):
    """Every kind JAX writes, with at least its keys; the port adds timing
    keys to the summary only."""
    jrec, trec = e2e["jax"]["records"], e2e["port"]["records"]
    assert [r["kind"] for r in trec] == [r["kind"] for r in jrec]
    for j, t in zip(jrec, trec):
        assert set(j) <= set(t), j["kind"]
        if j["kind"] != "summary":
            assert set(t) == set(j), j["kind"]
    summary = _kind(trec, "summary")[0]
    assert summary["steps"] == _kind(jrec, "summary")[0]["steps"] == 2 * N_TRAIN // B
    assert len(summary["step_ms"]) == N_TRAIN // B        # 2 steps a dispatch
    assert len(summary["loader_wait_ms"]) == 2 * N_TRAIN // B
    assert len(summary["eval_ms"]) == 2 and summary["checkpoint_bytes"][0] > 0


def test_e2e_checkpoint_files_and_config_json(e2e):
    """best_model/ holds the state dict; config.json beside it is the JAX
    package's format, which its own load_config_json reads back."""
    out = e2e["port"]["dir"] / "out"
    assert os.listdir(out / "best_model") == [tckpt.MODEL_FILE]
    got = jconfig.load_config_json(str(out / "config.json"))
    assert dataclasses.asdict(got) == dataclasses.asdict(e2e["port"]["cfg"])


def test_get_four_metrics_matches_jax():
    rng = np.random.default_rng(5)
    for n, c in ((0, 3), (1, 3), (17, 3), (40, 2), (25, 5)):
        labels, preds = rng.integers(0, c, n), rng.integers(0, c, n)
        for average in ("weighted", "macro", "micro"):
            assert (tmetrics.get_four_metrics(labels, preds, average, c)
                    == jmetrics.get_four_metrics(labels, preds, average, c))
        assert tmetrics.get_four_metrics(labels, preds) == jmetrics.get_four_metrics(labels, preds)


# ---- checkpoints --------------------------------------------------------------

def _tiny_batch(cfg, seed=0):
    b = tdata.synthetic_batch(4, cfg.max_seq, cfg.vision_config().image_size,
                              vocab_size=cfg.text_config().vocab_size, seed=seed)
    b["valid"][-1] = False
    return b


@pytest.mark.parametrize("with_opt", [True, False])
def test_checkpoint_round_trip(with_opt, tmp_path):
    cfg = tconfig.tiny_test_config()
    state = create_train_state(cfg, 10, device="cpu", seed=0)
    state, _ = make_train_step()(state, _tiny_batch(cfg), 1)
    tckpt.save_checkpoint(str(tmp_path / "best_model"), state, include_opt_state=with_opt)
    fresh = create_train_state(cfg, 10, device="cpu", seed=1)
    tckpt.restore_checkpoint(str(tmp_path / "best_model"), fresh)
    ev = make_eval_step()
    assert torch.equal(ev(fresh, _tiny_batch(cfg, 3))["logits"], ev(state, _tiny_batch(cfg, 3))["logits"])
    for (n, a), b in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), n
    opt, opt2 = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    if with_opt:
        assert fresh.step == state.step == 1
        assert float(fresh.optimizer.count) == float(state.optimizer.count) == 1   # the schedule
        assert opt2["param_groups"] == opt["param_groups"]
        assert opt2["state"].keys() == opt["state"].keys()
        for i, s in opt["state"].items():
            for k, v in s.items():
                assert torch.equal(opt2["state"][i][k], v), (i, k)
    else:
        assert fresh.step == 0 and not opt2["state"]
    # a later save without optimizer state drops the stale one
    tckpt.save_checkpoint(str(tmp_path / "best_model"), state)
    assert os.listdir(tmp_path / "best_model") == [tckpt.MODEL_FILE]


def test_checkpoint_geometry_mismatch_raises(tmp_path):
    cfg = tconfig.tiny_test_config(DR_step=3)
    tconfig.save_config_json(cfg, str(tmp_path / "config.json"))
    (tmp_path / "best_model").mkdir()
    assert tckpt.check_checkpoint_geometry(str(tmp_path / "best_model"), cfg) == str(
        tmp_path / "config.json")
    with pytest.raises(ValueError, match="DR_step: checkpoint=3 vs flags=4"):
        tckpt.check_checkpoint_geometry(str(tmp_path / "best_model"),
                                        tconfig.tiny_test_config(DR_step=4))
    # a state dict of another geometry does not load either
    state = create_train_state(cfg, 10, device="cpu")
    tckpt.save_checkpoint(str(tmp_path / "best_model"), state)
    other = create_train_state(tconfig.tiny_test_config(DR_step=4), 10, device="cpu")
    with pytest.raises(RuntimeError, match="state_dict"):
        tckpt.restore_checkpoint(str(tmp_path / "best_model"), other)


def test_orbax_directory_raises(tmp_path):
    import orbax.checkpoint as ocp
    path = str(tmp_path / "best_model")
    with ocp.StandardCheckpointer() as c:
        c.save(path, {"params": {"w": np.ones(3, np.float32)}, "batch_stats": {}})
    state = create_train_state(tconfig.tiny_test_config(), 10, device="cpu")
    with pytest.raises(ValueError, match="Orbax checkpoint"):
        tckpt.restore_checkpoint(path, state)
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path), state)


def test_eval_loss_of_a_wrapped_batch_equals_the_ragged_batch():
    """The trainer sums batch losses; a wrap-padded final batch must count
    its valid rows only, as the reference's ragged batch does: CE and JS
    are masked by ``valid`` in the model."""
    cfg = tconfig.tiny_test_config()
    state = create_train_state(cfg, 10, device="cpu", seed=0)
    batch = _tiny_batch(cfg, seed=2)
    ev = make_eval_step()
    wrapped = ev(state, batch)
    ragged = ev(state, {k: v[:3] for k, v in batch.items() if k != "valid"})
    for key in ("loss", "ce_loss", "js_loss"):
        torch.testing.assert_close(wrapped[key], ragged[key], atol=1e-6, rtol=0)
    torch.testing.assert_close(wrapped["logits"][:3], ragged["logits"], atol=1e-6, rtol=0)


def test_train_steps_take_uint8_pixels_as_the_predictor_does():
    """The CLI ships raw uint8 pixels (``--pixel_transfer uint8``); the
    train step normalises them on the device in the host's fp32 op order,
    so it equals a step on host-normalised float32 pixels."""
    cfg = tconfig.tiny_test_config(bert_name=NODROP)
    raw = np.random.default_rng(3).integers(0, 256, (4, 3, 32, 32)).astype(np.uint8)
    # data/image.py::preprocess_pil's float32 path, channel-first
    host = ((raw.astype(np.float32) / 255.0 - timage.CLIP_MEAN[:, None, None])
            / timage.CLIP_STD[:, None, None])
    losses = []
    for pixels in (raw, host.astype(np.float32)):
        state = create_train_state(cfg, 10, device="cpu", seed=0)
        batch = dict(_tiny_batch(cfg), pixel_values=pixels)
        losses.append(make_train_step()(state, batch, 1)[1]["loss"])
    assert host.dtype == np.float32
    torch.testing.assert_close(losses[0], losses[1], atol=1e-6, rtol=0)


def test_grad_accum_schedule_counts_optimizer_steps():
    """Three batches in groups of two: two optimizer steps an epoch (the
    last from one microbatch), and the schedule spans them."""
    cfg = tconfig.tiny_test_config(num_epochs=2, grad_accum_steps=2, save_path=None,
                                   eval_begin_epoch=9)
    tr = Trainer(train_data=[_tiny_batch(cfg, seed=s) for s in range(3)], cfg=cfg,
                 device="cpu")
    assert tr.train_num_steps == 4
    tr.train()
    assert tr.step == tr.state.step == 4
    assert float(tr.state.optimizer.count) == 4     # the schedule's position


def test_tensorboard_unavailable_warns_and_continues(monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)   # import fails
    cfg = tconfig.tiny_test_config(tensorboard_dir="unused", save_path=None)
    with caplog.at_level(logging.WARNING):
        tr = Trainer(train_data=[_tiny_batch(cfg)], cfg=cfg, device="cpu")
    assert tr.writer is None
    assert any("SummaryWriter unavailable" in m for m in caplog.messages)


# ---- auto-resume and patience -----------------------------------------------

class _Killed(Exception):
    pass


def test_auto_resume_equals_the_uninterrupted_run(tmp_path):
    """Two epochs with dropout on over a shuffled loader (a wrapped last
    batch each); one run is killed after epoch 1's resume checkpoint and
    rerun. The final weights, the epoch-2 losses and the test results equal
    the uninterrupted run's."""
    paths = tdata.write_fake_dataset(str(tmp_path / "data"), n=6, image_size=32,
                                     corrupt_every=4)

    def trainer(name, cls=Trainer):
        cfg = tconfig.tiny_test_config(num_epochs=2, auto_resume=True, lr=1e-3,
                                       save_path=str(tmp_path / name),
                                       metrics_jsonl=str(tmp_path / f"{name}.jsonl"))
        proc = tdata.MSDProcessor({k: paths[k] for k in ("train", "dev", "test")},
                                  cfg.bert_name, vocab_size=128)
        mk = lambda mode: tdata.MSDDataset(proc, paths["img_dir"], max_seq=cfg.max_seq,
                                           mode=mode, image_size=32, num_vision_tokens=5,
                                           pixel_transfer="uint8")
        return cls(train_data=tdata.DataLoader(mk("train"), 4, shuffle=True, num_workers=1,
                                               seed=cfg.seed),
                   dev_data=tdata.DataLoader(mk("dev"), 4, num_workers=1),
                   test_data=tdata.DataLoader(mk("test"), 4, num_workers=1),
                   cfg=cfg, device="cpu")

    class KilledAfterEpoch1(Trainer):
        def _save_resume(self, epoch, early_stopped=False):
            super()._save_resume(epoch, early_stopped)
            if epoch == 1:
                raise _Killed()

    whole = trainer("whole")
    whole_result = whole.train()
    with pytest.raises(_Killed):
        trainer("cut", KilledAfterEpoch1).train()
    resumed = trainer("cut")
    result = resumed.train()
    assert resumed.step == whole.step == 4
    assert result == whole_result
    for (n, a), b in zip(whole.state.model.state_dict().items(),
                         resumed.state.model.state_dict().values()):
        assert torch.equal(a, b), n
    windows = lambda name: [(r["epoch"], r["step"], r["loss"])
                            for r in map(json.loads, open(tmp_path / f"{name}.jsonl"))
                            if r["kind"] == "train_window" and r["epoch"] == 2]
    assert windows("cut") == windows("whole") and windows("whole")


@pytest.mark.parametrize("f1s,expected_epochs", [
    ({1: .5, 2: .6, 3: .7, 4: .8}, 4),   # strict improvement every epoch
    ({1: .5, 2: .5, 3: .5, 4: .5}, 3),   # ties count toward patience
    ({1: .5, 2: .6, 3: .4, 4: .3}, 4),   # decline after epoch 2
    ({1: .5, 2: .6, 3: .6, 4: .6}, 4),   # ties after a gain re-save the best
])
def test_patience_stops_at_jax_epochs(f1s, expected_epochs):
    """The cases of tests/test_trainer_features.py through both trainers'
    own ``evaluate`` and stop rule: only ``_run_eval`` is scripted (the same
    dev F1 sequence on both sides), and the train step is a stub on both,
    so the patience bookkeeping is all that runs. The stop epoch, the best
    dev epoch (``>=``: ties re-save) and the last strict improvement equal
    the JAX trainer's."""
    common = dict(batch_size=4, num_epochs=4, eval_begin_epoch=1, save_path=None,
                  steps_per_dispatch=1, patience=2)
    jcfg, tcfg = jconfig.tiny_test_config(**common), tconfig.tiny_test_config(**common)
    data = [_tiny_batch(tcfg, seed=s) for s in range(2)]

    def script(trainer, loss):
        def run_eval(_data):
            f = f1s[trainer.evaluated + 1]
            trainer.evaluated += 1
            m = {"accuracy": f, "precision": f, "recall": f, "f_score": f, "loss": 0.0}
            return m, [], []
        trainer.evaluated = 0
        trainer._run_eval = run_eval
        trainer._train_step = lambda state, batch, seed: (state, {"loss": loss})
        trainer.state = "unused: the train step is a stub"
        return trainer

    jt = script(JaxTrainer(train_data=data, dev_data=[], test_data=None,
                           model=JaxClassifier(jcfg), cfg=jcfg), jnp.zeros(()))
    tt = script(Trainer(train_data=data, dev_data=[], test_data=None, cfg=tcfg,
                        device="cpu"), torch.zeros(()))
    jt.train()
    tt.train()
    assert tt.step == jt.step == expected_epochs * len(data)
    assert tt.evaluated == jt.evaluated == expected_epochs
    assert (tt.best_dev_epoch, tt.last_improve_epoch, tt.best_dev_metric) == (
        jt.best_dev_epoch, jt.last_improve_epoch, jt.best_dev_metric)


# ---- the CLI -----------------------------------------------------------------

def test_cli_flags_and_defaults_are_jax_s():
    jp, tp = jcli.build_arg_parser(), tcli.build_arg_parser()
    jflags = {a.dest: (a.option_strings, a.default, a.choices, type(a).__name__)
              for a in jp._actions}
    tflags = {a.dest: (a.option_strings, a.default, a.choices, type(a).__name__)
              for a in tp._actions}
    assert tflags.keys() == jflags.keys() and len(jflags) == 79    # 78 flags and --help
    assert {k for k in jflags if tflags[k] != jflags[k]} == {"device"}
    assert tflags["device"][1] == "cuda" and jflags["device"][1] == "tpu"


@pytest.mark.parametrize("argv", [
    [], ["--dataset", "hfm", "--compute_dtype", "float32", "--no_pallas"],
    ["--mesh_data", "2", "--mesh_model", "4", "--mesh_stage", "2", "--num_classes", "5",
     "--sample_ratio", "0.5", "--optimizer_impl", "fused", "--grad_accum_steps", "3"]])
def test_config_from_args_gives_jax_fields(argv):
    argv = argv + ["--device", "cpu"]
    jcfg = jcli.config_from_args(jcli.build_arg_parser().parse_args(argv))
    tcfg = tcli.config_from_args(tcli.build_arg_parser().parse_args(argv))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


REFUSED_FLAGS = [["--dry_run"], ["--async_checkpoint"], ["--debug_nans"],
                 ["--prng_impl", "threefry2x32"], ["--pretrained_dir", "x"],
                 ["--sentic_lexicon", "x"], ["--mesh_data", "2"], ["--mesh_model", "2"],
                 ["--mesh_stage", "2"], ["--pipeline_microbatches", "2"], ["--mesh_topology"],
                 ["--coordinator_address", "h:1"], ["--num_processes", "1"],
                 ["--process_id", "0"], ["--seq_shard"], ["--fabric_shard"]]


# flags the CLI once refused and now honours: their case runs the CLI
ACCEPTED_FLAGS = ("--pretrained_dir", "--dry_run", "--async_checkpoint", "--debug_nans",
                  "--prng_impl", "--sentic_lexicon", "--mesh_data", "--mesh_model",
                  "--mesh_topology", "--coordinator_address", "--num_processes",
                  "--process_id", "--mesh_stage", "--pipeline_microbatches", "--seq_shard",
                  "--fabric_shard")
# the JAX package's layout settings: no-ops in one process, there and here,
# so the CLI runs with each alone; they act across processes
# (tests/test_torch_pipeline.py, tests/test_torch_parallel_hints.py)
LAYOUT_FLAGS = ("--seq_shard", "--fabric_shard", "--pipeline_microbatches")
# the multi-process flags, honoured since: in one process a mesh larger than
# the world raises naming it, and a coordinator flag alone raises naming the
# others it needs, before anything is written
PARALLEL_ERRORS = {"--mesh_data": "the world has 1 process",
                   "--mesh_model": "the world has 1 process",
                   "--mesh_stage": "the world has 1 process",
                   "--coordinator_address": "--num_processes N and --process_id",
                   "--process_id": "--process_id needs --coordinator_address"}


def _cli_runs_with(argv, tmp_path):
    """The tiny recipe for an epoch with ``argv``'s flag (``--sentic_lexicon``
    with ``--use_sentic_graph`` and a lexicon file of its own), and the
    saved ``config.json`` records it; ``--dry_run`` prints its line and
    writes nothing."""
    paths = tdata.write_fake_dataset(str(tmp_path / "d"), n=8, image_size=64,
                                     corrupt_every=5)
    out = tmp_path / "out"
    if argv[0] == "--dry_run":
        line = tcli.main(_tiny_cli_flags(paths) + argv + ["--save_path", str(out)])
        assert line["dry_run"] is True and line["params"] > 0
        assert not out.exists()
        return
    if argv[0] == "--sentic_lexicon":
        lexicon = tmp_path / "lexicon.txt"
        lexicon.write_text("happy\t0.9\nsad\t-0.7\n", encoding="utf-8")
        argv = ["--sentic_lexicon", str(lexicon), "--use_sentic_graph"]
    tcli.main(_tiny_cli_flags(paths) + argv + ["--save_path", str(out)])
    cfg = tconfig.load_config_json(str(out / "config.json"))
    field = argv[0][2:].replace("sentic_lexicon", "sentic_lexicon_path")
    value = getattr(cfg, field)
    assert value == (True if len(argv) == 1 else type(value)(argv[1]))
    assert (out / "best_model" / tckpt.MODEL_FILE).exists()


def _cli_runs_a_world_of_one(tmp_path):
    """``--num_processes 1 --process_id 0`` with a coordinator: one gloo
    process trains the tiny recipe for an epoch, and its process group is
    ended when the CLI returns."""
    import torch.distributed as dist

    from d2r_tpu_torch.parallel.launch import free_port
    paths = tdata.write_fake_dataset(str(tmp_path / "d"), n=8, image_size=64,
                                     corrupt_every=5)
    out = tmp_path / "out"
    tcli.main(_tiny_cli_flags(paths) + [
        "--num_processes", "1", "--process_id", "0",
        "--coordinator_address", f"127.0.0.1:{free_port()}", "--save_path", str(out)])
    assert not dist.is_initialized()
    assert (out / "best_model" / tckpt.MODEL_FILE).exists()


def _tiny_cli_flags(paths, epochs=1):
    """The verify recipe's flags at tiny size on a fabricated dataset."""
    return ["--device", "cpu", "--bert_name", "tiny-bert", "--vit_name", "tiny-vit",
            "--embed_size", "64", "--num_head_IMRC", "4", "--hid_IMRC", "64",
            "--hid_router", "32", "--max_seq", "16", "--batch_size", "4",
            "--num_epochs", str(epochs), "--lr", "3e-4", "--train_json", paths["train"],
            "--dev_json", paths["dev"], "--test_json", paths["test"],
            "--img_dir", paths["img_dir"], "--compute_dtype", "float32", "--no_pallas",
            "--num_workers", "2"]


def _cli_fine_tunes_frozen_pretrained_towers(tmp_path):
    """``--pretrained_dir`` with ``--freeze_towers``: one epoch on the tiny
    recipe from tiny HF state dicts (``tests/test_torch_pretrained.py``);
    the best model's towers equal the files' bit for bit (through the
    loader, the layout change included) and the rest of the model trained."""
    pytest.importorskip("transformers")
    from test_torch_pretrained import _state_dicts

    from d2r_tpu_torch.train.optimizer import is_trainable
    from d2r_tpu_torch.utils.weights import load_pretrained_state_dicts
    from d2r_tpu_torch.weights import flax_path

    text, vision = _state_dicts("bert")
    pre = tmp_path / "pretrained"
    pre.mkdir()
    torch.save(text, pre / "bert.pt")
    torch.save(vision, pre / "clip_vit.pt")
    paths = tdata.write_fake_dataset(str(tmp_path / "d"), n=12, image_size=64,
                                     corrupt_every=5)
    out = tmp_path / "out"
    tcli.main(_tiny_cli_flags(paths) + ["--pretrained_dir", str(pre), "--freeze_towers",
                                        "--save_path", str(out)])
    cfg = tconfig.load_config_json(str(out / "config.json"))
    want = load_pretrained_state_dicts(D2RClassifier(cfg), text, vision)
    got = torch.load(out / "best_model" / tckpt.MODEL_FILE, weights_only=True)
    frozen = [n for n, _ in want.named_parameters() if not is_trainable(flax_path(want, n))]
    assert frozen and all(torch.equal(got[n], want.state_dict()[n]) for n in frozen)
    assert not torch.equal(got["fc.weight"], want.state_dict()["fc.weight"])


@pytest.mark.parametrize("argv", REFUSED_FLAGS, ids=lambda a: a[0])
def test_refused_flags_raise_naming_themselves(argv, tmp_path):
    """Every flag here was once refused, naming itself and its ROADMAP item,
    and none is now: each is in :data:`ACCEPTED_FLAGS` and runs. Its case
    runs the CLI with it (a layout flag of :data:`LAYOUT_FLAGS` alone, a
    no-op in one process), or for the multi-process flags in one process
    checks the error that names what is missing (:data:`PARALLEL_ERRORS`)."""
    assert sorted(a[0] for a in REFUSED_FLAGS) == sorted(ACCEPTED_FLAGS)
    assert set(LAYOUT_FLAGS) <= set(ACCEPTED_FLAGS)
    if argv[0] == "--pretrained_dir":
        _cli_fine_tunes_frozen_pretrained_towers(tmp_path)
    elif argv[0] == "--num_processes":
        _cli_runs_a_world_of_one(tmp_path)
    elif argv[0] in PARALLEL_ERRORS:
        with pytest.raises(ValueError, match=re.escape(PARALLEL_ERRORS[argv[0]])):
            tcli.main(argv + ["--device", "cpu", "--save_path", str(tmp_path / "out")])
        assert not (tmp_path / "out").exists()
    else:
        _cli_runs_with(argv, tmp_path)


@pytest.mark.parametrize("override", [
    dict(async_checkpoint=True), dict(debug_nans=True), dict(prng_impl="threefry2x32"),
    dict(sentic_lexicon_path="x"), dict(mesh_shape=(2,)), dict(mesh_shape=(-1, 4)),
    dict(pipeline_microbatches=2), dict(mesh_topology=True), dict(seq_shard=True),
    dict(fabric_shard=True)], ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_the_trainer_refuses_what_the_cli_refuses(override):
    """The library entry point refuses the same config values as the CLI,
    a model passed in or not; those ported since (the trainer extras, the
    lexicon path, ``mesh_topology`` and the layout settings) it accepts, as
    the CLI does. A mesh larger than one process's world raises, naming the
    world. The layout settings it accepts in one process, and their check
    accepts them under a model axis or pipeline stages too, where they act;
    pipeline stages build a trainer in one process."""
    field = list(override)[0]
    if field == "mesh_shape":   # the CLI's axis names for the shape
        override = dict(override, mesh_axis_names=("data", "model")[:len(override[field])])
    cfg = tconfig.tiny_test_config(save_path=None, **override)
    for model in (None, D2RClassifier(tconfig.tiny_test_config())):
        if field in ("async_checkpoint", "debug_nans", "prng_impl", "sentic_lexicon_path",
                     "mesh_topology"):
            Trainer(train_data=[_tiny_batch(cfg)], cfg=cfg, model=model, device="cpu")
            continue
        if field in ("pipeline_microbatches", "seq_shard", "fabric_shard"):
            Trainer(train_data=[_tiny_batch(cfg)], cfg=cfg, model=model, device="cpu")
            acting = dict(override, **(dict(pipeline_stages=2) if field == "pipeline_microbatches"
                                       else dict(mesh_shape=(2, 2),
                                                 mesh_axis_names=("data", "model"))))
            acting_cfg = tconfig.tiny_test_config(save_path=None, **acting)
            acting_cfg.check_supported()
            if field == "pipeline_microbatches":
                Trainer(train_data=[_tiny_batch(acting_cfg)], cfg=acting_cfg, device="cpu")
            continue
        assert field == "mesh_shape", field
        with pytest.raises(ValueError, match="the world has 1 process"):
            Trainer(train_data=[_tiny_batch(cfg)], cfg=cfg, model=model, device="cpu")
    tconfig.tiny_test_config(mesh_shape=(1,)).check_supported()    # one device: honoured


@pytest.mark.parametrize("argv,match", [
    (["--no_pallas", "--device", "cuda"], "--no_pallas off the CPU"),
    (["--remat", "--device", "cpu"], "remat=True"),
    (["--scan_layers", "--device", "cpu"], "scan_layers=True"),
    (["--use_sentic_graph", "--device", "cpu"], "use_sentic_graph=True"),
    (["--quant_train", "int8", "--device", "cpu"], "quant_train='int8'"),
    (["--adam_mu_dtype", "bfloat16", "--device", "cpu"], "adam_mu_dtype='bfloat16'"),
    (["--alpha", "0.5", "--device", "cpu"], "alpha=0.5")])
def test_config_values_the_port_cannot_honour_raise_from_the_cli(argv, match, tmp_path):
    """The values still refused raise, naming themselves. Those the port
    has since ported (``remat``, ``scan_layers``, bf16 Adam moments, CCR's
    ``alpha``, ``use_sentic_graph``, int8 ``quant_train``) run the tiny
    recipe for an epoch instead, and its ``config.json`` records
    ``match``'s field and value."""
    field, _, value = match.partition("=")
    if field not in ("remat", "scan_layers", "adam_mu_dtype", "alpha", "use_sentic_graph",
                     "quant_train"):
        with pytest.raises(NotImplementedError, match=match):
            tcli.main(argv)
        return
    paths = tdata.write_fake_dataset(str(tmp_path / "d"), n=8, image_size=64,
                                     corrupt_every=5)
    out = tmp_path / "out"
    tcli.main(_tiny_cli_flags(paths) + argv[:-2] + ["--save_path", str(out)])
    cfg = tconfig.load_config_json(str(out / "config.json"))
    assert repr(getattr(cfg, field)) == value
    assert (out / "best_model" / tckpt.MODEL_FILE).exists()


def test_cli_trains_saves_and_restores_bit_for_bit(tmp_path, caplog):
    """The verify recipe at tiny size: write_fake_dataset(n=12,
    image_size=224, corrupt_every=5), two epochs; then --only_test
    --load_path best_model gives the same test loss."""
    paths = tdata.write_fake_dataset(str(tmp_path / "d"), n=12, image_size=224,
                                     corrupt_every=5)
    flags = ["--device", "cpu", "--bert_name", "tiny-bert", "--vit_name", "tiny-vit",
             "--embed_size", "64", "--num_head_IMRC", "4", "--hid_IMRC", "64",
             "--hid_router", "32", "--max_seq", "16", "--batch_size", "4",
             "--num_epochs", "2", "--lr", "3e-4", "--train_json", paths["train"],
             "--dev_json", paths["dev"], "--test_json", paths["test"],
             "--img_dir", paths["img_dir"], "--compute_dtype", "float32", "--no_pallas",
             "--num_workers", "2"]
    out = tmp_path / "output"
    with caplog.at_level(logging.INFO):
        tcli.main(flags + ["--save_path", str(out), "--metrics_jsonl", str(tmp_path / "a.jsonl"),
                           "--profile_dir", str(tmp_path / "prof"), "--steps_per_dispatch", "1"])
    assert any(m.startswith("Save best model at") for m in caplog.messages)
    assert "traceEvents" in json.load(open(tmp_path / "prof" / "trace.json"))
    assert "***** Test Eval results *****" in caplog.messages
    assert (out / "best_model" / tckpt.MODEL_FILE).exists() and (out / "config.json").exists()
    test = lambda p: next(r for r in map(json.loads, open(p)) if r["kind"] == "test")
    trained = test(tmp_path / "a.jsonl")
    assert np.isfinite(trained["loss"])
    tcli.main(flags + ["--save_path", str(tmp_path / "o2"), "--metrics_jsonl",
                       str(tmp_path / "b.jsonl"), "--only_test", "--load_path",
                       str(out / "best_model")])
    probe = test(tmp_path / "b.jsonl")
    assert probe["loss"] == trained["loss"] and probe["f_score"] == trained["f_score"]
