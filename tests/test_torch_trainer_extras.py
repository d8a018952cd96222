"""The trainer extras the port once refused, on the CPU: ``--dry_run``,
``--async_checkpoint``, ``--debug_nans`` and ``--prng_impl``, and the
refusals left (the parallel settings only).

- ``--dry_run`` at tiny width prints one JSON line with the JAX CLI's key
  set, and its ``params`` equals what JAX's ``_dry_run`` prints for the same
  config (JAX's function run with its step compile stubbed out, which it
  treats as best-effort; its state from ``eval_shape`` of an init with the
  adjacency when ``use_sentic_graph`` is on).
- ``--async_checkpoint``: the best model, its optimizer state and the
  auto-resume slots of a two-epoch CLI run equal a synchronous run's bit for
  bit, and so does the test pass after the best model's reload; a save
  copies the state at once (a parameter changed after the call is not
  written); a failed write raises at the next wait.
- ``--debug_nans``: a step on a batch with NaN pixels raises
  ``FloatingPointError`` naming the step and a parameter, before the
  optimizer steps; the same step without the flag does not raise.
- ``--prng_impl threefry2x32`` gives the ``rbg`` run's bits (dropout on).
"""

import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2r_tpu import cli as jcli
from d2r_tpu import config as jconfig
from d2r_tpu.ops import qdot as jqdot
from d2r_tpu.train import state as jstate
from d2r_tpu_torch import cli as tcli
from d2r_tpu_torch import config as tconfig
from d2r_tpu_torch.data import dataset as tdata
from d2r_tpu_torch.train import checkpoint as tckpt
from d2r_tpu_torch.train.state import create_train_state, make_train_step
from d2r_tpu_torch.train.trainer import Trainer


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _reset_jax_mode():
    """JAX's ``_dry_run`` of an int8 config leaves ``d2r_tpu.ops.qdot.MODE``
    set for later traces in the process (a module global)."""
    prev = jqdot.MODE
    yield
    jqdot.MODE = prev


TINY = ["--device", "cpu", "--bert_name", "tiny-bert", "--vit_name", "tiny-vit",
        "--embed_size", "64", "--num_head_IMRC", "4", "--hid_IMRC", "64",
        "--hid_router", "32", "--max_seq", "16", "--batch_size", "4", "--lr", "3e-4",
        "--compute_dtype", "float32", "--no_pallas", "--num_workers", "2"]


# ---- --dry_run --------------------------------------------------------------

def _jax_dry_run_line(argv, monkeypatch, capsys):
    """The line JAX's ``_dry_run`` prints for ``argv``, its step compile
    stubbed (it catches that failure and leaves the cost keys null) and its
    state's params from ``eval_shape`` instead of a jitted init."""
    def create_train_state(model, cfg, tx, rng, batch, total_steps=1000, mesh=None):
        inputs = jstate._model_inputs({k: jnp.asarray(v) for k, v in batch.items()})
        return types.SimpleNamespace(params=jax.eval_shape(model.init, rng, **inputs)["params"])

    def make_train_step(model):
        def lower(*_):
            raise RuntimeError("the step is not compiled in this test")
        return types.SimpleNamespace(lower=lower)

    monkeypatch.setattr(jstate, "create_train_state", create_train_state)
    monkeypatch.setattr(jstate, "make_train_step", make_train_step)
    cfg = jcli.config_from_args(jcli.build_arg_parser().parse_args(argv))
    jcli._dry_run(cfg, jcli.logger)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("extra", [[], ["--use_sentic_graph", "--quant_train", "int8"]],
                         ids=["plain", "sentic-int8"])
def test_dry_run_prints_jax_keys_and_params(extra, monkeypatch, capsys):
    argv = TINY + ["--dry_run"] + extra
    port = tcli.main(argv)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == port
    want = _jax_dry_run_line(argv, monkeypatch, capsys)
    assert set(port) == set(want)
    assert port["params"] == want["params"]
    for key in ("dry_run", "batch_size", "max_seq", "compute_dtype"):
        assert port[key] == want[key], key
    assert port["flops_per_step"] > 0 and port["bytes_accessed_per_step"] is None
    # JAX meshes every device it sees (the suite's CPU has several); the
    # port trains on one
    assert port["devices"] == 1 and port["mesh"] == {"data": 1} and set(want["mesh"]) == {"data"}


def test_dry_run_counts_the_gcn():
    """The sentic model's line counts the GCN's parameters and products."""
    base = tcli.main(TINY + ["--dry_run"])
    sentic = tcli.main(TINY + ["--dry_run", "--use_sentic_graph"])
    assert sentic["params"] - base["params"] == 64 * 64 + 64
    assert sentic["flops_per_step"] > base["flops_per_step"]


# ---- --async_checkpoint -----------------------------------------------------

@functools.lru_cache(maxsize=None)
def _dataset(root):
    return tdata.write_fake_dataset(root, n=10, image_size=64, corrupt_every=5)


def _run_cli(tmp_path, name, extra):
    paths = _dataset(str(tmp_path / "data"))
    out = tmp_path / name
    tcli.main(TINY + ["--num_epochs", "2", "--train_json", paths["train"],
                      "--dev_json", paths["dev"], "--test_json", paths["test"],
                      "--img_dir", paths["img_dir"], "--save_path", str(out),
                      "--save_opt_state", "--auto_resume", "--steps_per_dispatch", "1",
                      "--metrics_jsonl", str(out / "metrics.jsonl")] + extra)
    return out


def _saved(out):
    files = sorted(p.relative_to(out) for p in out.rglob("*.pth"))
    return files, {str(f): torch.load(out / f, weights_only=True) for f in files}


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_async_checkpoint_saves_what_a_synchronous_run_saves(tmp_path):
    sync = _run_cli(tmp_path, "sync", [])
    asyn = _run_cli(tmp_path, "async", ["--async_checkpoint"])
    files, want = _saved(sync)
    got_files, got = _saved(asyn)
    assert files == got_files and len(files) == 6     # best model + two resume slots, 2 files each
    for f in want:
        assert _equal(got[f], want[f]), f

    def records(out, kind):
        return [{k: v for k, v in json.loads(line).items() if k not in ("ts", "elapsed_s")}
                for line in open(out / "metrics.jsonl") if json.loads(line)["kind"] == kind]

    assert records(asyn, "test") == records(sync, "test") and records(sync, "test")
    assert records(asyn, "dev") == records(sync, "dev")
    assert tconfig.load_config_json(str(asyn / "config.json")).async_checkpoint


def test_async_save_copies_the_state_at_once(tmp_path):
    cfg = tconfig.tiny_test_config()
    state = create_train_state(cfg, 10, device="cpu", seed=0)
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    tckpt.save_checkpoint(str(tmp_path / "m"), state, include_opt_state=True, async_save=True)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    tckpt.wait_for_async_saves()
    got = torch.load(tmp_path / "m" / tckpt.MODEL_FILE, weights_only=True)
    assert _equal(got, want)


def test_a_failed_async_write_raises_at_the_next_wait(tmp_path, monkeypatch):
    cfg = tconfig.tiny_test_config()
    state = create_train_state(cfg, 10, device="cpu", seed=0)

    def fail(*_):
        raise OSError("disk full")

    monkeypatch.setattr(tckpt, "_write_checkpoint", fail)
    tckpt.save_checkpoint(str(tmp_path / "m"), state, async_save=True)
    with pytest.raises(OSError, match="disk full"):
        tckpt.wait_for_async_saves()
    tckpt.wait_for_async_saves()            # reported once, then nothing is pending


# ---- --debug_nans and --prng_impl -------------------------------------------

def _batch(cfg, seed=0):
    b = tdata.synthetic_batch(4, cfg.max_seq, cfg.vision_config().image_size,
                              vocab_size=cfg.text_config().vocab_size, seed=seed)
    b["valid"][-1] = False
    return b


def test_debug_nans_raises_on_a_nan_batch_before_the_update():
    cfg = tconfig.tiny_test_config(debug_nans=True)
    bad = _batch(cfg)
    bad["pixel_values"][1, :, :4, :4] = np.nan
    state = create_train_state(cfg, 10, device="cpu", seed=0)
    state, _ = make_train_step(True)(state, _batch(cfg, seed=1), 1)     # a finite step first
    before = {k: v.clone() for k, v in state.model.named_parameters()}
    trainer = Trainer(train_data=[bad], cfg=cfg, device="cpu")
    trainer.state = state
    with pytest.raises(FloatingPointError, match=r"debug_nans: step 1: the (loss|gradient of \S+)"):
        trainer._train_step(state, bad, 1)
    # the optimizer did not step (the forward's BatchNorm statistics did move)
    assert _equal({k: v for k, v in state.model.named_parameters()}, before)
    assert state.step == 1


def test_without_debug_nans_a_nan_batch_does_not_raise():
    cfg = tconfig.tiny_test_config()
    bad = _batch(cfg)
    bad["pixel_values"][1, :, :4, :4] = np.nan
    state = create_train_state(cfg, 10, device="cpu", seed=0)
    state, metrics = make_train_step()(state, bad, 1)
    assert not torch.isfinite(metrics["loss"])


def test_debug_nans_through_the_trainer_and_the_cli(tmp_path):
    """The trainer raises from ``train``; the CLI takes the flag and trains
    a finite run to the end."""
    cfg = tconfig.tiny_test_config(debug_nans=True, save_path=None, num_epochs=1,
                                   eval_begin_epoch=2)
    bad = _batch(cfg)
    bad["pixel_values"][:] = np.nan
    with pytest.raises(FloatingPointError, match="step 0"):
        Trainer(train_data=[bad], cfg=cfg, device="cpu").train()
    out = _run_cli(tmp_path, "nans", ["--debug_nans"])
    assert tconfig.load_config_json(str(out / "config.json")).debug_nans


@pytest.mark.parametrize("accum", [1, 2])
def test_prng_impl_names_give_the_same_bits(accum):
    """Dropout on (tiny-bert's 0.1): three steps under either name."""
    states = []
    for impl in tconfig.PRNG_IMPLS:
        cfg = tconfig.tiny_test_config(prng_impl=impl, save_path=None, num_epochs=1,
                                       eval_begin_epoch=2, grad_accum_steps=accum)
        trainer = Trainer(train_data=[_batch(cfg, s) for s in range(3)], cfg=cfg, device="cpu")
        trainer.train()
        states.append(trainer.state.model.state_dict())
    assert _equal(states[0], states[1])


def test_only_the_parallel_settings_are_refused():
    assert {f for f, *_ in tconfig.UNPORTED} == {
        "mesh_shape", "pipeline_microbatches", "mesh_topology", "seq_shard", "fabric_shard"}
    assert {flag for flag, *_ in tcli.REFUSED} == {
        "--coordinator_address", "--num_processes", "--process_id"}
    assert all("Queue 1 item 9" in item for *_, item in tconfig.UNPORTED + tcli.REFUSED)
    tconfig.tiny_test_config(use_sentic_graph=True, sentic_lexicon_path="x", quant_train="int8_all",
                             async_checkpoint=True, debug_nans=True,
                             prng_impl="threefry2x32").check_supported()
    with pytest.raises(NotImplementedError, match="prng_impl='unsafe_rbg'"):
        tconfig.tiny_test_config(prng_impl="unsafe_rbg").check_supported()
    assert jconfig.D2RConfig().prng_impl in tconfig.PRNG_IMPLS
