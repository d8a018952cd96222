"""The port's serving path (``d2r_tpu_torch/serve.py``, ``restore_model``)
on the CPU: the plain ``Predictor`` against the JAX package's on one seeded
Flax tree, ``latency_stats``, the padding that staging into a captured
bucket does, and restoring a checkpoint for serving. Replay of the CUDA
graphs is tested on the card (``tests/test_torch_cuda.py``).

Also the helpers the other serving test files share: ``tiny_tree`` (a
seeded fp32 Flax tree at ``tiny_test_config``, built from ``eval_shape``)
and ``tiny_checkpoint`` (the port's checkpoint layout of it).
"""

import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d2r_tpu.config import tiny_test_config as jax_tiny_config
from d2r_tpu.models.unimo import D2RClassifier as JaxClassifier
from d2r_tpu.serve import Predictor as JaxPredictor
from d2r_tpu.serve import latency_stats as jax_latency_stats
from d2r_tpu_torch.config import save_config_json, tiny_test_config
from d2r_tpu_torch.serve import Predictor, latency_stats, pad_into
from d2r_tpu_torch.train import checkpoint as tckpt
from d2r_tpu_torch.weights import from_jax_variables
from tests.test_torch_model import INPUTS, batch, random_variables

KEYS = ("input_ids", "attention_mask", "token_type_ids", "pixel_values")


@functools.lru_cache(maxsize=None)
def tiny_tree(seed=0):
    """A seeded Flax variable tree of the JAX ``D2RClassifier`` at
    ``tiny_test_config()``, every leaf a numpy fp32 array."""
    jcfg = jax_tiny_config()
    b = batch(jcfg, 2)
    tree = random_variables(JaxClassifier(jcfg), [jnp.asarray(b[k]) for k in INPUTS], seed=seed)
    return {c: jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree[c])
            for c in ("params", "batch_stats")}


def tiny_checkpoint(root, seed=0):
    """``root/best_model/model.pth`` and ``root/config.json`` of the port's
    model holding ``tiny_tree(seed)``, as the trainer lays them out. Returns
    the ``best_model`` path."""
    cfg = tiny_test_config()
    path = os.path.join(str(root), "best_model")
    model = from_jax_variables(cfg, tiny_tree(seed))
    tckpt.save_checkpoint(path, types.SimpleNamespace(model=model))
    save_config_json(cfg, os.path.join(str(root), "config.json"))
    return path


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _predictors():
    jpred = JaxPredictor(jax_tiny_config(), tiny_tree(), batch_buckets=(2, 4))
    cfg = tiny_test_config()
    tpred = Predictor(cfg, from_jax_variables(cfg, tiny_tree()), batch_buckets=(2, 4),
                      device="cpu")
    return jpred, tpred


def test_plain_predictor_matches_jax_and_runs_eagerly_on_the_cpu():
    """Requests of 1, 4 and 9 rows (9 chunked as 4 + 4 + 1): probabilities
    within 1e-4 of the JAX ``Predictor``; on the CPU no graph is captured,
    and asking for one raises."""
    jpred, tpred = _predictors()
    tpred.warmup()
    b = batch(tpred.cfg, 9, seed=2)
    for n in (1, 4, 9):
        args = [b[k][:n] for k in KEYS]
        ref, got = jpred.predict(*args), tpred.predict(*args)
        assert got["probs"].shape == (n, 3) and got["label"].shape == (n,)
        np.testing.assert_allclose(got["probs"], np.asarray(ref["probs"], np.float32),
                                   atol=1e-4, rtol=0)
    assert tpred.graphs == {}
    with pytest.raises(RuntimeError, match="CUDA graphs need a CUDA device"):
        tpred.graph(2)


@pytest.mark.parametrize("device_resident", [False, True])
def test_latency_stats(device_resident):
    """The port's ``latency_stats`` returns what the JAX package's does."""
    jpred, tpred = _predictors()
    b = batch(tpred.cfg, 3, seed=5)
    got = latency_stats(tpred, b, iters=3, warmup=1, device_resident=device_resident)
    ref = jax_latency_stats(jpred, b, iters=3, warmup=1, device_resident=device_resident)
    assert set(got) == set(ref) == {"mean", "p50", "p95"}
    assert 0 < got["p50"] <= got["p95"] and got["mean"] > 0


def test_latency_stats_device_resident_takes_one_bucket():
    _, tpred = _predictors()
    with pytest.raises(ValueError, match="one bucket"):
        latency_stats(tpred, batch(tpred.cfg, 5), device_resident=True)


@pytest.mark.parametrize("shape,bucket", [
    ((3, 10), (4, 16)), ((4, 16), (4, 16)), ((1, 16), (8, 16)),
    ((2, 3, 32, 32), (4, 3, 32, 32))], ids=["short-rows", "exact", "one-row", "pixels"])
def test_pad_into_equals_np_pad(shape, bucket):
    """Staging into a captured bucket writes what ``np.pad`` with zeros
    gives, over a buffer that held another request."""
    rng = np.random.default_rng(0)
    x = rng.integers(1, 100, shape).astype(np.int32)
    buf = rng.integers(1, 100, bucket).astype(np.int32)   # stale contents
    pad_into(buf, x)
    np.testing.assert_array_equal(buf, np.pad(x, [(0, b - s) for s, b in zip(shape, bucket)]))


@pytest.mark.parametrize("shape", [(5, 16), (2, 17), (2, 3, 16, 32)])
def test_pad_into_refuses_what_does_not_fit(shape):
    buf = np.zeros((4, 16) if len(shape) == 2 else (4, 3, 32, 32), np.int32)
    with pytest.raises(ValueError, match="does not fit"):
        pad_into(buf, np.zeros(shape, np.int32))


def test_restore_model_reads_model_pth_only(tmp_path):
    """``restore_model`` gives the saved weights in eval mode, skips a
    saved optimizer state, and refuses an Orbax directory and a missing
    one."""
    path = tiny_checkpoint(tmp_path)
    torch.save({"optimizer": "unused"}, os.path.join(path, tckpt.TRAIN_STATE_FILE))
    cfg = tiny_test_config()
    model = tckpt.restore_model(path, cfg, device="cpu")
    assert not model.training
    want = from_jax_variables(cfg, tiny_tree()).state_dict()
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    orbax = tmp_path / "orbax"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="Orbax"):
        tckpt.restore_model(str(orbax), cfg, device="cpu")
    with pytest.raises(FileNotFoundError):
        tckpt.restore_model(str(tmp_path / "absent"), cfg, device="cpu")
