"""A mesh train step against the port's one-process step on the global
batch, and checkpoints across meshes, on the CPU over gloo.

From one model (the seed's, with the two ill-conditioned spots moved off,
``test_torch_parallel_ranks.conditioned_model``) and one global batch of 8
rows, wrap-padded so that the second data rank alone holds padding: a step
under dp = 2 and under (2, 2) lands within rtol 2e-4 / atol 2e-6 of the
one-process step on every parameter and buffer (the tolerance of the JAX
package's ``tests/test_tp_semantics.py:137-141``), its losses within rtol
2e-4; every rank's tensors are bit-equal to data index 0's in its model
column, and, under (2, 2), the tensors that the model axis leaves whole are
bit-equal across the model ranks. Each of accumulation over two
microbatches, a dispatch of two steps, ``remat``, the SenticNet graph, CCR
(``alpha`` 0.5, whose unread ``fc_1``/``fc_2`` get no gradient),
``quant_train="int8_all"`` (data axis only) and dropout on (tiny-bert's
0.1) under ``prng_impl`` rbg and threefry2x32 and with accumulation is a
case of its own: the masks are keyed on global coordinates, so the mesh
draws one process's.

Checkpoints: a (2, 2) step saved with ``save_checkpoint`` (rank 0 writes
the whole tensors) holds one process's keys and shapes; it restores into a
fresh (2, 2) state and into one process exactly, Adam moments and step
included; and one process's checkpoint restores into a (2, 2) state
exactly.
"""

import functools

import numpy as np
import pytest
import torch

import test_torch_parallel_ranks as ranks
from d2r_tpu_torch.parallel.launch import spawn
from d2r_tpu_torch.train import checkpoint as ckpt
from d2r_tpu_torch.train.state import create_train_state

MESHES = {(2,): list(ranks.STEP_VARIANTS),
          (2, 2): [v for v in ranks.STEP_VARIANTS if v != "int8_all"]}
CASES = [(shape, v) for shape, variants in MESHES.items() for v in variants]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def one_process(variant):
    return ranks.run_step(variant)[:2]


@functools.lru_cache(maxsize=None)
def mesh_steps(shape):
    return spawn(ranks.step_rank, int(np.prod(shape)), (shape, MESHES[shape]))


@pytest.mark.parametrize("shape,variant", CASES,
                         ids=[f"{'x'.join(map(str, s))}-{v}" for s, v in CASES])
def test_mesh_step_matches_one_process(shape, variant):
    want_losses, want = one_process(variant)
    runs = mesh_steps(shape)
    losses, got, _ = runs[0][variant]
    for r in runs:
        assert r[variant][0] == losses          # the global losses, on every rank
        # whole tensors equal across model ranks; every tensor across data ranks
        assert r[variant][2] == {"model": [], "data": []}
    np.testing.assert_allclose(losses, want_losses, rtol=ranks.STEP_RTOL)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=ranks.STEP_RTOL,
                                   atol=ranks.STEP_ATOL, err_msg=k)


def test_whole_tensor_gradients_agree_across_model_ranks_to_the_bit():
    """An ulp of difference in one whole tensor's gradient between the
    model ranks (what a scatter-add's order gave on the card) is gone after
    the mesh's reduction, so the replicas' updates stay equal."""
    assert spawn(ranks.drift_rank, 2, ((1, 2),)) == [([], False), ([], True)]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(directory, one process's checkpoint ``one``, the (2, 2) ranks'
    results): the (2, 2) ranks save ``mesh`` and restore both."""
    directory = str(tmp_path_factory.mktemp("ckpt"))
    _, _, state = ranks.run_step("plain")
    ckpt.save_checkpoint(f"{directory}/one", state, include_opt_state=True)
    return directory, spawn(ranks.checkpoint_rank, 4, ((2, 2), directory))[0]


def _files(directory, name):
    model = torch.load(f"{directory}/{name}/{ckpt.MODEL_FILE}", weights_only=True)
    train = torch.load(f"{directory}/{name}/{ckpt.TRAIN_STATE_FILE}", weights_only=True)
    return model, train


def _equal(a, b):
    assert a.keys() == b.keys()
    return all(torch.equal(a[k], b[k]) for k in a)


def _equal_moments(a, b):
    return a["state"].keys() == b["state"].keys() and all(
        torch.equal(a["state"][i][k], b["state"][i][k])
        for i in a["state"] for k in ("exp_avg", "exp_avg_sq"))


def test_mesh_checkpoint_holds_one_process_keys_and_shapes(saved):
    directory, _ = saved
    (mesh, mesh_train), (one, one_train) = _files(directory, "mesh"), _files(directory, "one")
    assert {k: (v.shape, v.dtype) for k, v in mesh.items()} == {
        k: (v.shape, v.dtype) for k, v in one.items()}
    for k, v in one.items():
        np.testing.assert_allclose(mesh[k].numpy(), v.numpy(), rtol=ranks.STEP_RTOL,
                                   atol=ranks.STEP_ATOL, err_msg=k)
    assert mesh_train["step"] == one_train["step"] == 1
    shapes = lambda train: {i: {k: t.shape for k, t in st.items()}
                            for i, st in train["optimizer"]["state"].items()}
    assert shapes(mesh_train) == shapes(one_train)


@pytest.mark.parametrize("name", ["mesh", "one"])
def test_checkpoint_restores_into_a_mesh_exactly(saved, name):
    """A (2, 2) state restored from the (2, 2) checkpoint or from one
    process's gathers back to the file's tensors bit for bit."""
    directory, restored = saved
    model, train = _files(directory, name)
    got_model, got_opt, step = restored[name]
    assert _equal(got_model, model)
    assert _equal_moments(got_opt, train["optimizer"])
    assert step == train["step"]


def test_mesh_checkpoint_restores_into_one_process_exactly(saved):
    directory, _ = saved
    model, train = _files(directory, "mesh")
    state = create_train_state(ranks.step_config("plain"), total_steps=10, device="cpu", seed=1)
    ckpt.restore_checkpoint(f"{directory}/mesh", state)
    assert _equal(state.model.state_dict(), model)
    assert _equal_moments(state.optimizer.state_dict(), train["optimizer"])
    assert state.step == train["step"]
