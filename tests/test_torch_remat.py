"""Rematerialisation (``remat``, ``remat_ffn_act``) on the CPU, in fp32.

- Bit for bit against the step without it: ``remat``, ``remat_ffn_act`` and
  both, with dropout off and on (``tiny-bert``'s 0.1 rates, the same seed):
  the gradients after one forward and backward, both generators of the
  ``DropoutRNG`` where they end without remat, and the losses and
  parameters of two train steps.
- Against the JAX package: one train step of the scaled recipe's model
  knobs (``remat``, ``remat_ffn_act``, ``scan_layers``; dropout off), from
  ``test_torch_train.py``'s tree in the scanned layout (its values, so that
  only the knobs differ from that file's step test): the loss within 1e-4,
  and every leaf's gradient within 1e-4 of the leaf's max |grad| (floored
  as there), compared in the scanned layout.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import (  # noqa: F401  (the module fixture pins one torch thread)
    INPUTS,
    _batch,
    _configs,
    _jax_first_moment_grads,
    _one_torch_thread,
    _port_grads,
    _random_tree,
)

from d2r_tpu.models.unimo import D2RClassifier as JaxClassifier
from d2r_tpu.train import optimizer as joptim
from d2r_tpu.train.state import TrainState as JaxTrainState
from d2r_tpu.train.state import make_train_step as jax_make_train_step
from d2r_tpu.utils.weights import stack_tower_layers
from d2r_tpu_torch.config import tiny_test_config
from d2r_tpu_torch.models.layers import DropoutRNG
from d2r_tpu_torch.models.unimo import D2RClassifier
from d2r_tpu_torch.train.state import create_train_state, make_train_step
from d2r_tpu_torch.weights import from_jax_variables, load_jax_variables, to_jax_variables

KNOBS = [dict(remat=True), dict(remat_ffn_act=True), dict(remat=True, remat_ffn_act=True)]
DROPOUT = {"off": "tiny-bert-dropout-0", "on": "tiny-bert"}
TOTAL_STEPS = 10


@functools.lru_cache(maxsize=None)
def _tree():
    jcfg, _ = _configs(DR_step=3)
    return _random_tree(JaxClassifier(jcfg), _batch(jcfg), seed=7)


def _model(**cfg):
    return load_jax_variables(D2RClassifier(tiny_test_config(DR_step=3, **cfg)),
                              copy.deepcopy(_tree()))


def _backward(model, batch, seed=3):
    """Gradients and both generators' states after one train-mode forward
    and backward with an explicit DropoutRNG."""
    model.train().zero_grad(set_to_none=True)
    rng = DropoutRNG(seed, "cpu")
    loss, _, _ = model(**{k: torch.as_tensor(batch[k]) for k in INPUTS}, rng=rng)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return float(loss.detach()), grads, (rng.host.get_state(), rng.device.get_state())


@pytest.mark.parametrize("dropout", sorted(DROPOUT))
@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: "+".join(k))
def test_remat_backward_is_bit_equal_and_leaves_the_generators_alike(knobs, dropout):
    batch = _batch(tiny_test_config())
    ref_loss, ref_grads, ref_gens = _backward(_model(bert_name=DROPOUT[dropout]), batch)
    loss, grads, gens = _backward(_model(bert_name=DROPOUT[dropout], **knobs), batch)
    assert loss == ref_loss
    for name, g in ref_grads.items():
        assert torch.equal(grads[name], g), name
    assert all(torch.equal(a, b) for a, b in zip(gens, ref_gens))


@pytest.mark.parametrize("dropout", sorted(DROPOUT))
@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: "+".join(k))
def test_remat_train_steps_are_bit_equal(knobs, dropout):
    batches = [_batch(tiny_test_config(), seed=s) for s in (0, 1)]

    def run(**cfg):
        cfg = tiny_test_config(DR_step=3, bert_name=DROPOUT[dropout], lr=1e-3, **cfg)
        state = create_train_state(cfg, TOTAL_STEPS, device="cpu",
                                   model=load_jax_variables(D2RClassifier(cfg),
                                                            copy.deepcopy(_tree())))
        step = make_train_step()
        losses = [float(step(state, b, 5)[1]["loss"]) for b in batches]
        return losses, dict(state.model.named_parameters())

    ref_losses, ref_params = run()
    losses, params = run(**knobs)
    assert losses == ref_losses
    for name, p in ref_params.items():
        assert torch.equal(params[name], p), name


def test_remat_is_a_plain_call_without_autograd():
    """Eval forwards (the serving path) build no checkpoint: same logits,
    no grad graph."""
    batch = _batch(tiny_test_config())
    inputs = {k: torch.as_tensor(batch[k]) for k in INPUTS}
    with torch.no_grad():
        ref = _model().eval()(**inputs)[1]
        got = _model(remat=True, remat_ffn_act=True).eval()(**inputs)[1]
    assert torch.equal(got, ref) and got.grad_fn is None


SCALED_KNOBS = dict(remat=True, remat_ffn_act=True, scan_layers=True)


def _scanned_tree():
    """``test_torch_train.train_runs``'s tree, stacked into the scanned
    layout."""
    jcfg, _ = _configs(DR_step=3)
    tree = _random_tree(JaxClassifier(jcfg), _batch(jcfg))
    return {c: stack_tower_layers(t) for c, t in tree.items()}


@functools.lru_cache(maxsize=None)
def _scaled_step_runs():
    jcfg, tcfg = _configs(DR_step=3, **SCALED_KNOBS)
    batch = _batch(jcfg)
    jmodel = JaxClassifier(jcfg)
    tree = _scanned_tree()
    jstate = JaxTrainState.create(
        apply_fn=jmodel.apply, params=jax.tree_util.tree_map(jnp.asarray, tree["params"]),
        tx=joptim.make_optimizer(jcfg, TOTAL_STEPS),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, tree["batch_stats"]))
    jstate, jm = jax_make_train_step(jmodel)(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                             jax.random.key(1))
    state = create_train_state(tcfg, TOTAL_STEPS, device="cpu",
                               model=from_jax_variables(tcfg, copy.deepcopy(tree)))
    state, m = make_train_step()(state, batch, 1)
    return ((float(jm["loss"]), _jax_first_moment_grads(jstate.opt_state)),
            (float(m["loss"]), _port_grads(state.model)))


def test_scaled_recipe_knobs_train_step_matches_jax():
    (ref_loss, ref), (loss, got) = _scaled_step_runs()
    np.testing.assert_allclose(loss, ref_loss, atol=1e-4, rtol=0)
    assert set(ref) == set(got) and any("layers_scanned" in k for k in ref)
    floor = 1e-4 * max(np.abs(g).max() for g in ref.values())
    for key, r in ref.items():
        tol = 1e-4 * max(np.abs(r).max(), floor)
        assert np.abs(got[key] - r).max() <= tol, (key, np.abs(got[key] - r).max(), tol)


def test_scanned_tree_round_trips():
    """``to_jax_variables`` writes back the scanned tree it was loaded from."""
    _, tcfg = _configs(DR_step=3, **SCALED_KNOBS)
    tree = _scanned_tree()
    assert "layers_scanned" in tree["params"]["model"]["encoder_vision_layers"]
    back = to_jax_variables(from_jax_variables(tcfg, copy.deepcopy(tree)))
    ref = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(ref) == len(got)
    for path, leaf in ref:
        assert np.array_equal(got[path], leaf), path
