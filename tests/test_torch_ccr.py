"""The port's CCR contrastive loss (``alpha != 0``) against the JAX
package's, on the CPU, in fp32.

- ``ccr_contrastive_loss`` on normalised random views, and
  ``CrossModalAlignment``'s ``(rep, loss)`` from one Flax tree: within 1e-6.
  At ``alpha == 0``, or without projections, the loss is 0 and ``fc_1`` /
  ``fc_2`` do not exist, on both sides.
- The whole model at ``alpha=0.5`` (``tiny_test_config``): logits and every
  cross-modal alignment's discarded loss within 1e-4.
- One train step at ``alpha=0.5`` against JAX's (multi_transform AdamW,
  dropout off): the loss within 1e-4, and every leaf's gradient within 1e-4
  of the leaf's max |grad| (floored as in ``test_torch_train.py``). Nothing
  reads ``fc_1``/``fc_2``: their gradient is exactly 0 on both sides and
  AdamW only decays them, so those updated leaves agree within 1e-6, and
  moved.
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
    _flat,
    _jax_first_moment_grads,
    _one_torch_thread,
    _port_grads,
    _random_tree,
)

from d2r_tpu.models.unimo import D2RClassifier as JaxClassifier
from d2r_tpu.models.xmodules import CrossModalAlignment as JaxCMA
from d2r_tpu.ops.losses import ccr_contrastive_loss as jax_ccr
from d2r_tpu.ops.norms import torch_style_normalize as jax_normalize
from d2r_tpu.train import optimizer as joptim
from d2r_tpu.train.state import TrainState as JaxTrainState
from d2r_tpu.train.state import make_train_step as jax_make_train_step
from d2r_tpu_torch.models.xmodules import CrossModalAlignment
from d2r_tpu_torch.ops.losses import ccr_contrastive_loss
from d2r_tpu_torch.train.state import create_train_state, make_train_step
from d2r_tpu_torch.weights import from_jax_variables, load_jax_variables, to_jax_variables

ALPHA = 0.5
TOTAL_STEPS = 10


def _views(seed, b=3, length=7, d=16):
    rng = np.random.default_rng(seed)
    img = np.asarray(jax_normalize(jnp.asarray(rng.standard_normal((b, length, 2, d)),
                                               jnp.float32)))
    txt = np.asarray(jax_normalize(jnp.asarray(rng.standard_normal((b, length, 1, d)),
                                               jnp.float32)))
    return img, txt


@pytest.mark.parametrize("alpha,beta,margin", [(0.5, 0.0, 0.1), (1.0, 0.7, 0.2), (0.3, 2.0, 0.5)])
def test_ccr_contrastive_loss_matches_jax(alpha, beta, margin):
    img, txt = _views(int(10 * margin))
    ref = float(jax_ccr(jnp.asarray(img), jnp.asarray(txt), alpha=alpha, beta=beta, margin=margin))
    got = float(ccr_contrastive_loss(torch.tensor(img), torch.tensor(txt), alpha=alpha,
                                     beta=beta, margin=margin))
    assert ref > 0
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("alpha,projections", [(ALPHA, True), (ALPHA, False), (0.0, True)])
def test_cross_modal_alignment_rep_and_loss_match_jax(alpha, projections):
    d, rng = 32, np.random.default_rng(1)
    text = rng.standard_normal((2, 6, d)).astype(np.float32)
    image = rng.standard_normal((2, 5, d)).astype(np.float32)
    jmod = JaxCMA(d, alpha=alpha, margin=0.1, with_projections=projections)
    params = jmod.init(jax.random.key(0), jnp.asarray(text), jnp.asarray(image))["params"]
    # small query/key weights: the 100x-temperature softmax stays off near-ties
    params = jax.tree_util.tree_map(np.asarray, params)
    for name in ("query", "key"):
        params[name]["kernel"] = params[name]["kernel"] * np.float32(0.1)
    ref_rep, ref_loss = jmod.apply({"params": params}, jnp.asarray(text), jnp.asarray(image))

    cma = CrossModalAlignment(d, alpha=alpha, margin=0.1, with_projections=projections)
    load_jax_variables(cma, {"params": copy.deepcopy(params)})
    with torch.no_grad():
        rep, loss = cma(torch.from_numpy(text), torch.from_numpy(image))
    has_loss = alpha != 0.0 and projections
    assert ("fc_1" in params) == ("fc_2" in params) == has_loss == hasattr(cma, "fc_1")
    np.testing.assert_allclose(rep.detach().numpy(), np.asarray(ref_rep), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(loss), float(ref_loss), atol=1e-6, rtol=0)
    assert (float(ref_loss) > 0) == has_loss


@functools.lru_cache(maxsize=None)
def _tree():
    jcfg, _ = _configs(DR_step=3, alpha=ALPHA)
    return _random_tree(JaxClassifier(jcfg), _batch(jcfg), seed=5)


def test_model_at_alpha_matches_jax():
    """Logits, and the loss of every alignment that computes one (GLAC's and
    CRCMC's; CMRC's Refinement has none), which the cells discard."""
    jcfg, tcfg = _configs(DR_step=3, alpha=ALPHA)
    batch = _batch(jcfg)
    jmodel = JaxClassifier(jcfg)
    tree = _tree()

    @jax.jit
    def run(v, *args):
        return jmodel.apply(v, *args, deterministic=True, use_running_average=True,
                            valid=jnp.asarray(batch["valid"]), capture_intermediates=True,
                            mutable=["intermediates"])

    (_, ref_logits, _), inter = run(tree, *[jnp.asarray(batch[k]) for k in INPUTS[:5]])
    ref_losses = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(inter["intermediates"])[0]:
        keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        if keys[-4:] == ["cma", "__call__", "0", "1"]:      # (rep, loss)[1]
            ref_losses[".".join(keys[:-3])] = float(leaf)

    model = from_jax_variables(tcfg, copy.deepcopy(tree))
    losses = {}
    for name, m in model.named_modules():
        if isinstance(m, CrossModalAlignment):
            m.register_forward_hook(lambda _m, _a, out, name=name: losses.__setitem__(
                name, float(out[1])))
    with torch.no_grad():
        _, logits, _ = model(**{k: torch.as_tensor(batch[k]) for k in INPUTS})
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=1e-4, rtol=0)
    # 2 branches x 3 routing layers x (GLAC, CMRC's Refinement, CRCMC)
    assert set(losses) == set(ref_losses) and len(ref_losses) == 2 * 3 * 3
    for key, ref in ref_losses.items():
        assert (ref == 0.0) == key.endswith("refine.cma"), key
        np.testing.assert_allclose(losses[key], ref, atol=1e-4, rtol=0, err_msg=key)


@functools.lru_cache(maxsize=None)
def _train_step_runs():
    jcfg, tcfg = _configs(DR_step=3, alpha=ALPHA, lr=1e-3)
    batch = _batch(jcfg)
    tree = _tree()
    jmodel = JaxClassifier(jcfg)
    jstate = JaxTrainState.create(
        apply_fn=jmodel.apply, params=jax.tree_util.tree_map(jnp.asarray, tree["params"]),
        tx=joptim.make_optimizer(jcfg, TOTAL_STEPS),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, tree["batch_stats"]))
    jstate, jm = jax_make_train_step(jmodel)(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                             jax.random.key(1))
    state = create_train_state(tcfg, TOTAL_STEPS, device="cpu",
                               model=from_jax_variables(tcfg, copy.deepcopy(tree)))
    state, m = make_train_step()(state, batch, 1)
    jax_out = {"loss": float(jm["loss"]), "grads": _jax_first_moment_grads(jstate.opt_state),
               "params": _flat(jstate.params)}
    port_out = {"loss": float(m["loss"]), "grads": _port_grads(state.model),
                "params": _flat(to_jax_variables(state.model)["params"])}
    return _flat(tree["params"]), jax_out, port_out


def test_train_step_at_alpha_matches_jax():
    _, jax_out, port_out = _train_step_runs()
    np.testing.assert_allclose(port_out["loss"], jax_out["loss"], atol=1e-4, rtol=0)
    ref, got = jax_out["grads"], port_out["grads"]
    assert set(ref) == set(got)
    floor = 1e-4 * max(np.abs(g).max() for g in ref.values())
    for key, r in ref.items():
        tol = 1e-4 * max(np.abs(r).max(), floor)
        assert np.abs(got[key] - r).max() <= tol, (key, np.abs(got[key] - r).max(), tol)


def test_unread_projections_are_decayed_as_optax_decays_them():
    before, jax_out, port_out = _train_step_runs()
    keys = [k for k in before if "/cma/fc_" in k]
    assert len(keys) == 2 * 3 * 2 * 2 * 2      # branches, layers, cells, fc_1/2, kernel/bias
    for key in keys:
        assert not jax_out["grads"][key].any() and not port_out["grads"][key].any(), key
        np.testing.assert_allclose(port_out["params"][key], np.asarray(jax_out["params"][key]),
                                   atol=1e-6, rtol=0, err_msg=key)
        assert not np.array_equal(port_out["params"][key], before[key]), key
