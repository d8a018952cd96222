"""The port's training slice against the JAX package's, on the CPU, in fp32.

One random Flax variable tree (numpy, seeded, shapes from ``eval_shape``) is
loaded into both packages at ``tiny_test_config`` with a dropout-0 text
preset registered on both sides under one name (dropout bits cannot match
across frameworks). The batch is ``synthetic_batch``'s, PAD ids included,
with one ``valid=False`` row.

- The train step against JAX's ``make_train_step`` with
  ``optimizer_impl="multi_transform"``: the step-1 loss and, per leaf, the
  step-1 gradient within 1e-4 of the leaf's max |grad| (JAX's gradient is
  read back from its first Adam moment, ``mu = 0.1 g``); the losses of 3
  steps within 1e-4; the BatchNorm running statistics after one step within
  1e-5.
- The optimizer alone: the same numpy gradients for 5 steps through JAX's
  ``make_optimizer(cfg, total_steps)`` (multi_transform) and the port's,
  with and without ``freeze_towers``: parameters within 1e-6.
- The PAD word-embedding row's gradient is exactly 0; ``to_jax_variables``
  inverts ``from_jax_variables`` exactly; ``make_accum_step`` equals the mean
  of separate gradient computations; train-mode BatchNorm with
  ``row_valid`` matches JAX's.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from d2r_tpu import config as jconfig
from d2r_tpu.data.dataset import synthetic_batch
from d2r_tpu.models import layers as jlayers
from d2r_tpu.models.unimo import D2RClassifier as JaxClassifier
from d2r_tpu.train import optimizer as joptim
from d2r_tpu.train.state import TrainState as JaxTrainState
from d2r_tpu.train.state import make_train_step as jax_make_train_step
from d2r_tpu_torch import config as tconfig
from d2r_tpu_torch.models import layers as tlayers
from d2r_tpu_torch.ops.kernels import adamw as tadamw
from d2r_tpu_torch.train import checkpoint as tckpt
from d2r_tpu_torch.train import optimizer as toptim
from d2r_tpu_torch.train.state import (
    create_train_state,
    make_accum_step,
    make_eval_step,
    make_multi_step,
    make_train_step,
)
from d2r_tpu_torch.weights import (
    flax_path,
    from_jax_variables,
    load_jax_variables,
    to_jax_variables,
)

NODROP = "tiny-bert-dropout-0"
INPUTS = ("input_ids", "attention_mask", "token_type_ids", "labels", "pixel_values",
          "valid")
TOTAL_STEPS = 10
STEPS = 3


def _nodrop(pkg):
    tc = pkg.tiny_test_config().text_config()
    return dataclasses.replace(tc, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


jconfig.register_text_preset(NODROP, lambda: _nodrop(jconfig))
tconfig.register_text_preset(NODROP, lambda: _nodrop(tconfig))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the tiny model's ops are too small to share, and
    beside the suite's other workers more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(**kw):
    kw = {"bert_name": NODROP, "optimizer_impl": "multi_transform", "warmup_ratio": 0.0, **kw}
    return jconfig.tiny_test_config(**kw), tconfig.tiny_test_config(**kw)


def _batch(cfg, n=4, seed=0):
    b = synthetic_batch(n, cfg.max_seq, cfg.vision_config().image_size,
                        vocab_size=cfg.text_config().vocab_size, seed=seed)
    b["valid"] = np.arange(n) < n - 1          # one wrap-padded row
    return {k: b[k] for k in INPUTS}


def _random_tree(model, batch, seed=0):
    """A Flax variable tree of ``model``, numpy: kernels at half the fan-in
    scale (the 100x-temperature cross-modal softmaxes stay off near-ties),
    LayerNorm scales near 1, positive BN variances, small biases, and BLOCK
    fusion's merge biases in [1, ~1.3]. The last keeps the fused products z
    away from 0, where the signed square root's derivative 1/(2 sqrt|z|) is
    unbounded: with biases around 0 a few z fall close to 0 next to their
    terms' size, and the two packages' fp32 rounding of those z, amplified
    there, moves every gradient upstream of the fusion by about the 1e-4
    of its max that the gradient test allows."""
    shapes = jax.eval_shape(model.init, jax.random.key(0),
                            *[jnp.asarray(batch[k]) for k in INPUTS[:5]])
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = str(getattr(path[-1], "key", path[-1]))
        n = rng.standard_normal(s.shape).astype(np.float32)
        if leaf == "kernel" or leaf.startswith("merge_kernel"):
            fan_in = (np.prod(s.shape[:3]) if len(s.shape) == 4
                      else s.shape[1 if leaf.startswith("merge") else 0])
            return 0.5 * n / np.sqrt(fan_in)
        if leaf == "scale":
            return 1.0 + 0.1 * n
        if leaf == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if leaf == "class_embedding":
            return n
        return 0.1 * n

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    tree = {c: jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree[c])
            for c in ("params", "batch_stats")}
    fusion = tree["params"]["model"]["block_fusion"]
    for name in ("merge_bias0", "merge_bias1"):
        fusion[name] = np.abs(fusion[name]) + np.float32(1.0)
    return tree


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_grads(model):
    """The port's ``.grad`` of every parameter as a Flax tree."""
    g = copy.deepcopy(model)
    with torch.no_grad():
        for (_, p), (_, q) in zip(model.named_parameters(), g.named_parameters()):
            q.copy_(p.grad)
    return _flat(to_jax_variables(g)["params"])


def _jax_first_moment_grads(opt_state):
    """Step-1 gradients from the multi_transform AdamW state: after one
    update from zero moments, mu = (1 - 0.9) g."""
    grads = {}
    for label, masked in opt_state.inner_states.items():
        adam = [s for s in jax.tree_util.tree_leaves(
            masked, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)]
        grads.update({k: v / np.float32(0.1) for k, v in _flat(adam[0].mu).items()})
    return grads


@functools.lru_cache(maxsize=None)
def train_runs(**flags):
    """JAX and port: 3 train steps from one tree, with the configs' ``flags``.
    Returns per-package dicts of step losses, step-1 grads and step-1 batch
    stats, and the port's eval logits after the steps."""
    jcfg, tcfg = _configs(DR_step=3, **flags)
    batch = _batch(jcfg)
    jmodel = JaxClassifier(jcfg)
    tree = _random_tree(jmodel, batch)

    jstate = JaxTrainState.create(
        apply_fn=jmodel.apply, params=jax.tree_util.tree_map(jnp.asarray, tree["params"]),
        tx=joptim.make_optimizer(jcfg, TOTAL_STEPS),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, tree["batch_stats"]))
    jstep = jax_make_train_step(jmodel)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jax_out = {"losses": []}
    for i in range(STEPS):
        jstate, m = jstep(jstate, jbatch, jax.random.key(1))
        jax_out["losses"].append(float(m["loss"]))
        if i == 0:
            jax_out["grads"] = _jax_first_moment_grads(jstate.opt_state)
            jax_out["batch_stats"] = _flat(jstate.batch_stats)

    state = create_train_state(tcfg, TOTAL_STEPS, device="cpu",
                               model=from_jax_variables(tcfg, copy.deepcopy(tree)))
    step = make_train_step()
    port_out = {"losses": []}
    for i in range(STEPS):
        state, m = step(state, batch, 1)
        port_out["losses"].append(float(m["loss"]))
        if i == 0:
            port_out["grads"] = _port_grads(state.model)
            port_out["batch_stats"] = _flat(to_jax_variables(state.model)["batch_stats"])
    port_out["logits"] = make_eval_step()(state, batch)["logits"]
    return jax_out, port_out


# the JAX package's layout settings, which it reads as no-ops without a
# model axis or pipeline stages (d2r_tpu/parallel/mesh.py:200-205,228-236,
# d2r_tpu/models/bert.py:225-239)
LAYOUT = dict(seq_shard=True, fabric_shard=True, pipeline_microbatches=2)


def test_layout_flags_change_nothing_in_one_process():
    """The port accepts the layout settings in one process: its losses and
    logits equal those without them, and JAX's run with the same settings
    gives the same losses as the port within the step test's tolerance."""
    _, plain = train_runs()
    jax_flags, port_flags = train_runs(**LAYOUT)
    assert port_flags["losses"] == plain["losses"]
    assert torch.equal(port_flags["logits"], plain["logits"])
    np.testing.assert_allclose(port_flags["losses"], jax_flags["losses"], atol=1e-4, rtol=0)


GRAD_MODULES = ["fc"] + [f"model/{m}" for m in (
    "text_embeddings", "encoder_text_layers", "self_text", "text_cls_pool",
    "vision_embeddings", "vision_pre_layernorm", "encoder_vision_layers", "self_vision",
    "vision_cls_pool", "itr_module", "Reversed_itr_module", "text_pool", "vision_pool",
    "block_fusion")]


@pytest.mark.parametrize("module", GRAD_MODULES)
def test_step1_gradients_match_jax(module):
    """Every leaf under ``module`` within 1e-4 of its max |grad|. A leaf
    whose gradient is zero in exact arithmetic (a bias ahead of a
    shift-invariant softmax or BatchNorm) holds rounding noise only; its
    scale is floored at 1e-4 of the model's largest gradient."""
    jax_out, port_out = train_runs()
    floor = 1e-4 * max(np.abs(g).max() for g in jax_out["grads"].values())
    keys = [k for k in jax_out["grads"] if k == module or k.startswith(module + "/")]
    assert keys and set(keys) <= set(port_out["grads"]), module
    for key in keys:
        ref, got = jax_out["grads"][key], port_out["grads"][key]
        tol = 1e-4 * max(np.abs(ref).max(), floor)
        assert np.abs(got - ref).max() <= tol, (key, np.abs(got - ref).max(), tol)


def test_every_parameter_gets_a_gradient_from_both():
    jax_out, port_out = train_runs()
    assert set(jax_out["grads"]) == set(port_out["grads"])


def test_losses_of_three_steps_match_jax():
    jax_out, port_out = train_runs()
    np.testing.assert_allclose(port_out["losses"], jax_out["losses"], atol=1e-4, rtol=0)
    assert port_out["losses"][2] != port_out["losses"][0]     # the update moved it


def test_batch_stats_after_one_step_match_jax():
    """Step 1 runs with one valid=False row: the running statistics count
    only the valid rows."""
    jax_out, port_out = train_runs()
    assert set(jax_out["batch_stats"]) == set(port_out["batch_stats"])
    for key, ref in jax_out["batch_stats"].items():
        np.testing.assert_allclose(port_out["batch_stats"][key], ref, atol=1e-5, rtol=0,
                                   err_msg=key)


# ---- optimizer alone ------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _opt_tree():
    jcfg, _ = _configs(DR_step=3)
    return _random_tree(JaxClassifier(jcfg), _batch(jcfg), seed=3)


@pytest.mark.parametrize("freeze,impl", [
    pytest.param(False, "multi_transform", id="False"),
    pytest.param(True, "multi_transform", id="True"),
    *(pytest.param(f, i, id=f"{f}-{i}") for i in ("grouped", "fused", "fused_leaf")
      for f in (False, True))])
def test_optimizer_matches_jax_multi_transform(freeze, impl):
    """Five steps of the same numpy gradients through the JAX package's
    ``impl`` and the port's AdamW (the kernel's plain twin, with the count
    and the schedule as device scalars); lr 1e-3 and warmup_ratio 0.2 (the
    first step at lr 0, a fractional warmup of 1.0 step over 5). ``fused``
    with ``freeze_towers`` raises the same ``ValueError`` in both."""
    jcfg, tcfg = _configs(DR_step=3, lr=1e-3, warmup_ratio=0.2, freeze_towers=freeze,
                          optimizer_impl=impl)
    total = 5
    tree = copy.deepcopy(_opt_tree())
    jparams = jax.tree_util.tree_map(jnp.asarray, tree["params"])
    model = from_jax_variables(tcfg, copy.deepcopy(tree)).train()
    template = None if impl == "multi_transform" else jparams
    if freeze and impl == "fused":
        with pytest.raises(ValueError, match="freeze_towers is incompatible"):
            joptim.make_optimizer(jcfg, total, template)
        with pytest.raises(ValueError, match="freeze_towers is incompatible"):
            toptim.make_optimizer(tcfg, total, model)
        return
    tx = joptim.make_optimizer(jcfg, total, template)
    opt_state = tx.init(jparams)

    optimizer = toptim.make_optimizer(tcfg, total, model)
    gmodel = copy.deepcopy(model)
    rng = np.random.default_rng(11)
    fc_sched = joptim.linear_warmup_decay(jcfg.fc_lr, jcfg.warmup_ratio * total, total)
    for step in range(total):
        grads = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32), tree["params"])
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)

        load_jax_variables(gmodel, {"params": grads, "batch_stats": tree["batch_stats"]})
        for (_, p), (_, g) in zip(model.named_parameters(), gmodel.named_parameters()):
            p.grad = g.detach().clone()
        np.testing.assert_allclose(float(optimizer.lrs()["fc"]), float(fc_sched(step)),
                                   rtol=1e-6)
        optimizer.step()

    ref = _flat(jparams)
    got = _flat(to_jax_variables(model)["params"])
    frozen = 0
    for key, r in ref.items():
        np.testing.assert_allclose(got[key], r, atol=1e-6, rtol=0, err_msg=key)
        if freeze and not toptim.is_trainable(key):
            frozen += 1
            np.testing.assert_array_equal(got[key], _flat(tree["params"])[key])
    assert (frozen > 0) == freeze


def test_optimizer_state_of_torch_adamw_loads():
    """A ``train_state.pth`` of the port before its own AdamW holds
    ``torch.optim.AdamW``'s state dict (the same per-parameter keys, no
    ``mu_dtype``): it loads, with fp32 moments, and steps."""
    cfg = tconfig.tiny_test_config(DR_step=3)
    state = create_train_state(cfg, TOTAL_STEPS, device="cpu", seed=0)
    old = torch.optim.AdamW([{k: v for k, v in g.items() if k != "mu_dtype"}
                             for g in state.optimizer.param_groups])
    for p in state.model.parameters():
        p.grad = torch.ones_like(p)
    old.step()
    state.optimizer.load_state_dict(old.state_dict())
    assert {g["mu_dtype"] for g in state.optimizer.param_groups} == {"float32"}
    state.optimizer.step()
    assert all(float(s["step"]) == 2 for s in state.optimizer.state.values())


@pytest.mark.parametrize("warmup,total", [(0.0, 10), (1.5, 10), (0.3, 4), (20.0, 10)])
def test_schedule_matches_jax(warmup, total):
    """The optimizer's schedule, in fp32 on the device (the AdamW kernel's,
    through its plain twin), equals JAX's ``jnp`` schedule bit for bit, at
    fractional warmups too."""
    ref = joptim.linear_warmup_decay(5e-2, warmup, total)
    sch = tadamw.schedule(warmup, total)
    for step in range(total + 2):
        factor = tadamw.schedule_plain(torch.tensor(float(step)), sch)
        device_lr = torch.tensor(np.float32(5e-2)) * factor
        assert device_lr.dtype == torch.float32
        assert device_lr.numpy().tobytes() == np.asarray(ref(step), np.float32).tobytes(), step


def test_group_labels_and_tower_mask_match_jax():
    jcfg, tcfg = _configs(DR_step=3)
    tree = _opt_tree()
    jlabels = {k: str(v) for k, v in _flat(joptim._label_tree(tree["params"])).items()}
    jmask = _flat(joptim.trainable_mask(tree["params"]))
    model = from_jax_variables(tcfg, copy.deepcopy(tree))
    mask = toptim.trainable_mask(model)
    for name, _ in model.named_parameters():
        path = flax_path(model, name)
        assert toptim.param_group_label(path) == jlabels[path], path
        assert mask[name] == bool(jmask[path]), path
    assert set(jlabels.values()) == set(toptim.GROUPS)


# ---- the rest of the slice -------------------------------------------------

def test_pad_row_gradient_is_exactly_zero():
    """As tests/test_pad_embedding_grad.py: PAD (id 0) at the tail of every
    row and once mid-sequence; its embedding row gets no gradient."""
    _, tcfg = _configs(DR_step=3)
    batch = _batch(tcfg, seed=3)
    batch["input_ids"][:, -4:] = 0
    batch["input_ids"][0, 2] = 0
    batch["attention_mask"][:, -4:] = 0
    state = create_train_state(tcfg, TOTAL_STEPS, device="cpu", seed=0)
    state, _ = make_train_step()(state, batch, 0)
    emb = state.model.model.text_embeddings.word_embeddings.weight.grad
    assert torch.equal(emb[0], torch.zeros_like(emb[0]))
    used = np.unique(batch["input_ids"][batch["input_ids"] != 0])
    assert any(emb[int(t)].abs().max() > 0 for t in used)


@pytest.mark.parametrize("dr_step", [3, 4])
def test_to_jax_variables_inverts_from_jax_variables(dr_step):
    jcfg, tcfg = _configs(DR_step=dr_step)
    tree = _random_tree(JaxClassifier(jcfg), _batch(jcfg), seed=dr_step)
    back = to_jax_variables(from_jax_variables(tcfg, copy.deepcopy(tree)))
    ref, got = _flat(tree), _flat(back)
    assert set(ref) == set(got)
    for key in ref:
        assert got[key].shape == ref[key].shape and np.array_equal(got[key], ref[key]), key


def test_to_jax_variables_refuses_a_tensor_with_no_leaf():
    _, tcfg = _configs(DR_step=3)
    model = from_jax_variables(tcfg, copy.deepcopy(_opt_tree()))
    model.fc.register_buffer("stray", torch.zeros(2))
    with pytest.raises(KeyError, match="fc.stray"):
        to_jax_variables(model)


def test_accum_step_equals_mean_of_gradients():
    """K = 2 microbatches: one optimizer step from the mean of two separate
    gradient computations, BatchNorm statistics carried from the first to
    the second, equals ``make_accum_step``."""
    _, tcfg = _configs(DR_step=3, lr=1e-3)
    batches = [_batch(tcfg, seed=s) for s in (0, 1)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in INPUTS}
    model = from_jax_variables(tcfg, copy.deepcopy(_opt_tree()))
    a = create_train_state(tcfg, TOTAL_STEPS, device="cpu", model=copy.deepcopy(model))
    b = create_train_state(tcfg, TOTAL_STEPS, device="cpu", model=copy.deepcopy(model))

    params = list(a.model.parameters())
    mean, losses = [torch.zeros_like(p) for p in params], []
    for batch in batches:
        inputs = {k: torch.as_tensor(v) for k, v in batch.items()}
        loss, _, _ = a.model(**inputs)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        mean = [m + (0 if g is None else g) / 2 for m, g in zip(mean, grads)]
        losses.append(float(loss.detach()))
    for p, m in zip(params, mean):
        p.grad = m
    a.optimizer.step()

    b, metrics = make_accum_step(2)(b, stacked, 0)
    assert b.step == 1
    np.testing.assert_allclose(float(metrics["loss"]), np.mean(losses), rtol=1e-6)
    for (n, p), q in zip(b.model.named_parameters(), a.model.parameters()):
        torch.testing.assert_close(p, q, atol=1e-6, rtol=1e-5, msg=n)
    for (n, x), y in zip(b.model.named_buffers(), a.model.buffers()):
        torch.testing.assert_close(x, y, atol=1e-6, rtol=1e-5, msg=n)


def test_multi_and_eval_steps():
    _, tcfg = _configs(DR_step=3)
    batches = [_batch(tcfg, seed=s) for s in (0, 1, 2)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in INPUTS}
    model = from_jax_variables(tcfg, copy.deepcopy(_opt_tree()))
    a = create_train_state(tcfg, TOTAL_STEPS, device="cpu", model=copy.deepcopy(model))
    b = create_train_state(tcfg, TOTAL_STEPS, device="cpu", model=copy.deepcopy(model))
    a, m = make_multi_step(3)(a, stacked, 5)
    single = make_train_step()
    losses = [float(single(b, batch, 5)[1]["loss"]) for batch in batches]
    assert a.step == b.step == 3
    np.testing.assert_array_equal(m["losses"].numpy(), np.float32(losses))
    assert float(m["loss"]) == losses[-1]
    ev = make_eval_step()(a, batches[0])
    assert not a.model.training and ev["logits"].shape == (4, 3)
    assert torch.isfinite(ev["loss"])


def test_dropout_draws_from_the_step_generator_only():
    """With the bert-base dropout rates: two steps from the same state and
    seed agree bitwise whatever the global RNG does (every mask comes from
    the step's seed buffer), and another seed differs."""
    cfg = tconfig.tiny_test_config(DR_step=3)
    batch = _batch(cfg)

    def run(seed):
        torch.manual_seed(seed * 7 + 1)
        state = create_train_state(cfg, TOTAL_STEPS, device="cpu", seed=0)
        return float(make_train_step()(state, batch, seed)[1]["loss"])

    assert run(3) == run(3)
    assert run(3) != run(4)


def test_batch_norm_train_mode_matches_jax():
    x = np.random.default_rng(0).standard_normal((5, 7, 1)).astype(np.float32) * 2 + 0.3
    valid = np.array([1, 1, 0, 1, 0], bool)
    v = {"params": {"scale": np.array([1.3], np.float32), "bias": np.array([-0.2], np.float32)},
         "batch_stats": {"mean": np.array([0.4], np.float32), "var": np.array([2.5], np.float32)}}
    for row_valid in (None, valid):
        ref, mutated = jlayers.TorchBatchNorm(1).apply(
            v, jnp.asarray(x), use_running_average=False,
            row_valid=None if row_valid is None else jnp.asarray(row_valid),
            mutable=["batch_stats"])
        bn = tlayers.TorchBatchNorm(1)
        load_jax_variables(bn, v).train()
        out = bn(torch.from_numpy(x), None if row_valid is None else torch.from_numpy(row_valid))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-6)
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(mutated["batch_stats"]["mean"]), atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(mutated["batch_stats"]["var"]), atol=1e-6)


@pytest.mark.parametrize("knob", [dict(remat=True), dict(remat_ffn_act=True),
                                  dict(scan_layers=True), dict(adam_mu_dtype="bfloat16"),
                                  dict(optimizer_impl="sgd")])
def test_unsupported_training_knobs_raise(knob):
    """An optimizer the JAX package does not have still raises; the scaled
    recipe's knobs, refused until the port had them, are accepted and a
    train step runs with each."""
    cfg = tconfig.tiny_test_config(**knob)
    if "optimizer_impl" in knob:
        with pytest.raises(NotImplementedError, match=list(knob)[0]):
            cfg.check_supported()
        return
    cfg.check_supported()
    state = create_train_state(cfg, TOTAL_STEPS, device="cpu", seed=0)
    state, metrics = make_train_step()(state, _batch(cfg), 0)
    assert torch.isfinite(metrics["loss"])
    mu = {s["exp_avg"].dtype for s in state.optimizer.state.values()}
    assert mu == {torch.bfloat16 if "adam_mu_dtype" in knob else torch.float32}


def _bf16_ulp(x):
    """One bf16 ulp at each element of ``x`` (8 significant bits)."""
    x = np.abs(np.asarray(x, np.float32))
    return np.where(x > 0, np.exp2(np.floor(np.log2(np.where(x > 0, x, 1))) - 7), 0)


def test_bf16_first_moments_match_optax_grouped():
    """``adam_mu_dtype="bfloat16"`` on the grouped path: five steps of the
    same numpy gradients through optax's ``scale_by_adam(mu_dtype=bf16)``
    chain and the port's AdamW. mu stays bf16 and within one bf16 ulp of
    optax's; nu and the parameters within 1e-6."""
    jcfg, tcfg = _configs(DR_step=3, lr=1e-3, warmup_ratio=0.2, optimizer_impl="grouped",
                          adam_mu_dtype="bfloat16")
    total = 5
    tree = copy.deepcopy(_opt_tree())
    jparams = jax.tree_util.tree_map(jnp.asarray, tree["params"])
    tx = joptim.make_optimizer(jcfg, total, jparams)
    opt_state = tx.init(jparams)

    model = from_jax_variables(tcfg, copy.deepcopy(tree)).train()
    optimizer = toptim.make_optimizer(tcfg, total, model)
    gmodel = copy.deepcopy(model)
    rng = np.random.default_rng(12)
    for _ in range(total):
        grads = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32), tree["params"])
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        load_jax_variables(gmodel, {"params": grads, "batch_stats": tree["batch_stats"]})
        for (_, p), (_, g) in zip(model.named_parameters(), gmodel.named_parameters()):
            p.grad = g.detach().clone()
        optimizer.step()

    adam = opt_state[0]
    assert {x.dtype for x in jax.tree_util.tree_leaves(adam.mu)} == {jnp.dtype(jnp.bfloat16)}
    moments = {}
    for key in ("exp_avg", "exp_avg_sq"):
        m = copy.deepcopy(gmodel)
        with torch.no_grad():
            for p, q in zip(model.parameters(), m.parameters()):
                q.copy_(optimizer.state[p][key].float())
        moments[key] = _flat(to_jax_variables(m)["params"])
    assert {s["exp_avg"].dtype for s in optimizer.state.values()} == {torch.bfloat16}
    ref_mu = {k: np.asarray(v, np.float32) for k, v in _flat(adam.mu).items()}
    ref_nu, ref_p = _flat(adam.nu), _flat(jparams)
    got_p = _flat(to_jax_variables(model)["params"])
    for key in ref_p:
        diff = np.abs(moments["exp_avg"][key] - ref_mu[key])
        assert (diff <= _bf16_ulp(ref_mu[key])).all(), (key, diff.max())
        np.testing.assert_allclose(moments["exp_avg_sq"][key], ref_nu[key], atol=1e-6, rtol=0,
                                   err_msg=key)
        np.testing.assert_allclose(got_p[key], ref_p[key], atol=1e-6, rtol=0, err_msg=key)


@pytest.mark.parametrize("impl", ["fused", "fused_leaf", "multi_transform"])
def test_bf16_mu_is_honoured_on_the_grouped_path_only(impl):
    """The JAX package's other three lowerings keep fp32 first moments
    whatever ``adam_mu_dtype`` says, and so does the port."""
    jcfg, tcfg = _configs(DR_step=3, optimizer_impl=impl, adam_mu_dtype="bfloat16")
    jparams = jax.tree_util.tree_map(jnp.asarray, _opt_tree()["params"])
    tx = joptim.make_optimizer(jcfg, TOTAL_STEPS, None if impl == "multi_transform" else jparams)
    floats = {x.dtype for x in jax.tree_util.tree_leaves(tx.init(jparams))
              if jnp.issubdtype(x.dtype, jnp.floating)}
    assert floats == {jnp.dtype(jnp.float32)}
    state = create_train_state(tcfg, TOTAL_STEPS, device="cpu", seed=0)
    state, _ = make_train_step()(state, _batch(tcfg), 0)
    assert {s["exp_avg"].dtype for s in state.optimizer.state.values()} == {torch.float32}


def test_resume_with_bf16_moments_is_bit_exact(tmp_path):
    """Two steps, a full-state checkpoint, a fresh state restored from it:
    the moments come back bf16 and bit-equal, and the next step of both
    gives the same parameters."""
    cfg = tconfig.tiny_test_config(DR_step=3, adam_mu_dtype="bfloat16", lr=1e-3)
    batches = [_batch(cfg, seed=s) for s in (0, 1, 2)]
    step = make_train_step()
    a = create_train_state(cfg, TOTAL_STEPS, device="cpu", seed=0)
    for b in batches[:2]:
        a, _ = step(a, b, 4)
    tckpt.save_checkpoint(str(tmp_path / "ckpt"), a, include_opt_state=True)
    b = tckpt.restore_checkpoint(str(tmp_path / "ckpt"),
                                 create_train_state(cfg, TOTAL_STEPS, device="cpu", seed=1))
    assert b.step == a.step == 2
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        assert sb["exp_avg"].dtype == torch.bfloat16
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[key], sb[key]), key
    a, ma = step(a, batches[2], 4)
    b, mb = step(b, batches[2], 4)
    assert float(ma["loss"]) == float(mb["loss"])
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("impl", ["grouped", "fused", "fused_leaf", "multi_transform"])
def test_every_optimizer_impl_spelling_builds_the_same_optimizer(impl):
    cfg = tconfig.tiny_test_config(optimizer_impl=impl)
    cfg.check_supported()
    state = create_train_state(cfg, TOTAL_STEPS, device="cpu", seed=0)
    groups = {g["name"]: (len(g["params"]), g["lr"]) for g in state.optimizer.param_groups}
    assert set(groups) == set(toptim.GROUPS)
    assert groups["fc"] == (2, 5e-2)          # weight and bias at the base lr
    assert float(state.optimizer.lrs()["fc"]) == 0.0   # warmup: lr 0 at step 0
