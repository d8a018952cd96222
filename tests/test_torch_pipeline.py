"""The port's pipeline stages (``d2r_tpu_torch/models/pipeline.py``,
``cfg.pipeline_stages``, ``--mesh_stage``, ``--pipeline_microbatches``)
against the JAX package's ``PipelinedStack`` and against the port's own
sequential towers, on the CPU.

- One seeded Flax tree of JAX's pipelined model (``pipeline_stages=2``, M
  in {2, 4}): the port's pipelined forward (train mode, dropout 0, batch
  statistics, ``valid``) within 1e-4 of JAX's; the port's pipelined forward
  within 1e-6 of its sequential one on the same weights (the largest
  difference reported); M does not change the math.
- The relayout (``weights.pipeline_tower_layers`` and its inverse) equals
  JAX's ``pipeline_tower_layers``/``unpipeline_tower_layers`` leaf for leaf,
  and ``to_jax_variables`` of a pipelined model gives JAX's tree, keys and
  shapes; ``param_partition_spec`` equals JAX's on every path, and every
  rank's slices of a (data, stage, model) = (2, 2, 2) mesh equal the shards
  of JAX's ``make_param_shardings`` on the 8-device CPU mesh (a stage rank
  holds its stage's blocks only).
- Pretrained towers load into a pipelined model as into a sequential one;
  JAX's validation errors.
- A pipelined train step in one process equals the sequential step; stage
  meshes (1, 2, 1), (2, 2, 1) and (1, 2, 2) over gloo equal the one-process
  pipelined step at PR 10's tolerances (loss rtol 2e-4; the reduced
  gradients atol 2e-5, JAX's ``tests/test_tp_semantics.py``; the updated
  tensors rtol 2e-4 / atol 2e-6), replicas bit-equal; with dropout on
  (1, 2, 1) draws one process's masks.
- Checkpoints: a stage mesh's checkpoint holds one process's keys and
  shapes and restores into a stage mesh exactly, one process's into a stage
  mesh exactly; a pipelined checkpoint served through ``restore_model``
  and ``Predictor`` gives the unpipelined model's answers bit for bit.
- The CLI with ``--mesh_stage 2 --pipeline_microbatches 4`` as two gloo
  processes against one process's sequential run.
"""

import dataclasses
import functools
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parallel_ranks as ranks
from d2r_tpu import config as jconfig
from d2r_tpu.models.unimo import D2RClassifier as JaxClassifier
from d2r_tpu.parallel import mesh as jmesh
from d2r_tpu.utils import weights as jweights
from d2r_tpu_torch import config as tconfig
from d2r_tpu_torch import weights as tweights
from d2r_tpu_torch.parallel.launch import spawn
from d2r_tpu_torch.parallel.mesh import Mesh, param_partition_spec, shard_model
from d2r_tpu_torch.train import checkpoint as ckpt
from test_torch_parallel_forward import random_variables

INPUTS = ("input_ids", "attention_mask", "token_type_ids", "labels", "pixel_values")
STAGE_MESHES = [(1, 2, 1), (2, 2, 1), (1, 2, 2)]
GRAD_ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(**kw):
    kw = {"batch_size": ranks.BATCH, "bert_name": ranks.NODROP, **kw}
    return jconfig.tiny_test_config(**kw), tconfig.tiny_test_config(**kw)


def _batch():
    return ranks.global_batch(ranks.step_config("plain"), 4, ranks.PADDED)


# the dropout-0 tiny text tower under the rank module's name, for JAX too
jconfig.register_text_preset(ranks.NODROP, lambda: dataclasses.replace(
    jconfig.tiny_test_config().text_config(), hidden_dropout_prob=0.0,
    attention_probs_dropout_prob=0.0))


@functools.lru_cache(maxsize=None)
def _tree(stages=2):
    """A seeded Flax tree of JAX's model in the layout of ``stages``."""
    jcfg, _ = _cfgs(pipeline_stages=stages)
    b = _batch()
    tree = random_variables(JaxClassifier(jcfg), [jnp.asarray(b[k]) for k in INPUTS])
    return {c: jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree[c])
            for c in ("params", "batch_stats")}


def _port_forward(tcfg, tree):
    model = tweights.from_jax_variables(tcfg, tree).train()
    b = _batch()
    with torch.no_grad():
        loss, logits, aux = model(*(torch.as_tensor(b[k]) for k in INPUTS),
                                  valid=torch.as_tensor(b["valid"]))
    return float(loss), float(aux["js_loss"]), logits.numpy()


@pytest.mark.parametrize("microbatches", [2, 4])
def test_pipelined_forward_matches_jax(microbatches):
    jcfg, tcfg = _cfgs(pipeline_stages=2, pipeline_microbatches=microbatches)
    model = JaxClassifier(jcfg)
    b = _batch()
    (loss, logits, aux), _ = jax.jit(lambda v, x, valid: model.apply(
        v, *x, valid=valid, deterministic=True, use_running_average=False,
        mutable=["batch_stats"]))(_tree(), [jnp.asarray(b[k]) for k in INPUTS],
                                  jnp.asarray(b["valid"]))
    got_loss, got_js, got_logits = _port_forward(tcfg, _tree())
    np.testing.assert_allclose(got_logits, np.asarray(logits), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_loss, float(loss), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_js, float(aux["js_loss"]), atol=1e-4, rtol=0)


@pytest.mark.parametrize("microbatches", [2, 4])
def test_pipelined_forward_matches_sequential(microbatches, capsys):
    _, piped = _cfgs(pipeline_stages=2, pipeline_microbatches=microbatches)
    _, plain = _cfgs()
    seq_tree = {c: jweights.unstack_tower_layers(jweights.unpipeline_tower_layers(t))
                for c, t in _tree().items()}
    a, b = _port_forward(piped, _tree()), _port_forward(plain, seq_tree)
    diff = max(abs(a[0] - b[0]), abs(a[1] - b[1]), float(np.abs(a[2] - b[2]).max()))
    with capsys.disabled():
        print(f"\npipelined (M={microbatches}) against sequential: largest difference {diff:.3g}")
    assert diff <= 1e-6


def test_microbatch_count_does_not_change_the_math():
    outs = [_port_forward(_cfgs(pipeline_stages=2, pipeline_microbatches=m)[1], _tree())
            for m in (2, 4, 8)]
    for o in outs[1:]:
        np.testing.assert_allclose(o[2], outs[0][2], atol=1e-6, rtol=0)
        np.testing.assert_allclose(o[0], outs[0][0], atol=1e-6, rtol=0)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _same_tree(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg="/".join(k))


def test_relayout_and_round_trip_equal_jax():
    piped = _tree()
    seq = {c: jweights.unstack_tower_layers(jweights.unpipeline_tower_layers(t))
           for c, t in piped.items()}
    for stages in (1, 2):
        for c in seq:
            _same_tree(tweights.pipeline_tower_layers(seq[c], stages) if stages > 1
                       else tweights.stack_tower_layers(seq[c]),
                       jweights.pipeline_tower_layers(seq[c], stages) if stages > 1
                       else jweights.stack_tower_layers(seq[c]))
    for c in seq:
        _same_tree(tweights.unpipeline_tower_layers(piped[c]),
                   jweights.unpipeline_tower_layers(piped[c]))
        _same_tree(tweights.unstack_tower_layers(tweights.unpipeline_tower_layers(piped[c])),
                   seq[c])
    # a pipelined port model writes JAX's pipelined tree back, and loads it
    _, tcfg = _cfgs(pipeline_stages=2)
    model = tweights.from_jax_variables(tcfg, piped)
    out = tweights.to_jax_variables(model)
    for c in piped:
        _same_tree(out[c], piped[c])
    with pytest.raises(KeyError, match="pipelined layout"):
        tweights.from_jax_variables(tcfg, seq)


def test_stage_specs_and_rank_slices_equal_jax_shardings(eight_devices):
    """Every path's spec equals JAX's ``param_partition_spec`` (with and
    without the two axes), and every rank of (2, 2, 2) holds, in the port's
    layout, JAX's shard on ``mesh.devices[d, s, m]``: the stage's blocks of
    the (S, N/S, ...) leaves, the tp rule past the two leading axes."""
    tree = _tree()
    paths = ["/".join(k) for k, _ in _leaves(tree["params"])]
    assert any("stages_pipelined" in p for p in paths)
    for p in paths:
        for model_axis in (False, True):
            for stage_axis in (False, True):
                assert param_partition_spec(p, model_axis, stage_axis) == tuple(
                    jmesh.param_partition_spec(p, model_axis, stage_axis)), p
    mesh = jmesh.make_mesh((2, 2, 2), ("data", "stage", "model"))
    shardings = jmesh.make_param_shardings(tree["params"], mesh)
    _, tcfg = _cfgs(pipeline_stages=2)
    whole = tweights.from_jax_variables(tcfg, tree)
    per_stage = tcfg.text_config().num_hidden_layers // 2
    for rank in range(8):
        d, s, m = rank // 4, (rank // 2) % 2, rank % 2
        model = shard_model(tweights.from_jax_variables(tcfg, tree),
                            Mesh(2, 2, rank, "cpu", pp=2))
        held = [i for i in range(model.model.encoder_text_layers.num_layers)
                if hasattr(model.model.encoder_text_layers, f"layer_{i}")]
        assert held == list(range(s * per_stage, (s + 1) * per_stage))
        for key, t in model.named_parameters():
            path = tweights.flax_path(model, key)
            pick = None
            for tower in ("encoder_text_layers", "encoder_vision_layers"):
                if f"{tower}/layer_" in path:
                    index, rest = path.split(f"{tower}/layer_", 1)[1].split("/", 1)
                    path = (f"model/{tower}/layers_pipelined/pipeline/stages_pipelined/layers/"
                            f"layer/{rest}")
                    pick = int(index) - s * per_stage
            leaf, sharding = tree["params"], shardings
            for part in path.split("/"):
                leaf, sharding = leaf[part], sharding[part]
            arr = jax.device_put(leaf, sharding)
            shard = next(np.asarray(x.data) for x in arr.addressable_shards
                         if x.device == mesh.devices[d, s, m])
            if pick is not None:
                assert shard.shape[0] == 1
                shard = shard[0, pick]
            *prefix, name = key.split(".")
            module = model.get_submodule(".".join(prefix))
            want = tweights._translate(module, path.rsplit("/", 1)[1], shard)[1]
            np.testing.assert_array_equal(t.detach().numpy(), np.ascontiguousarray(want),
                                          err_msg=f"rank {rank} {key}")
    assert len(list(whole.parameters())) > len(list(model.parameters()))


def test_pretrained_towers_load_into_a_pipelined_model(tmp_path):
    """``load_pretrained_params`` into a pipelined model goes through its
    pipelined tree (JAX ``d2r_tpu/utils/weights.py:191-200``) and gives the
    sequential model's tensors, from HF-keyed files fabricated without
    ``transformers`` (``chip_smoke.fabricate_pretrained``)."""
    import chip_smoke
    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.utils.weights import load_pretrained_params
    _, seq = _cfgs()
    _, piped = _cfgs(pipeline_stages=2)
    chip_smoke.fabricate_pretrained(seq, str(tmp_path), seed=4)
    want = load_pretrained_params(str(tmp_path), build_model(seq, device="cpu")).state_dict()
    got = load_pretrained_params(str(tmp_path), build_model(piped, device="cpu")).state_dict()
    assert list(got) == list(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert not torch.equal(want["model.encoder_text_layers.layer_1.output_dense.weight"],
                           build_model(seq, device="cpu").state_dict()[
                               "model.encoder_text_layers.layer_1.output_dense.weight"])


def test_validation_errors_are_jax_s():
    b = _batch()
    args = [jnp.asarray(b[k]) for k in INPUTS]
    targs = [torch.as_tensor(b[k]) for k in INPUTS]
    for kw, match in ((dict(pipeline_stages=3), "pipeline_stages=3 must divide num_layers=2"),
                      (dict(pipeline_stages=2, pipeline_microbatches=3),
                       "pipeline_microbatches=3 must be >= 1 and divide batch=8")):
        jcfg, tcfg = _cfgs(**kw)
        with pytest.raises(ValueError, match=match):
            jax.eval_shape(JaxClassifier(jcfg).init, jax.random.key(0), *args)
        from d2r_tpu_torch.models.unimo import build_model
        with pytest.raises(ValueError, match=match):
            build_model(tcfg, device="cpu")(*targs)


def _close(got, want, msg=""):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=ranks.STEP_RTOL, err_msg=msg)
    assert got["grads"].keys() == want["grads"].keys()
    for k, v in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k].numpy(), v.numpy(), atol=GRAD_ATOL, rtol=0,
                                   err_msg=f"{msg} grad {k}")
    assert got["params"].keys() == want["params"].keys()
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), rtol=ranks.STEP_RTOL,
                                   atol=ranks.STEP_ATOL, err_msg=f"{msg} {k}")


@functools.lru_cache(maxsize=None)
def one_process(**overrides):
    ranks.register_presets()
    return ranks.layout_step(overrides)[0]


def _one(overrides):
    return one_process(**overrides)


def test_pipelined_step_matches_sequential():
    _close(_one(dict(pipeline_stages=2)), _one({}), "pipelined against sequential")
    _close(_one(dict(pipeline_stages=2, pipeline_microbatches=4)), _one({}), "M = 4")


VARIANTS = {"pipe": dict(pipeline_stages=2)}
DROPOUT = {"pipe_dropout": dict(pipeline_stages=2, bert_name="tiny-bert")}


@functools.lru_cache(maxsize=None)
def mesh_run(shape):
    variants = {**VARIANTS, **(DROPOUT if shape == (1, 2, 1) else {})}
    return spawn(ranks.layout_rank, int(np.prod(shape)), (shape, variants))


@pytest.mark.parametrize("shape", STAGE_MESHES, ids=lambda s: "x".join(map(str, s)))
def test_stage_mesh_step_matches_one_process(shape):
    runs = mesh_run(shape)
    got = runs[0]["pipe"]
    _close(got, _one(VARIANTS["pipe"]), f"mesh {shape}")
    for r in runs:
        assert r["pipe"]["loss"] == got["loss"]
        assert r["pipe"]["replicas"] == {"model": [], "stage": [], "data": []}
    if shape == (1, 2, 1):
        # dropout on: the masks are keyed on (microbatch, block), wherever
        # the block runs
        _close(runs[0]["pipe_dropout"], _one(DROPOUT["pipe_dropout"]), "dropout")


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(directory, the (1, 2, 1) ranks' results): one process's pipelined
    step saved as ``one``; the ranks save ``mesh`` and restore both."""
    directory = str(tmp_path_factory.mktemp("pipe_ckpt"))
    _, state = ranks.layout_step(dict(pipeline_stages=2))
    ckpt.save_checkpoint(f"{directory}/one", state, include_opt_state=True)
    return directory, spawn(ranks.pipeline_checkpoint_rank, 2, ((1, 2, 1), directory))[0]


def test_stage_mesh_checkpoints_are_one_process_s(saved):
    directory, restored = saved
    load = lambda name, f: torch.load(f"{directory}/{name}/{f}", weights_only=True)
    mesh, one = load("mesh", ckpt.MODEL_FILE), load("one", ckpt.MODEL_FILE)
    assert list(mesh) == list(one)
    for k, v in one.items():
        np.testing.assert_allclose(mesh[k].numpy(), v.numpy(), rtol=ranks.STEP_RTOL,
                                   atol=ranks.STEP_ATOL, err_msg=k)
    mesh_train, one_train = load("mesh", ckpt.TRAIN_STATE_FILE), load("one", ckpt.TRAIN_STATE_FILE)
    shapes = lambda t: {i: {k: v.shape for k, v in st.items()}
                        for i, st in t["optimizer"]["state"].items()}
    assert shapes(mesh_train) == shapes(one_train)
    assert ([g["params"] for g in mesh_train["optimizer"]["param_groups"]]
            == [g["params"] for g in one_train["optimizer"]["param_groups"]])
    for name in ("mesh", "one"):
        model, opt, step = restored[name]
        want_model, want_train = load(name, ckpt.MODEL_FILE), load(name, ckpt.TRAIN_STATE_FILE)
        assert list(model) == list(want_model)
        assert all(torch.equal(model[k], want_model[k]) for k in model)
        want_opt = want_train["optimizer"]
        assert opt["state"].keys() == want_opt["state"].keys()
        assert all(torch.equal(opt["state"][i][k], want_opt["state"][i][k])
                   for i in opt["state"] for k in ("exp_avg", "exp_avg_sq"))
        assert step == want_train["step"] == 1


def test_pipelined_checkpoint_serves_unpipelined(saved):
    from d2r_tpu_torch.models.unimo import D2RClassifier
    from d2r_tpu_torch.serve import Predictor
    directory, _ = saved
    _, piped = _cfgs(pipeline_stages=2, pipeline_microbatches=2)
    _, plain = _cfgs()
    served = ckpt.restore_model(f"{directory}/mesh", piped, "cpu")
    assert served.model.encoder_text_layers.stages == 1
    reference = D2RClassifier(plain)
    reference.load_state_dict(torch.load(f"{directory}/mesh/{ckpt.MODEL_FILE}",
                                         weights_only=True))
    b = _batch()
    keys = ("input_ids", "attention_mask", "token_type_ids", "pixel_values")
    with torch.no_grad():
        a = served.eval()(*(torch.as_tensor(b[k]) for k in INPUTS))[1]
        r = reference.eval()(*(torch.as_tensor(b[k]) for k in INPUTS))[1]
    assert torch.equal(a, r)
    got = Predictor(piped, served, batch_buckets=(1, 8), device="cpu").predict(
        *[b[k][:3] for k in keys])
    want = Predictor(plain, reference, batch_buckets=(1, 8), device="cpu").predict(
        *[b[k][:3] for k in keys])
    np.testing.assert_array_equal(got["probs"], want["probs"])


def test_cli_stage_mesh_matches_one_process(tmp_path):
    """``--mesh_stage 2 --pipeline_microbatches 4`` as two gloo processes:
    rank 0 alone reports, and its test loss is one process's sequential
    run's within rtol 2e-4; its best model loads into one process."""
    from d2r_tpu_torch.data.dataset import write_fake_dataset
    from d2r_tpu_torch.parallel import launch
    paths = write_fake_dataset(str(tmp_path / "ds"), n=12, image_size=32)
    flags = ["--bert_name", ranks.NODROP]
    outs = ranks._two_processes(paths, str(tmp_path / "piped"),
                                flags + ["--mesh_stage", "2", "--pipeline_microbatches", "4"])
    assert "Test Eval results" not in outs[1]
    p = subprocess.run(ranks._cli(launch.tiny_train_cmd(paths, str(tmp_path / "one"),
                                                        extra=flags)),
                       env=ranks._cli_env(), cwd=launch.REPO, text=True, capture_output=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-4000:]
    np.testing.assert_allclose(ranks._final_test_loss(outs[0]), ranks._final_test_loss(p.stderr),
                               rtol=2e-4)
    cfg = tconfig.load_config_json(str(tmp_path / "piped" / "config.json"))
    assert (cfg.pipeline_stages, cfg.pipeline_microbatches) == (2, 4)
    assert cfg.mesh_axis_names == ("data", "stage")
    assert os.path.exists(tmp_path / "piped" / "best_model" / ckpt.MODEL_FILE)
    ckpt.restore_model(str(tmp_path / "piped" / "best_model"), cfg, "cpu")
