"""The port's training across processes (``d2r_tpu_torch/parallel``) on the
CPU, over gloo: what each spawned rank runs, and the checks that need no
JAX.

The rank functions here run in processes started by
``d2r_tpu_torch.parallel.launch.spawn``; they import only torch, numpy and
the port. ``tests/test_torch_parallel_step.py`` holds their results against
the JAX package and against the port's one-process step.

The tests of this file: ``allgather_1d`` with unequal lengths; the launch
helpers; the CLI as two gloo processes from the JAX package's flags
(``--coordinator_address``, ``--num_processes 2``, ``--process_id``) against
one process, and ``--num_processes -1`` from a launcher's environment. The
CLI runs take a dropout-0 text preset, registered in each process (the
mesh steps with dropout on are ``test_torch_parallel_step.py``'s).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from d2r_tpu_torch import config as tconfig
from d2r_tpu_torch.parallel import distributed, launch
from d2r_tpu_torch.parallel.mesh import (
    full_state_dict,
    make_mesh,
    replica_mismatches,
)

NODROP = "tiny-bert-dropout-0"
BATCH = 8
# the one train step against the port's one-process step, as the JAX
# package's tests/test_tp_semantics.py:137-141 holds its mesh step
STEP_RTOL, STEP_ATOL = 2e-4, 2e-6
# the configurations of one mesh train step (int8_all: data axis only)
STEP_VARIANTS = {
    "plain": {}, "grad_accum": dict(grad_accum_steps=2),
    "multi_step": dict(steps_per_dispatch=2), "remat": dict(remat=True),
    "sentic": dict(use_sentic_graph=True), "alpha": dict(alpha=0.5),
    "int8_all": dict(quant_train="int8_all"),
    # tiny-bert's dropout (0.1 on the hidden states and the attention
    # probabilities), keyed on global coordinates: under either prng_impl,
    # and with accumulation, whose microbatch m is the data ranks' m-th
    # microbatches side by side (here the m-th global batch)
    "dropout": dict(bert_name="tiny-bert"),
    "dropout_threefry": dict(bert_name="tiny-bert", prng_impl="threefry2x32"),
    "dropout_accum": dict(bert_name="tiny-bert", grad_accum_steps=2),
}


def register_presets():
    """The dropout-0 twin of tiny-bert, under :data:`NODROP`."""
    tc = dataclasses.replace(tconfig.tiny_test_config().text_config(),
                             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    tconfig.register_text_preset(NODROP, lambda: tc)


register_presets()


def mesh_axes(shape):
    return ("data", "model")[:len(shape)]


def step_config(variant, **overrides):
    return tconfig.tiny_test_config(**{"batch_size": BATCH, "bert_name": NODROP,
                                       "warmup_ratio": 0.0, **STEP_VARIANTS[variant],
                                       **overrides})


def global_batch(cfg, seed, valid=None):
    """A global batch of :data:`BATCH` rows made with numpy from ``seed``
    (uint8 pixels, PAD ids past random lengths), with ``valid`` and, for a
    ``use_sentic_graph`` config, a random adjacency."""
    from d2r_tpu_torch.data.dataset import synthetic_batch
    vc = cfg.vision_config()
    b = synthetic_batch(BATCH, cfg.max_seq, vc.image_size,
                        vocab_size=cfg.text_config().vocab_size, seed=seed)
    rng = np.random.default_rng(seed)
    b["pixel_values"] = rng.integers(0, 256, size=b["pixel_values"].shape).astype(np.uint8)
    b["valid"] = np.ones(BATCH, bool) if valid is None else np.asarray(valid, bool)
    if cfg.use_sentic_graph:
        b["sentic_adj"] = rng.uniform(0.0, 2.0, (BATCH, cfg.max_seq, cfg.max_seq)
                                      ).astype(np.float32)
    return b


# the wrap-padded batch: its last two rows are padding, which the second
# data rank holds alone at dp = 2
PADDED = [1, 1, 1, 1, 1, 1, 0, 0]


def local_rows(batch, mesh):
    """This rank's rows of a global batch: its data row's slice."""
    if mesh is None or mesh.dp == 1:
        return batch
    n = BATCH // mesh.dp
    return {k: v[mesh.data_index * n:(mesh.data_index + 1) * n] for k, v in batch.items()}


def conditioned_model(cfg):
    """The seed-0 model with the two spots moved off where the model itself
    turns fp32 rounding into gradient noise (as ``chip_smoke.py`` phase 7
    does): BLOCK fusion's merge biases to [1, 1.1], away from the signed
    square root's unbounded slope at 0, and the cross-modal alignments'
    query and key weights shrunk 10x, away from near-ties of their
    100x-temperature softmaxes. Summation order alone (one process against
    a mesh) moves the gradients there by more than the step tolerance."""
    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.models.xmodules import CrossModalAlignment
    model = build_model(cfg, device="cpu", seed=0)
    with torch.no_grad():
        fusion = model.model.block_fusion
        for bias in (fusion.merge_bias0, fusion.merge_bias1):
            bias.abs_().add_(1.0)
        for m in model.modules():
            if isinstance(m, CrossModalAlignment):
                m.query.weight.mul_(0.1)
                m.key.weight.mul_(0.1)
    return model


def run_step(variant, mesh=None):
    """One optimizer step of ``variant`` from :func:`conditioned_model` (two
    global batches for accumulation and multi-step dispatch, the second one
    wrap-padded): (losses, the whole state dict after it, the state)."""
    from d2r_tpu_torch.train.state import (
        create_train_state,
        make_accum_step,
        make_multi_step,
        make_train_step,
    )
    cfg = step_config(variant)
    state = create_train_state(cfg, total_steps=10, device="cpu", model=conditioned_model(cfg),
                               mesh=mesh)
    batches = [local_rows(global_batch(cfg, s, valid), mesh)
               for s, valid in ((1, None), (2, PADDED))]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    if variant in ("grad_accum", "dropout_accum"):
        state, m = make_accum_step(2)(state, stacked, 5)
        losses = [float(m["loss"])]
    elif variant == "multi_step":
        state, m = make_multi_step(2)(state, stacked, 5)
        losses = m["losses"].tolist()
    else:
        state, m = make_train_step()(state, batches[1], 5)
        losses = [float(m["loss"])]
    return losses, full_state_dict(state.model, mesh), state


def step_rank(rank, world, shape, variants):
    """Each variant's step on this rank: (losses, whole state dict on rank 0,
    the tensors that differ from their copies on the other model ranks and
    on the other data ranks, ``replica_mismatches``)."""
    register_presets()
    mesh = make_mesh(shape, mesh_axes(shape))
    out = {}
    for variant in variants:
        losses, full, state = run_step(variant, mesh)
        out[variant] = (losses, full if rank == 0 else None,
                        replica_mismatches(state.model, mesh))
    return out


def forward_rank(rank, world, shape, variables, batches):
    """Train-mode forwards (dropout 0) of the model holding the Flax tree
    ``variables``, one a batch from the same start: loss, JS loss, this
    rank's logits rows and the BatchNorm running statistics after it."""
    from d2r_tpu_torch.parallel.mesh import shard_model
    from d2r_tpu_torch.train.state import _model_inputs
    from d2r_tpu_torch.weights import from_jax_variables
    register_presets()
    mesh = make_mesh(shape, mesh_axes(shape))
    out = []
    for batch in batches:
        model = shard_model(from_jax_variables(step_config("plain"), variables), mesh).train()
        with torch.no_grad():
            loss, logits, aux = model(**_model_inputs(local_rows(batch, mesh), "cpu"))
        out.append({"loss": float(loss), "js_loss": float(aux["js_loss"]), "logits": logits,
                    "running": {k: v for k, v in model.state_dict().items()
                                if "running" in k}})
    return out


def dropout_rank(rank, world, shape):
    """One train step of tiny-bert (dropout 0.1 on the hidden states and the
    attention probabilities) from the seed-0 model: the dropout seed and
    local head count of every attention call, and the BERT blocks' outputs
    (replicated activations under a model axis)."""
    from d2r_tpu_torch.ops import attention
    from d2r_tpu_torch.train.state import create_train_state, make_train_step
    mesh = make_mesh(shape, mesh_axes(shape))
    cfg = tconfig.tiny_test_config(batch_size=BATCH, warmup_ratio=0.0)
    state = create_train_state(cfg, total_steps=10, device="cpu", seed=0, mesh=mesh)
    calls, blocks = [], []
    kernel = attention.fused_attention_small

    def recording(q, k, v, bias, scale, rate=0.0, seed=None):
        calls.append((seed, q.shape[2], rate))
        return kernel(q, k, v, bias, scale, rate, seed)

    encoder = state.model.model.encoder_text_layers
    for i in range(encoder.num_layers):
        getattr(encoder, f"layer_{i}").register_forward_hook(
            lambda _m, _a, out: blocks.append(out.detach().clone()))
    attention.fused_attention_small = recording
    try:
        make_train_step()(state, local_rows(global_batch(cfg, 3), mesh), 11)
    finally:
        attention.fused_attention_small = kernel
    return {"calls": calls, "blocks": blocks, "data_index": mesh.data_index,
            "model_index": mesh.model_index}


def checkpoint_rank(rank, world, shape, directory):
    """A mesh step, saved with ``save_checkpoint`` (optimizer state too);
    a fresh mesh state restored from it; and a fresh mesh state restored from
    the one-process checkpoint at ``directory/one``: the whole state dicts
    and optimizer states each ends with."""
    from d2r_tpu_torch.parallel.mesh import full_optimizer_state
    from d2r_tpu_torch.train import checkpoint as ckpt
    from d2r_tpu_torch.train.state import create_train_state
    register_presets()
    mesh = make_mesh(shape, mesh_axes(shape))
    _, _, state = run_step("plain", mesh)
    ckpt.save_checkpoint(os.path.join(directory, "mesh"), state, include_opt_state=True)
    out = {}
    for name in ("mesh", "one"):
        fresh = create_train_state(step_config("plain"), total_steps=10, device="cpu",
                                   seed=1, mesh=mesh)
        ckpt.restore_checkpoint(os.path.join(directory, name), fresh)
        out[name] = (full_state_dict(fresh.model, mesh),
                     full_optimizer_state(fresh.model, fresh.optimizer, mesh), fresh.step)
    return out if rank == 0 else None


def drift_rank(rank, world, shape):
    """A backward under a model axis, then an ulp added to one whole
    tensor's gradient on the last model rank (as a scatter-add's order can
    on the card): the keys whose gradients differ across the model ranks
    after the mesh's reduction, and whether this rank's was perturbed."""
    from d2r_tpu_torch.train.state import (
        _forward_backward,
        _reduce_gradients,
        create_train_state,
    )
    register_presets()
    mesh = make_mesh(shape, mesh_axes(shape))
    cfg = step_config("plain")
    state = create_train_state(cfg, total_steps=10, device="cpu", model=conditioned_model(cfg),
                               mesh=mesh)
    _forward_backward(state.model, local_rows(global_batch(cfg, 1), mesh), 5, mesh)
    grad = state.model.model.text_embeddings.token_type_embeddings.weight.grad
    perturbed = mesh.model_index == mesh.tp - 1
    if perturbed:
        grad[0, 0] = torch.nextafter(grad[0, 0], torch.tensor(float("inf")))
    _reduce_gradients(state)
    src, bad = mesh.data_index * mesh.tp, []
    for key, p in state.model.named_parameters():
        *prefix, name = key.split(".")
        if p.grad is None or name in getattr(state.model.get_submodule(".".join(prefix)),
                                             "shards", {}):
            continue
        ref = p.grad.clone()
        dist.broadcast(ref, src=src, group=mesh.model_group)
        if not torch.equal(ref, p.grad):
            bad.append(key)
    return bad, perturbed


# the mesh axes of the layout checks (pipeline stages, the two hints), in
# JAX's order
def layout_axes(shape):
    return {1: ("data",), 2: ("data", "model"), 3: ("data", "stage", "model")}[len(shape)]


def layout_step(overrides, mesh=None, seed=2):
    """One train step of the dropout-0 tiny config with ``overrides`` (a
    ``bert_name`` among them selects the text preset) from
    :func:`conditioned_model`, on this rank's rows of the wrap-padded global
    batch: the loss, the JS loss, the whole reduced gradients and the whole
    updated state dict, the sequence length the first text block and the
    first vision block see and the rows the first routing layer sees; and
    the state."""
    from d2r_tpu_torch.parallel.mesh import full_gradients
    from d2r_tpu_torch.train.state import create_train_state, make_train_step
    cfg = tconfig.tiny_test_config(**{"batch_size": BATCH, "bert_name": NODROP,
                                      "warmup_ratio": 0.0, **overrides})
    state = create_train_state(cfg, total_steps=10, device="cpu", model=conditioned_model(cfg),
                               mesh=mesh)
    model, seen = state.model.model, {}
    probes = {"text_len": next(getattr(model.encoder_text_layers, f"layer_{i}")
                               for i in range(model.encoder_text_layers.num_layers)
                               if hasattr(model.encoder_text_layers, f"layer_{i}")),
              "vision_len": next(getattr(model.encoder_vision_layers, f"layer_{i}")
                                 for i in range(model.encoder_vision_layers.num_layers)
                                 if hasattr(model.encoder_vision_layers, f"layer_{i}")),
              "fabric_rows": model.itr_module.dynamic_itr_l0}
    def probe(name):
        def hook(_m, args):
            seen.setdefault(name, args[1].shape[0] if name == "fabric_rows"
                            else args[0].shape[1])
        return hook

    hooks = [m.register_forward_pre_hook(probe(name)) for name, m in probes.items()]
    state, m = make_train_step()(state, local_rows(global_batch(cfg, seed, PADDED), mesh), 5)
    for h in hooks:
        h.remove()
    return {"loss": float(m["loss"]), "js_loss": float(m["js_loss"]), **seen,
            "grads": full_gradients(state.model, mesh),
            "params": full_state_dict(state.model, mesh)}, state


def layout_rank(rank, world, shape, variants):
    """Each of ``variants`` ({name: config overrides}) as a :func:`layout_step`
    on this rank of the mesh ``shape``, with ``replica_mismatches`` after
    it; the whole tensors on rank 0 only."""
    register_presets()
    mesh = make_mesh(shape, layout_axes(shape))
    out = {}
    for name, overrides in variants.items():
        r, state = layout_step(overrides, mesh)
        r["replicas"] = replica_mismatches(state.model, mesh)
        if rank != 0:
            r.pop("grads"), r.pop("params")
        out[name] = r
    return out


def pipeline_checkpoint_rank(rank, world, shape, directory):
    """A pipelined step on the stage mesh ``shape``, saved with its
    optimizer state under ``directory/mesh``; then a fresh mesh state
    restored from it and one restored from the one-process pipelined
    checkpoint ``directory/one``: their whole state dicts, optimizer states
    and steps (rank 0)."""
    from d2r_tpu_torch.parallel.mesh import full_optimizer_state
    from d2r_tpu_torch.train import checkpoint as ckpt
    from d2r_tpu_torch.train.state import create_train_state
    register_presets()
    mesh = make_mesh(shape, layout_axes(shape))
    overrides = dict(pipeline_stages=2)
    _, state = layout_step(overrides, mesh)
    ckpt.save_checkpoint(os.path.join(directory, "mesh"), state, include_opt_state=True)
    out = {}
    for name in ("mesh", "one"):
        cfg = tconfig.tiny_test_config(batch_size=BATCH, bert_name=NODROP, **overrides)
        fresh = create_train_state(cfg, total_steps=10, device="cpu", seed=1, mesh=mesh)
        ckpt.restore_checkpoint(os.path.join(directory, name), fresh)
        out[name] = (full_state_dict(fresh.model, mesh),
                     full_optimizer_state(fresh.model, fresh.optimizer, mesh), fresh.step)
    return out if rank == 0 else None


def qdot_rank(rank, world, dtype_name, device="cpu"):
    """``quant_dot`` on the model group of (1, 2): one seeded (x, w, g),
    split by the model axis along K (row-parallel) and along N
    (column-parallel), in both modes: whether the forward, the input
    gradient and the weight gradient equal this rank's part of the one
    process product's, bit for bit (on ``device``: the card's ranks share
    card 0 over gloo)."""
    from d2r_tpu_torch.ops.qdot import quant_dot
    if device != "cpu":
        torch.cuda.set_device(0)
    mesh = make_mesh((1, 2), ("data", "model"), device=device)
    dtype = getattr(torch, dtype_name)
    rng = np.random.default_rng(0)
    x0 = torch.tensor(rng.standard_normal((3, 7, 40)), dtype=dtype, device=device)
    w0 = torch.tensor(rng.standard_normal((24, 40)), dtype=dtype, device=device)
    g0 = torch.tensor(rng.standard_normal((3, 7, 24)), dtype=dtype, device=device)
    out = {}
    for mode in ("int8", "int8_all"):
        def run(x, w, g, **kw):
            x, w = x.clone().requires_grad_(), w.clone().requires_grad_()
            y = quant_dot(x, w, mode, **kw)
            y.backward(g)
            return y.detach(), x.grad, w.grad

        y, dx, dw = run(x0, w0, g0)
        k, n, i = 20, 12, mesh.model_index
        yr, dxr, dwr = run(x0[..., i * k:(i + 1) * k], w0[:, i * k:(i + 1) * k], g0,
                           model_group=mesh.model_group, split="row")
        yc, dxc, dwc = run(x0, w0[i * n:(i + 1) * n], g0[..., i * n:(i + 1) * n],
                           model_group=mesh.model_group, split="column")
        out[mode] = {
            "row": [torch.equal(yr, y), torch.equal(dxr, dx[..., i * k:(i + 1) * k]),
                    torch.equal(dwr, dw[:, i * k:(i + 1) * k])],
            "column": [torch.equal(yc, y[..., i * n:(i + 1) * n]),
                       # int8's input gradient is a float product, summed
                       # over the two ranks' halves of N in another order
                       torch.equal(dxc, dx) if mode == "int8_all" else bool(torch.allclose(
                           dxc.float(), dx.float(), rtol=0, atol=1e-5 if dtype_name ==
                           "float32" else 0.1)),
                       torch.equal(dwc, dw[i * n:(i + 1) * n])]}
    return out


def gather_rank(rank, world, lengths):
    from d2r_tpu_torch.parallel.mesh import make_mesh as mk
    mesh = mk((-1,), ("data",))
    values = list(range(100 * rank, 100 * rank + lengths[rank]))
    return distributed.allgather_1d(values, mesh.data_group, mesh.collective_device)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_allgather_1d_joins_unequal_lengths_in_rank_order():
    lengths = [3, 0, 5]
    got = launch.spawn(gather_rank, 3, (lengths,))
    want = [v for r, n in enumerate(lengths) for v in range(100 * r, 100 * r + n)]
    assert got == [want] * 3


def test_launch_helpers():
    env = launch.rank_env(1, 2, 1234, base={})
    assert (env["RANK"], env["WORLD_SIZE"], env["MASTER_PORT"]) == ("1", "2", "1234")
    cmd = launch.tiny_train_cmd({"train": "t", "dev": "d", "test": "s", "img_dir": "i"}, "o")
    assert cmd[1:3] == ["-m", "d2r_tpu_torch.cli"] and "--no_pallas" in cmd
    assert launch.free_port() > 0


# the CLI with the dropout-0 preset registered first
CLI_CODE = ("import sys, test_torch_parallel_ranks as r; r.register_presets(); "
            "from d2r_tpu_torch import cli; cli.main(sys.argv[1:])")


def _cli(cmd):
    """``launch.tiny_train_cmd``'s flags through :data:`CLI_CODE`."""
    return [sys.executable, "-c", CLI_CODE] + cmd[3:]


def _final_test_loss(out: str) -> float:
    lines = out.splitlines()
    i = next(i for i, line in enumerate(lines) if "Test Eval results" in line)
    return float(next(line for line in lines[i:] if "loss =" in line).split("loss =")[1])


def _cli_env():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [launch.REPO, os.path.dirname(os.path.abspath(__file__))]), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return env


def _two_processes(paths, out, flags):
    """The tiny CLI as two gloo processes; their outputs."""
    from concurrent.futures import ThreadPoolExecutor
    env, port = _cli_env(), launch.free_port()
    procs = [subprocess.Popen(
        _cli(launch.tiny_train_cmd(paths, out, extra=flags + [
            "--coordinator_address", f"127.0.0.1:{port}", "--num_processes", "2",
            "--process_id", str(rank)])), env=env, cwd=launch.REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for rank in range(2)]
    with ThreadPoolExecutor(2) as pool:   # drain both: a full pipe would stall a rank
        outs = list(pool.map(lambda p: p.communicate(timeout=300)[0], procs))
    for rank, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank}:\n{text[-4000:]}"
    return outs


def test_cli_two_processes_match_one(tmp_path):
    """Two gloo processes from the JAX package's flags: rank 0 alone
    reports, and the test loss is one process's within rtol 2e-4. The
    checkpoint does not depend on the mesh: rank 0's best model holds one
    process's keys, shapes and types, and one process restoring it
    (``--only_test --load_path``) gives the two processes' test loss
    within the forward tolerance, rtol 2e-5. Auto-resume across the
    processes: the same command again restores the finished run's state
    and gives its test loss bit for bit."""
    from d2r_tpu_torch.data.dataset import write_fake_dataset
    paths = write_fake_dataset(str(tmp_path / "ds"), n=12, image_size=32)
    env = _cli_env()
    flags = ["--bert_name", NODROP]
    multi = flags + ["--auto_resume"]
    outs = _two_processes(paths, str(tmp_path / "multi"), multi)
    assert "Test Eval results" not in outs[1]
    multi_loss = _final_test_loss(outs[0])

    def one_process(out, extra=()):
        p = subprocess.run(_cli(launch.tiny_train_cmd(paths, str(tmp_path / out),
                                                      extra=flags + list(extra))),
                           env=env, cwd=launch.REPO, text=True, capture_output=True, timeout=300)
        assert p.returncode == 0, p.stderr[-4000:]
        return _final_test_loss(p.stderr)

    np.testing.assert_allclose(multi_loss, one_process("one"), rtol=2e-4)
    a, b = (torch.load(tmp_path / d / "best_model" / "model.pth", weights_only=True)
            for d in ("multi", "one"))
    assert {k: (v.shape, v.dtype) for k, v in a.items()} == {
        k: (v.shape, v.dtype) for k, v in b.items()}
    probe = one_process("probe", ["--only_test", "--load_path",
                                  str(tmp_path / "multi" / "best_model")])
    np.testing.assert_allclose(probe, multi_loss, rtol=2e-5)
    resumed = _two_processes(paths, str(tmp_path / "multi"), multi)
    assert "Auto-resume: restored 1 completed epoch" in resumed[0]
    assert _final_test_loss(resumed[0]) == multi_loss


def test_cli_num_processes_minus_one_reads_the_launcher_environment(tmp_path, monkeypatch):
    """``--num_processes -1`` joins through ``env://``: without the
    launcher's variables it raises naming them; with them (a world of one)
    it trains an epoch and ends its process group."""
    from d2r_tpu_torch import cli
    from d2r_tpu_torch.data.dataset import write_fake_dataset
    paths = write_fake_dataset(str(tmp_path / "ds"), n=8, image_size=32)
    argv = launch.tiny_train_cmd(paths, str(tmp_path / "out"), batch_size=4,
                                 extra=["--bert_name", NODROP, "--num_processes", "-1"])[3:]
    for k in distributed.LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        cli.main(argv)
    for k, v in launch.rank_env(0, 1, launch.free_port(), base={}).items():
        monkeypatch.setenv(k, v)
    cli.main(argv)
    assert not dist.is_initialized()
    assert (tmp_path / "out" / "best_model" / "model.pth").exists()



def serve_rank(rank, world, shape, tree, requests, buckets, quantize=(None,)):
    """A mesh ``Predictor`` (``serve.py``) over ``shape`` holding the Flax
    tree ``tree`` at ``tiny_test_config()``, on the CPU, for each mode of
    ``quantize``: warmed up, then each request predicted, then
    ``latency_stats`` both ways (every rank calls each together). Returns
    the probabilities of each request by mode, and the model's QKV width
    on this rank."""
    from d2r_tpu_torch.serve import Predictor, latency_stats
    from d2r_tpu_torch.weights import from_jax_variables
    mesh = make_mesh(shape, mesh_axes(shape))
    cfg = tconfig.tiny_test_config()
    probs = {}
    for mode in quantize:
        pred = Predictor(cfg, from_jax_variables(cfg, tree), batch_buckets=buckets,
                         device="cpu", quantize=mode, mesh=mesh)
        pred.warmup()
        probs[mode] = [pred.predict(*r)["probs"] for r in requests]
        for resident in (False, True):
            stats = latency_stats(pred, dict(zip(("input_ids", "attention_mask",
                                                  "token_type_ids", "pixel_values"),
                                                 requests[0])),
                                  iters=2, warmup=1, device_resident=resident)
            assert 0 < stats["p50"] <= stats["p95"], stats
    qkv = pred.model.model.encoder_text_layers.layer_0.attention_self.qkv
    return {"probs": probs, "qkv_hidden": qkv.hidden}


def int8_serve_rank(rank, world, shape, device="cpu"):
    """An int8 mesh ``Predictor`` over ``shape`` of the seeded tiny model
    (bf16), each rank's quantized modules holding their local slices of the
    codes and scales (on ``device``: the W8A16 kernel on the ranks' shared
    card 0, over gloo): the probabilities of a request of three rows, and
    one process's int8 ``Predictor`` on the same rows."""
    from d2r_tpu_torch.models.unimo import build_model
    from d2r_tpu_torch.serve import Predictor
    if device != "cpu":
        torch.cuda.set_device(0)
    mesh = make_mesh(shape, mesh_axes(shape), device=device)
    cfg = tconfig.tiny_test_config(compute_dtype="bfloat16")
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 128, size=(3, cfg.max_seq)).astype(np.int32)
    mask = np.ones_like(ids)
    pixels = rng.integers(0, 256, size=(3, 3, 32, 32)).astype(np.uint8)
    rows = (ids, mask, np.zeros_like(ids), pixels)
    out = {}
    for name, m in (("mesh", mesh), ("one", None)):
        pred = Predictor(cfg, build_model(cfg, device="cpu", seed=0), batch_buckets=(4,),
                         device=device, quantize="int8", mesh=m)
        out[name] = pred.predict(*rows)["probs"]
    return out
