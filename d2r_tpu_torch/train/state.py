"""Train state and step functions (counterpart of ``d2r_tpu/train/state.py``).

A step is what the reference's loop does per batch (forward, backward, AdamW
step, LR step) plus the BatchNorm running statistics, which train-mode
forwards update in place. PyTorch runs eagerly, so a step is a Python
function over a mutable :class:`TrainState`; every function returns the
state it was given, as the JAX ones return their new state. On the card the
attention sites run K1 forward and K2 backward
(``ops/kernels/fused_attention.py``); parameters stay fp32 and each module
casts them to the compute type at use.

Dropout: each step makes one :class:`~d2r_tpu_torch.models.layers.DropoutRNG`
seeded from ``(dropout_seed, step)`` as ``jax.random.fold_in`` derives the
step's key. Its CPU generator hands every attention call its seed as a host
int (no device sync); its device generator draws the hidden dropout masks.
A step is not capturable by a CUDA graph yet: the seeds are host ints baked
into each launch.

``debug_nans`` (``--debug_nans``, the port's counterpart of
``jax_debug_nans``): before the optimizer steps, every step checks its loss
and every gradient and raises ``FloatingPointError`` naming the step and
the first parameter whose gradient is not finite, so no update is applied
from it. The check reads one flag back from the device a step.

Across processes (``create_train_state(..., mesh=...)``, ``parallel/``): the
model is built whole on the CPU from the seed, as one process builds it,
then cut to this rank's slices (``shard_model``) and moved to its card. A
step runs this rank's rows; the model's collectives make the loss the
global batch's, and after the backward (after the last microbatch, with
accumulation) the gradients of the optimizer's parameters are averaged
over the data group, which is the global loss's gradient (the scheme of
``parallel/distributed.py``); those of the tensors a model axis leaves
whole are first averaged over the model group, which keeps the replicas
equal to the bit (:func:`_reduce_gradients`). No ``DistributedDataParallel`` wrapper: one
explicit reduction a step covers the leaves that get no gradient (CMA's
unread ``fc_1``/``fc_2`` at ``alpha != 0``; AdamW still decays them) and
frozen towers alike, and the state dict keeps its keys. The dropout seed
of a step folds in the rank's data index when the data axis is larger than
1, so data ranks draw different masks, and the model ranks of a data row
the same ones for their replicated activations.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import torch
import torch.distributed as dist
from torch import nn

from d2r_tpu_torch.config import D2RConfig, resolve_device
from d2r_tpu_torch.models.layers import DropoutRNG, fold_in
from d2r_tpu_torch.models.unimo import build_model
from d2r_tpu_torch.parallel.mesh import Mesh, shard_model
from d2r_tpu_torch.train.optimizer import make_optimizer

BATCH_KEYS = ("input_ids", "attention_mask", "token_type_ids", "labels",
              "pixel_values")
OPTIONAL_KEYS = ("valid", "sentic_adj")
# elements a bucket of the gradient all-reduce
REDUCE_BUCKET = 1 << 24


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0
    mesh: Optional[Mesh] = None


def _model_inputs(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    """The model's keyword inputs from a batch of numpy arrays or tensors,
    on ``device``; ``valid`` (B,) and ``sentic_adj`` (B, L, L) are passed on
    when present."""
    keys = BATCH_KEYS + tuple(k for k in OPTIONAL_KEYS if k in batch)
    return {k: torch.as_tensor(batch[k]).to(device) for k in keys}


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def create_train_state(cfg: D2RConfig, total_steps: int = 1000, device="cuda",
                       seed: int = 0, model: Optional[nn.Module] = None,
                       mesh: Optional[Mesh] = None) -> TrainState:
    """A train state on ``device``: ``model`` (moved there) or a fresh
    ``D2RClassifier`` with random weights from ``seed``, in train mode, with
    the 4-group AdamW of ``train/optimizer.py``. With a ``mesh`` of more
    than one process the whole model (the one given, or the seed's, built
    on the CPU) is cut to this rank's slices first. Raises if ``device`` is
    CUDA and no GPU is present."""
    dev = resolve_device(device)
    if mesh is not None and mesh.world > 1:
        model = build_model(cfg, device="cpu", seed=seed) if model is None else model
        model = shard_model(model, mesh).to(dev)
    else:
        mesh = None
        model = build_model(cfg, device=dev, seed=seed) if model is None else model.to(dev)
    optimizer, scheduler = make_optimizer(cfg, total_steps, model.train())
    return TrainState(model, optimizer, scheduler, mesh=mesh)


def _forward_backward(model: nn.Module, batch: Mapping, seed: int,
                      mesh: Optional[Mesh] = None):
    """One train-mode forward and backward; gradients add into ``.grad``."""
    model.train()
    if mesh is not None and mesh.dp > 1:
        seed = fold_in(seed, mesh.data_index)
    rng = DropoutRNG(seed, _device(model))
    loss, logits, aux = model(**_model_inputs(batch, _device(model)), rng=rng)
    loss.backward()
    return loss.detach(), aux


def _check_finite(state: TrainState, loss: torch.Tensor) -> None:
    """``FloatingPointError`` if ``loss`` or any gradient is not finite."""
    named = [(n, p.grad) for n, p in state.model.named_parameters() if p.grad is not None]
    flags = torch.stack([torch.isfinite(loss).all()]
                        + [torch.isfinite(g).all() for _, g in named]).cpu()
    if bool(flags.all()):
        return
    where = ("the loss" if not flags[0] else
             "the gradient of " + next(n for (n, _), ok in zip(named, flags[1:]) if not ok))
    raise FloatingPointError(f"debug_nans: step {state.step}: {where} is not finite "
                             f"(loss {float(loss)})")


@torch.no_grad()
def _mean_over(grads, group, size: int) -> None:
    """Replace each of ``grads`` by its mean over ``group``, in buckets of
    at most :data:`REDUCE_BUCKET` elements."""
    bucket, count = [], 0
    for g in list(grads) + [None]:
        if bucket and (g is None or count + g.numel() > REDUCE_BUCKET):
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat, group=group)
            flat.div_(size)
            torch._foreach_copy_(bucket, [v.view_as(t) for v, t in
                                          zip(flat.split([t.numel() for t in bucket]), bucket)])
            bucket, count = [], 0
        if g is not None:
            bucket.append(g)
            count += g.numel()


def _reduce_gradients(state: TrainState) -> None:
    """The mesh's gradient reduction. Under a model axis, first the mean
    over the model group of the gradients of the tensors it leaves whole:
    every model rank computes them alike, but not always to the bit on the
    card (a scatter-add's order can differ between two processes, e.g. the
    token-type embedding's backward, where every token hits row 0), and
    replicas updated from different bits drift apart; the mean of equal
    values changes nothing. Then the mean of every gradient over the data
    group: the global loss's gradient."""
    mesh = state.mesh
    if mesh is None:
        return
    grads = [p for g in state.optimizer.param_groups for p in g["params"]
             if p.grad is not None]
    if mesh.tp > 1:
        split = {id(getattr(m, name)) for m in state.model.modules()
                 for name in getattr(m, "shards", {})}
        _mean_over([p.grad for p in grads if id(p) not in split], mesh.model_group, mesh.tp)
    if mesh.dp > 1:
        _mean_over([p.grad for p in grads], mesh.data_group, mesh.dp)


def _apply(state: TrainState) -> None:
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1


def make_train_step(debug_nans: bool = False) -> Callable:
    """``train_step(state, batch, dropout_seed) -> (state, metrics)``: one
    optimizer step on ``batch``; metrics are the loss, ce_loss and js_loss
    as device scalars (reading them syncs). The step's gradients stay in the
    parameters' ``.grad`` until the next step."""

    def train_step(state: TrainState, batch: Mapping, dropout_seed: int):
        state.model.zero_grad(set_to_none=True)
        loss, aux = _forward_backward(state.model, batch,
                                      fold_in(dropout_seed, state.step), state.mesh)
        _reduce_gradients(state)
        if debug_nans:
            _check_finite(state, loss)
        _apply(state)
        return state, {"loss": loss, **{k: v.detach() for k, v in aux.items()}}

    return train_step


def _microbatch(stacked: Mapping, i: int) -> Dict:
    return {k: v[i] for k, v in stacked.items()}


def make_multi_step(num_steps: int, debug_nans: bool = False) -> Callable:
    """``multi_step(state, stacked, dropout_seed)``: ``num_steps`` train
    steps over batches stacked on a leading axis, returning
    ``{"loss": last loss, "losses": (num_steps,)}``."""
    single = make_train_step(debug_nans)

    def multi_step(state: TrainState, stacked: Mapping, dropout_seed: int):
        losses = []
        for i in range(num_steps):
            state, metrics = single(state, _microbatch(stacked, i), dropout_seed)
            losses.append(metrics["loss"])
        losses = torch.stack(losses)
        return state, {"loss": losses[-1], "losses": losses}

    return multi_step


def make_accum_step(accum_steps: int, debug_nans: bool = False) -> Callable:
    """``accum_step(state, stacked, dropout_seed)``: ONE optimizer step from
    the gradients averaged over ``accum_steps`` microbatches stacked on a
    leading axis. The microbatches run in order, so train-mode BatchNorm sees
    each as that many sequential steps would; microbatch i's dropout seed
    folds in ``(step, i)``. Returns ``{"loss": mean microbatch loss}``."""

    def accum_step(state: TrainState, stacked: Mapping, dropout_seed: int):
        model = state.model
        model.zero_grad(set_to_none=True)
        step_seed = fold_in(dropout_seed, state.step)
        total = None
        for i in range(accum_steps):
            loss, _ = _forward_backward(model, _microbatch(stacked, i),
                                        fold_in(step_seed, i), state.mesh)
            total = loss.float() if total is None else total + loss.float()
        _reduce_gradients(state)
        with torch.no_grad():
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(accum_steps)
        if debug_nans:
            _check_finite(state, total)
        _apply(state)
        return state, {"loss": total / accum_steps}

    return accum_step


def make_eval_step() -> Callable:
    """``eval_step(state, batch) -> metrics``: an eval-mode forward (no
    dropout, BatchNorm on its running statistics) returning the loss, the
    logits, ce_loss and js_loss."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Mapping) -> Dict[str, torch.Tensor]:
        model = state.model.eval()
        loss, logits, aux = model(**_model_inputs(batch, _device(model)))
        return {"loss": loss, "logits": logits, **aux}

    return eval_step

