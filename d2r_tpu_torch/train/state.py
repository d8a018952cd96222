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
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import torch
from torch import nn

from d2r_tpu_torch.config import D2RConfig, resolve_device
from d2r_tpu_torch.models.layers import DropoutRNG
from d2r_tpu_torch.models.unimo import build_model
from d2r_tpu_torch.train.optimizer import make_optimizer

BATCH_KEYS = ("input_ids", "attention_mask", "token_type_ids", "labels",
              "pixel_values")
_M64 = (1 << 64) - 1


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def fold_in(seed: int, data: int) -> int:
    """A 64-bit seed derived from ``(seed, data)``, the part
    ``jax.random.fold_in`` plays for keys."""
    return _splitmix64((_splitmix64(int(seed) & _M64) + int(data)) & _M64)


def _model_inputs(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    """The model's keyword inputs from a batch of numpy arrays or tensors,
    on ``device``; ``valid`` (B,) is passed on when present."""
    keys = BATCH_KEYS + (("valid",) if "valid" in batch else ())
    return {k: torch.as_tensor(batch[k]).to(device) for k in keys}


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def create_train_state(cfg: D2RConfig, total_steps: int = 1000, device="cuda",
                       seed: int = 0, model: Optional[nn.Module] = None) -> TrainState:
    """A train state on ``device``: ``model`` (moved there) or a fresh
    ``D2RClassifier`` with random weights from ``seed``, in train mode, with
    the 4-group AdamW of ``train/optimizer.py``. Raises if ``device`` is
    CUDA and no GPU is present."""
    dev = resolve_device(device)
    model = build_model(cfg, device=dev, seed=seed) if model is None else model.to(dev)
    optimizer, scheduler = make_optimizer(cfg, total_steps, model.train())
    return TrainState(model, optimizer, scheduler)


def _forward_backward(model: nn.Module, batch: Mapping, seed: int):
    """One train-mode forward and backward; gradients add into ``.grad``."""
    model.train()
    rng = DropoutRNG(seed, _device(model))
    loss, logits, aux = model(**_model_inputs(batch, _device(model)), rng=rng)
    loss.backward()
    return loss.detach(), aux


def _apply(state: TrainState) -> None:
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1


def make_train_step() -> Callable:
    """``train_step(state, batch, dropout_seed) -> (state, metrics)``: one
    optimizer step on ``batch``; metrics are the loss, ce_loss and js_loss
    as device scalars (reading them syncs). The step's gradients stay in the
    parameters' ``.grad`` until the next step."""

    def train_step(state: TrainState, batch: Mapping, dropout_seed: int):
        state.model.zero_grad(set_to_none=True)
        loss, aux = _forward_backward(state.model, batch,
                                      fold_in(dropout_seed, state.step))
        _apply(state)
        return state, {"loss": loss, **{k: v.detach() for k, v in aux.items()}}

    return train_step


def _microbatch(stacked: Mapping, i: int) -> Dict:
    return {k: v[i] for k, v in stacked.items()}


def make_multi_step(num_steps: int) -> Callable:
    """``multi_step(state, stacked, dropout_seed)``: ``num_steps`` train
    steps over batches stacked on a leading axis, returning
    ``{"loss": last loss, "losses": (num_steps,)}``."""
    single = make_train_step()

    def multi_step(state: TrainState, stacked: Mapping, dropout_seed: int):
        losses = []
        for i in range(num_steps):
            state, metrics = single(state, _microbatch(stacked, i), dropout_seed)
            losses.append(metrics["loss"])
        losses = torch.stack(losses)
        return state, {"loss": losses[-1], "losses": losses}

    return multi_step


def make_accum_step(accum_steps: int) -> Callable:
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
                                        fold_in(step_seed, i))
            total = loss.float() if total is None else total + loss.float()
        with torch.no_grad():
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(accum_steps)
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

