"""Optimizer and learning-rate schedule (counterpart of
``d2r_tpu/train/optimizer.py``).

The reference's 4-group AdamW: groups by substring of the Flax parameter
path, 'fc' (top-level name starting with 'fc', lr ``fc_lr`` = 5e-2), 'text'
('text' in the path), 'vision' ('vision' in the path) and 'other', all at
``lr`` except fc, with weight decay 1e-2 on EVERY parameter (LayerNorm and
biases included), betas (0.9, 0.999) and eps 1e-8. The schedule is HF's
linear warmup then linear decay, with a fractional warmup, multiplying every
group's base lr and evaluated at the pre-increment step, so the first step
runs at lr 0 when there is warmup.

The JAX package lowers this one function four ways for the TPU
(``optimizer_impl``: grouped, fused, fused_leaf, multi_transform); here
every spelling is ``torch.optim.AdamW`` over the four groups plus a
``LambdaLR``. ``freeze_towers`` leaves the pretrained towers out of the
optimizer: they get neither update nor weight decay.

Groups are labelled on the port's parameter names mapped back to Flax paths
(``weights.flax_path``), so both packages label the same leaves.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn

from d2r_tpu_torch.config import OPTIMIZER_IMPLS, D2RConfig
from d2r_tpu_torch.weights import flax_path

# The modules a pretrained checkpoint fills: freezing them is
# "linear-probe the fabric". Matched by path component.
TOWER_MODULES = frozenset({
    "text_embeddings", "encoder_text_layers",
    "vision_embeddings", "vision_pre_layernorm", "encoder_vision_layers",
})
GROUPS = ("other", "text", "vision", "fc")
BETAS, EPS, WEIGHT_DECAY = (0.9, 0.999), 1e-8, 1e-2


def param_group_label(path: str) -> str:
    """The reference's substring grouping of a '/'-joined Flax path, e.g.
    'model/encoder_text_layers/layer_0/attention_self/qkv/kernel'."""
    top = path.split("/", 1)[0]
    if top.startswith("fc"):
        return "fc"
    if "text" in path:
        return "text"
    if "vision" in path:
        return "vision"
    return "other"


def is_trainable(path: str) -> bool:
    """False on the leaves of the pretrained towers."""
    return not any(part in TOWER_MODULES for part in path.split("/"))


def trainable_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> whether ``freeze_towers`` leaves it trainable."""
    return {n: is_trainable(flax_path(model, n)) for n, _ in model.named_parameters()}


def linear_warmup_decay(base_lr: float, warmup_steps: float,
                        total_steps: int) -> Callable[[int], float]:
    """HF ``get_linear_schedule_with_warmup`` with a FLOAT warmup (the
    reference passes ``warmup_ratio * total`` unrounded):

        lr(step) = base_lr * step / max(1, warmup)                if step < warmup
                   base_lr * max(0, (total-step) / max(1, total-warmup))  otherwise
    """
    warmup, total = max(float(warmup_steps), 0.0), float(total_steps)

    def schedule(step: int) -> float:
        if step < warmup:
            return base_lr * step / max(1.0, warmup)
        return base_lr * max(0.0, (total - step) / max(1.0, total - warmup))

    return schedule


def make_optimizer(cfg: D2RConfig, total_steps: int, model: nn.Module
                   ) -> Tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """AdamW over the four groups of ``model``'s parameters, and its
    schedule. Call ``scheduler.step()`` after each ``optimizer.step()``."""
    if cfg.optimizer_impl not in OPTIMIZER_IMPLS:
        raise ValueError(f"unknown optimizer_impl: {cfg.optimizer_impl!r}")
    params = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        path = flax_path(model, name)
        if cfg.freeze_towers and not is_trainable(path):
            continue
        params[param_group_label(path)].append(p)
    groups = [{"params": params[g], "lr": cfg.fc_lr if g == "fc" else cfg.lr, "name": g}
              for g in GROUPS if params[g]]
    optimizer = torch.optim.AdamW(groups, betas=BETAS, eps=EPS, weight_decay=WEIGHT_DECAY)
    factor = linear_warmup_decay(1.0, cfg.warmup_ratio * total_steps, total_steps)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, factor)
