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
every spelling is :class:`AdamW` over the four groups plus a ``LambdaLR``.
:class:`AdamW` is optax's ``adamw`` operation for operation, with two
behaviours of optax that ``torch.optim.AdamW`` lacks: a parameter that got
no gradient steps with a zero one (optax decays every leaf and moves its
moments), and ``adam_mu_dtype="bfloat16"`` keeps the first moments in bf16,
as ``optax.scale_by_adam(mu_dtype=...)`` does on the JAX package's grouped
path, the only one that honours it (``d2r_tpu/train/optimizer.py:277-283``).
``freeze_towers`` leaves the pretrained towers out of the optimizer: they
get neither update nor weight decay.

Groups are labelled on the port's parameter names mapped back to Flax paths
(``weights.flax_path``), so both packages label the same leaves.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np

import torch
from torch import nn

from d2r_tpu_torch.config import ADAM_MU_DTYPES, OPTIMIZER_IMPLS, D2RConfig
from d2r_tpu_torch.weights import flax_path

# The modules a pretrained checkpoint fills: freezing them is
# "linear-probe the fabric". Matched by path component.
TOWER_MODULES = frozenset({
    "text_embeddings", "encoder_text_layers",
    "vision_embeddings", "vision_pre_layernorm", "encoder_vision_layers",
})
GROUPS = ("other", "text", "vision", "fc")
BETAS, EPS, WEIGHT_DECAY = (0.9, 0.999), 1e-8, 1e-2
# elements a chunk of the update: its temporaries (five of a chunk's size
# at most, 640 MB) stay far below the moments' own bytes at D2R-large
CHUNK_ELEMENTS = 1 << 25


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


def _chunks(params: List[torch.Tensor]):
    """``params`` in runs of at most :data:`CHUNK_ELEMENTS` elements (a
    larger tensor alone)."""
    run, size = [], 0
    for p in params:
        if run and size + p.numel() > CHUNK_ELEMENTS:
            yield run
            run, size = [], 0
        run.append(p)
        size += p.numel()
    if run:
        yield run


class AdamW(torch.optim.Optimizer):
    """optax's ``adamw`` (``scale_by_adam`` -> ``add_decayed_weights`` ->
    ``-lr``) in its operation order, over ``torch._foreach`` lists:

        mu = (1 - b1) g + b1 mu          nu = (1 - b2) g^2 + b2 nu
        u = (mu / c1) / (sqrt(nu / c2) + eps) + wd p,   p = p + (-lr) u

    with ``c = 1 - b^t`` in fp32 at the post-increment count t. A parameter
    whose ``.grad`` is None gets a zero gradient, so it still decays and
    its moments still move. With ``mu_dtype="bfloat16"`` the first moment is
    stored in bf16 and updated as optax updates it: ``b1 * mu`` in bf16 (b1
    rounded to bf16, as JAX rounds a Python scalar against a bf16 array),
    plus ``(1 - b1) g`` in fp32; that fp32 mu feeds the update, and is
    rounded to bf16 only for storage. The state keeps ``torch.optim.AdamW``'s
    keys (``step``, ``exp_avg``, ``exp_avg_sq``)."""

    def __init__(self, params, lr: float, betas=BETAS, eps: float = EPS,
                 weight_decay: float = WEIGHT_DECAY, mu_dtype: str = "float32"):
        if mu_dtype not in ADAM_MU_DTYPES:
            raise ValueError(f"unknown mu_dtype {mu_dtype!r}")
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay, mu_dtype=mu_dtype))

    def __setstate__(self, state) -> None:
        super().__setstate__(state)
        for group in self.param_groups:   # a torch.optim.AdamW state dict has none
            group.setdefault("mu_dtype", "float32")

    def load_state_dict(self, state_dict) -> None:
        """As ``Optimizer.load_state_dict``, which casts every moment to its
        parameter's dtype; bf16 first moments go back to bf16 (exact)."""
        super().load_state_dict(state_dict)
        for group in self.param_groups:
            mu_dtype = getattr(torch, group["mu_dtype"])
            for p in group["params"]:
                st = self.state.get(p)
                if st and "exp_avg" in st:
                    st["exp_avg"] = st["exp_avg"].to(mu_dtype)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        for group in self.param_groups:
            params = group["params"]
            if not params:
                continue
            b1, b2 = group["betas"]
            mu_dtype = getattr(torch, group["mu_dtype"])
            steps = []
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(p, dtype=mu_dtype)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                steps.append(st["step"])
            torch._foreach_add_(steps, 1.0)
            t = np.float32(steps[0].item())
            c1 = float(np.float32(1.0) - np.float32(b1) ** t)
            c2 = float(np.float32(1.0) - np.float32(b2) ** t)
            for chunk in _chunks(params):
                self._update(chunk, group, b1, b2, c1, c2, mu_dtype)

    def _update(self, params, group, b1, b2, c1, c2, mu_dtype) -> None:
        grads = [p.grad for p in params]
        mus = [self.state[p]["exp_avg"] for p in params]
        nus = [self.state[p]["exp_avg_sq"] for p in params]
        scaled = torch._foreach_mul(grads, 1.0 - b1)
        if mu_dtype == torch.float32:
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, scaled)
            mu = mus
        else:   # b1 (rounded to the storage type) * mu in that type, then the fp32 sum
            b1_low = float(torch.tensor(b1, dtype=mu_dtype))
            mu = scaled
            torch._foreach_add_(mu, torch._foreach_mul(mus, b1_low))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1.0 - b2)
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, sq)
        denom = torch._foreach_div(nus, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, group["eps"])
        update = torch._foreach_div(mu, c1)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(update, torch._foreach_mul(params, group["weight_decay"]))
        torch._foreach_mul_(update, -group["lr"])
        torch._foreach_add_(params, update)
        if mu is not mus:
            torch._foreach_copy_(mus, mu)


def make_optimizer(cfg: D2RConfig, total_steps: int, model: nn.Module
                   ) -> Tuple[AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """:class:`AdamW` over the four groups of ``model``'s parameters, and
    its schedule. Call ``scheduler.step()`` after each ``optimizer.step()``.
    The first moments are bf16 only for ``adam_mu_dtype="bfloat16"`` with
    ``optimizer_impl="grouped"``, as in the JAX package."""
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
    mu_dtype = cfg.adam_mu_dtype if cfg.optimizer_impl == "grouped" else "float32"
    optimizer = AdamW(groups, lr=cfg.lr, mu_dtype=mu_dtype)
    factor = linear_warmup_decay(1.0, cfg.warmup_ratio * total_steps, total_steps)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, factor)
