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
(``optimizer_impl``: grouped, fused, fused_leaf, multi_transform) and holds
them equal bit for bit in fp32; here every spelling is :class:`AdamW`, one
CUDA kernel a step on the card (``ops/kernels/adamw.py``, ``csrc/adamw.cu``:
optax's operation order, one pass over every parameter) with the count and
the schedule on the device, as JAX keeps ``count`` in its optimizer state
and evaluates the schedule with ``jnp`` in fp32. No host value enters a
step, so the step can be captured in a CUDA graph. Two behaviours of optax
that ``torch.optim.AdamW`` lacks: a parameter that got no gradient steps
with a zero one (optax decays every leaf and moves its moments), and
``adam_mu_dtype="bfloat16"`` keeps the first moments in bf16, as
``optax.scale_by_adam(mu_dtype=...)`` does on the JAX package's grouped
path, the only one that honours it (``d2r_tpu/train/optimizer.py:277-283``).
``freeze_towers`` leaves the pretrained towers out of the optimizer: they
get neither update nor weight decay; with ``optimizer_impl="fused"`` it
raises the JAX package's ``ValueError``.

``torch.optim.AdamW(fused=True)`` is no substitute: it decays the
parameters before the Adam update, another operation order and other bits
than optax's.

Groups are labelled on the port's parameter names mapped back to Flax paths
(``weights.flax_path``), so both packages label the same leaves.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from d2r_tpu_torch.config import ADAM_MU_DTYPES, OPTIMIZER_IMPLS, D2RConfig
from d2r_tpu_torch.ops.kernels import adamw as kernel
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


class AdamW(torch.optim.Optimizer):
    """optax's ``adamw`` (``scale_by_adam`` -> ``add_decayed_weights`` ->
    ``-lr``) in its operation order:

        mu = (1 - b1) g + b1 mu          nu = (1 - b2) g^2 + b2 nu
        u = (mu / c1) / (sqrt(nu / c2) + eps) + wd p,   p = p + (-lr) u

    with ``c = 1 - b^t`` in fp32 at the post-increment count t and ``lr`` the
    group's base lr times the schedule's factor at the
    pre-increment count, in fp32 (HF's linear warmup then linear decay
    with a fractional warmup, ``ops/kernels/adamw.py::schedule_plain``, as
    the JAX package's ``linear_warmup_decay`` evaluates it with ``jnp``).
    The count is a one-element fp32 tensor on
    the parameters' device (:attr:`count`, the ``step`` of every parameter's
    state); the update reads it and increments it on the device. A
    parameter whose ``.grad`` is None gets a zero gradient tensor, kept
    from then on, so it still decays and its moments still move. With
    ``mu_dtype="bfloat16"`` the first moment is stored in bf16 and updated
    as optax updates it: ``b1 * mu`` in bf16 (b1 rounded to bf16, as JAX
    rounds a Python scalar against a bf16 array), plus ``(1 - b1) g`` in
    fp32; that fp32 mu feeds the update, and is rounded to bf16 only for
    storage. The state keeps ``torch.optim.AdamW``'s keys (``step``,
    ``exp_avg``, ``exp_avg_sq``), so either's state dict loads into the
    other.

    On the card a step is one kernel launch (plus the count's increment)
    through a device table of the tensors' addresses, rebuilt only when a
    gradient or moment moves; on the CPU it is the kernel's plain twin."""

    def __init__(self, params, lr: float, betas=BETAS, eps: float = EPS,
                 weight_decay: float = WEIGHT_DECAY, mu_dtype: str = "float32",
                 warmup_steps: float = 0.0, total_steps: int = 1):
        if mu_dtype not in ADAM_MU_DTYPES:
            raise ValueError(f"unknown mu_dtype {mu_dtype!r}")
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay, mu_dtype=mu_dtype))
        self.schedule = kernel.schedule(warmup_steps, total_steps)
        self.count: Optional[torch.Tensor] = None
        self._table = None

    def __setstate__(self, state) -> None:
        super().__setstate__(state)
        for group in self.param_groups:   # a torch.optim.AdamW state dict has none
            group.setdefault("mu_dtype", "float32")

    def _device(self) -> torch.device:
        return self.param_groups[0]["params"][0].device

    def _link_count(self, value: Optional[torch.Tensor] = None) -> None:
        """Make :attr:`count` (set to ``value`` when given) the ``step`` of
        every parameter's state."""
        if self.count is None:
            self.count = torch.zeros((), dtype=torch.float32, device=self._device())
        if value is not None:
            self.count.copy_(value.reshape(()))
        for st in self.state.values():
            if st:
                st["step"] = self.count

    def load_state_dict(self, state_dict) -> None:
        """As ``Optimizer.load_state_dict``, which casts every moment to its
        parameter's dtype; bf16 first moments go back to bf16 (exact). The
        count takes the saved ``step`` (every parameter's is the same).
        A group saved with the ``LambdaLR`` of earlier versions holds the
        scheduled lr under ``lr`` and the base lr under ``initial_lr``: the
        base lr is restored. Moments the optimizer already holds are
        overwritten in place, so a captured step that reads them stays
        valid."""
        held = {p: dict(st) for p, st in self.state.items()}
        super().load_state_dict(state_dict)
        steps = []
        for group in self.param_groups:
            if "initial_lr" in group:
                group["lr"] = group.pop("initial_lr")
            mu_dtype = getattr(torch, group["mu_dtype"])
            for p in group["params"]:
                st = self.state.get(p)
                if not st or "exp_avg" not in st:
                    continue
                st["exp_avg"] = st["exp_avg"].to(mu_dtype)
                steps.append(st["step"])
                for k in ("exp_avg", "exp_avg_sq"):
                    old = held.get(p, {}).get(k)
                    if old is not None and old.shape == st[k].shape and old.dtype == st[k].dtype:
                        st[k] = old.copy_(st[k])
        self._link_count(steps[0].to(self._device(), torch.float32) if steps else None)

    def set_count(self, steps: int) -> None:
        """Set the count to ``steps`` (the schedule's position)."""
        self._link_count(torch.tensor(float(steps)))

    def _groups(self):
        """(params, grads, mus, nus, base lr) of each group, the state made
        at the first step as ``torch.optim.AdamW`` makes it."""
        self._link_count()
        out = []
        for group in self.param_groups:
            params = group["params"]
            mu_dtype = getattr(torch, group["mu_dtype"])
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                st = self.state[p]
                if not st:
                    st["step"] = self.count
                    st["exp_avg"] = torch.zeros_like(p, dtype=mu_dtype)
                    st["exp_avg_sq"] = torch.zeros_like(p)
            out.append((params, [p.grad for p in params],
                        [self.state[p]["exp_avg"] for p in params],
                        [self.state[p]["exp_avg_sq"] for p in params], group["lr"]))
        return out

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        groups = [g for g in self._groups() if g[0]]
        if not groups:
            return
        betas, eps, wd = (self.param_groups[0][k] for k in ("betas", "eps", "weight_decay"))
        self._table = kernel.adamw_update(groups, self.count, kernel.hyper(betas, eps, wd),
                                          self.schedule, self._table)

    def lrs(self) -> Dict[str, torch.Tensor]:
        """Each group's lr at the current count (fp32 device scalars), by
        group name: what the next step applies."""
        self._link_count()
        factor = kernel.schedule_plain(self.count, self.schedule)
        return {g.get("name", str(i)): torch.tensor(kernel._f32(g["lr"]),
                                                    device=factor.device) * factor
                for i, g in enumerate(self.param_groups)}


def make_optimizer(cfg: D2RConfig, total_steps: int, model: nn.Module) -> AdamW:
    """:class:`AdamW` over the four groups of ``model``'s parameters, with
    the schedule over ``total_steps``. The first moments are bf16 only for
    ``adam_mu_dtype="bfloat16"`` with ``optimizer_impl="grouped"``, as in
    the JAX package; ``freeze_towers`` with ``optimizer_impl="fused"``
    raises its ``ValueError``."""
    if cfg.optimizer_impl not in OPTIMIZER_IMPLS:
        raise ValueError(f"unknown optimizer_impl: {cfg.optimizer_impl!r}")
    if cfg.freeze_towers and cfg.optimizer_impl == "fused":
        raise ValueError("freeze_towers is incompatible with optimizer_impl='fused'; use "
                         "'grouped' (default), 'fused_leaf', or 'multi_transform'")
    params = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        path = flax_path(model, name)
        if cfg.freeze_towers and not is_trainable(path):
            continue
        params[param_group_label(path)].append(p)
    groups = [{"params": params[g], "lr": cfg.fc_lr if g == "fc" else cfg.lr, "name": g}
              for g in GROUPS if params[g]]
    mu_dtype = cfg.adam_mu_dtype if cfg.optimizer_impl == "grouped" else "float32"
    return AdamW(groups, lr=cfg.lr, mu_dtype=mu_dtype,
                 warmup_steps=cfg.warmup_ratio * total_steps, total_steps=total_steps)
