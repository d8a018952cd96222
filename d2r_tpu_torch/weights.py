"""Move weights between a Flax variable tree of the JAX package and the
port's model: :func:`load_jax_variables` / :func:`from_jax_variables` load
one, :func:`to_jax_variables` writes the port's parameters and buffers back
out as one, in Flax names and layouts.

The port's modules carry the Flax module names, so a Flax leaf
``params/model/.../qkv/kernel`` lands on the port module
``model. ... .qkv``; only the leaf name and layout change, by module type:

=================  ==========================  ===============================
port module        Flax leaf                   port tensor
=================  ==========================  ===============================
TorchLinear        kernel (in, out), bias      weight (out, in), bias
QKVDense           kernel (in, 3, h), (3, h)   weight (3h, in), bias (3h,)
Embed              embedding (n, d)            weight (n, d)
LayerNorm          scale, bias                 weight, bias
PatchConv          kernel HWIO                 weight OIHW
TorchBatchNorm     scale, bias; batch_stats    weight, bias; running_mean,
                   mean, var                   running_var
any other          the leaf's own name         the parameter of that name
=================  ==========================  ===============================

(``AttentionFiltration``'s ``attn_sim_w_kernel`` (in, 1), ``BlockFusion``'s
stacked ``merge_kernel{0,1}``/``merge_bias{0,1}`` and the vision tower's
``class_embedding`` keep their names and layouts.)

Coverage is strict in both directions: a Flax leaf with no place in the
port, a port parameter or buffer that no leaf sets (or that maps to no
leaf), or a shape that differs, raises and names the key.

A model whose config sets ``scan_layers`` reads and writes the JAX
package's scanned layout: each tower's blocks as ONE subtree
``layers_scanned/layer`` whose leaves stack the blocks' leaves on a leading
(N,) axis (``d2r_tpu/utils/weights.py:213-270``, :func:`stack_tower_layers`).
The port runs the same loop of blocks either way; only the tree differs.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from d2r_tpu_torch.config import D2RConfig
from d2r_tpu_torch.models.layers import Embed, LayerNorm, QKVDense, TorchBatchNorm, TorchLinear
from d2r_tpu_torch.models.unimo import D2RClassifier
from d2r_tpu_torch.models.vit import PatchConv


def _flatten(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


TOWERS = ("encoder_text_layers", "encoder_vision_layers")


def _map_towers(tree: Mapping, fn) -> dict:
    """``tree`` with ``fn`` applied to each tower subtree (:data:`TOWERS`),
    found at any depth; everything else passes through."""
    return {k: (fn(v) if k in TOWERS else _map_towers(v, fn) if isinstance(v, Mapping) else v)
            for k, v in tree.items()}


def _tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (nested mappings)."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def _layer_names(tower: Mapping):
    return sorted((k for k in tower if k.startswith("layer_")), key=lambda k: int(k[6:]))


def stack_tower_layers(tree: Mapping) -> dict:
    """Per-layer tower subtrees ``{'layer_0': t0, ..., 'layer_{N-1}'}`` ->
    ``{'layers_scanned': {'layer': stacked}}``, each leaf stacked on a new
    leading (N,) axis: the layout of the JAX package's ``nn.scan`` over its
    blocks (``scan_layers``). Everything else passes through."""

    def stack(tower):
        names = _layer_names(tower)
        if not names:
            return tower
        rest = {k: v for k, v in tower.items() if k not in names}
        stacked = _tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                            *(tower[n] for n in names))
        return {"layers_scanned": {"layer": stacked}, **rest}

    return _map_towers(tree, stack)


def unstack_tower_layers(tree: Mapping) -> dict:
    """The inverse of :func:`stack_tower_layers`; a tower without
    ``layers_scanned`` passes through."""

    def unstack(tower):
        if "layers_scanned" not in tower:
            return tower
        stacked = tower["layers_scanned"]["layer"]
        first = stacked
        while isinstance(first, Mapping):
            first = next(iter(first.values()))
        out = {f"layer_{i}": _tree_map(lambda x, i=i: np.asarray(x)[i], stacked)
               for i in range(np.shape(first)[0])}
        out.update({k: v for k, v in tower.items() if k != "layers_scanned"})
        return out

    return _map_towers(tree, unstack)


def _scanned(model: nn.Module) -> bool:
    cfg = getattr(model, "cfg", None)
    return bool(getattr(cfg, "scan_layers", False))


def _translate(module: nn.Module, leaf: str, a: np.ndarray):
    """(port tensor name, array in the port's layout), or None if the module
    has no such leaf."""
    if isinstance(module, TorchLinear):
        table = {"kernel": ("weight", a.T), "bias": ("bias", a)}
    elif isinstance(module, QKVDense):
        table = {"kernel": ("weight", a.reshape(a.shape[0], -1).T),
                 "bias": ("bias", a.reshape(-1))}
    elif isinstance(module, Embed):
        table = {"embedding": ("weight", a)}
    elif isinstance(module, LayerNorm):
        table = {"scale": ("weight", a), "bias": ("bias", a)}
    elif isinstance(module, PatchConv):
        table = {"kernel": ("weight", a.transpose(3, 2, 0, 1))}
    elif isinstance(module, TorchBatchNorm):
        table = {"scale": ("weight", a), "bias": ("bias", a),
                 "mean": ("running_mean", a), "var": ("running_var", a)}
    else:
        table = {name: (name, a) for name, _ in module.named_parameters(recurse=False)}
    return table.get(leaf)


def load_jax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Set every parameter and buffer of ``model`` from the Flax tree
    ``{"params": ..., "batch_stats": ...}`` (nested mappings of arrays), in
    place. When ``model.cfg.scan_layers`` is set, every tower of the tree
    must be in the scanned layout."""
    if _scanned(model):
        def scanned(tower):
            if "layers_scanned" not in tower or _layer_names(tower):
                raise KeyError("scan_layers is set but a tower of the Flax tree is not in "
                               "the scanned layout (layers_scanned/layer)")
            return tower
        variables = {c: unstack_tower_layers(_map_towers(t, scanned))
                     for c, t in variables.items()}
    expected = model.state_dict()
    state: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(collection, {})):
            flax_key = "/".join((collection,) + path)
            try:
                module = model.get_submodule(".".join(path[:-1]))
            except AttributeError:
                raise KeyError(f"Flax leaf {flax_key!r} has no module in the port") from None
            got = _translate(module, path[-1], np.asarray(arr, dtype=np.float32))
            if got is None:
                raise KeyError(f"Flax leaf {flax_key!r} has no tensor in the port's "
                               f"{type(module).__name__}")
            name, value = got
            key = ".".join(path[:-1] + (name,))
            if key in state:
                raise KeyError(f"Flax leaf {flax_key!r} sets port key {key!r} twice")
            t = torch.tensor(np.ascontiguousarray(value))
            if key not in expected or tuple(t.shape) != tuple(expected[key].shape):
                raise ValueError(
                    f"Flax leaf {flax_key!r} -> {key!r}: shape {tuple(t.shape)}, port "
                    f"has {tuple(expected[key].shape) if key in expected else 'no such key'}")
            state[key] = t
    missing = sorted(set(expected) - set(state))
    if missing:
        raise KeyError(f"port keys with no Flax leaf: {missing[:10]}"
                       + (f" and {len(missing) - 10} more" if len(missing) > 10 else ""))
    model.load_state_dict(state, strict=True)
    return model


def from_jax_variables(cfg: D2RConfig, variables: Mapping) -> D2RClassifier:
    """A port ``D2RClassifier`` on the CPU, in fp32 and eval mode, holding the
    weights of the JAX package's ``D2RClassifier(cfg)`` variables."""
    return load_jax_variables(D2RClassifier(cfg), variables).eval()


def _to_flax(module: nn.Module, name: str, t: np.ndarray):
    """(collection, Flax leaf name, array in the Flax layout) of the port
    tensor ``name`` of ``module``: the inverse of :func:`_translate`."""
    if isinstance(module, TorchLinear):
        table = {"weight": ("kernel", lambda a: a.T), "bias": ("bias", None)}
    elif isinstance(module, QKVDense):
        h = module.hidden
        table = {"weight": ("kernel", lambda a: a.T.reshape(a.shape[1], 3, h)),
                 "bias": ("bias", lambda a: a.reshape(3, h))}
    elif isinstance(module, Embed):
        table = {"weight": ("embedding", None)}
    elif isinstance(module, LayerNorm):
        table = {"weight": ("scale", None), "bias": ("bias", None)}
    elif isinstance(module, PatchConv):
        table = {"weight": ("kernel", lambda a: a.transpose(2, 3, 1, 0))}
    elif isinstance(module, TorchBatchNorm):
        table = {"weight": ("scale", None), "bias": ("bias", None),
                 "running_mean": ("mean", None), "running_var": ("var", None)}
    else:
        table = {n: (n, None) for n, _ in module.named_parameters(recurse=False)}
    if name not in table:
        return None
    leaf, fn = table[name]
    collection = "batch_stats" if name.startswith("running_") else "params"
    return collection, leaf, (t if fn is None or t is None else fn(t))


def flax_path(model: nn.Module, key: str) -> str:
    """The '/'-joined Flax path (collection left out) of the port's
    parameter or buffer ``key``, e.g. ``fc.weight`` -> ``fc/kernel``."""
    *prefix, name = key.split(".")
    got = _to_flax(model.get_submodule(".".join(prefix)), name, None)
    if got is None:
        raise KeyError(f"port key {key!r} has no Flax leaf")
    return "/".join(prefix + [got[1]])


def to_jax_variables(model: nn.Module) -> Dict[str, dict]:
    """The port model's parameters and buffers as the Flax tree
    ``{"params": ..., "batch_stats": ...}`` of numpy fp32 arrays in Flax
    layouts (the scanned one when ``model.cfg.scan_layers`` is set), which
    :func:`load_jax_variables` takes back unchanged."""
    tree: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for key, t in model.state_dict().items():
        *prefix, name = key.split(".")
        # a copy: on the CPU .numpy() would share memory with the live tensor
        got = _to_flax(model.get_submodule(".".join(prefix)), name,
                       t.detach().to("cpu", torch.float32).numpy().copy())
        if got is None:
            raise KeyError(f"port key {key!r} has no Flax leaf")
        collection, leaf, arr = got
        node = tree[collection]
        for part in prefix:
            node = node.setdefault(part, {})
        if leaf in node:
            raise KeyError(f"port key {key!r} sets Flax leaf {leaf!r} twice")
        node[leaf] = np.ascontiguousarray(arr)
    return {c: stack_tower_layers(t) for c, t in tree.items()} if _scanned(model) else tree
