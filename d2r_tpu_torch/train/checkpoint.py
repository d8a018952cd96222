"""Checkpoints (counterpart of ``d2r_tpu/train/checkpoint.py``).

The port's format is the reference's: ``torch.save(model.state_dict())``,
here as ``model.pth`` in a checkpoint directory (``save_path/best_model/``),
plus ``train_state.pth`` (optimizer, the schedule's position and step) when
the optimizer state is kept, and the run's ``config.json`` beside the directory. The
policy is the JAX package's: the best dev weighted-F1 model, reloaded for
test; ``--save_opt_state`` keeps the optimizer state too; ``--auto_resume``
writes the full train state at every epoch boundary.

The JAX package's Orbax directories are refused with a clear error: its
trees reach the port only through ``weights.from_jax_variables``.

Files are written under a temporary name and renamed into place, so a kill
mid-write never leaves a half-written file under the final name.

``--async_checkpoint`` (``save_checkpoint(async_save=True)``): the state is
copied to host memory at once, so training may go on updating the
parameters, and one process-wide save thread writes the files.
:func:`wait_for_async_saves` blocks until every save handed to it is on
disk and raises the first write's error, if one failed; call it before
reading a path that may have a save in flight and before the process exits.

Across processes (a train state with a ``mesh``): a checkpoint does not
depend on the mesh. Every rank gathers the whole tensors (the split
parameters and their Adam moments, over the model group), rank 0 alone
writes them (every stage's tower blocks gathered over the stage group
too), and the ranks meet at a barrier before anyone reads; with
``async_save`` the gather is synchronous on every rank and only rank 0's
thread writes (``wait_for_async_saves(mesh)`` awaits it, then meets). A
restore reads the whole tensors on every rank and keeps its slices and
its stage's blocks. So a (2, 2) run's ``model.pth`` loads into one
process, and one process's into any mesh; the port's keys do not change
with ``pipeline_stages``, so a pipelined run's checkpoint serves
unpipelined (:func:`restore_model`).
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
from typing import Any, Dict, List, Optional

import torch

from d2r_tpu_torch.config import load_config_json, resolve_device, serving_config
from d2r_tpu_torch.models.unimo import D2RClassifier
from d2r_tpu_torch.parallel.mesh import (
    full_optimizer_state,
    full_state_dict,
    local_optimizer_state,
    local_state_dict,
)

MODEL_FILE = "model.pth"
TRAIN_STATE_FILE = "train_state.pth"
# files of an Orbax checkpoint directory (the JAX package's format)
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")


def _abs(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def _save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _to_host(obj):
    """``obj`` with every tensor replaced by a copy in host memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _write_checkpoint(path: str, model: Dict, train_state: Optional[Dict]) -> None:
    os.makedirs(path, exist_ok=True)
    train_state_file = os.path.join(path, TRAIN_STATE_FILE)
    if train_state is not None:
        _save(train_state, train_state_file)
    elif os.path.exists(train_state_file):
        os.remove(train_state_file)   # an older save's, which no longer matches
    _save(model, os.path.join(path, MODEL_FILE))


# --async_checkpoint: one save thread for the process and the saves handed
# to it, awaited (and their errors raised) by wait_for_async_saves
_SAVER: Optional[cf.ThreadPoolExecutor] = None
_PENDING: List[cf.Future] = []


def wait_for_async_saves(mesh=None) -> None:
    """Block until every asynchronous save is on disk; a save that failed
    raises its error here. With a ``mesh`` the ranks then meet, so none
    reads what rank 0 is still writing."""
    while _PENDING:
        _PENDING.pop(0).result()
    if mesh is not None:
        mesh.barrier()


def save_checkpoint(path: str, state, include_opt_state: bool = False,
                    async_save: bool = False) -> None:
    """Save ``state``'s model (parameters and BatchNorm running statistics)
    under the directory ``path``; with ``include_opt_state`` also the
    optimizer, the schedule and the step. The model file is written last.
    With ``async_save`` the state is copied to host memory now and written
    by the save thread, after any save still in flight."""
    global _SAVER
    path = _abs(path)
    mesh = getattr(state, "mesh", None)   # a TrainState's; any object with .model
    train_state = None
    if include_opt_state:
        # the schedule lives on the device (the optimizer's count); its
        # position is kept under the key the LambdaLR of earlier versions
        # wrote
        train_state = {"optimizer": full_optimizer_state(state.model, state.optimizer, mesh),
                       "scheduler": {"last_epoch": state.step},
                       "step": state.step}
    model = full_state_dict(state.model, mesh)
    if mesh is not None and mesh.rank != 0:
        if not async_save:
            mesh.barrier()
        return
    if not async_save:
        _write_checkpoint(path, model, train_state)
        if mesh is not None:
            mesh.barrier()
        return
    snapshot = (_to_host(model), _to_host(train_state))
    if _SAVER is None:
        _SAVER = cf.ThreadPoolExecutor(max_workers=1, thread_name_prefix="d2r-save")
    _PENDING.append(_SAVER.submit(_write_checkpoint, path, *snapshot))


def checkpoint_bytes(path: str) -> int:
    """Bytes on disk of the checkpoint directory ``path``."""
    path = _abs(path)
    return sum(os.path.getsize(os.path.join(path, f))
               for f in (MODEL_FILE, TRAIN_STATE_FILE)
               if os.path.exists(os.path.join(path, f)))


def _model_file(path: str) -> str:
    path = _abs(path)
    model = os.path.join(path, MODEL_FILE)
    if os.path.isfile(model):
        return model
    if os.path.isdir(path) and any(os.path.exists(os.path.join(path, m))
                                   for m in _ORBAX_MARKERS):
        raise ValueError(
            f"{path} is an Orbax checkpoint of the JAX package; d2r_tpu_torch "
            f"reads only its own format ({MODEL_FILE}). Load a JAX variable "
            f"tree with d2r_tpu_torch.weights.from_jax_variables instead.")
    raise FileNotFoundError(f"no d2r_tpu_torch checkpoint at {path} (no {MODEL_FILE})")


def restore_checkpoint(path: str, state):
    """Load the checkpoint at ``path`` into ``state`` (in place, on the
    model's device) and return it: the model always; the optimizer, schedule
    and step when the checkpoint has them. A checkpoint of another geometry,
    or optimizer state of another parameter grouping, raises."""
    device = next(state.model.parameters()).device
    mesh = getattr(state, "mesh", None)   # a TrainState's; any object with .model
    weights = torch.load(_model_file(path), map_location=device, weights_only=True)
    state.model.load_state_dict(local_state_dict(state.model, mesh, weights))
    train_state = os.path.join(_abs(path), TRAIN_STATE_FILE)
    if os.path.exists(train_state):
        saved = torch.load(train_state, map_location=device, weights_only=True)
        state.optimizer.load_state_dict(
            local_optimizer_state(state.model, state.optimizer, mesh, saved["optimizer"]))
        state.optimizer.set_count(int(saved["scheduler"]["last_epoch"]))
        state.step = int(saved["step"])
    return state


def restore_model(load_path: str, cfg, device="cuda"):
    """The serving counterpart of the JAX package's ``restore_variables``: a
    ``D2RClassifier(cfg)`` in eval mode on ``device`` holding the weights of
    the checkpoint at ``load_path``. Only ``model.pth`` is read; optimizer
    state, when saved, is skipped. A checkpoint of another geometry
    raises. A pipelined config's model comes back unpipelined
    (``config.serving_config``; the weights are the same), as the JAX
    package serves it (``d2r_tpu/serve.py:41-55``)."""
    dev = resolve_device(device)
    model = D2RClassifier(serving_config(cfg))
    model.load_state_dict(torch.load(_model_file(load_path), map_location="cpu",
                                     weights_only=True))
    return model.eval().to(dev)


# D2RConfig fields that fix the parameters' shapes and names; the JAX
# package's list. The others (max_seq, batch, lr, ...) may differ between
# training and reload.
GEOMETRY_FIELDS = ("bert_name", "vit_name", "embed_size", "num_head_IMRC",
                   "hid_IMRC", "hid_router", "num_cells", "path_hid",
                   "num_classes", "DR_step", "use_sentic_graph",
                   "scan_layers", "pipeline_stages")


def check_checkpoint_geometry(load_path: str, cfg) -> Optional[str]:
    """Cross-check ``cfg`` against the ``config.json`` in or beside
    ``load_path``. Raises ``ValueError`` listing every differing
    :data:`GEOMETRY_FIELDS` entry; returns the config.json used, or None
    when there is none."""
    root = _abs(load_path).rstrip("/")
    for cand in (os.path.join(root, "config.json"),
                 os.path.join(os.path.dirname(root), "config.json")):
        if not os.path.exists(cand):
            continue
        saved = load_config_json(cand)
        diffs = [(f, getattr(saved, f), getattr(cfg, f))
                 for f in GEOMETRY_FIELDS if getattr(saved, f) != getattr(cfg, f)]
        if diffs:
            lines = "; ".join(f"{f}: checkpoint={a!r} vs flags={b!r}" for f, a, b in diffs)
            raise ValueError(
                f"model geometry mismatch between {cand} and the current flags: "
                f"{lines}. Pass the training-time values (or fix --load_path).")
        return cand
    return None


# Auto-resume (--auto_resume): the full train state alternates between two
# slot directories (epoch parity), and a small JSON meta naming the valid
# slot is published LAST by atomic rename. A kill at any point leaves either
# the old meta (naming the intact previous slot) or the new one (naming the
# finished slot), never a meta naming a half-written slot.

RESUME_SUBDIR = "resume"
_RESUME_META = "resume_meta.json"


def _resume_meta_path(save_path: str) -> str:
    return os.path.join(_abs(save_path), RESUME_SUBDIR, _RESUME_META)


def save_resume_checkpoint(save_path: str, state, meta: Dict[str, Any]) -> None:
    """Write the full train state for ``meta['epoch']`` completed epochs,
    then publish ``meta``."""
    slot = f"slot_{int(meta['epoch']) % 2}"
    save_checkpoint(os.path.join(_abs(save_path), RESUME_SUBDIR, slot), state,
                    include_opt_state=True)
    mesh = getattr(state, "mesh", None)
    if mesh is None or mesh.rank == 0:
        tmp = _resume_meta_path(save_path) + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(dict(meta, slot=slot), f)
        os.replace(tmp, _resume_meta_path(save_path))
    if mesh is not None:
        mesh.barrier()


def load_resume_meta(save_path: str) -> Optional[Dict[str, Any]]:
    """The published resume meta, or None when there is nothing to resume
    (no meta, or it names a slot that is gone)."""
    path = _resume_meta_path(save_path)
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        meta = json.load(f)
    if not os.path.isdir(os.path.join(_abs(save_path), RESUME_SUBDIR, meta["slot"])):
        return None
    return meta


def restore_resume_checkpoint(save_path: str, state, meta: Dict[str, Any]):
    """Restore the full train state named by ``meta``."""
    slot_dir = os.path.join(_abs(save_path), RESUME_SUBDIR, meta["slot"])
    if not os.path.exists(os.path.join(slot_dir, TRAIN_STATE_FILE)):
        raise ValueError(f"resume checkpoint at {slot_dir} has no optimizer state; "
                         f"it was not written by save_resume_checkpoint")
    return restore_checkpoint(slot_dir, state)
