"""The (data, model) process mesh and the tensor-parallel layout
(counterpart of ``d2r_tpu/parallel/mesh.py``).

One process per card: a mesh of ``dp x tp`` processes, rank ``r`` at data
index ``r // tp`` and model index ``r % tp``, the row-major order that
``np.asarray(devices).reshape(shape)`` gives the JAX package's mesh
(``d2r_tpu/parallel/mesh.py:66``). Each data row (the ``tp`` ranks of one
data index) holds one model and reads one slice of the batch; each model
column (the ``dp`` ranks of one model index) holds the same shard of every
parameter and reduces its gradients.

* ``data`` axis: the batch is split; the JS loss's Gram matrices, the SAF
  BatchNorm statistics and the cross-entropy's count stay global through
  the data group's collectives (``parallel/distributed.py``).
* ``model`` axis: the large tower matmuls are sharded by the JAX package's
  path rules (:data:`PARAM_RULES`, matched against each parameter's Flax
  path): head-aligned QKV and MLP up-projections by output features
  (column-parallel), the attention output and MLP down-projections by input
  features (row-parallel, bias added once after the sum), the word
  embeddings by vocabulary rows, and the cross-modal alignments'
  query/key/value by output features (gathered before their replicated
  consumers, as GSPMD would). Attention runs K1 and K2 on each rank's own
  heads. A dimension the model axis does not divide stays replicated, as
  ``make_param_shardings`` leaves it.

Differences from the JAX package, by design: the product of the mesh must
equal the world (JAX would quietly take the first ``n`` devices); and
``--mesh_topology`` keeps process order, which is what JAX itself does off a
TPU. Pipeline stages, and ``seq_shard`` and ``fabric_shard`` under a model
axis larger than 1, are not here (the config refuses them; with no such
axis JAX reads the two hints as no-ops, and so does the port).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from d2r_tpu_torch.models.layers import Embed, QKVDense
from d2r_tpu_torch.parallel import distributed
from d2r_tpu_torch.weights import _to_flax, _translate, flax_path

DATA_AXIS = "data"
MODEL_AXIS = "model"

# Matched in order against '/'-joined Flax parameter paths (a copy of
# d2r_tpu/parallel/mesh.py:83-100). Each spec names, per axis of the Flax
# leaf, the mesh axis it is split over.
PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # fused head-aligned qkv (in, 3, h): shard the per-projection hidden axis
    (r"(qkv|sa_qkv)/kernel$", (None, None, MODEL_AXIS)),
    (r"(qkv|sa_qkv)/bias$", (None, MODEL_AXIS)),
    # separate attention projections: shard output features (heads)
    (r"(query|key|value|q_proj|k_proj|v_proj)/kernel$", (None, MODEL_AXIS)),
    (r"(query|key|value|q_proj|k_proj|v_proj)/bias$", (MODEL_AXIS,)),
    # attention output projection: shard input features
    (r"(attention_output/dense|out_proj)/kernel$", (MODEL_AXIS, None)),
    # MLP up-projection: shard hidden
    (r"(intermediate_dense|mlp_fc1)/kernel$", (None, MODEL_AXIS)),
    (r"(intermediate_dense|mlp_fc1)/bias$", (MODEL_AXIS,)),
    # MLP down-projection: shard input
    (r"(output_dense|mlp_fc2)/kernel$", (MODEL_AXIS, None)),
    # embeddings: shard vocab rows
    (r"word_embeddings/embedding$", (MODEL_AXIS, None)),
)


class Mesh:
    """This process's place in a ``dp x tp`` mesh and its two groups:
    ``data_group`` (the ranks of its model column, None when dp = 1) and
    ``model_group`` (the ranks of its data row, None when tp = 1).
    ``device`` is this process's card (or the CPU)."""

    def __init__(self, dp: int, tp: int, rank: int, device, data_group=None,
                 model_group=None):
        self.dp, self.tp, self.rank = dp, tp, rank
        self.device = torch.device(device)
        self.data_group, self.model_group = data_group, model_group

    @property
    def world(self) -> int:
        return self.dp * self.tp

    @property
    def data_index(self) -> int:
        return self.rank // self.tp

    @property
    def model_index(self) -> int:
        return self.rank % self.tp

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes in JAX's ``("data", "model")`` order; the model axis
        only when it is larger than 1, as the CLI names the axes."""
        return {DATA_AXIS: self.dp, **({MODEL_AXIS: self.tp} if self.tp > 1 else {})}

    @property
    def data_shard(self) -> Optional[Tuple[int, int]]:
        """``DataLoader(process_shard=...)`` of this rank: its data index of
        ``dp`` (the model ranks of a data row load the same rows), None when
        the batch is not split."""
        return (self.data_index, self.dp) if self.dp > 1 else None

    @property
    def collective_device(self) -> torch.device:
        """Where host-side values go for a collective: the card under NCCL,
        the CPU under gloo."""
        if self.world > 1 and dist.get_backend() == "nccl":
            return self.device
        return torch.device("cpu")

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier()

    def __deepcopy__(self, memo):
        return self   # process groups are not copied with a module


def make_mesh(mesh_shape: Sequence[int] = (-1,),
              axis_names: Sequence[str] = (DATA_AXIS,), device="cpu") -> Mesh:
    """The mesh of this process's world (one process when there is no
    process group). A single -1 absorbs the world. The product must equal
    the world size: the error names how to start the processes. Every
    process calls this with the same arguments: the groups are made
    collectively."""
    if len(mesh_shape) != len(axis_names):
        raise ValueError(f"mesh_shape {tuple(mesh_shape)} and axis names "
                         f"{tuple(axis_names)} differ in length")
    unknown = set(axis_names) - {DATA_AXIS, MODEL_AXIS}
    if unknown:
        raise NotImplementedError(f"mesh axes {sorted(unknown)}: the port's mesh has the "
                                  f"axes {DATA_AXIS!r} and {MODEL_AXIS!r}")
    rank, world = distributed.world()
    shape = dict(zip(axis_names, mesh_shape))
    if list(mesh_shape).count(-1) > 1:
        raise ValueError(f"mesh_shape {tuple(mesh_shape)}: at most one -1")
    known = 1
    for size in shape.values():
        known *= size if size != -1 else 1
    for name, size in shape.items():
        if size == -1:
            shape[name] = world // known
    dp, tp = shape.get(DATA_AXIS, 1), shape.get(MODEL_AXIS, 1)
    if dp < 1 or tp < 1 or dp * tp != world:
        need = f"a multiple of {known}" if -1 in mesh_shape else f"{dp * tp}"
        raise ValueError(
            f"mesh {dict(zip(axis_names, mesh_shape))} needs {need} processes, one per "
            f"card, and the world has {world} process{'es' if world > 1 else ''}: start "
            f"them with --coordinator_address HOST:PORT --num_processes N --process_id "
            f"RANK (or --num_processes -1 under a launcher such as torchrun)")
    data_group = model_group = None
    if world > 1:
        # every process makes every group, in one order
        for m in range(tp):
            g = dist.new_group([d * tp + m for d in range(dp)]) if dp > 1 else None
            if rank % tp == m:
                data_group = g
        for d in range(dp):
            g = dist.new_group([d * tp + m for m in range(tp)]) if tp > 1 else None
            if rank // tp == d:
                model_group = g
    return Mesh(dp, tp, rank, device, data_group, model_group)


def mesh_for(cfg, device="cpu") -> Mesh:
    """The mesh of ``cfg.mesh_shape`` / ``mesh_axis_names`` over this
    process's world. ``cfg.mesh_topology`` changes nothing: ranks keep
    process order, as the JAX package's devices do off a TPU."""
    return make_mesh(cfg.mesh_shape, cfg.mesh_axis_names, device)


def param_partition_spec(path: str) -> Tuple[Optional[str], ...]:
    """The spec of the Flax leaf at ``path`` under a model axis (``()`` =
    replicated). In a scanned tower (``layers_scanned``) the leaf has a
    leading (num_layers,) axis, which stays unsplit: the rule shifts one
    axis right."""
    for pattern, spec in PARAM_RULES:
        if re.search(pattern, path):
            return (None, *spec) if "layers_scanned" in path else spec
    return ()


def _flax_view(module: nn.Module, name: str, t: torch.Tensor) -> torch.Tensor:
    return _to_flax(module, name, t)[2]


def _port_view(module: nn.Module, name: str, a: torch.Tensor) -> torch.Tensor:
    leaf = _to_flax(module, name, None)[1]
    return _translate(module, leaf, a)[1]


def _shard_axis(model: nn.Module, key: str, tp: int) -> Optional[int]:
    """The axis of the Flax leaf of port tensor ``key`` that the model axis
    splits, or None (no rule, or a size the axis does not divide)."""
    *prefix, name = key.split(".")
    module = model.get_submodule(".".join(prefix))
    spec = param_partition_spec(flax_path(model, key))
    if MODEL_AXIS not in spec:
        return None
    axis = spec.index(MODEL_AXIS)
    shape = _flax_view(module, name, getattr(module, name).detach()).shape
    return axis if len(spec) <= len(shape) and shape[axis] % tp == 0 else None


def local_slice(module: nn.Module, name: str, full: torch.Tensor, axis: int,
                tp: int, index: int) -> torch.Tensor:
    """Model rank ``index``'s slice of ``module``'s tensor ``name`` (port
    layout): cut in the Flax layout, so a QKV weight keeps whole heads of
    each of q, k and v."""
    a = _flax_view(module, name, full)
    k = a.shape[axis] // tp
    return _port_view(module, name, a.narrow(axis, index * k, k)).contiguous().clone()


def gather_full(module: nn.Module, name: str, local: torch.Tensor, axis: int,
                mesh: Mesh) -> torch.Tensor:
    """The whole tensor from the model ranks' slices (port layout); every
    rank of the model group calls it."""
    a = _flax_view(module, name, local)
    return _port_view(module, name, distributed._gather(a.contiguous(), mesh.model_group, axis))


def _check_layout(model: nn.Module) -> None:
    """Raise on a layout the port's layers cannot run: a Megatron pair with
    one side split and the other replicated, or a head-sharded projection
    whose shard is not whole heads."""
    from d2r_tpu_torch.models.bert import BertLayer, BertSelfAttention
    from d2r_tpu_torch.models.cells import IntraModelReasoningCell
    from d2r_tpu_torch.models.vit import CLIPAttention, CLIPEncoderLayer

    for name, m in model.named_modules():
        if isinstance(m, BertLayer):
            pairs = ((m.attention_self.qkv, m.attention_output.dense),
                     (m.intermediate_dense, m.output_dense))
        elif isinstance(m, CLIPEncoderLayer):
            pairs = ((m.self_attn.qkv, m.self_attn.out_proj), (m.mlp_fc1, m.mlp_fc2))
        else:
            pairs = ()
        for up, down in pairs:
            if (up.tp is None) != (down.tp is None):
                raise NotImplementedError(
                    f"{name}: the model axis splits one of a column/row-parallel pair and "
                    f"not the other; pick --mesh_model dividing both (ROADMAP.md Queue 3)")
        if isinstance(m, (BertSelfAttention, CLIPAttention, IntraModelReasoningCell)):
            qkv = m.sa_qkv if isinstance(m, IntraModelReasoningCell) else m.qkv
            if qkv.tp is not None and qkv.hidden % m.head_dim:
                raise NotImplementedError(
                    f"{name}: a model shard of {qkv.hidden} features is not whole heads of "
                    f"{m.head_dim}; --mesh_model must divide the head count")


def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Give every module of ``model`` the mesh and keep only this rank's
    slice of each parameter that :data:`PARAM_RULES` split, in place: the
    modules then run their collectives (``TorchLinear.tp`` "column" or
    "row", ``QKVDense.tp`` "column" with ``hidden`` the local width,
    ``Embed.tp`` "vocab"). Call it on the whole model, built from the seed
    or loaded as one process would, before the optimizer exists. Each split
    module records its tensors' split Flax axes in ``shards``. Raises on
    the layout settings the port refuses under this model axis
    (``D2RConfig.check_supported``)."""
    if getattr(model, "cfg", None) is not None:
        model.cfg.check_supported(mesh.world, model_axis=mesh.tp)
    for m in model.modules():
        if hasattr(m, "mesh"):
            m.mesh = mesh
    if mesh.tp == 1:
        return model
    for key in [k for k, _ in model.named_parameters()]:
        axis = _shard_axis(model, key, mesh.tp)
        if axis is None:
            continue
        *prefix, name = key.split(".")
        module = model.get_submodule(".".join(prefix))
        p = getattr(module, name)
        local = local_slice(module, name, p.detach(), axis, mesh.tp, mesh.model_index)
        setattr(module, name, nn.Parameter(local, requires_grad=p.requires_grad))
        module.shards = {**module.shards, name: axis}
    for m in model.modules():
        if not getattr(m, "shards", None):
            continue
        if isinstance(m, QKVDense):       # q, k and v keep hidden/tp rows each
            m.hidden //= mesh.tp
            m.tp = "column"
        elif isinstance(m, Embed):
            m.tp = "vocab"
        else:                             # TorchLinear: the Flax kernel is (in, out)
            m.tp = "column" if m.shards["weight"] == 1 else "row"
    _check_layout(model)
    return model


def _sharded(model: nn.Module, key: str):
    """(module, name, axis) of a split tensor ``key``, or None."""
    *prefix, name = key.split(".")
    module = model.get_submodule(".".join(prefix))
    axis = getattr(module, "shards", {}).get(name)
    return None if axis is None else (module, name, axis)


def full_state_dict(model: nn.Module, mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every split tensor gathered whole: the
    state dict one process would hold, whatever the mesh (every rank of a
    model group calls it)."""
    state = model.state_dict()
    if mesh is None or mesh.tp == 1:
        return state
    for key in state:
        got = _sharded(model, key)
        if got is not None:
            module, name, axis = got
            state[key] = gather_full(module, name, state[key], axis, mesh)
    return state


def local_state_dict(model: nn.Module, mesh: Optional[Mesh],
                     full: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A whole state dict (one process's, any mesh's) cut to this rank's
    slices of ``model``."""
    if mesh is None or mesh.tp == 1:
        return full
    out = dict(full)
    for key in full:
        got = _sharded(model, key)
        if got is not None:
            module, name, axis = got
            out[key] = local_slice(module, name, full[key], axis, mesh.tp, mesh.model_index)
    return out


def _moment_keys(model: nn.Module, optimizer) -> Dict[int, str]:
    """The optimizer state dict's parameter index -> the parameter's key."""
    names = {id(p): k for k, p in model.named_parameters()}
    index, out = 0, {}
    for group in optimizer.param_groups:
        for p in group["params"]:
            out[index] = names[id(p)]
            index += 1
    return out


def _map_moments(model, optimizer, opt_state, fn):
    """``opt_state`` with ``fn(module, name, axis, tensor)`` applied to the
    moments of every split parameter."""
    keys = _moment_keys(model, optimizer)
    state = {}
    for i, st in opt_state["state"].items():
        got = _sharded(model, keys[int(i)])
        state[i] = st if got is None else {
            k: (fn(*got, v) if isinstance(v, torch.Tensor) and v.dim() else v)
            for k, v in st.items()}
    return {**opt_state, "state": state}


def full_optimizer_state(model, optimizer, mesh: Optional[Mesh]) -> Dict:
    """``optimizer.state_dict()`` with the moments of split parameters
    gathered whole (every rank of a model group calls it)."""
    opt_state = optimizer.state_dict()
    if mesh is None or mesh.tp == 1:
        return opt_state
    return _map_moments(model, optimizer, opt_state,
                        lambda module, name, axis, v: gather_full(module, name, v, axis, mesh))


def local_optimizer_state(model, optimizer, mesh: Optional[Mesh], full: Dict) -> Dict:
    """A whole optimizer state dict cut to this rank's slices."""
    if mesh is None or mesh.tp == 1:
        return full
    return _map_moments(model, optimizer, full,
                        lambda module, name, axis, v: local_slice(
                            module, name, v, axis, mesh.tp, mesh.model_index))


def replica_mismatches(model: nn.Module, mesh: Mesh) -> Dict[str, list]:
    """The keys of this rank's parameters and buffers that differ, bit for
    bit, from the copy the mesh says must be equal: ``"model"``, the tensors
    the model axis leaves whole against the first model rank of this data
    row; ``"data"``, every local tensor against data index 0's rank of this
    model column. Every rank calls it (broadcasts over both groups)."""
    out = {"model": [], "data": []}
    for axis, group, src in (("model", mesh.model_group, mesh.data_index * mesh.tp),
                             ("data", mesh.data_group, mesh.model_index)):
        if group is None:
            continue
        for key, t in model.state_dict().items():
            if axis == "model" and _sharded(model, key) is not None:
                continue
            ref = t.detach().clone()
            dist.broadcast(ref, src=src, group=group)
            if not torch.equal(ref, t):
                out[axis].append(key)
    return out
