"""The (data, stage, model) process mesh and the tensor- and
pipeline-parallel layout (counterpart of ``d2r_tpu/parallel/mesh.py``).

One process per card: a mesh of ``dp x pp x tp`` processes in JAX's axis
order, rank ``r`` at data index ``r // (pp tp)``, stage index
``(r // tp) % pp`` and model index ``r % tp``, the row-major order that
``np.asarray(devices).reshape(shape)`` gives the JAX package's mesh
(``d2r_tpu/parallel/mesh.py:66``). Each data row (the ``pp x tp`` ranks of
one data index) holds one model and reads one slice of the batch; each
model column (the ``dp`` ranks of one (stage, model) pair) holds the same
shard of every parameter and reduces its gradients.

* ``data`` axis: the batch is split; the JS loss's Gram matrices, the SAF
  BatchNorm statistics and the cross-entropy's count stay global through
  the data group's collectives (``parallel/distributed.py``).
* ``stage`` axis (``--mesh_stage``, ``cfg.pipeline_stages``): each stage
  rank holds only its stage's blocks of the two towers (stage ``s`` of
  ``S`` holds blocks ``[s N/S, (s+1) N/S)``, JAX's ``stages_pipelined``
  leading axis), and runs them in the GPipe schedule of
  ``models/pipeline.py``; everything outside the towers is replicated over
  the stage group, as in JAX.
* ``model`` axis: the large tower matmuls are sharded by the JAX package's
  path rules (:data:`PARAM_RULES`, matched against each parameter's Flax
  path): head-aligned QKV and MLP up-projections by output features
  (column-parallel), the attention output and MLP down-projections by input
  features (row-parallel, bias added once after the sum), the word
  embeddings by vocabulary rows, and the cross-modal alignments'
  query/key/value by output features (gathered before their replicated
  consumers, as GSPMD would). Attention runs K1 and K2 on each rank's own
  heads. A dimension the model axis does not divide stays replicated, as
  ``make_param_shardings`` leaves it. ``cfg.seq_shard`` cuts the towers'
  activations between the matmuls along the sequence (``models/layers.py``),
  and ``cfg.fabric_shard`` spreads the routing fabric's rows over the
  model ranks, whose fabric then stays whole on every rank
  (``models/unimo.py``).

Differences from the JAX package, by design: the product of the mesh must
equal the world (JAX would quietly take the first ``n`` devices);
``--mesh_topology`` keeps process order, which is what JAX itself does off a
TPU; and under ``fabric_shard`` the fabric's parameters are whole on every
rank (JAX keeps its tp rules there and lets GSPMD gather them at use).
"""

from __future__ import annotations

import datetime
import re
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from d2r_tpu_torch.models.layers import Embed, QKVDense
from d2r_tpu_torch.parallel import distributed
from d2r_tpu_torch.quant import Int8Weight
from d2r_tpu_torch.weights import _to_flax, _translate, flax_path

DATA_AXIS = "data"
STAGE_AXIS = "stage"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, STAGE_AXIS, MODEL_AXIS)
# the routing fabric: the modules that ``fabric_shard`` spreads over rows
FABRIC = ("model.itr_module", "model.Reversed_itr_module")
# a tower block's tensor: (tower, block index, the rest of the key)
_TOWER_LAYER = r"^(.*\.encoder_(?:text|vision)_layers)\.layer_(\d+)\.(.+)$"

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
    """This process's place in a ``dp x pp x tp`` mesh and its groups:
    ``data_group`` (the ranks of its model column, None when dp = 1),
    ``model_group`` (the ranks of its (data, stage) row, None when tp = 1),
    ``stage_group`` (the ranks of its (data, model) pair, None when pp = 1)
    and ``fabric_group`` (the data x model ranks of its stage, None when
    dp x tp = 1). ``device`` is this process's card (or the CPU)."""

    def __init__(self, dp: int, tp: int, rank: int, device, data_group=None,
                 model_group=None, pp: int = 1, stage_group=None, fabric_group=None):
        self.dp, self.tp, self.pp, self.rank = dp, tp, pp, rank
        self.device = torch.device(device)
        self.data_group, self.model_group = data_group, model_group
        self.stage_group, self.fabric_group = stage_group, fabric_group

    @property
    def world(self) -> int:
        return self.dp * self.pp * self.tp

    @property
    def data_index(self) -> int:
        return self.rank // (self.pp * self.tp)

    @property
    def stage_index(self) -> int:
        return (self.rank // self.tp) % self.pp

    @property
    def model_index(self) -> int:
        return self.rank % self.tp

    def rank_at(self, data: int, stage: int, model: int) -> int:
        """The global rank at mesh coordinates (data, stage, model)."""
        return (data * self.pp + stage) * self.tp + model

    @property
    def shape(self) -> Dict[str, int]:
        """Axis sizes in JAX's ``("data", "stage", "model")`` order; the
        stage and model axes only when larger than 1, as the CLI names the
        axes."""
        return {DATA_AXIS: self.dp, **({STAGE_AXIS: self.pp} if self.pp > 1 else {}),
                **({MODEL_AXIS: self.tp} if self.tp > 1 else {})}

    @property
    def data_shard(self) -> Optional[Tuple[int, int]]:
        """``DataLoader(process_shard=...)`` of this rank: its data index of
        ``dp`` (the stage and model ranks of a data row load the same rows),
        None when the batch is not split."""
        return (self.data_index, self.dp) if self.dp > 1 else None

    @property
    def collective_device(self) -> torch.device:
        """Where host-side values go for a collective: the card under NCCL,
        the CPU under gloo."""
        if self.world > 1 and dist.get_backend() == "nccl":
            return self.device
        return torch.device("cpu")

    def model_row(self) -> "Mesh":
        """This rank's (data, stage) row as a mesh of its own: the model
        axis and its group alone, no data group. A serving model takes it
        (``serve.Predictor``): its rows are independent, and the data axis
        only splits a bucket's rows."""
        return Mesh(1, self.tp, self.model_index, self.device, model_group=self.model_group)

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier()

    def __deepcopy__(self, memo):
        return self   # process groups are not copied with a module


def make_mesh(mesh_shape: Sequence[int] = (-1,),
              axis_names: Sequence[str] = (DATA_AXIS,), device="cpu",
              timeout: Optional[datetime.timedelta] = None) -> Mesh:
    """The mesh of this process's world (one process when there is no
    process group). A single -1 absorbs the world. The axes are a subset of
    ``("data", "stage", "model")`` in that order, JAX's. The product must
    equal the world size: the error names how to start the processes.
    Every process calls this with the same arguments: the groups are made
    collectively. ``timeout`` bounds this process's waits in the groups'
    collectives (default: the backend's)."""
    if len(mesh_shape) != len(axis_names):
        raise ValueError(f"mesh_shape {tuple(mesh_shape)} and axis names "
                         f"{tuple(axis_names)} differ in length")
    unknown = set(axis_names) - set(AXES)
    if unknown:
        raise NotImplementedError(f"mesh axes {sorted(unknown)}: the port's mesh has the "
                                  f"axes {AXES}")
    if list(axis_names) != [a for a in AXES if a in axis_names]:
        raise ValueError(f"mesh axes {tuple(axis_names)}: the order is JAX's, {AXES}")
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
    dp, pp, tp = (shape.get(a, 1) for a in AXES)
    if dp < 1 or pp < 1 or tp < 1 or dp * pp * tp != world:
        need = f"a multiple of {known}" if -1 in mesh_shape else f"{dp * pp * tp}"
        raise ValueError(
            f"mesh {dict(zip(axis_names, mesh_shape))} needs {need} processes, one per "
            f"card, and the world has {world} process{'es' if world > 1 else ''}: start "
            f"them with --coordinator_address HOST:PORT --num_processes N --process_id "
            f"RANK (or --num_processes -1 under a launcher such as torchrun)")
    mesh = Mesh(dp, tp, rank, device, pp=pp)
    if world > 1:
        # every process makes every group, in one order
        at = mesh.rank_at
        groups = {
            "data_group": (dp, [[at(d, s, m) for d in range(dp)]
                                for s in range(pp) for m in range(tp)]),
            "stage_group": (pp, [[at(d, s, m) for s in range(pp)]
                                 for d in range(dp) for m in range(tp)]),
            "model_group": (tp, [[at(d, s, m) for m in range(tp)]
                                 for d in range(dp) for s in range(pp)]),
            "fabric_group": (dp * tp, [[at(d, s, m) for d in range(dp) for m in range(tp)]
                                       for s in range(pp)]),
        }
        for attr, (size, members) in groups.items():
            for ranks in members:
                g = dist.new_group(ranks, timeout=timeout) if size > 1 else None
                if rank in ranks:
                    setattr(mesh, attr, g)
    return mesh


def mesh_for(cfg, device="cpu") -> Mesh:
    """The mesh of ``cfg.mesh_shape`` / ``mesh_axis_names`` over this
    process's world. ``cfg.mesh_topology`` changes nothing: ranks keep
    process order, as the JAX package's devices do off a TPU."""
    return make_mesh(cfg.mesh_shape, cfg.mesh_axis_names, device)


def param_partition_spec(path: str, has_model_axis: bool = True,
                         has_stage_axis: bool = False) -> Tuple[Optional[str], ...]:
    """The spec of the Flax leaf at ``path`` (``()`` = replicated), JAX's
    rule. In a scanned tower (``layers_scanned``) the leaf has a leading
    (num_layers,) axis, which stays unsplit: the rule shifts one axis
    right. In a pipelined tower (``stages_pipelined``) it has two, (stages,
    layers a stage), with or without a stage axis: the first is split over
    ``stage`` when the mesh has one, every leaf of the stage alike, and the
    tp rule shifts two axes right."""
    inner = ()
    if has_model_axis:
        inner = next((spec for pattern, spec in PARAM_RULES if re.search(pattern, path)), ())
    if "stages_pipelined" in path:
        return (STAGE_AXIS if has_stage_axis else None, None, *inner)
    return (None, *inner) if inner and "layers_scanned" in path else inner


def tower_layer(key: str) -> Optional[Tuple[str, int, str]]:
    """(tower, block index, rest) of a tower block's port key such as
    ``model.encoder_text_layers.layer_3.output_dense.weight``, else None:
    the tensors a stage owns."""
    m = re.match(_TOWER_LAYER, key)
    return None if m is None else (m.group(1), int(m.group(2)), m.group(3))


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


def _towers(model: nn.Module):
    """The two tower stacks (``BertEncoder``, ``CLIPVisionEncoder``)."""
    from d2r_tpu_torch.models.bert import BertEncoder
    from d2r_tpu_torch.models.vit import CLIPVisionEncoder
    return [m for m in model.modules() if isinstance(m, (BertEncoder, CLIPVisionEncoder))]


def _keep_stage(model: nn.Module, mesh: Mesh) -> None:
    """Drop every tower block outside this rank's stage."""
    for tower in _towers(model):
        if tower.stages != mesh.pp:
            raise ValueError(f"pipeline_stages={tower.stages} on a mesh of {mesh.pp} stages")
        if tower.num_layers % mesh.pp:
            raise ValueError(f"pipeline_stages={mesh.pp} must divide num_layers="
                             f"{tower.num_layers}")
        k = tower.num_layers // mesh.pp
        for i in range(tower.num_layers):
            if i // k != mesh.stage_index:
                delattr(tower, f"layer_{i}")


def _fabric_keys(model: nn.Module, key: str) -> bool:
    return any(key.startswith(f + ".") for f in FABRIC)


def shard_model(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Give every module of ``model`` the mesh, keep only this rank's stage
    of the towers' blocks under a stage axis, and keep only this rank's
    slice of each parameter that :data:`PARAM_RULES` split, in place: the
    modules then run their collectives (``TorchLinear.tp`` "column" or
    "row", ``QKVDense.tp`` "column" with ``hidden`` the local width,
    ``Embed.tp`` "vocab"). Under ``fabric_shard`` the fabric stays whole
    (its rows are split instead). Call it on the whole model, built from
    the seed or loaded as one process would, before the optimizer exists.
    Each split module records its tensors' split Flax axes in ``shards``."""
    cfg = getattr(model, "cfg", None)
    for m in model.modules():
        if hasattr(m, "mesh"):
            m.mesh = mesh
    if mesh.pp > 1:
        _keep_stage(model, mesh)
    if mesh.tp == 1:
        return model
    whole_fabric = cfg is not None and cfg.fabric_shard
    int8 = [f"{name}.weight" for name, m in model.named_modules() if isinstance(m, Int8Weight)]
    for key in [k for k, _ in model.named_parameters()] + int8:
        if whole_fabric and _fabric_keys(model, key):
            continue
        axis = _shard_axis(model, key, mesh.tp)
        if axis is None:
            continue
        *prefix, name = key.split(".")
        module = model.get_submodule(".".join(prefix))
        if isinstance(module, Int8Weight) and name == "weight":
            _split_int8(module, axis, mesh)
        else:
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


def _split_int8(module: nn.Module, axis: int, mesh: Mesh) -> None:
    """A quantized weight (``quant.py``) cut as its dense weight would be:
    the int8 codes by the same rule, and the per-output-channel scales with
    them where the output features are split (a QKV or column-parallel
    weight); a row-parallel weight keeps every scale, taken over the whole
    input, as the JAX package quantizes before it places."""
    module.weight_q = local_slice(module, "weight", module.weight_q, axis, mesh.tp,
                                  mesh.model_index)
    if isinstance(module, QKVDense) or axis == 1:
        out_axis = 1 if isinstance(module, QKVDense) else 0
        k = module.weight_scale.shape[out_axis] // mesh.tp
        module.weight_scale = module.weight_scale.narrow(
            out_axis, mesh.model_index * k, k).contiguous().clone()


def _sharded(model: nn.Module, key: str):
    """(module, name, axis) of a split tensor ``key``, or None."""
    *prefix, name = key.split(".")
    module = model.get_submodule(".".join(prefix))
    axis = getattr(module, "shards", {}).get(name)
    return None if axis is None else (module, name, axis)


def _staged(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.pp > 1


def stage_owned(key: str, mesh: Optional[Mesh]) -> bool:
    """Whether ``key`` is a tensor of this rank's stage only (a tower block
    under a stage axis), rather than replicated over the stage group."""
    return _staged(mesh) and tower_layer(key) is not None


def _expand_stages(model: nn.Module, keys, mesh: Mesh):
    """One process's order of this stage rank's ``keys``: each tower's run
    of block keys replaced by that run for every stage in turn. Returns
    (full keys, {full key: (own key, stage)})."""
    per = {tower_layer(k)[0]: k for k in keys if tower_layer(k) is not None}
    blocks = {prefix: model.get_submodule(prefix).num_layers // mesh.pp for prefix in per}
    out, where, done = [], {}, set()
    for k in keys:
        got = tower_layer(k)
        if got is None:
            out.append(k)
            where[k] = (k, None)
            continue
        if got[0] in done:
            continue
        done.add(got[0])
        run = [(j, tower_layer(j)) for j in keys
               if tower_layer(j) is not None and tower_layer(j)[0] == got[0]]
        k_blocks = blocks[got[0]]
        for stage in range(mesh.pp):
            for own, (prefix, i, rest) in run:
                full = f"{prefix}.layer_{i + (stage - mesh.stage_index) * k_blocks}.{rest}"
                out.append(full)
                where[full] = (own, stage)
    return out, where


def _gather_stages(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(pp, ...) of the stage ranks' ``t`` (every stage rank calls it)."""
    return distributed._gather(t.detach().unsqueeze(0).contiguous(), mesh.stage_group, 0)


def full_state_dict(model: nn.Module, mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every split tensor gathered whole, and
    every stage's tower blocks: the state dict one process would hold, in
    its order, whatever the mesh (every rank of a model group and a stage
    group calls it)."""
    return _whole(model, mesh, model.state_dict())


def full_gradients(model: nn.Module, mesh: Optional[Mesh]) -> Dict[str, torch.Tensor]:
    """The parameters' gradients (zeros where there is none) gathered as
    :func:`full_state_dict` gathers the parameters."""
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach()
             for k, p in model.named_parameters()}
    return _whole(model, mesh, grads)


def _whole(model: nn.Module, mesh: Optional[Mesh],
           state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    if mesh is None or (mesh.tp == 1 and mesh.pp == 1):
        return state
    if mesh.tp > 1:
        for key in state:
            got = _sharded(model, key)
            if got is not None:
                module, name, axis = got
                state[key] = gather_full(module, name, state[key], axis, mesh)
    if not _staged(mesh):
        return state
    stacks = {k: _gather_stages(v, mesh) for k, v in state.items() if tower_layer(k)}
    keys, where = _expand_stages(model, list(state), mesh)
    return {k: state[k] if stage is None else stacks[own][stage]
            for k, (own, stage) in ((k, where[k]) for k in keys)}


def local_state_dict(model: nn.Module, mesh: Optional[Mesh],
                     full: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A whole state dict (one process's, any mesh's) cut to this rank's
    stage and slices of ``model``."""
    if mesh is None or (mesh.tp == 1 and mesh.pp == 1):
        return full
    out = {k: full[k] for k in model.state_dict()} if _staged(mesh) else dict(full)
    if mesh.tp > 1:
        for key in list(out):
            got = _sharded(model, key)
            if got is not None:
                module, name, axis = got
                out[key] = local_slice(module, name, full[key], axis, mesh.tp,
                                       mesh.model_index)
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


def _group_keys(model, optimizer, mesh: Mesh):
    """Each optimizer group's keys as this rank holds them, and as one
    process holds them (with every stage's blocks)."""
    keys = _moment_keys(model, optimizer)
    own, index = [], 0
    for group in optimizer.param_groups:
        own.append([keys[index + j] for j in range(len(group["params"]))])
        index += len(group["params"])
    return own, [_expand_stages(model, g, mesh) for g in own]


def full_optimizer_state(model, optimizer, mesh: Optional[Mesh]) -> Dict:
    """``optimizer.state_dict()`` with the moments of split parameters
    gathered whole and every stage's (every rank of a model group and a
    stage group calls it): one process's optimizer state, in its parameter
    order."""
    opt_state = optimizer.state_dict()
    if mesh is None or (mesh.tp == 1 and mesh.pp == 1):
        return opt_state
    if mesh.tp > 1:
        opt_state = _map_moments(
            model, optimizer, opt_state,
            lambda module, name, axis, v: gather_full(module, name, v, axis, mesh))
    if not _staged(mesh):
        return opt_state
    own, expanded = _group_keys(model, optimizer, mesh)
    index = {k: i for i, k in enumerate(k for g in own for k in g)}
    moments = {k: opt_state["state"].get(i) for k, i in index.items()}
    stacks = {k: {n: _gather_stages(v, mesh) for n, v in st.items()
                  if isinstance(v, torch.Tensor) and v.dim()}
              for k, st in moments.items() if st is not None and tower_layer(k)}
    state, groups, n = {}, [], 0
    for group, (keys, where) in zip(opt_state["param_groups"], expanded):
        ids = []
        for k in keys:
            own_key, stage = where[k]
            st = moments[own_key]
            if st is not None:
                state[n] = st if stage is None else {
                    name: stacks[own_key][name][stage] if name in stacks[own_key] else v
                    for name, v in st.items()}
            ids.append(n)
            n += 1
        groups.append({**group, "params": ids})
    return {"state": state, "param_groups": groups}


def local_optimizer_state(model, optimizer, mesh: Optional[Mesh], full: Dict) -> Dict:
    """A whole optimizer state dict (one process's order) cut to this
    rank's stage and slices."""
    if mesh is None or (mesh.tp == 1 and mesh.pp == 1):
        return full
    if _staged(mesh):
        own, expanded = _group_keys(model, optimizer, mesh)
        full_index = {k: i for i, k in enumerate(k for keys, _ in expanded for k in keys)}
        state, groups, n = {}, [], 0
        for group, keys in zip(full["param_groups"], own):
            ids = []
            for k in keys:
                st = full["state"].get(full_index[k])
                if st is not None:
                    state[n] = st
                ids.append(n)
                n += 1
            groups.append({**group, "params": ids})
        full = {"state": state, "param_groups": groups}
    if mesh.tp == 1:
        return full
    return _map_moments(model, optimizer, full,
                        lambda module, name, axis, v: local_slice(
                            module, name, v, axis, mesh.tp, mesh.model_index))


def replica_mismatches(model: nn.Module, mesh: Mesh) -> Dict[str, list]:
    """The keys of this rank's parameters and buffers that differ, bit for
    bit, from the copy the mesh says must be equal: ``"model"``, the tensors
    the model axis leaves whole against the first model rank of this
    (data, stage) row; ``"stage"``, the tensors outside the towers' blocks
    against stage 0's rank of this (data, model) pair; ``"data"``, every
    local tensor against data index 0's rank of this model column (the
    ``"stage"`` key only on a mesh with a stage axis). Every rank calls it
    (broadcasts over every group)."""
    out = {"model": [], **({"stage": []} if mesh.pp > 1 else {}), "data": []}
    d, s, m = mesh.data_index, mesh.stage_index, mesh.model_index
    for axis, group, src in (("model", mesh.model_group, mesh.rank_at(d, s, 0)),
                             ("stage", mesh.stage_group, mesh.rank_at(d, 0, m)),
                             ("data", mesh.data_group, mesh.rank_at(0, s, m))):
        if group is None:
            continue
        for key, t in model.state_dict().items():
            if axis == "model" and _sharded(model, key) is not None:
                continue
            if axis == "stage" and tower_layer(key) is not None:
                continue
            ref = t.detach().clone()
            dist.broadcast(ref, src=src, group=group)
            if not torch.equal(ref, t):
                out[axis].append(key)
    return out
