"""Multi-process runtime (counterpart of ``d2r_tpu/parallel/distributed.py``).

The JAX package runs one process per host, each owning its local chips, in
one SPMD program. The port runs one process per card (``torch.distributed``):
a (data, stage, model) mesh of ``dp x pp x tp`` processes (``parallel/mesh.py``). This
module joins the processes, gives each its card, and holds the collectives
the model and the trainer call.

Data contract, as in the JAX package: every process computes the same
deterministic global batch order, and each data row of the mesh loads only
its contiguous ``batch/dp`` slice of every global batch
(``DataLoader(process_shard=mesh.data_shard)``); the ``tp`` processes of one
data row load the same rows.

**The gradient scheme.** Every data rank computes the one global loss: the
batch-global Gram matrices of the JS loss from rows gathered over the data
group (:func:`gather_rows`), the SAF BatchNorm statistics and the
cross-entropy's sum and count from all-reduces over it
(:func:`all_reduce_sum`). These data-group collectives are differentiated
as what they are: the backward of a sum over ranks is the sum of the
gradients over ranks, and the backward of a gather is that sum cut to the
rank's own rows. As every one of the ``dp`` ranks differentiates the same
loss, the gradient that reaches a rank's rows is ``dp`` times their share;
the trainer's all-reduce then takes the MEAN over the data group
(``train/state.py``), which is the gradient of the global loss.

The model group follows Megatron-LM instead: every model rank holds the
same loss once, so a column-parallel layer's input is an identity forward
whose backward sums the partial input gradients (:func:`copy_to`), a
row-parallel layer's output is a sum forward whose backward is the identity
(:func:`reduce_from`), and a sharded output gathered for a replicated
consumer returns each rank its own columns (:func:`gather_features`).
Sequence parallelism (``seq_shard``) cuts the replicated activations
between a block's matmuls along the sequence: :func:`split_seq` takes a
rank's slice (backward: the slices' gradients gathered), and
:func:`gather_seq` joins them for a column-parallel input (backward: the
partial gradients summed, then the rank's slice), so a row-parallel
output summed and split is Megatron's reduce-scatter, with the
all-reduce's sum. The fabric's work-sharing (``fabric_shard``) spreads a
data row's batch over its model ranks: :func:`scatter_rows` takes the
rank's rows, and :func:`gather_rows` over the model group joins them.
Inside the spread fabric every model rank differentiates the one loss
through its own rows only, so the gather's summed backward gives the
fabric ``tp`` times its share, as the data group gives ``dp`` times, and
the trainer's mean over the model group of the replicated fabric's
gradients is then the sum of the ranks' shares; :func:`scatter_rows`
divides its gathered gradient by ``tp`` again for the towers. The
pipeline's stage group has its hop in ``models/pipeline.py``.

Every collective is built from ``all_reduce`` alone: it is the one that the
gloo backend takes on CUDA tensors besides broadcast (several ranks on one
card run over gloo; NCCL takes two ranks on two cards only). A gather sums
zero-padded buffers, which adds only zeros, so it moves bits exactly. A
``group`` of None means a mesh axis of size 1: every function is then the
identity.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# the environment a launcher (torchrun) sets for --num_processes -1
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
TIMEOUT = datetime.timedelta(minutes=30)


def default_backend(device) -> str:
    """NCCL for CUDA, gloo for the CPU. NCCL never gives way to gloo
    quietly: without it a CUDA run raises."""
    if torch.device(device).type != "cuda":
        return "gloo"
    if not dist.is_nccl_available():
        raise RuntimeError("a CUDA run across processes needs NCCL, and this torch "
                           "has none")
    return "nccl"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda", backend: Optional[str] = None,
               timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Join the process group; the CLI's ``--coordinator_address``,
    ``--num_processes`` and ``--process_id``. Returns True when it created
    the group (the caller then ends it with :func:`shutdown`), False when
    nothing multi-process was asked for (no coordinator round trip) or a
    group exists already.

    ``num_processes`` -1 is the counterpart of JAX's auto-detection: the
    launcher's ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``
    (``init_method="env://"``), which must be set. Otherwise all three
    flags are needed: ``init_method="tcp://<coordinator_address>"``.
    ``backend`` (tests, ``chip_smoke.py``; no flag) defaults to
    :func:`default_backend` of ``device``; ``timeout`` bounds this process's
    waits in the world group's collectives. Call it before any device use."""
    if coordinator_address is None and num_processes is None:
        if process_id is not None:
            raise ValueError("--process_id needs --coordinator_address and --num_processes")
        return False
    if dist.is_initialized():
        return False
    backend = backend or default_backend(device)
    if num_processes is not None and num_processes < 0:
        missing = [k for k in LAUNCHER_ENV if k not in os.environ]
        if missing:
            raise ValueError(f"--num_processes -1 reads the launcher's environment, and "
                             f"{missing} are not set (run under torchrun, or pass "
                             f"--coordinator_address, --num_processes and --process_id)")
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("a multi-process run needs --coordinator_address HOST:PORT, "
                             "--num_processes N and --process_id RANK together (or "
                             "--num_processes -1 under a launcher)")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"--process_id {process_id} outside [0, {num_processes})")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
    logger.info("process group up: rank %d of %d (%s)", dist.get_rank(),
                dist.get_world_size(), backend)
    return True


def shutdown() -> None:
    """End the process group that :func:`initialize` created."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world() -> tuple:
    """(rank, world size); (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def local_device(device="cuda") -> torch.device:
    """The card of this process, ``cuda:{LOCAL_RANK}`` or ``cuda:{rank %
    device_count}``, made current; the CPU stays the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda" or not dist.is_initialized():
        return dev
    index = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def warmup_collectives(mesh) -> None:
    """One tiny all-reduce over the world, then over each group of this
    rank (data, stage, model, fabric), while the processes are still in step from
    :func:`initialize`: each transport connects now, not inside the first
    step, behind a skew of seconds between the ranks' first forwards. With
    a process group of one (``--num_processes 1``) the world's all-reduce
    still runs, so its backend is exercised; without a group, nothing."""
    if not dist.is_initialized():
        return
    groups = (mesh.data_group, mesh.stage_group, mesh.model_group, mesh.fabric_group)
    for group in [dist.group.WORLD] + [g for g in groups if g is not None]:
        dist.all_reduce(torch.zeros(8, device=mesh.device), group=group)
    logger.info("collectives warmed up (%d processes)", mesh.world)


def local_batch_size(global_batch_size: int, count: int) -> int:
    """A data rank's slice of the global batch; it must divide exactly (every
    rank runs one static shape)."""
    if global_batch_size % count != 0:
        raise ValueError(f"global batch size {global_batch_size} must be divisible by the "
                         f"data axis {count}: every data rank loads one equal slice")
    return global_batch_size // count


# --- collectives ----------------------------------------------------------

def _size_rank(group):
    return dist.get_world_size(group), dist.get_rank(group)


def _summed(t: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of ``t`` summed over ``group``."""
    out = t.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' equal-shaped ``x`` concatenated along ``dim`` in rank
    order: each writes its block into zeros, and the blocks are summed."""
    n, r = _size_rank(group)
    shape = list(x.shape)
    k = shape[dim]
    shape[dim] = n * k
    out = x.new_zeros(shape)
    out.narrow(dim, r * k, k).copy_(x)
    dist.all_reduce(out, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _Gather(torch.autograd.Function):
    """The ranks' blocks of ``x`` along ``dim``; backward: this rank's block
    of the gradient, summed over the group first when ``summed``."""

    @staticmethod
    def forward(ctx, x, group, dim, summed):
        ctx.group, ctx.dim, ctx.width, ctx.summed = group, dim, x.shape[dim], summed
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        if ctx.summed:
            g = _summed(g, ctx.group)
        return g.narrow(ctx.dim, r * ctx.width, ctx.width).contiguous(), None, None, None


class _Split(torch.autograd.Function):
    """This rank's block of ``x`` along ``dim``; backward: the ranks'
    gradient blocks gathered, times ``scale``."""

    @staticmethod
    def forward(ctx, x, group, dim, scale):
        n, r = _size_rank(group)
        if x.shape[dim] % n:
            raise ValueError(f"a dimension of {x.shape[dim]} does not split over {n} ranks")
        ctx.group, ctx.dim, ctx.scale = group, dim, scale
        k = x.shape[dim] // n
        return x.narrow(dim, r * k, k).contiguous()

    @staticmethod
    def backward(ctx, g):
        out = _gather(g.contiguous(), ctx.group, ctx.dim)
        return (out if ctx.scale == 1.0 else out.mul_(ctx.scale)), None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None



def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the data group; backward: the gradients summed over it."""
    return x if group is None else _AllReduceSum.apply(x, group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' rows of ``x`` (dim 0) in rank order; backward: the
    gradients summed over the group, cut to this rank's rows."""
    return x if group is None else _Gather.apply(x, group, 0, True)


def scatter_rows(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of the rows of ``x``, replicated over ``group``
    (the fabric's input under ``fabric_shard``); backward: the ranks'
    gradient blocks gathered and divided by the group's size (see the
    module docstring)."""
    return x if group is None else _Split.apply(x, group, 0, 1.0 / dist.get_world_size(group))


def split_seq(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's slice of ``x`` (B, L, ...) along the sequence, ``x``
    replicated over the model ``group``; backward: the slices' gradients
    gathered."""
    return x if group is None else _Split.apply(x, group, 1, 1.0)


def gather_seq(x: torch.Tensor, group, summed: bool = True) -> torch.Tensor:
    """The model ranks' sequence slices of ``x`` joined (dim 1). Backward:
    with ``summed``, the partial gradients of a column-parallel consumer
    summed over the group, then this rank's slice; without, this rank's
    slice of its own gradient (a replicated consumer, or one whose
    backward sums already)."""
    return x if group is None else _Gather.apply(x, group, 1, summed)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """A column-parallel layer's input: identity; backward: the partial
    gradients summed over the model group."""
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel layer's partial output summed over the model group;
    backward: identity."""
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_features(x: torch.Tensor, group) -> torch.Tensor:
    """The model ranks' columns of ``x`` (last dim) in rank order, for a
    replicated consumer; backward: this rank's columns of the gradient."""
    return x if group is None else _Gather.apply(x, group, x.dim() - 1, False)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (no gradient); any dtype, int32
    included."""
    return x if group is None else _summed(x, group)


@torch.no_grad()
def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over the group (no gradient)."""
    if group is None:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def allgather_1d(values: Sequence[int], group, device="cpu") -> List[int]:
    """Variable-length int lists of the group's ranks joined in rank order,
    the same list on every rank (eval metrics over ALL samples): lengths
    first, then the lists padded to the longest."""
    if group is None:
        return list(values)
    n, r = _size_rank(group)
    local = torch.tensor(list(values), dtype=torch.int64, device=device)
    lengths = _gather(torch.tensor([local.numel()], dtype=torch.int64, device=device),
                      group, 0).tolist()
    padded = torch.full((max(lengths),), -1, dtype=torch.int64, device=device)
    padded[:local.numel()] = local
    rows = _gather(padded[None], group, 0).tolist()
    return [v for row, k in zip(rows, lengths) for v in row[:k]]
