"""AdamW in one pass: the CUDA kernel ``csrc/adamw.cu``, its plain twin and
the device table the kernel walks.

The function is optax's ``adamw`` in its operation order (see
``train/optimizer.py``) over every tensor of every lr group, with the step
count and the learning-rate schedule on the device: the count is a
one-element fp32 tensor that the update reads (the schedule at the
pre-increment count, the bias corrections at count + 1) and then
increments, so no host value enters a step and a CUDA graph can capture it.

:func:`adamw_plain` is the twin: the sixteen ``torch._foreach`` passes of
the port's earlier optimizer, with the count-dependent scalars as 0-d
tensors on the count's device (a CUDA tensor divided by a host scalar is
multiplied by its reciprocal, one ulp off the quotient). Each of its
operations rounds to fp32, as each of the kernel's does, so the two agree
bit for bit on the card. It runs for CPU tensors; on CUDA tensors
:func:`adamw_update` launches the kernel or raises.

The kernel replaces no TPU kernel: the JAX package's ``fused_adamw`` and
``fused_leaf_adamw`` (``d2r_tpu/train/optimizer.py:112,181``) are XLA
fusions. What bounds it is bytes: 28 a parameter with fp32 first moments
(read p, g, mu, nu; write p, mu, nu), 24 with bf16 ones.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from d2r_tpu_torch.ops.kernels import build

# the kernel's persistent grid: blocks an SM (csrc/adamw.cu kBlocksPerSM)
BLOCKS_PER_SM = 2
# elements a chunk: the unit a block of the grid claims at a time, one
# load batch of its 256 threads x 4 vectors x 4 elements
CHUNK = 1 << 12
# the kernel's 16-byte body: p, g, nu and fp32 mu aligned to 16 bytes, bf16
# mu to 8 (four elements); a chunk starts at a multiple of VECTOR elements
VECTOR = 4
# elements a chunk of the twin's passes: its temporaries (five of a chunk's
# size at most, 640 MB) stay far below the moments' own bytes at D2R-large
PLAIN_CHUNK = 1 << 25


class Hyper(NamedTuple):
    """The update's constants as the fp32 values both versions use."""

    b1: float
    b2: float
    omb1: float        # fp32(1 - b1), the Python double rounded once
    omb2: float
    b1_low: float      # b1 rounded to bf16 (bf16 first moments)
    eps: float
    wd: float


class Schedule(NamedTuple):
    """``linear_warmup_decay``'s constants in fp32, as ``jnp`` rounds the
    Python floats it is given: warmup, max(1, warmup), total and
    max(1, total - warmup)."""

    warmup: float
    warm_div: float
    total: float
    decay_div: float


def _f32(x: float) -> float:
    return float(np.float32(x))


def hyper(betas: Tuple[float, float], eps: float, weight_decay: float) -> Hyper:
    b1, b2 = betas
    b1_low = float(torch.tensor(b1, dtype=torch.bfloat16))
    return Hyper(_f32(b1), _f32(b2), _f32(1.0 - b1), _f32(1.0 - b2), b1_low, _f32(eps),
                 _f32(weight_decay))


def schedule(warmup_steps: float, total_steps: float) -> Schedule:
    warmup, total = max(float(warmup_steps), 0.0), float(total_steps)
    return Schedule(_f32(warmup), _f32(max(1.0, warmup)), _f32(total),
                    _f32(max(1.0, total - warmup)))


def schedule_plain(count: torch.Tensor, sch: Schedule) -> torch.Tensor:
    """The schedule's factor at ``count`` (fp32), in tensor ops: the twin of
    the kernel's ``schedule`` and of the JAX package's ``linear_warmup_decay``
    with base lr 1."""
    div = lambda x: torch.tensor(x, dtype=torch.float32, device=count.device)
    warm = count / div(sch.warm_div)
    decay = torch.clamp_min((sch.total - count) / div(sch.decay_div), 0.0)
    return torch.where(count < sch.warmup, warm, decay)


def _chunks(items: Sequence, sizes: Sequence[int]):
    """``items`` in runs of at most :data:`PLAIN_CHUNK` elements (a larger
    tensor alone)."""
    run, size = [], 0
    for item, n in zip(items, sizes):
        if run and size + n > PLAIN_CHUNK:
            yield run
            run, size = [], 0
        run.append(item)
        size += n
    if run:
        yield run


@torch.no_grad()
def adamw_plain(groups: Sequence[Tuple[List[torch.Tensor], List[torch.Tensor],
                                       List[torch.Tensor], List[torch.Tensor], float]],
                count: torch.Tensor, hp: Hyper, sch: Schedule) -> None:
    """One AdamW step over ``groups`` of (params, grads, mus, nus, base lr)
    in place, then ``count += 1``: the kernel's function in sixteen
    ``torch._foreach`` passes. A bf16 ``mus`` list is updated as optax's
    ``scale_by_adam(mu_dtype=bf16)`` updates it."""
    t = count + 1.0
    c1 = 1.0 - torch.pow(torch.tensor(hp.b1, device=count.device), t)
    c2 = 1.0 - torch.pow(torch.tensor(hp.b2, device=count.device), t)
    factor = schedule_plain(count, sch)
    for params, grads, mus, nus, base_lr in groups:
        if not params:
            continue
        neg_lr = -(torch.tensor(_f32(base_lr), device=count.device) * factor)
        rows = list(zip(params, grads, mus, nus))
        for run in _chunks(rows, [p.numel() for p in params]):
            _update(*map(list, zip(*run)), hp, c1, c2, neg_lr)
    count.add_(1.0)


def _update(params, grads, mus, nus, hp: Hyper, c1, c2, neg_lr) -> None:
    scaled = torch._foreach_mul(grads, hp.omb1)
    if mus[0].dtype == torch.float32:
        torch._foreach_mul_(mus, hp.b1)
        torch._foreach_add_(mus, scaled)
        mu = mus
    else:   # b1 (rounded to the storage type) * mu in that type, then the fp32 sum
        mu = scaled
        torch._foreach_add_(mu, torch._foreach_mul(mus, hp.b1_low))
    sq = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(sq, hp.omb2)
    torch._foreach_mul_(nus, hp.b2)
    torch._foreach_add_(nus, sq)
    denom = torch._foreach_div(nus, c2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, hp.eps)
    update = torch._foreach_div(mu, c1)
    torch._foreach_div_(update, denom)
    torch._foreach_add_(update, torch._foreach_mul(params, hp.wd))
    torch._foreach_mul_(update, neg_lr)
    torch._foreach_add_(params, update)
    if mu is not mus:
        torch._foreach_copy_(mus, mu)


class Table:
    """The kernel's device table for one set of (p, g, mu, nu) addresses,
    in one int64 tensor ``data``:

    - a row of seven words a tensor: the four pointers, numel, group and
      the vector end (the elements from 0 that take the 16-byte body:
      ``numel - numel % 4``, or 0 where a pointer is not aligned for it;
      the rest takes the scalar body);
    - from ``chunks_at``, ``n_chunks`` (tensor row, first element, elements)
      triples: every tensor cut into chunks of at most :data:`CHUNK` elements,
      starting at multiples of 4, the largest first (the last claims, which
      end the kernel, are the smallest);
    - at ``next_at``, the counter from which the kernel's persistent grid of
      ``blocks`` blocks claims chunks beyond its first ``blocks``; the
      launch's tick resets it to 0.

    Also the groups' base lrs in fp32 (``base_lr``); ``key`` is the tuple of
    addresses it was built for; ``scalar_elements`` counts the elements
    that take the scalar body."""

    def __init__(self, groups, key: tuple, device: torch.device, blocks: int):
        rows, chunks = [], []
        for gi, (params, grads, mus, nus, _) in enumerate(groups):
            for p, g, mu, nu in zip(params, grads, mus, nus):
                n = p.numel()
                aligned = (all(x.data_ptr() % 16 == 0 for x in (p, g, nu))
                           and mu.data_ptr() % (VECTOR * mu.element_size()) == 0)
                chunks.extend((len(rows), s, min(CHUNK, n - s)) for s in range(0, n, CHUNK))
                rows.append((p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(), n, gi,
                             n - n % VECTOR if aligned else 0))
        chunks.sort(key=lambda c: -c[2])
        words = np.array([w for r in rows for w in r] + [w for c in chunks for w in c] + [0],
                         dtype=np.uint64).view(np.int64)
        self.data = torch.from_numpy(words).to(device)
        self.chunks_at = 7 * len(rows)
        self.n_chunks = len(chunks)
        self.next_at = self.chunks_at + 3 * len(chunks)
        self.blocks = blocks
        self.elements = sum(r[4] for r in rows)
        self.scalar_elements = sum(r[4] - r[6] for r in rows)
        self.base_lr = torch.tensor([_f32(g[4]) for g in groups], dtype=torch.float32,
                                    device=device)
        self.key = key


def table_key(groups) -> tuple:
    """The addresses a :class:`Table` is valid for."""
    return tuple((p.data_ptr(), g.data_ptr(), m.data_ptr(), n.data_ptr())
                 for params, grads, mus, nus, _ in groups
                 for p, g, m, n in zip(params, grads, mus, nus))


def _check(groups, count: torch.Tensor) -> None:
    mu_types = {m.dtype for _, _, mus, _, _ in groups for m in mus}
    if len(mu_types) != 1 or not mu_types <= {torch.float32, torch.bfloat16}:
        raise TypeError(f"the first moments must be all float32 or all bfloat16, "
                        f"got {mu_types}")
    if count.dtype != torch.float32 or count.numel() != 1:
        raise TypeError("the count is one float32 element")
    for params, grads, mus, nus, _ in groups:
        for p, g, m, n in zip(params, grads, mus, nus):
            for name, x, dt in (("p", p, torch.float32), ("g", g, torch.float32),
                                ("nu", n, torch.float32), ("mu", m, m.dtype)):
                if (x.dtype != dt or x.device != count.device or not x.is_contiguous()
                        or x.shape != p.shape):
                    raise ValueError(
                        f"adamw_update takes contiguous fp32 {name} of the parameter's "
                        f"shape on {count.device}, got {x.dtype} {tuple(x.shape)} on "
                        f"{x.device}")


_fn = []


def _kernel():
    if not _fn:
        fn = build.load("adamw").d2r_adamw
        p, f = ctypes.c_void_p, ctypes.c_float
        fn.argtypes = [ctypes.c_int, p, p, ctypes.c_longlong, p, ctypes.c_int, ctypes.c_int,
                       p, p, f, f, f, f, f, f, f, f, f, f, f, p]
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]


def grid(device: torch.device) -> int:
    """The kernel's persistent grid on ``device``: :data:`BLOCKS_PER_SM`
    blocks on each SM."""
    return torch.cuda.get_device_properties(device).multi_processor_count * BLOCKS_PER_SM


def adamw_update(groups, count: torch.Tensor, hp: Hyper, sch: Schedule,
                 table: "Table" = None) -> "Table":
    """One AdamW step over ``groups`` of (params, grads, mus, nus, base lr),
    in place, then ``count += 1``. On CUDA tensors: the kernel, through
    ``table`` when it was built for these addresses, else through a new one
    (built with a host-to-device copy, so not under capture); returns the
    table used. On CPU tensors: the twin; returns None."""
    if count.device.type == "cpu":
        adamw_plain(groups, count, hp, sch)
        return None
    if count.device.type != "cuda":
        raise ValueError(f"adamw_update: no kernel for device {count.device}")
    key = table_key(groups)
    if table is None or table.key != key:
        _check(groups, count)
        table = Table(groups, key, count.device, grid(count.device))
    mu_bf16 = next(m for _, _, mus, _, _ in groups for m in mus).dtype == torch.bfloat16
    base = table.data.data_ptr()
    with torch.cuda.device(count.device):
        stream = torch.cuda.current_stream(count.device).cuda_stream
        err = _kernel()(int(mu_bf16), base, base + 8 * table.chunks_at, table.n_chunks,
                        base + 8 * table.next_at, table.blocks, len(groups),
                        table.base_lr.data_ptr(), count.data_ptr(), hp.b1, hp.b2, hp.omb1,
                        hp.omb2, hp.b1_low, hp.eps, hp.wd, sch.warmup, sch.warm_div,
                        sch.total, sch.decay_div, stream)
    if err != 0:
        raise RuntimeError(f"adamw launch failed: cudaError {err}")
    adamw_update.launches += 1
    return table


# host calls that launched the kernel (with its count increment) since the
# count was last set to 0; a launch under CUDA graph capture counts once,
# a replay not at all
adamw_update.launches = 0
