"""Pipeline parallelism for the encoder towers (counterpart of
``d2r_tpu/models/pipeline.py``; ``cfg.pipeline_stages``,
``--mesh_stage``, ``--pipeline_microbatches``).

A tower's ``N`` blocks run as ``S`` stages of ``N/S`` consecutive blocks
over ``M`` microbatches of the batch (``pipeline_microbatches``, default
``S``), in the GPipe timetable of the JAX package: ``T = M + S - 1`` ticks,
stage ``s`` running microbatch ``t - s`` at tick ``t``, the first and last
``S - 1`` ticks a bubble. The same errors as JAX's are raised when ``S``
does not divide the depth or ``M`` the batch.

* **One process** (no stage axis, JAX's one-device case): every stage runs
  in this process. Nothing runs concurrently there, so each microbatch goes
  through the stages in turn, the timetable's math and masks; autograd
  gives the backward, and a step is one CUDA graph on the card like any
  other.
* **Across processes** (a mesh with a ``stage`` axis,
  ``parallel/mesh.py``): a rank holds and runs only its own stage's
  blocks. After each tick the stages' outputs hop over the stage group as
  one summed, zero-padded buffer (the port's collectives are all-reduces),
  and stage ``s`` takes stage ``s - 1``'s block of it as its next input.
  The backward runs the schedule in reverse with the hop reversed, stage by
  stage (:class:`_StagePipeline`), so every rank issues its collectives in
  one order. Every stage rank holds the same loss once, as the model group
  does: the tower's output, the last stage's blocks, is replicated, so its
  gradient reaches the last stage from that rank's own copy; the tower's
  input enters as :func:`~d2r_tpu_torch.parallel.distributed.copy_to` does
  (identity, the gradient that stage 0 computes summed over the stage
  group, so every rank's embeddings see it).

Everything outside the towers (embeddings, the fabric, the heads) is
replicated over the stage axis, as in JAX.

**Dropout.** Block ``i`` of microbatch ``m`` draws from its own run of
:data:`SITES_PER_BLOCK` ordinals of the step's
:class:`~d2r_tpu_torch.models.layers.DropoutRNG`, at ``base + (m N + i)
SITES_PER_BLOCK``, ``base`` the ordinal the tower starts at: the Philox key
of a site is (the step's seed, that ordinal), whichever process runs it,
so one process and a stage mesh draw the same masks, and every
(microbatch, block) pair its own. Within a microbatch the bits are keyed on
the global row: microbatch ``m`` of a step over a data axis is the data
ranks' m-th microbatches side by side, a rank's rows at its data index
times their count. JAX draws per (tick, stage) from its
split keys, which the port's bits cannot match (as with every dropout
site). ``remat`` rematerialises each block as in the sequential stack.
Sequence parallelism stays outside a pipelined tower, as in JAX.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from d2r_tpu_torch.models.layers import DropoutRNG
from d2r_tpu_torch.parallel.distributed import _gather, _summed

# dropout ordinals reserved for one block of one microbatch (a BERT block
# draws three: the attention probabilities and two hidden dropouts)
SITES_PER_BLOCK = 4


def check_pipeline(num_layers: int, stages: int, microbatches: int, batch: int) -> None:
    """JAX's errors (``d2r_tpu/models/pipeline.py:172-184``)."""
    if num_layers % stages != 0:
        raise ValueError(f"pipeline_stages={stages} must divide num_layers={num_layers}")
    if microbatches < 1 or batch % microbatches != 0:
        raise ValueError(f"pipeline_microbatches={microbatches} must be >= 1 and divide "
                         f"batch={batch}")


class PipelinedStack:
    """The GPipe schedule over one tower: ``block(i, x, bias, rng)`` runs
    block ``i``; ``params()`` gives the parameters of the blocks this
    process holds (all of them, or its stage's under a stage axis); ``mesh``
    is the process mesh or None. Not a module: the blocks stay the tower's
    ``layer_{i}``, so the parameters keep their names whatever the
    layout."""

    def __init__(self, block: Callable, num_layers: int, stages: int, microbatches: int,
                 params: Callable[[], List[torch.Tensor]], mesh=None):
        self.block, self.params = block, params
        self.num_layers, self.stages, self.microbatches = num_layers, stages, microbatches
        self.mesh = mesh if mesh is not None and mesh.pp > 1 else None
        if self.mesh is not None and self.mesh.pp != stages:
            raise ValueError(f"pipeline_stages={stages} on a mesh of {self.mesh.pp} stages")
        self.per_stage = num_layers // stages if num_layers % stages == 0 else 0

    def _rng(self, base: Optional[int], rng: Optional[DropoutRNG], m: int, i: int):
        if rng is None:
            return None
        # this data rank's rows of microbatch m start at its share of the
        # microbatch: the step's microbatch m is the data ranks' side by side
        sub = DropoutRNG(rng.seed, row0=rng.row0 // self.microbatches)
        sub.site = base + (m * self.num_layers + i) * SITES_PER_BLOCK
        return sub

    def run_stage(self, s: int, m: int, h, bias, rng, base):
        """Stage ``s``'s blocks on microbatch ``m``."""
        b = None if bias is None else bias[m]
        for i in range(s * self.per_stage, (s + 1) * self.per_stage):
            h = self.block(i, h, b, self._rng(base, rng, m, i))
        return h

    def __call__(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        S, M = self.stages, self.microbatches
        check_pipeline(self.num_layers, S, M, x.shape[0])
        base = None if rng is None else rng.site
        if rng is not None:
            rng.site += M * self.num_layers * SITES_PER_BLOCK
        xs = list(x.chunk(M))
        bs = None if bias is None else list(bias.chunk(M))
        if self.mesh is None:
            return self._local(xs, bs, rng, base)
        if torch.is_grad_enabled():
            return _StagePipeline.apply(self, rng, base, bs, x,
                                        *[p for p in self.params() if p.requires_grad])
        return torch.cat(_schedule(self, xs, bs, rng, base, None), dim=0)

    def _local(self, xs, bs, rng, base) -> torch.Tensor:
        """Every stage in this process: nothing runs concurrently here, so
        each microbatch runs through the stages in turn, which gives the
        timetable's math and masks."""
        outs = []
        for m, h in enumerate(xs):
            for s in range(self.stages):
                h = self.run_stage(s, m, h, bs, rng, base)
            outs.append(h)
        return torch.cat(outs, dim=0)


def _hop(mine: torch.Tensor, mesh) -> torch.Tensor:
    """The stages' blocks, (S, ...) on every stage rank: each writes its
    own into zeros and the buffers are summed over the stage group."""
    return _gather(mine.unsqueeze(0).contiguous(), mesh.stage_group, 0)


def _schedule(pipe: PipelinedStack, xs, bs, rng, base, records) -> List[torch.Tensor]:
    """This rank's stage over the T ticks, with a hop a tick; returns the
    tower's output microbatches (replicated). ``records`` (a list, or None
    without autograd) receives (microbatch, input, output) of each tick the
    stage computes, its input a leaf that takes a gradient."""
    mesh = pipe.mesh
    S, M, s = pipe.stages, pipe.microbatches, mesh.stage_index
    carry, outs = None, [None] * M
    zeros = torch.zeros_like(xs[0])
    for t in range(M + S - 1):
        m = t - s
        if 0 <= m < M:
            h = xs[m] if s == 0 else carry
            if records is not None:
                h = h.detach().requires_grad_(True)
                with torch.enable_grad():
                    out = pipe.run_stage(s, m, h, bs, rng, base)
                records.append((m, h, out))
                mine = out.detach()
            else:
                mine = pipe.run_stage(s, m, h, bs, rng, base)
        else:
            mine = zeros
        hop = _hop(mine, mesh)
        carry = hop[s - 1] if s > 0 else None
        if t >= S - 1:
            outs[t - (S - 1)] = hop[S - 1]
    return outs


class _StagePipeline(torch.autograd.Function):
    """This rank's stage of the schedule as one autograd node, so that the
    backward runs in reverse tick order on every rank: at each tick the
    stage's input gradient hops back over the stage group to stage s - 1,
    whose output it is; the last stage's output gradient is its own copy of
    the replicated tower output's. Inputs: the pipeline, the dropout RNG
    and its base ordinal, the bias microbatches, the tower input, then the
    held blocks' parameters, whose gradients it returns."""

    @staticmethod
    def forward(ctx, pipe, rng, base, bs, x, *params):
        ctx.pipe, ctx.records = pipe, []
        ctx.x_shape = x.shape
        outs = _schedule(pipe, list(x.detach().chunk(pipe.microbatches)), bs, rng, base,
                         ctx.records)
        ctx.params = params
        return torch.cat(outs, dim=0)

    @staticmethod
    def backward(ctx, gy):
        pipe, mesh = ctx.pipe, ctx.pipe.mesh
        S, M, s = pipe.stages, pipe.microbatches, mesh.stage_index
        records = {m: (h, out) for m, h, out in ctx.records}
        gys = list(gy.chunk(M))
        gx = gy.new_zeros(ctx.x_shape)
        gxs = list(gx.chunk(M))
        grads = [None] * len(ctx.params)
        g_next = None
        for t in reversed(range(M + S - 1)):
            m = t - s
            if 0 <= m < M:
                h, out = records.pop(m)
                g_out = gys[m] if s == S - 1 else g_next
                got = torch.autograd.grad([out], [h, *ctx.params], [g_out.contiguous()],
                                          allow_unused=True)
                g_in = got[0]
                for j, g in enumerate(got[1:]):
                    if g is not None:
                        grads[j] = g if grads[j] is None else grads[j] + g
                if s == 0:
                    gxs[m].copy_(g_in)
            else:
                g_in = torch.zeros_like(gys[0])
            hop = _hop(g_in, mesh)
            g_next = hop[s + 1] if s < S - 1 else None
        # the tower's input is replicated: every rank takes stage 0's gradient
        gx = _summed(gx, mesh.stage_group)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(ctx.params, grads)]
        return (None, None, None, None, gx, *grads)
