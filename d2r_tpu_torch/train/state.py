"""Train state and step functions (counterpart of ``d2r_tpu/train/state.py``).

A step is what the reference's loop does per batch (forward, backward, AdamW
step with its schedule) plus the BatchNorm running statistics, which
train-mode forwards update in place. Every function returns the state it
was given, as the JAX ones return their new state. On the card the
attention sites run K1 forward and K2 backward
(``ops/kernels/fused_attention.py``), the hidden dropouts the dropout
kernel (``ops/kernels/dropout.py``) and the optimizer the AdamW kernel
(``ops/kernels/adamw.py``); parameters stay fp32 and each module casts them
to the compute type at use.

One program a step, as in JAX. The JAX package jits forward, backward,
optimizer and BatchNorm statistics into one program (its
``make_train_step``, ``make_multi_step`` and ``make_accum_step``). Here, on
the card in one process, a step is a CUDA graph replay:

* the first :data:`WARMUP_STEPS` steps of each batch signature (its keys,
  shapes and types: ``sentic_adj`` present or not) and step kind run
  eagerly on a side stream, as real steps of the run (they build the
  kernels, the optimizer's state and its device table, and every
  gradient's storage);
* then the step is captured: the zeroing of the gradients, forward,
  backward and the AdamW kernel with its count and schedule; with
  accumulation, a forward/backward graph for the first microbatch (with
  the zeroing), one for the others and an apply graph (the divide by the
  microbatch count, then AdamW); with ``debug_nans``, the forward/backward
  graph, the host check, then the apply graph, so a bad step still raises
  before any update;
* each later step writes its batch and its dropout seed through pinned
  host buffers into the graph's static inputs (non-blocking copies on the
  current stream), replays, and copies the loss and aux out of the static
  outputs on the device. No step is lost or repeated by the capture, and
  no host value is read back in the step.

The eval step (:func:`make_eval_step`) is one program too: one eager
forward a batch signature on the side stream, then a graph of the eval-mode
forward, replayed a batch, whose outputs are copied out before the next.

The eager step stays, by this rule and no other: on the CPU, and with a
mesh of more than one process (the gloo collectives the mesh runs cannot be
captured). A one-process NCCL world has no mesh here and captures.

Gradients stay allocated: a step zeroes them in place rather than setting
them to None, so their addresses, and the AdamW kernel's table of them,
hold from one step to the next. The step's gradients stay in ``.grad``
until the next step.

Dropout: a step's seed is ``fold_in(dropout_seed, step)`` (and the
microbatch, with accumulation), as ``jax.random.fold_in`` derives the
step's key, written into the state's one-element seed buffer on the device;
every dropout site of the forward takes the next ordinal of a
:class:`~d2r_tpu_torch.models.layers.DropoutRNG` over that buffer and its
kernel derives the site's key on the card. A replay therefore draws the
masks of the seed the buffer holds.

``debug_nans`` (``--debug_nans``, the port's counterpart of
``jax_debug_nans``): before the optimizer steps, every step checks its loss
and every gradient and raises ``FloatingPointError`` naming the step and
the first parameter whose gradient is not finite, so no update is applied
from it. The check reads one flag back from the device a step.

Across processes (``create_train_state(..., mesh=...)``, ``parallel/``): the
model is built whole on the CPU from the seed, as one process builds it,
then cut to this rank's slices (``shard_model``) and moved to its card. A
step runs this rank's rows; the model's collectives make the loss the
global batch's, and after the backward (after the last microbatch, with
accumulation) the gradients of the optimizer's parameters are averaged
over the data group, which is the global loss's gradient (the scheme of
``parallel/distributed.py``); those of the tensors a model axis leaves
whole are first averaged over the model group, and those of the tensors
outside the towers' blocks over the stage group (a stage rank's own blocks
are reduced over the data group only), which keeps the replicas equal to
the bit (:func:`_reduce_gradients`). No ``DistributedDataParallel`` wrapper: one
explicit reduction a step covers the leaves that get no gradient (CMA's
unread ``fc_1``/``fc_2`` at ``alpha != 0``; AdamW still decays them) and
frozen towers alike, and the state dict keeps its keys. Every rank takes
the step's seed as it is: each dropout site keys its bits on the global
batch row (the rank's rows start at ``data_index`` x its row count), head
and position (:class:`~d2r_tpu_torch.models.layers.DropoutRNG`), so a mesh
step draws the one-process step's masks, under either ``prng_impl``. With
microbatches (accumulation, or a pipelined tower's ``models/pipeline.py``)
microbatch ``m`` of the step is the data ranks' m-th microbatches side by
side: the mesh step equals the one-process step whose microbatch ``m``
holds them in rank order (the batch itself when ``dp`` is 1 or there is one
microbatch).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from d2r_tpu_torch.config import D2RConfig, resolve_device
from d2r_tpu_torch.models.layers import DropoutRNG, fold_in
from d2r_tpu_torch.models.unimo import build_model
from d2r_tpu_torch.ops.kernels.fused_attention import seed_tensor
from d2r_tpu_torch.parallel.mesh import Mesh, shard_model, stage_owned
from d2r_tpu_torch.train.optimizer import AdamW, make_optimizer

BATCH_KEYS = ("input_ids", "attention_mask", "token_type_ids", "labels",
              "pixel_values")
OPTIONAL_KEYS = ("valid", "sentic_adj")
# elements a bucket of the gradient all-reduce
REDUCE_BUCKET = 1 << 24
# eager steps of each batch signature and step kind before its capture
WARMUP_STEPS = 2
# eager eval forwards of each batch signature before its capture
EVAL_WARMUP = 1


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: AdamW
    step: int = 0
    mesh: Optional[Mesh] = None
    # the step's dropout seed (one int64) on the model's device
    seed: Optional[torch.Tensor] = None
    # the captured steps (:class:`_Captured`), made at the first card step
    captured: Optional["_Captured"] = dataclasses.field(default=None, repr=False)


def _input_keys(batch: Mapping):
    return BATCH_KEYS + tuple(k for k in OPTIONAL_KEYS if k in batch)


def _model_inputs(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    """The model's keyword inputs from a batch of numpy arrays or tensors,
    on ``device``; ``valid`` (B,) and ``sentic_adj`` (B, L, L) are passed on
    when present."""
    return {k: torch.as_tensor(batch[k]).to(device) for k in _input_keys(batch)}


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def create_train_state(cfg: D2RConfig, total_steps: int = 1000, device="cuda",
                       seed: int = 0, model: Optional[nn.Module] = None,
                       mesh: Optional[Mesh] = None) -> TrainState:
    """A train state on ``device``: ``model`` (moved there) or a fresh
    ``D2RClassifier`` with random weights from ``seed``, in train mode, with
    the 4-group AdamW of ``train/optimizer.py`` scheduled over
    ``total_steps``. With a ``mesh`` of more than one process the whole
    model (the one given, or the seed's, built on the CPU) is cut to this
    rank's slices first. Raises if ``device`` is CUDA and no GPU is
    present."""
    dev = resolve_device(device)
    if mesh is not None and mesh.world > 1:
        model = build_model(cfg, device="cpu", seed=seed) if model is None else model
        model = shard_model(model, mesh).to(dev)
    else:
        mesh = None
        model = build_model(cfg, device=dev, seed=seed) if model is None else model.to(dev)
    optimizer = make_optimizer(cfg, total_steps, model.train())
    return TrainState(model, optimizer, mesh=mesh,
                      seed=torch.zeros(1, dtype=torch.int64, device=dev))


def _step_seed(state: TrainState, dropout_seed: int, microbatch: Optional[int] = None) -> int:
    """The dropout seed of this step (and microbatch), the same on every
    rank of a mesh."""
    seed = fold_in(dropout_seed, state.step)
    return seed if microbatch is None else fold_in(seed, microbatch)


def _zero_grads(model: nn.Module) -> None:
    """Zero every gradient in place (their storage, and addresses, stay)."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if grads:
        torch._foreach_zero_(grads)


def _fb(model: nn.Module, inputs: Mapping[str, torch.Tensor], seed: torch.Tensor,
        mesh: Optional[Mesh] = None):
    """One train-mode forward and backward drawing dropout from the seed
    buffer ``seed`` (at the global rows of this data rank of ``mesh``);
    gradients add into ``.grad``. Returns the detached loss and aux."""
    model.train()
    row0 = 0 if mesh is None else mesh.data_index * inputs["input_ids"].shape[0]
    loss, _, aux = model(**inputs, rng=DropoutRNG(seed, row0=row0))
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in aux.items()}


def _forward_backward(model: nn.Module, batch: Mapping, seed: int,
                      mesh: Optional[Mesh] = None):
    """:func:`_fb` on a host batch with the int ``seed``: the eager forward
    and backward."""
    dev = _device(model)
    return _fb(model, _model_inputs(batch, dev), seed_tensor(seed, dev), mesh)


def _check_finite(state: TrainState, loss: torch.Tensor) -> None:
    """``FloatingPointError`` if ``loss`` or any gradient is not finite."""
    named = [(n, p.grad) for n, p in state.model.named_parameters() if p.grad is not None]
    flags = torch.stack([torch.isfinite(loss).all()]
                        + [torch.isfinite(g).all() for _, g in named]).cpu()
    if bool(flags.all()):
        return
    where = ("the loss" if not flags[0] else
             "the gradient of " + next(n for (n, _), ok in zip(named, flags[1:]) if not ok))
    raise FloatingPointError(f"debug_nans: step {state.step}: {where} is not finite "
                             f"(loss {float(loss)})")


@torch.no_grad()
def _mean_over(grads, group, size: int) -> None:
    """Replace each of ``grads`` by its mean over ``group``, in buckets of
    at most :data:`REDUCE_BUCKET` elements."""
    bucket, count = [], 0
    for g in list(grads) + [None]:
        if bucket and (g is None or count + g.numel() > REDUCE_BUCKET):
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat, group=group)
            flat.div_(size)
            torch._foreach_copy_(bucket, [v.view_as(t) for v, t in
                                          zip(flat.split([t.numel() for t in bucket]), bucket)])
            bucket, count = [], 0
        if g is not None:
            bucket.append(g)
            count += g.numel()


def _reduce_gradients(state: TrainState) -> None:
    """The mesh's gradient reduction. Under a model axis, first the mean
    over the model group of the gradients of the tensors it leaves whole:
    every model rank computes them alike, but not always to the bit on the
    card (a scatter-add's order can differ between two processes, e.g. the
    token-type embedding's backward, where every token hits row 0), and
    replicas updated from different bits drift apart; the mean of equal
    values changes nothing. (Under ``fabric_shard`` each model rank's
    fabric gradient is ``tp`` times its rows' share, and the mean is their
    sum: ``parallel/distributed.py``.) Under a stage axis, the same mean
    over the stage group of the tensors outside the towers' blocks, which
    every stage rank holds and computes. Then the mean of every gradient
    over the data group: the global loss's gradient."""
    mesh = state.mesh
    if mesh is None:
        return
    named = {id(p): k for k, p in state.model.named_parameters()}
    grads = [p for g in state.optimizer.param_groups for p in g["params"]
             if p.grad is not None]
    if mesh.tp > 1:
        split = {id(getattr(m, name)) for m in state.model.modules()
                 for name in getattr(m, "shards", {})}
        _mean_over([p.grad for p in grads if id(p) not in split], mesh.model_group, mesh.tp)
    if mesh.pp > 1:
        _mean_over([p.grad for p in grads if not stage_owned(named[id(p)], mesh)],
                   mesh.stage_group, mesh.pp)
    if mesh.dp > 1:
        _mean_over([p.grad for p in grads], mesh.data_group, mesh.dp)


@torch.no_grad()
def _divide_grads(model: nn.Module, k: int) -> None:
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if grads:
        torch._foreach_div_(grads, k)


# ---- the eager steps ------------------------------------------------------

def _write_seed(state: TrainState, seed: int) -> None:
    """Write ``seed`` into the state's seed buffer (eager steps; the
    captured ones stage it with their batch)."""
    if state.seed.device.type == "cuda":
        _captured(state).write({}, {}, seed)
    else:
        state.seed.copy_(seed_tensor(seed))


def _eager_step(state: TrainState, batch: Mapping, dropout_seed: int, debug_nans: bool):
    _zero_grads(state.model)
    _write_seed(state, _step_seed(state, dropout_seed))
    loss, aux = _fb(state.model, _model_inputs(batch, state.seed.device), state.seed,
                    state.mesh)
    _reduce_gradients(state)
    if debug_nans:
        _check_finite(state, loss)
    state.optimizer.step()
    return {"loss": loss, **aux}


def _eager_accum(state: TrainState, micro: List[Mapping], dropout_seed: int,
                 debug_nans: bool):
    model = state.model
    _zero_grads(model)
    total = None
    for i, batch in enumerate(micro):
        _write_seed(state, _step_seed(state, dropout_seed, i))
        loss, _ = _fb(model, _model_inputs(batch, state.seed.device), state.seed, state.mesh)
        total = loss.float() if total is None else total + loss.float()
    _reduce_gradients(state)
    _divide_grads(model, len(micro))
    if debug_nans:
        _check_finite(state, total)
    state.optimizer.step()
    return {"loss": total / len(micro)}


# ---- the captured steps ---------------------------------------------------

class _Program:
    """The captured graphs of one batch signature and step kind: static
    device inputs, pinned host staging buffers (two, each reused once the
    copies that read it have run), the graphs by name and their static
    outputs."""

    def __init__(self, inputs: Dict[str, torch.Tensor]):
        self.inputs = inputs
        self.graphs: Dict[str, torch.cuda.CUDAGraph] = {}
        self.out: Dict[str, torch.Tensor] = {}


class _Captured:
    """A train state's captured steps on the card: the side stream of the
    warm-up steps and captures, the graphs' shared memory pool, the pinned
    buffers of the seed writes, and the programs by (kind, signature)."""

    def __init__(self, state: TrainState):
        self.device = state.seed.device
        self.seed = state.seed
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.programs: Dict[tuple, _Program] = {}
        self.eager: Dict[tuple, int] = {}
        self._slots: Dict[tuple, List] = {}
        self._events: Dict[tuple, List] = {}
        self._turn: Dict[tuple, int] = {}

    def write(self, arrays: Mapping, dsts: Mapping[str, torch.Tensor],
              seed: Optional[int] = None) -> None:
        """Queue copies of ``arrays`` (numpy or tensors) into ``dsts`` and of
        ``seed``, when given, into the seed buffer, on the current stream,
        through pinned buffers: no host sync, save a wait for the copies of
        two writes ago to have run before their buffers are reused."""
        key = tuple((k, tuple(d.shape), d.dtype) for k, d in dsts.items())
        if key not in self._slots:
            self._slots[key] = [None, None]
            self._events[key] = [None, None]
            self._turn[key] = 0
        i = self._turn[key]
        self._turn[key] = 1 - i
        if self._events[key][i] is not None:
            self._events[key][i].synchronize()
        if self._slots[key][i] is None:
            self._slots[key][i] = {
                **{k: torch.empty(d.shape, dtype=d.dtype).pin_memory() for k, d in dsts.items()},
                "__seed__": torch.empty(1, dtype=torch.int64).pin_memory()}
        slot = self._slots[key][i]
        if seed is not None:
            slot["__seed__"].copy_(seed_tensor(seed))
            self.seed.copy_(slot["__seed__"], non_blocking=True)
        for k, dst in dsts.items():
            x = arrays[k]
            if isinstance(x, torch.Tensor) and x.device.type == "cuda":
                dst.copy_(x)
                continue
            host = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            slot[k].numpy()[...] = host
            dst.copy_(slot[k], non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        self._events[key][i] = event

    def warm(self, key: tuple, runs: int = WARMUP_STEPS) -> bool:
        """Whether the step ``key`` still runs eagerly (its first ``runs``
        calls); counts the run."""
        n = self.eager.get(key, 0)
        if n < runs:
            self.eager[key] = n + 1
            return True
        return False

    def eagerly(self, fn: Callable, *args):
        """``fn(*args)`` on the side stream, ordered after and before the
        current stream's work."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            out = fn(*args)
        current.wait_stream(self.stream)
        return out

    def capture(self, name: str, program: _Program, body: Callable) -> None:
        """Capture ``body()`` into ``program.graphs[name]``; the outputs it
        returns join ``program.out``. A capture that fails raises."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            out = body()
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        program.graphs[name] = graph
        program.out.update(out or {})


def _signature(batch: Mapping) -> tuple:
    return tuple((k, tuple(np.shape(batch[k])), str(getattr(batch[k], "dtype", "")))
                 for k in _input_keys(batch))


def _captured(state: TrainState) -> _Captured:
    if state.captured is None:
        state.captured = _Captured(state)
    return state.captured


def captures(state: TrainState) -> bool:
    """The rule for the step's form: captured on the card in one process;
    eager on the CPU and across processes (gloo collectives cannot be
    captured)."""
    return state.mesh is None and state.seed.device.type == "cuda"


def _static_inputs(batch: Mapping, device) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(np.shape(batch[k]), device=device,
                           dtype=torch.as_tensor(batch[k][:0]).dtype)
            for k in _input_keys(batch)}


def _program(state: TrainState, key: tuple, batch: Mapping, build: Callable) -> _Program:
    cap = _captured(state)
    if key not in cap.programs:
        program = _Program(_static_inputs(batch, cap.device))
        build(cap, program)
        # the graphs write these: they live while the program does
        program.keep = [p.grad for p in state.model.parameters()]
        cap.programs[key] = program
    return cap.programs[key]


def _outputs(program: _Program, names) -> Dict[str, torch.Tensor]:
    """Copies, on the device, of the static outputs a replay overwrites."""
    return {k: program.out[k].clone() for k in names}


def _captured_step(state: TrainState, batch: Mapping, dropout_seed: int, debug_nans: bool):
    model, opt = state.model, state.optimizer
    key = ("step", debug_nans, _signature(batch))

    def build(cap: _Captured, p: _Program) -> None:
        def fb():
            _zero_grads(model)
            loss, aux = _fb(model, p.inputs, cap.seed)
            return {"loss": loss, **aux}

        def step():
            out = fb()
            opt.step()
            return out

        if debug_nans:
            cap.capture("fb", p, fb)
            cap.capture("apply", p, opt.step)
        else:
            cap.capture("step", p, step)

    p = _program(state, key, batch, build)
    _captured(state).write(batch, p.inputs, _step_seed(state, dropout_seed))
    if debug_nans:
        p.graphs["fb"].replay()
        _check_finite(state, p.out["loss"])
        p.graphs["apply"].replay()
    else:
        p.graphs["step"].replay()
    return _outputs(p, p.out)


def _captured_accum(state: TrainState, micro: List[Mapping], dropout_seed: int,
                    debug_nans: bool):
    model, opt, k = state.model, state.optimizer, len(micro)
    key = ("accum", k, debug_nans, _signature(micro[0]))

    def build(cap: _Captured, p: _Program) -> None:
        def first():
            _zero_grads(model)
            loss, _ = _fb(model, p.inputs, cap.seed)
            return {"total": loss.float()}

        def more():
            loss, _ = _fb(model, p.inputs, cap.seed)
            p.out["total"].add_(loss.float())

        def apply():
            _divide_grads(model, k)
            opt.step()
            return {"loss": p.out["total"] / k}

        cap.capture("first", p, first)
        if k > 1:
            cap.capture("more", p, more)
        cap.capture("apply", p, apply)

    p = _program(state, key, micro[0], build)
    cap = _captured(state)
    for i, batch in enumerate(micro):
        cap.write(batch, p.inputs, _step_seed(state, dropout_seed, i))
        p.graphs["first" if i == 0 else "more"].replay()
    if debug_nans:
        _check_finite(state, p.out["total"])
    p.graphs["apply"].replay()
    return _outputs(p, ["loss"])


def _run(state: TrainState, kind: tuple, eager: Callable, captured: Callable, *args):
    """One step of ``kind``: eager by the rule of :func:`captures`, or while
    the kind's warm-up steps last (on the side stream), else captured."""
    if not captures(state):
        out = eager(state, *args)
    else:
        cap = _captured(state)
        out = (cap.eagerly(eager, state, *args) if cap.warm(kind) else captured(state, *args))
    state.step += 1
    return out


def make_train_step(debug_nans: bool = False) -> Callable:
    """``train_step(state, batch, dropout_seed) -> (state, metrics)``: one
    optimizer step on ``batch``; metrics are the loss, ce_loss and js_loss
    as device scalars (reading them syncs). On the card in one process, a
    CUDA graph replay after the warm-up steps."""

    def train_step(state: TrainState, batch: Mapping, dropout_seed: int):
        metrics = _run(state, ("step", debug_nans, _signature(batch)), _eager_step,
                       _captured_step, batch, dropout_seed, debug_nans)
        return state, metrics

    return train_step


def _microbatch(stacked: Mapping, i: int) -> Dict:
    return {k: v[i] for k, v in stacked.items()}


def make_multi_step(num_steps: int, debug_nans: bool = False) -> Callable:
    """``multi_step(state, stacked, dropout_seed)``: ``num_steps`` train
    steps over batches stacked on a leading axis, returning
    ``{"loss": last loss, "losses": (num_steps,)}``. On the card, the
    single step's graph replayed ``num_steps`` times."""
    single = make_train_step(debug_nans)

    def multi_step(state: TrainState, stacked: Mapping, dropout_seed: int):
        losses = []
        for i in range(num_steps):
            state, metrics = single(state, _microbatch(stacked, i), dropout_seed)
            losses.append(metrics["loss"])
        losses = torch.stack(losses)
        return state, {"loss": losses[-1], "losses": losses}

    return multi_step


def make_accum_step(accum_steps: int, debug_nans: bool = False) -> Callable:
    """``accum_step(state, stacked, dropout_seed)``: ONE optimizer step from
    the gradients averaged over ``accum_steps`` microbatches stacked on a
    leading axis. The microbatches run in order, so train-mode BatchNorm sees
    each as that many sequential steps would; microbatch i's dropout seed
    folds in ``(step, i)``. Returns ``{"loss": mean microbatch loss}``. On
    the card, a forward/backward graph replayed a microbatch, then the
    apply graph."""

    def accum_step(state: TrainState, stacked: Mapping, dropout_seed: int):
        micro = [_microbatch(stacked, i) for i in range(accum_steps)]
        metrics = _run(state, ("accum", accum_steps, debug_nans, _signature(micro[0])),
                       _eager_accum, _captured_accum, micro, dropout_seed, debug_nans)
        return state, metrics

    return accum_step


def _eval_forward(model: nn.Module, inputs: Mapping[str, torch.Tensor]):
    model.eval()
    loss, logits, aux = model(**inputs)
    return {"loss": loss, "logits": logits, **aux}


def _eager_eval(state: TrainState, batch: Mapping) -> Dict[str, torch.Tensor]:
    return _eval_forward(state.model, _model_inputs(batch, _device(state.model)))


def _captured_eval(state: TrainState, batch: Mapping) -> Dict[str, torch.Tensor]:
    key = ("eval", _signature(batch))

    def build(cap: _Captured, p: _Program) -> None:
        cap.capture("eval", p, lambda: _eval_forward(state.model, p.inputs))

    p = _program(state, key, batch, build)
    _captured(state).write(batch, p.inputs)
    p.graphs["eval"].replay()
    return _outputs(p, p.out)


def make_eval_step() -> Callable:
    """``eval_step(state, batch) -> metrics``: an eval-mode forward (no
    dropout, BatchNorm on its running statistics) returning the loss, the
    logits, ce_loss and js_loss, as the JAX package's one jitted eval
    program. On the card in one process (:func:`captures`), a CUDA graph
    replay a batch signature after :data:`EVAL_WARMUP` eager forward on the
    side stream; the graph reads the parameters and BatchNorm statistics
    where they live, so train steps (the AdamW kernel) and
    ``restore_checkpoint`` (``load_state_dict``) reach it by writing them in
    place. The metrics are copies of the graph's static outputs, so every
    batch keeps its own. Eager on the CPU and across processes."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Mapping) -> Dict[str, torch.Tensor]:
        if not captures(state):
            return _eager_eval(state, batch)
        cap = _captured(state)
        if cap.warm(("eval", _signature(batch)), EVAL_WARMUP):
            return cap.eagerly(_eager_eval, state, batch)
        return _captured_eval(state, batch)

    return eval_step
