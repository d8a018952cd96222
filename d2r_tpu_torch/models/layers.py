"""Shared building blocks (counterpart of ``d2r_tpu/models/layers.py``).

Every module takes the compute ``dtype`` and casts its input and weights to
it at use, as the JAX modules do (parameters stay fp32, in training too);
LayerNorm and BatchNorm compute in fp32 and return the compute type.
``nn.Module.training`` plays the part of the JAX modules' ``deterministic=
False, use_running_average=False``: dropout runs and BatchNorm uses and
updates batch statistics. Dropout draws only from the :class:`DropoutRNG`
the caller passes down. Weights are stored torch-style
(``weight`` is (out, in)); ``d2r_tpu_torch/weights.py`` translates the Flax
layouts. Parameters are created empty: :func:`init_weights` fills them from
an explicit ``torch.Generator``, in the JAX package's init families.

Across processes (``parallel/mesh.py``): ``shard_model`` gives each module
with a ``mesh`` attribute the process mesh, and sets ``tp`` on the modules
whose weights the model axis splits: a "column" ``TorchLinear`` or
``QKVDense`` sums its input's gradient over the model group, a "row"
``TorchLinear`` sums its partial output over it and adds the bias after, a
"vocab" ``Embed`` looks up its own rows and sums. ``TorchBatchNorm`` takes
its train-mode statistics over the data group (over the fabric group while
the fabric's rows are spread, ``rows_group``). Without a mesh (``mesh`` is
None) every module computes as one process does.

Sequence parallelism (``cfg.seq_shard``, a :class:`SeqShard` passed down a
tower block): the block's input, LayerNorms, dropouts and residuals hold
this model rank's slice of the sequence. A column-parallel layer (``side``
"in") gathers the slices of its input, and a row-parallel one (``side``
"out") splits its summed output (Megatron's reduce-scatter, with the
all-reduce's sum), so the products are those of the unsharded block. The
hidden dropout of a slice draws the bits of the slice's elements of the
whole tensor (``ops/kernels/dropout.py``'s ``layout``), so its masks are
the unsharded ones. The tensors a slice uses whole (the LayerNorms, the
row-parallel biases) get from each rank the gradient of its slice alone:
:func:`grad_scaled` multiplies it by the slice count, so that the
trainer's mean over the model group of the tensors it leaves whole is the
sum of the slices' gradients.

Quantized training under a model axis (``quant`` with ``tp``): the product
whose contraction the model axis splits (a row-parallel forward, a
column-parallel ``int8_all`` input gradient) takes its scales over the
whole contraction (a max over the model group) and sums its int32 partial
products over the group before they are scaled, as GSPMD partitions the
JAX program; so the quantized product equals one process's bit for bit,
and a column-parallel layer's input gradient is summed in ``quant_dot``,
not by :func:`copy_to`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from d2r_tpu_torch.ops.kernels.dropout import hidden_dropout
from d2r_tpu_torch.ops.kernels.fused_attention import DropoutSeed, seed_tensor, splitmix64
from d2r_tpu_torch.ops.qdot import quant_dot
from d2r_tpu_torch.parallel.distributed import (
    all_reduce_sum,
    copy_to,
    gather_seq,
    reduce_from,
    split_seq,
)

_M64 = (1 << 64) - 1


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as BERT uses."""
    return F.gelu(x, approximate="none")


ACT2FN = {
    "gelu": gelu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "quick_gelu": quick_gelu,
    "relu": torch.relu,
    "tanh": torch.tanh,
}


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape))


def fold_in(seed: int, data: int) -> int:
    """A 64-bit seed derived from ``(seed, data)``, the part
    ``jax.random.fold_in`` plays for keys."""
    return splitmix64((splitmix64(int(seed) & _M64) + int(data)) & _M64)


@dataclasses.dataclass(frozen=True)
class SeqShard:
    """A tower block's activations cut along the sequence over the model
    group: this rank holds slice ``index`` of ``count``, of a sequence of
    ``length``."""

    group: object
    index: int
    count: int
    length: int


class _Parallel:
    """The process mesh (``parallel/mesh.py``) and, where the model axis
    splits the module's tensors, how (``tp``) and along which Flax axis
    (``shards``: tensor name -> axis). Set by ``shard_model``.
    ``rows_group``, when set, replaces the data group as the group whose
    ranks hold the batch's rows (the fabric group under ``fabric_shard``,
    for the duration of the fabric's forward)."""

    mesh = None
    tp: Optional[str] = None
    shards: dict = {}
    rows_group = None

    def _model_group(self):
        return self.mesh.model_group if self.tp else None

    def _data_group(self):
        if self.rows_group is not None:
            return self.rows_group
        return None if self.mesh is None else self.mesh.data_group

    def _dense(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        """``x . weight^T (+ bias)`` in the compute type; a quantized module
        (``quant.py``) takes the W8A16 product instead."""
        return F.linear(x, self.weight.to(self.dtype), bias)

    def _quant_groups(self) -> dict:
        """``quant_dot``'s groups: the rows' group, and the model group
        with the side it splits."""
        return {"group": self._data_group(), "model_group": self._model_group(),
                "split": self.tp}


class _GradScaled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, k):
        ctx.k = k
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.k, None


def grad_scaled(t: torch.Tensor, seq: Optional[SeqShard]) -> torch.Tensor:
    """``t`` itself; under ``seq``, its gradient times the slice count (see
    the module docstring)."""
    return t if seq is None else _GradScaled.apply(t, float(seq.count))


def _column_input(module: "_Parallel", x: torch.Tensor, seq: Optional[SeqShard]):
    """The input of a module at the "in" side of a tower block's pair: the
    sequence slices joined under ``seq``; the partial gradients summed over
    the model group where the module is column-parallel, unless its
    quantized product sums them itself."""
    summed = module.tp == "column" and module.quant == "none"
    if seq is not None:
        return gather_seq(x, seq.group, summed)
    return copy_to(x, module._model_group()) if summed else x


def _seq_output(y: torch.Tensor, seq: Optional[SeqShard]) -> torch.Tensor:
    """The output of a module at the "out" side of a pair, already summed
    over the model group: this rank's sequence slice under ``seq``."""
    return y if seq is None else split_seq(y, seq.group)


class TorchLinear(_Parallel, nn.Module):
    """Dense layer with torch.nn.Linear's init: weight and bias uniform in
    +-1/sqrt(in); ``bias_init_value`` fixes the bias instead (the Router's
    1.5); ``use_bias=False`` has none. ``quant`` is the quantized-training
    mode (``ops/qdot.py``), set by the model from ``cfg.quant_train``: with
    ``"none"`` the product is ``F.linear``'s. ``tp`` "column" (output
    features split) or "row" (input features split) under a model axis."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32,
                 bias_init_value: Optional[float] = None, use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.bias_init_value = bias_init_value
        self.quant = "none"
        # "in" or "out": the end of a tower block's column/row pair this
        # layer is, set by the block (sequence parallelism)
        self.side: Optional[str] = None
        self.weight = _param(out_features, in_features)
        self.bias = _param(out_features) if use_bias else None

    def init_params(self, gen: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        self.weight.data.uniform_(-bound, bound, generator=gen)
        if self.bias is None:
            return
        if self.bias_init_value is None:
            self.bias.data.uniform_(-bound, bound, generator=gen)
        else:
            self.bias.data.fill_(self.bias_init_value)

    def _product(self, x: torch.Tensor) -> torch.Tensor:
        return quant_dot(x.to(self.dtype), self.weight.to(self.dtype), self.quant,
                         **self._quant_groups()).to(self.dtype)

    def forward(self, x: torch.Tensor, seq: Optional[SeqShard] = None) -> torch.Tensor:
        """``seq``: a tower block's sequence slices (``side`` says which end
        of its pair this layer is)."""
        bias = None if self.bias is None else self.bias.to(self.dtype)
        if seq is not None and self.side is None:
            raise ValueError("a sequence-sharded input reaches a layer with no side")
        if self.tp == "row" or (seq is not None and self.side == "out"):
            # the partial products summed (the quantized product sums its
            # int32 ones), then the bias once
            if self.quant == "none":
                y = reduce_from(self._dense(x.to(self.dtype), None), self._model_group())
            else:
                y = self._product(x)
            y = _seq_output(y, seq)
            return y if bias is None else y + grad_scaled(bias, seq)
        if self.tp == "column" or seq is not None:
            x = _column_input(self, x, seq)
        if self.quant == "none":
            return self._dense(x.to(self.dtype), bias)
        y = self._product(x)
        return y if bias is None else y + bias


class QKVDense(_Parallel, nn.Module):
    """Fused q/k/v projection: one (in -> 3*hidden) product. q, k and v come
    back as views of the (..., 3, hidden) result, with a row stride of
    3*hidden, which the attention kernel reads as they are. Quantized
    (``quant``), the whole (3*hidden, in) weight takes one scale per output
    row, as the JAX package's reshape to (in, 3*hidden) gives it. Under a
    model axis (``tp`` "column") each rank holds ``hidden`` = hidden/tp rows
    of each of q, k and v: whole heads, the JAX layout's split."""

    def __init__(self, in_features: int, hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.hidden = hidden
        self.quant = "none"
        self.weight = _param(3 * hidden, in_features)
        self.bias = _param(3 * hidden)

    def init_params(self, gen: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        self.weight.data.uniform_(-bound, bound, generator=gen)
        self.bias.data.uniform_(-bound, bound, generator=gen)

    def forward(self, x: torch.Tensor, seq: Optional[SeqShard] = None):
        x = _column_input(self, x, seq)
        if self.quant == "none":
            y = self._dense(x.to(self.dtype), self.bias.to(self.dtype))
        else:
            y = (quant_dot(x.to(self.dtype), self.weight.to(self.dtype), self.quant,
                           **self._quant_groups()).to(self.dtype) + self.bias.to(self.dtype))
        y = y.view(*y.shape[:-1], 3, self.hidden)
        return y[..., 0, :], y[..., 1, :], y[..., 2, :]


class BertPooler(nn.Module):
    """Token 0 -> Linear -> tanh."""

    def __init__(self, hidden_size: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense = TorchLinear(hidden_size, hidden_size, dtype=dtype)

    def forward(self, hidden_states: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(hidden_states[:, 0]))


class LayerNorm(nn.Module):
    """LayerNorm computed in fp32 (Flax's LayerNorm promotes bf16 input to
    fp32 for its statistics), returned in the compute type."""

    def __init__(self, features: int, eps: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = _param(features)
        self.bias = _param(features)

    def init_params(self, gen: torch.Generator) -> None:
        self.weight.data.fill_(1.0)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor, seq: Optional[SeqShard] = None) -> torch.Tensor:
        """``seq``: ``x`` is a sequence slice (the gradient of the weight and
        bias :func:`grad_scaled`)."""
        y = F.layer_norm(x.float(), self.weight.shape, grad_scaled(self.weight, seq).float(),
                         grad_scaled(self.bias, seq).float(), self.eps)
        return y.to(self.dtype)


# tables of at most this many rows (BERT's token types) take
# :class:`_SmallTableLookup` on the card
SMALL_TABLE_ROWS = 16


class _SmallTableLookup(torch.autograd.Function):
    """``F.embedding`` whose table gradient is summed without atomics: row v
    is the sum over the positions that look it up, one reduction a row
    (fixed order). The library's CUDA backward accumulates with atomics in
    no fixed order; where thousands of positions share a row (every token of
    a batch reads token type 0) two runs then part in the last bits of that
    row's gradient (``bisect_cli_runs.py``)."""

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.rows = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1, 1)
        g2d = g.reshape(-1, g.shape[-1])
        zero = g2d.new_zeros(())
        grad = torch.stack([torch.where(flat == v, g2d, zero).sum(0) for v in range(ctx.rows)])
        return None, grad


class Embed(_Parallel, nn.Module):
    """Lookup table returning the compute type. ``tp`` "vocab": this rank
    holds rows ``[i*n, (i+1)*n)`` of the table at model index i; other ids
    look up zeros, and the ranks' lookups are summed."""

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = _param(num_embeddings, features)

    def init_params(self, gen: torch.Generator) -> None:
        self.weight.data.normal_(0.0, 1.0 / math.sqrt(self.weight.shape[1]),
                                 generator=gen)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.tp != "vocab":
            if self.weight.is_cuda and self.weight.shape[0] <= SMALL_TABLE_ROWS:
                return _SmallTableLookup.apply(ids.long(), self.weight).to(self.dtype)
            return F.embedding(ids.long(), self.weight).to(self.dtype)
        n = self.weight.shape[0]
        local = ids.long() - self.mesh.model_index * n
        inside = (local >= 0) & (local < n)
        rows = F.embedding(torch.where(inside, local, torch.zeros_like(local)), self.weight)
        rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
        return reduce_from(rows, self._model_group()).to(self.dtype)


class DropoutRNG:
    """The randomness of one training forward, passed down explicitly (the
    global RNG is never read): ``seed``, a one-element int64 tensor on the
    model's device holding the step's 64-bit seed, and the ordinal of the
    next dropout site. Every site, an attention call (K1 and K2) or a
    hidden dropout (``ops/kernels/dropout.py``), takes the next ordinal and
    its kernel derives the site's Philox key from the two on the card
    (``ops/kernels/fused_attention.py::site_key``), as the JAX package's
    kernels read their seed from device memory. Writing the buffer reseeds
    a whole step: an eager one, or a CUDA graph's replay.

    ``row0``: the global batch row of this forward's first row (a data rank
    holds a slice of the step's rows). Every mask is keyed on global
    coordinates, the batch row, the head, the position, so a mesh draws the
    one-process step's bits whatever its layout."""

    def __init__(self, seed: Union[int, torch.Tensor], device=None, row0: int = 0):
        self.seed = seed if isinstance(seed, torch.Tensor) else seed_tensor(seed, device)
        self.site = 0
        self.row0 = row0

    def next_seed(self, h0: int = 0) -> DropoutSeed:
        """The next site's seed, at this forward's batch row and head
        ``h0`` (this model rank's first head at a head-split site)."""
        site = self.site
        self.site += 1
        return DropoutSeed(self.seed, site, self.row0, h0)


def _replay_draws(rng: DropoutRNG):
    """``checkpoint``'s ``context_fn`` for a layer drawing from ``rng``: the
    site counter now, as the layer's forward starts, and a context for the
    recompute that sets it back and afterwards returns it to where the
    backward found it."""
    at_forward = rng.site

    @contextlib.contextmanager
    def replay():
        now = rng.site
        rng.site = at_forward
        try:
            yield
        finally:
            rng.site = now

    return contextlib.nullcontext(), replay()


def remat(fn: Callable, *args, rng: Optional[DropoutRNG] = None):
    """``fn(*args)`` rematerialised: its activations are not kept for the
    backward, which runs ``fn`` again to rebuild them
    (``torch.utils.checkpoint``, non-reentrant), as ``nn.remat`` and
    ``jax.checkpoint`` do in the JAX package. Without autograd it is a plain
    call.

    The recompute must draw what the forward drew. Every mask is a
    function of the step's seed buffer and the site's ordinal, so
    :func:`_replay_draws` only winds ``rng``'s site counter back for the
    recompute: the step leaves it where it leaves it without remat."""
    if not torch.is_grad_enabled():
        return fn(*args)
    replay = {} if rng is None else {"context_fn": lambda: _replay_draws(rng)}
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **replay)


class Dropout(nn.Module):
    """Inverted dropout, as Flax's ``nn.Dropout``: in train mode an element
    is kept with probability 1 - rate and scaled by 1/(1-rate), its bit from
    the next site of ``rng`` (``ops/kernels/dropout.py``: a kernel on the
    card that regenerates the mask in the backward); the identity in eval
    mode or at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, rng: Optional[DropoutRNG],
                seq: Optional[SeqShard] = None) -> torch.Tensor:
        """``x`` (B, L, ...) holds rows ``rng.row0`` on of the step's
        batch; ``seq``: it is a sequence slice (B, L/n, ...). Either way it
        draws the bits of its elements in the whole step's tensor."""
        if not self.training or self.rate == 0.0:
            return x
        if rng is None:
            raise ValueError("train-mode dropout needs a DropoutRNG")
        return hidden_dropout(x, self.rate, rng.next_seed(), slice_layout(x, rng.row0, seq))


def slice_layout(x: torch.Tensor, row0: int, seq: Optional[SeqShard]):
    """``hidden_dropout``'s layout of ``x`` (B, L, ...) within the step's
    whole tensor: rows from ``row0`` of the batch, and under ``seq`` slice
    ``seq.index`` of the sequence; None for the whole tensor itself."""
    if row0 == 0 and seq is None:
        return None
    seg = math.prod(x.shape[1:])
    whole = seg if seq is None else seq.length * seg // x.shape[1]
    offset = row0 * whole + (0 if seq is None else seq.index * seg)
    return seg, whole, offset


def attention_dropout(module: nn.Module, rate: float, rng: Optional[DropoutRNG],
                      qkv: Optional[QKVDense] = None) -> Tuple[float, Optional[DropoutSeed]]:
    """(rate, seed) for ``dot_product_attention``: the next site of ``rng``
    in train mode at a non-zero rate, else no dropout. Where the model axis
    splits ``qkv`` by heads, the seed's head offset is this rank's first
    head (``module.head_dim`` wide), so the masks are the global heads'."""
    if not module.training or rate == 0.0:
        return 0.0, None
    if rng is None:
        raise ValueError("train-mode attention dropout needs a DropoutRNG")
    h0 = (qkv.mesh.model_index * (qkv.hidden // module.head_dim)
          if qkv is not None and qkv.tp else 0)
    return rate, rng.next_seed(h0)


class TorchBatchNorm(_Parallel, nn.Module):
    """torch.nn.BatchNorm1d over the last axis, statistics in fp32.

    Eval mode normalises with the running statistics. Train mode normalises
    with the biased batch statistics over every leading axis and updates the
    running ones in place with momentum 0.1 and the UNBIASED variance.
    ``row_valid`` (B,) restricts the batch statistics to the valid rows
    (a wrap-padded final batch), as ``d2r_tpu/models/layers.py:140-206``.
    Under a data axis the statistics are the global batch's, two-pass as on
    one process: the weighted sum and count summed over the data group give
    the mean, then the squared deviations are summed (autograd through both
    sums), so the running statistics come out equal on every rank."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32, momentum: float = 0.1):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.momentum = momentum
        self.weight = _param(num_features)
        self.bias = _param(num_features)
        self.register_buffer("running_mean", torch.empty(num_features))
        self.register_buffer("running_var", torch.empty(num_features))

    def init_params(self, gen: torch.Generator) -> None:
        self.weight.data.fill_(1.0)
        self.bias.data.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    @torch.no_grad()
    def _update_running(self, mean, var, unbiased_n) -> None:
        m = self.momentum
        self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1 - m) * self.running_var + m * (var * unbiased_n))

    def forward(self, x: torch.Tensor,
                row_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        x32 = x.float()
        group = self._data_group()
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            axes = tuple(range(x.ndim - 1))
            if row_valid is not None or group is not None:
                w = (torch.ones(x.shape[0], device=x.device) if row_valid is None
                     else row_valid.to(torch.float32))
                w = w.reshape((x.shape[0],) + (1,) * (x.ndim - 1))
                count = all_reduce_sum(torch.sum(w) * math.prod(x.shape[1:-1]), group)
                mean = all_reduce_sum(torch.sum(x32 * w, dim=axes), group) / count
                var = all_reduce_sum(torch.sum(w * torch.square(x32 - mean), dim=axes),
                                     group) / count
                unbiased_n = count / torch.clamp(count - 1.0, min=1.0)
            else:
                mean = torch.mean(x32, dim=axes)
                var = torch.mean(torch.square(x32 - mean), dim=axes)
                n = math.prod(x.shape[:-1])
                unbiased_n = n / max(n - 1, 1)
            self._update_running(mean, var, unbiased_n)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight + self.bias
        return y.to(self.dtype)


@torch.no_grad()
def init_weights(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Fill every parameter and buffer of ``model`` from ``gen``, module by
    module in registration order; the same generator state gives the same
    weights on any machine. Weights are made on the CPU, so build the model
    there and move it afterwards."""
    for m in model.modules():
        if hasattr(m, "init_params"):
            m.init_params(gen)
    return model
