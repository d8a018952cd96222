"""BERT text tower (counterpart of ``d2r_tpu/models/bert.py``): embeddings
with absolute (BERT) or RoBERTa positions, post-LN blocks, exact-erf GELU
and the additive (1-mask)*-10000 key bias. In train mode dropout runs at
``hidden_dropout_prob`` on the embeddings, the attention output and the FFN
output, and at ``attention_probs_dropout_prob`` on the attention
probabilities (inside the fused kernel). Submodule names are the Flax module
names, so each parameter has the path of its Flax leaf."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from d2r_tpu_torch.config import TextEncoderConfig
from d2r_tpu_torch.models.layers import (
    ACT2FN,
    Dropout,
    Embed,
    LayerNorm,
    QKVDense,
    SeqShard,
    TorchLinear,
    _Parallel,
    attention_dropout,
    remat,
)
from d2r_tpu_torch.models.pipeline import PipelinedStack
from d2r_tpu_torch.ops.attention import dot_product_attention, merge_heads, split_heads
from d2r_tpu_torch.parallel.distributed import gather_seq, split_seq


class BertEmbeddings(nn.Module):
    """word + token_type + position embeddings, then LayerNorm and dropout.

    Positions are ``0..seq_len-1`` (``position_style="absolute"``) or
    RoBERTa's, derived from the attention mask as HF's
    ``create_position_ids_from_input_ids``: ``cumsum(mask) * mask +
    pad_token_id``, so real tokens take rows ``pad+1, pad+2, ...`` and padded
    slots the ``pad_token_id`` row (``d2r_tpu/models/bert.py:45-67``).

    The PAD row of the word table gets no gradient, as torch's
    ``nn.Embedding(padding_idx=pad)`` in the reference: the lookups at PAD
    positions are detached (``d2r_tpu/models/bert.py:80-91``)."""

    def __init__(self, cfg: TextEncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.position_style not in ("absolute", "roberta"):
            raise ValueError(f"unknown position_style {cfg.position_style!r}; "
                             "known: 'absolute', 'roberta'")
        self.cfg = cfg
        c = cfg
        self.word_embeddings = Embed(c.vocab_size, c.hidden_size, dtype)
        self.position_embeddings = Embed(c.max_position_embeddings, c.hidden_size, dtype)
        self.token_type_embeddings = Embed(c.type_vocab_size, c.hidden_size, dtype)
        self.LayerNorm = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)
        self.dropout = Dropout(c.hidden_dropout_prob)

    def position_ids(self, input_ids: torch.Tensor,
                     attention_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """(1, L) or (B, L) rows of the position table. Checked on the host
        against the table's size: out of range, a CUDA gather would be a
        device-side assert, not a clean error."""
        c, seq_len = self.cfg, input_ids.shape[1]
        if c.position_style == "absolute":
            if seq_len > c.max_position_embeddings:
                raise ValueError(f"seq_len {seq_len} exceeds max_position_embeddings "
                                 f"{c.max_position_embeddings}")
            return torch.arange(seq_len, device=input_ids.device)[None, :]
        if attention_mask is None:
            raise ValueError("position_style='roberta' needs the attention mask to "
                             "derive position ids")
        if seq_len + c.pad_token_id + 1 > c.max_position_embeddings:
            raise ValueError(
                f"roberta positions need max_position_embeddings >= seq_len + "
                f"pad_token_id + 1 = {seq_len + c.pad_token_id + 1}, have "
                f"{c.max_position_embeddings}")
        mask = attention_mask.to(torch.int32)
        return torch.cumsum(mask, dim=1, dtype=torch.int32) * mask + c.pad_token_id

    def forward(self, input_ids: torch.Tensor, token_type_ids: torch.Tensor,
                rng=None, attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        positions = self.position_ids(input_ids, attention_mask)
        words = self.word_embeddings(input_ids)
        is_pad = (input_ids == self.cfg.pad_token_id)[..., None]
        words = torch.where(is_pad, words.detach(), words)
        x = (words
             + self.token_type_embeddings(token_type_ids)
             + self.position_embeddings(positions))
        return self.dropout(self.LayerNorm(x), rng)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: TextEncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.head_dim = cfg.head_dim
        self.qkv = QKVDense(cfg.hidden_size, cfg.hidden_size, dtype)

    def forward(self, x: torch.Tensor, key_bias, rng=None,
                seq: Optional[SeqShard] = None) -> torch.Tensor:
        h = self.qkv.hidden // self.head_dim     # this rank's heads under a model axis
        q, k, v = self.qkv(x, seq)
        rate, seed = attention_dropout(self, self.cfg.attention_probs_dropout_prob, rng,
                                       self.qkv)
        ctx = dot_product_attention(split_heads(q, h), split_heads(k, h),
                                    split_heads(v, h), key_bias=key_bias,
                                    scale=self.cfg.head_dim ** -0.5,
                                    dropout_rate=rate, dropout_seed=seed)
        return merge_heads(ctx)


class BertSelfOutput(nn.Module):
    """dense -> dropout -> LayerNorm(x + input)."""

    def __init__(self, cfg: TextEncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dense = TorchLinear(cfg.hidden_size, cfg.hidden_size, dtype=dtype)
        self.dense.side = "out"
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype)
        self.dropout = Dropout(cfg.hidden_dropout_prob)

    def forward(self, hidden: torch.Tensor, input_tensor: torch.Tensor,
                rng=None, seq: Optional[SeqShard] = None) -> torch.Tensor:
        return self.LayerNorm(self.dropout(self.dense(hidden, seq), rng, seq) + input_tensor,
                              seq)


class BertLayer(nn.Module):
    """Post-LN BERT block. ``remat_ffn_act``: the FFN's 4x-wide activation
    is not kept for the backward but rebuilt from the pre-activation
    (``act -> output_dense`` rematerialised; the dropout after it stays
    outside), the part of the step that the JAX package's
    ``save_anything_except_these_names("ffn_act")`` policy recomputes
    (``d2r_tpu/train/state.py:138-147``)."""

    def __init__(self, cfg: TextEncoderConfig, dtype: torch.dtype = torch.float32,
                 remat_ffn_act: bool = False):
        super().__init__()
        c = cfg
        self.remat_ffn_act = remat_ffn_act
        self.act = ACT2FN[c.hidden_act]
        self.attention_self = BertSelfAttention(c, dtype)
        self.attention_output = BertSelfOutput(c, dtype)
        self.intermediate_dense = TorchLinear(c.hidden_size, c.intermediate_size, dtype=dtype)
        self.output_dense = TorchLinear(c.intermediate_size, c.hidden_size, dtype=dtype)
        self.attention_self.qkv.side, self.intermediate_dense.side = "in", "in"
        self.output_dense.side = "out"
        self.output_LayerNorm = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)
        self.output_dropout = Dropout(c.hidden_dropout_prob)

    def ffn_out(self, pre: torch.Tensor, seq: Optional[SeqShard] = None) -> torch.Tensor:
        return self.output_dense(self.act(pre), seq)

    def forward(self, x: torch.Tensor, key_bias=None, rng=None,
                seq: Optional[SeqShard] = None) -> torch.Tensor:
        """``seq``: ``x`` and the output are this rank's sequence slices
        (``models/layers.py``)."""
        x = self.attention_output(self.attention_self(x, key_bias, rng, seq), x, rng, seq)
        pre = self.intermediate_dense(x, seq)
        h = remat(self.ffn_out, pre, seq) if self.remat_ffn_act else self.ffn_out(pre, seq)
        return self.output_LayerNorm(self.output_dropout(h, rng, seq) + x, seq)


class BertEncoder(_Parallel, nn.Module):
    """Stack of ``num_hidden_layers`` post-LN blocks, named ``layer_{i}``.
    ``remat``: each block rematerialised (:func:`remat`), keeping only its
    input for the backward, as ``nn.remat(BertLayer)`` at
    ``d2r_tpu/models/bert.py:255-259``. The JAX package's ``scan_layers``
    changes only its parameters' layout (``weights.py``): the loop is the
    same. ``stages`` > 1 runs the blocks as a GPipe pipeline of that many
    stages over ``microbatches`` (``models/pipeline.py``; JAX
    ``d2r_tpu/models/bert.py:225-239``); under a stage axis this process
    holds only its stage's blocks (``parallel.mesh.shard_model``).
    ``seq_shard``: under a model axis that divides the sequence, the blocks
    run on this rank's sequence slice (JAX ``bert.py:193-195,262-265``);
    a pipelined stack leaves it out, as JAX does."""

    def __init__(self, cfg: TextEncoderConfig, dtype: torch.dtype = torch.float32,
                 remat: bool = False, remat_ffn_act: bool = False, stages: int = 1,
                 microbatches: int = 0, seq_shard: bool = False):
        super().__init__()
        self.num_layers = cfg.num_hidden_layers
        self.remat = remat
        self.stages, self.microbatches = stages, microbatches or stages
        self.seq_shard = seq_shard
        for i in range(self.num_layers):
            self.add_module(f"layer_{i}", BertLayer(cfg, dtype, remat_ffn_act))

    def block(self, i: int, x, key_bias=None, rng=None, seq=None):
        layer = getattr(self, f"layer_{i}")
        return (remat(layer, x, key_bias, rng, seq, rng=rng) if self.remat
                else layer(x, key_bias, rng, seq))

    def forward(self, x: torch.Tensor, key_bias=None, rng=None) -> torch.Tensor:
        if self.stages > 1:
            return pipeline_of(self)(x, key_bias, rng)
        seq = seq_shard_of(self, x)
        x = x if seq is None else split_seq(x, seq.group)
        for i in range(self.num_layers):
            x = self.block(i, x, key_bias, rng, seq)
        return x if seq is None else gather_seq(x, seq.group, summed=False)


def seq_shard_of(tower: nn.Module, x: torch.Tensor) -> Optional[SeqShard]:
    """The sequence slices of a tower's blocks: under ``seq_shard`` with a
    model axis larger than 1 that divides the sequence, else None (a no-op,
    as JAX's ``seq_sharding_constraint``, ``d2r_tpu/parallel/mesh.py:200-205``)."""
    mesh = tower.mesh
    if not tower.seq_shard or mesh is None or mesh.tp == 1 or x.shape[1] % mesh.tp:
        return None
    return SeqShard(mesh.model_group, mesh.model_index, mesh.tp, x.shape[1])


def held_layers(tower: nn.Module):
    """The block indices this process holds, in order."""
    return [i for i in range(tower.num_layers) if hasattr(tower, f"layer_{i}")]


def pipeline_of(tower: nn.Module) -> PipelinedStack:
    """The GPipe schedule over ``tower``'s blocks (its ``block``)."""
    return PipelinedStack(tower.block, tower.num_layers, tower.stages, tower.microbatches,
                          lambda: [p for i in held_layers(tower)
                                   for p in getattr(tower, f"layer_{i}").parameters()],
                          tower.mesh)
