"""Multi-head attention dispatch (counterpart of ``d2r_tpu/ops/attention.py``).

All attention of the model goes through :func:`dot_product_attention`, over
(B, L, H, D) tensors in the projection layout (no head transposes):

* L, S <= 128 and D <= 128: the fused kernels, K1 forward and K2 backward
  (``ops/kernels/fused_attention.py``). On a CUDA tensor that launches the
  CUDA kernels; on a CPU tensor it runs their plain versions. Every site of
  the D2R-base model is in this band.
* kv length >= 256 on a CUDA tensor: the JAX package sends this to its
  long-context kernel, K3, which the port has not ported yet, so it raises.
* anything else: the plain einsum math, as the JAX package's XLA path.

The JAX package leaves its short-sequence kernel opt-in on the TPU, a TPU
measurement; the H100 takes K1 for every short site.
"""

from __future__ import annotations

from typing import Optional

import torch

from d2r_tpu_torch.ops.kernels.fused_attention import (
    fused_attention_small,
    fused_attention_small_plain,
    supports_fused_small,
)

# at / above this kv length the JAX package runs its long-context kernel
LONG_KV_LEN = 256


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    key_bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
) -> torch.Tensor:
    """Scaled dot-product attention with post-softmax dropout.

    q: (B, L, H, D); k, v: (B, S, H, D); key_bias: additive (B, S) or None;
    scale defaults to 1/sqrt(D). Dropout at ``dropout_rate`` runs when
    ``dropout_seed`` is an int (training) and not when it is None (eval);
    its bits are the kernels' (``dropout_keep_mask``) on every path.
    Returns (B, L, H, D) in q's type.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if dropout_seed is None:
        dropout_rate = 0.0
    if supports_fused_small(q, k):
        return fused_attention_small(q, k, v, key_bias, scale, dropout_rate, dropout_seed)
    if q.is_cuda and k.shape[1] >= LONG_KV_LEN:
        raise NotImplementedError(
            f"kv length {k.shape[1]} >= {LONG_KV_LEN} needs the long-context "
            "kernel K3 (d2r_tpu/ops/kernels/flash_attention.py), which is not "
            "ported yet; see ROADMAP.md Queue 2")
    return fused_attention_small_plain(q, k, v, key_bias, scale, dropout_rate,
                                       dropout_seed)


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, H*D) -> (B, L, H, D), a view even of a strided QKV slice."""
    b, l, hd = x.shape
    return x.view(b, l, num_heads, hd // num_heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, L, H, D) -> (B, L, H*D)."""
    b, l, h, d = x.shape
    return x.reshape(b, l, h * d)


def padding_key_bias(attention_mask: torch.Tensor) -> torch.Tensor:
    """1/0 padding mask (B, S) -> additive bias (B, S): cast to int, then
    ``(1 - m) * -10000``, as the reference's get_extended_attention_mask."""
    m = attention_mask.to(torch.int32).to(torch.float32)
    return (1.0 - m) * -10000.0
