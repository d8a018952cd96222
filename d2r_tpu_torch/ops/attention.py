"""Multi-head attention dispatch (counterpart of ``d2r_tpu/ops/attention.py``).

All attention of the model goes through :func:`dot_product_attention`, over
(B, L, H, D) tensors in the projection layout (no head transposes):

* L, S <= 128 and D <= 128: the fused kernels, K1 forward and K2 backward
  (``ops/kernels/fused_attention.py``). Every site of D2R-base is in this
  band, and the text-side sites of D2R-large (L = S = 64).
* otherwise, with no attention dropout: the long-context kernel K3
  (``ops/kernels/flash_attention.py``) at any D, as the JAX package's,
  backward through its plain twin as in the JAX package. The vision-side
  sites of D2R-large (257 tokens: 24 + 1 CLIP-L layers and 4 IMRC cells)
  take it.
* with attention dropout outside K1's band: the plain einsum math, as the
  JAX package's XLA path computes it there (no kernel of either package
  takes dropout there). No site of either configuration takes this branch.

On a CUDA tensor the kernels' branches launch the CUDA kernels; on a CPU
tensor they run the kernels' plain versions. The JAX package's gates were
TPU measurements (its short-sequence kernel is opt-in, and K3 starts at a
kv length of 256); on the H100 every site a kernel can take goes to it.
"""

from __future__ import annotations

from typing import Optional

import torch

from d2r_tpu_torch.ops.kernels.flash_attention import flash_attention, supports_flash
from d2r_tpu_torch.ops.kernels.fused_attention import (
    fused_attention_small,
    fused_attention_small_plain,
    supports_fused_small,
)


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
    if dropout_rate == 0.0 and supports_flash(q):
        return flash_attention(q, k, v, key_bias, scale)
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
