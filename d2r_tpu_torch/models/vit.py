"""CLIP-ViT vision tower (counterpart of ``d2r_tpu/models/vit.py``):
on-device uint8 normalisation, bias-free conv patch embedding, class token,
learned positions, and pre-LN quick-gelu blocks. No attention mask: all
tokens attend. In train mode the attention probabilities drop out at
``attention_dropout`` (0 in the presets), as in the JAX package; its only
dropout site (the config check refuses a non-zero hidden ``dropout``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from d2r_tpu_torch.config import VisionEncoderConfig
from d2r_tpu_torch.models.layers import (
    ACT2FN,
    Embed,
    LayerNorm,
    QKVDense,
    TorchLinear,
    attention_dropout,
    remat,
)
from d2r_tpu_torch.ops.attention import dot_product_attention, merge_heads, split_heads

# CLIP's pixel statistics (copied from d2r_tpu/data/image.py)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class PatchConv(nn.Module):
    """Bias-free conv with stride = kernel = patch; weight OIHW."""

    def __init__(self, in_ch: int, out_ch: int, patch: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.patch = patch
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, patch, patch))

    def init_params(self, gen: torch.Generator) -> None:
        fan_in = self.weight[0].numel()
        self.weight.data.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        stride=self.patch)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: VisionEncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.patch_embedding = PatchConv(cfg.num_channels, cfg.hidden_size,
                                         cfg.patch_size, dtype)
        self.class_embedding = nn.Parameter(torch.empty(cfg.hidden_size))
        self.position_embedding = Embed(cfg.num_tokens, cfg.hidden_size, dtype)
        self.register_buffer("pixel_mean", torch.tensor(CLIP_MEAN)[:, None, None],
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(CLIP_STD)[:, None, None],
                             persistent=False)

    def init_params(self, gen: torch.Generator) -> None:
        self.class_embedding.data.normal_(0.0, 1.0, generator=gen)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values: (B, C, H, W), normalised floats or raw uint8; uint8
        is normalised here as ``(x/255 - mean)/std`` in fp32, the op order of
        the host-side preprocessing."""
        if pixel_values.dtype == torch.uint8:
            pixel_values = ((pixel_values.float() / 255.0 - self.pixel_mean.float())
                            / self.pixel_std.float())
        batch = pixel_values.shape[0]
        patches = self.patch_embedding(pixel_values)          # (B, hidden, h, w)
        patches = patches.flatten(2).transpose(1, 2)          # (B, h*w, hidden)
        cls = self.class_embedding.to(self.dtype).expand(batch, 1, -1)
        positions = self.position_embedding(
            torch.arange(self.cfg.num_tokens, device=pixel_values.device))
        return torch.cat([cls, patches], dim=1) + positions[None]


class CLIPAttention(nn.Module):
    def __init__(self, cfg: VisionEncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.qkv = QKVDense(cfg.hidden_size, cfg.hidden_size, dtype)
        self.out_proj = TorchLinear(cfg.hidden_size, cfg.hidden_size, dtype=dtype)

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        h = self.cfg.num_attention_heads
        q, k, v = self.qkv(x)
        rate, seed = attention_dropout(self, self.cfg.attention_dropout, rng)
        ctx = dot_product_attention(split_heads(q, h), split_heads(k, h),
                                    split_heads(v, h), scale=self.cfg.head_dim ** -0.5,
                                    dropout_rate=rate, dropout_seed=seed)
        return self.out_proj(merge_heads(ctx))


class CLIPEncoderLayer(nn.Module):
    """Pre-LN ViT block. ``remat_ffn_act`` as in ``bert.BertLayer``:
    ``act -> mlp_fc2`` rematerialised."""

    def __init__(self, cfg: VisionEncoderConfig, dtype: torch.dtype = torch.float32,
                 remat_ffn_act: bool = False):
        super().__init__()
        c = cfg
        self.remat_ffn_act = remat_ffn_act
        self.act = ACT2FN[c.hidden_act]
        self.layer_norm1 = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)
        self.self_attn = CLIPAttention(c, dtype)
        self.layer_norm2 = LayerNorm(c.hidden_size, c.layer_norm_eps, dtype)
        self.mlp_fc1 = TorchLinear(c.hidden_size, c.intermediate_size, dtype=dtype)
        self.mlp_fc2 = TorchLinear(c.intermediate_size, c.hidden_size, dtype=dtype)

    def ffn_out(self, pre: torch.Tensor) -> torch.Tensor:
        return self.mlp_fc2(self.act(pre))

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), rng)
        pre = self.mlp_fc1(self.layer_norm2(x))
        return x + (remat(self.ffn_out, pre) if self.remat_ffn_act else self.ffn_out(pre))


class CLIPVisionEncoder(nn.Module):
    """Stack of pre-LN blocks, named ``layer_{i}``; ``remat`` as in
    ``bert.BertEncoder`` (``d2r_tpu/models/vit.py:179-183``)."""

    def __init__(self, cfg: VisionEncoderConfig, dtype: torch.dtype = torch.float32,
                 remat: bool = False, remat_ffn_act: bool = False):
        super().__init__()
        self.num_layers = cfg.num_hidden_layers
        self.remat = remat
        for i in range(self.num_layers):
            self.add_module(f"layer_{i}", CLIPEncoderLayer(cfg, dtype, remat_ffn_act))

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            x = remat(layer, x, rng, rng=rng) if self.remat else layer(x, rng)
        return x
