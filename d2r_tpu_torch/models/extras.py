"""Checked-in-but-dead reference modules (counterpart of
``d2r_tpu/models/extras.py``; SURVEY.md section 2.7).

None is reachable from the live training path of the reference or of either
package; they complete the module surface, with the Flax module and leaf
names, so ``weights.py::load_jax_variables`` loads a JAX tree of each
strictly:

* :class:`SELayer`: squeeze-excitation over modality channels (ref:
  models/XModules.py:258-273). The reference's ``channel // channel``
  reduction is always 1, reproduced as written.
* :class:`GraphReasoning`: SGRAF full-graph similarity reasoning (ref:
  models/XModules.py:331-363); its weights keep the Flax layout (in, out)
  under their Flax names.
* :class:`GatedQueryAttLayer`, :class:`AGSA`, :class:`SelfEncoder`: the
  adaptive gated self-attention stack (ref: models/XModules.py:48-143).
* :class:`VariationalEncoder`, :class:`AmbiguityLearning`: VAE-style
  modality-ambiguity weighting (ref: models/XModules.py:396-450). The
  noise comes from an explicit ``torch.Generator`` or is passed in, so a
  caller can feed the JAX package's draws.

Modules compute in ``dtype`` as the rest of the port's do (parameters fp32,
cast at use); BatchNorm in train mode uses and updates batch statistics
(``use_running_average=False`` in JAX), in eval mode the running ones.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from d2r_tpu_torch.models.layers import TorchBatchNorm, TorchLinear, _param
from d2r_tpu_torch.ops.losses import js_div


class SELayer(nn.Module):
    """x: (B, C, D) -> (x scaled by its channel gates, the gates (B, C))."""

    def __init__(self, channel: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = channel // channel          # the reference's quirk: 1
        self.fc_0 = TorchLinear(channel, hidden, dtype=dtype, use_bias=False)
        self.fc_2 = TorchLinear(hidden, channel, dtype=dtype, use_bias=False)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        y = torch.mean(x, dim=-1)
        gate = torch.sigmoid(self.fc_2(torch.relu(self.fc_0(y))))
        return x * gate[..., None], gate


class GraphReasoning(nn.Module):
    """sim_emb (B, L, sim_dim) -> relu(W_sim (softmax(q k^T) sim_emb)), the
    three products' kernels (in, out) Xavier-uniform, biases zero."""

    def __init__(self, sim_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        for name in ("graph_query_w", "graph_key_w", "sim_graph_w"):
            setattr(self, f"{name}_kernel", _param(sim_dim, sim_dim))
            setattr(self, f"{name}_bias", _param(sim_dim))

    def init_params(self, gen: torch.Generator) -> None:
        d = self.graph_query_w_kernel.shape[0]
        r = math.sqrt(6.0) / math.sqrt(2 * d)
        for name in ("graph_query_w", "graph_key_w", "sim_graph_w"):
            getattr(self, f"{name}_kernel").data.uniform_(-r, r, generator=gen)
            getattr(self, f"{name}_bias").data.zero_()

    def _lin(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return (x @ getattr(self, f"{name}_kernel").to(self.dtype)
                + getattr(self, f"{name}_bias").to(self.dtype))

    def forward(self, sim_emb: torch.Tensor) -> torch.Tensor:
        sim_emb = sim_emb.to(self.dtype)
        q, k = self._lin("graph_query_w", sim_emb), self._lin("graph_key_w", sim_emb)
        edge = torch.softmax(torch.einsum("bld,bmd->blm", q.float(), k.float()), dim=-1)
        sgr = torch.einsum("blm,bmd->bld", edge.to(self.dtype).float(), sim_emb.float())
        return torch.relu(self._lin("sim_graph_w", sgr.to(self.dtype)))


class GatedQueryAttLayer(nn.Module):
    """Multi-head self-attention whose q and k are gated by
    sigmoid(fc_g(fc_q(q) * fc_k(k))); x (B, L, embed_size)."""

    def __init__(self, embed_size: int, h: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_size, self.h = embed_size, h
        d_k = embed_size // h
        self.linear_q = TorchLinear(embed_size, embed_size, dtype=dtype)
        self.linear_k = TorchLinear(embed_size, embed_size, dtype=dtype)
        self.linear_v = TorchLinear(embed_size, embed_size, dtype=dtype)
        self.fc_q = TorchLinear(d_k, d_k, dtype=dtype)
        self.fc_k = TorchLinear(d_k, d_k, dtype=dtype)
        self.fc_g = TorchLinear(d_k, 2 * d_k, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, l, _ = x.shape
        d_k = self.embed_size // self.h
        heads = lambda t: t.reshape(b, l, self.h, d_k).transpose(1, 2)
        q, k, v = (heads(m(x)) for m in (self.linear_q, self.linear_k, self.linear_v))
        gate = torch.sigmoid(self.fc_g(self.fc_q(q) * self.fc_k(k)))
        q = q * gate[..., :d_k]
        k = k * gate[..., d_k:]
        scores = torch.einsum("bhld,bhmd->bhlm", q.float(), k.float()) / math.sqrt(d_k)
        if mask is not None:
            scores = torch.where(mask == 0, torch.full_like(scores, -1e9), scores)
        p = torch.softmax(scores, dim=-1).to(q.dtype)
        out = torch.einsum("bhlm,bhmd->bhld", p.float(), v.float()).to(q.dtype)
        return out.transpose(1, 2).reshape(b, l, self.embed_size)


class AGSA(nn.Module):
    """Adaptive gating self-attention: ``num_layers`` residual
    (GatedQueryAttLayer -> BatchNorm over the (B*L, D) rows) blocks."""

    def __init__(self, num_layers: int, embed_size: int, h: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"att_{i}", GatedQueryAttLayer(embed_size, h, dtype))
            setattr(self, f"bn_{i}", TorchBatchNorm(embed_size, dtype=dtype))

    def forward(self, rgn_emb: torch.Tensor) -> torch.Tensor:
        agsa = rgn_emb
        for i in range(self.num_layers):
            agsa = agsa + getattr(self, f"bn_{i}")(getattr(self, f"att_{i}")(agsa))
        return agsa


class SelfEncoder(nn.Module):
    """x (B, L, hidden_size) -> mapping to embed_size, one AGSA block, then
    a residual (fc1 -> relu -> fc2 -> BatchNorm)."""

    def __init__(self, hidden_size: int, embed_size: int, head: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mapping = TorchLinear(hidden_size, embed_size, dtype=dtype)
        self.agsa = AGSA(1, embed_size, h=head, dtype=dtype)
        self.fc1 = TorchLinear(embed_size, hidden_size, dtype=dtype)
        self.fc2 = TorchLinear(hidden_size, embed_size, dtype=dtype)
        self.bn = TorchBatchNorm(embed_size, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        agsa = self.agsa(self.mapping(x))
        return agsa + self.bn(self.fc2(torch.relu(self.fc1(agsa))))


class VariationalEncoder(nn.Module):
    """x (..., in_features) -> (mu, softplus(sigma) + 1e-7), each
    (..., z_dim), through a 768-wide hidden layer."""

    def __init__(self, in_features: int = 768, z_dim: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.z_dim = z_dim
        self.net_0 = TorchLinear(in_features, 768, dtype=dtype)
        self.net_2 = TorchLinear(768, 2 * z_dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        params = self.net_2(torch.relu(self.net_0(x)))
        return params[..., :self.z_dim], F.softplus(params[..., self.z_dim:]) + 1e-7


def _normal_log_prob(z, mu, sigma):
    """``Independent(Normal(mu, sigma), 1).log_prob(z)``."""
    var = torch.square(sigma)
    return torch.sum(-0.5 * (torch.square(z - mu) / var + torch.log(2 * math.pi * var)),
                     dim=-1)


class AmbiguityLearning(nn.Module):
    """Symmetric-KL ambiguity weighting: ``weight_js * -js_div(weight_input,
    [1 - skl, skl, 1 - skl])``, skl the sigmoid of the two encodings'
    sampled symmetric KL. The encoders stay fp32 whatever ``dtype``, as in
    the JAX package."""

    def __init__(self, text_features: int = 768, image_features: int = 768,
                 weight_js: float = 0.5):
        super().__init__()
        self.weight_js = weight_js
        self.encoder_text = VariationalEncoder(text_features)
        self.encoder_image = VariationalEncoder(image_features)

    def forward(self, text_encoding: torch.Tensor, image_encoding: torch.Tensor,
                weight_input: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """``noise``: the two standard-normal draws (each of mu's shape);
        else they come from ``generator``, which must then be given."""
        mu1, s1 = self.encoder_text(text_encoding)
        mu2, s2 = self.encoder_image(image_encoding)
        if noise is None:
            if generator is None:
                raise ValueError("AmbiguityLearning samples: pass a torch.Generator or the "
                                 "two noise tensors")
            noise = [torch.randn(mu.shape, generator=generator, device=generator.device)
                     .to(mu.device) for mu in (mu1, mu2)]
        z1, z2 = mu1 + s1 * noise[0], mu2 + s2 * noise[1]
        kl_1_2 = _normal_log_prob(z1, mu1, s1) - _normal_log_prob(z1, mu2, s2)
        kl_2_1 = _normal_log_prob(z2, mu2, s2) - _normal_log_prob(z2, mu1, s1)
        skl = torch.sigmoid((kl_1_2 + kl_2_1) / 2.0)
        weight_uni = (1 - skl)[:, None]
        weight_target = torch.cat([weight_uni, skl[:, None], weight_uni], dim=1)
        return self.weight_js * (-js_div(weight_input, weight_target))
