"""Forward losses of ``D2RClassifier`` (counterpart of
``d2r_tpu/ops/losses.py``): cross-entropy plus the path-consistency JS term,
which the reference adds with a NEGATIVE sign."""

from __future__ import annotations

from typing import Optional

import torch


def kl_div_batchmean(log_input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``torch.nn.KLDivLoss(reduction='batchmean')`` with 0*log(0) = 0."""
    pointwise = torch.xlogy(target, target) - target * log_input
    return torch.sum(pointwise) / target.shape[0]


def js_div(p_logits: torch.Tensor, q_logits: torch.Tensor,
           valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric JS divergence of two row-softmaxed similarity matrices.

    Entries where a softmax row underflows to exactly 0 contribute 0 (safe
    log). ``valid`` (B,) drops invalid columns from each row softmax and
    invalid rows from the batch mean.
    """
    if valid is not None:
        v = valid.to(torch.float32)
        col_bias = (1.0 - v)[None, :] * -1e30
        p = torch.softmax(p_logits.float() + col_bias, dim=-1)
        q = torch.softmax(q_logits.float() + col_bias, dim=-1)
        row_mask = v[:, None]
        denom = torch.clamp(torch.sum(v), min=1.0)
    else:
        p = torch.softmax(p_logits.float(), dim=-1)
        q = torch.softmax(q_logits.float(), dim=-1)
        row_mask = None
        denom = p_logits.shape[0]
    m = (p + q) / 2.0

    def kl_vs_mean(t):
        pos = t > 0
        safe_t = torch.where(pos, t, torch.ones_like(t))
        safe_m = torch.where(pos, m, torch.ones_like(m))
        pointwise = torch.where(
            pos, safe_t * (torch.log(safe_t) - torch.log(safe_m)),
            torch.zeros_like(t))
        if row_mask is not None:
            pointwise = pointwise * row_mask
        return torch.sum(pointwise) / denom

    return (kl_vs_mean(p) + kl_vs_mean(q)) / 2.0


def path_consistency_loss(sim_paths, sim_text, reversed_sim_paths, sim_vision,
                          weight_js_1: float, weight_js_2: float,
                          valid=None) -> torch.Tensor:
    """``-w1*JS(sim_paths, sim_text) - w2*JS(rev_sim_paths, sim_vision)``."""
    return (-weight_js_1 * js_div(sim_paths, sim_text, valid=valid)
            - weight_js_2 * js_div(reversed_sim_paths, sim_vision, valid=valid))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels; ``valid`` masks rows."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    if valid is None:
        return torch.mean(nll)
    v = valid.to(torch.float32)
    return torch.sum(nll * v) / torch.clamp(torch.sum(v), min=1.0)


def ccr_contrastive_loss(img_rep: torch.Tensor, txt_rep: torch.Tensor, alpha: float,
                         beta: float = 0.0, margin: float = 0.2) -> torch.Tensor:
    """CCR + CCS margin ranking loss (``d2r_tpu/ops/losses.py:127-161``).

    img_rep (B, L, 2, D): the attention and reverse-attention views,
    normalised; txt_rep (B, L, 1, D): the text view, normalised. CCR: each
    view's score against the text vector, a hinge of ``margin`` against the
    attention view's (the first view is the positive and adds nothing).
    CCS: the (B, L, L) Gram of attention views against text tokens, a hinge
    against its diagonal, the diagonal left out, the max violation a row.
    Returns ``alpha * sum(CCR) + beta * sum(CCS)``."""
    # 1/sqrt(D) in fp32 as JAX computes it, a host float (no device work)
    inv_sqrt_d = (1.0 / torch.sqrt(torch.tensor(float(img_rep.shape[-1])))).item()
    scores = torch.einsum("blvd,blud->blvu", img_rep, txt_rep)[..., 0] * inv_sqrt_d
    cost_ccr = torch.clamp(margin + scores - scores[..., 0:1], min=0.0)
    cost_ccr = torch.cat([torch.zeros_like(cost_ccr[..., :1]), cost_ccr[..., 1:]], dim=-1)

    ccs = torch.einsum("bld,bmd->blm", img_rep[:, :, 0, :], txt_rep[:, :, 0, :]) * inv_sqrt_d
    diag = torch.diagonal(ccs, dim1=-2, dim2=-1)[..., None]
    cost_ccs = torch.clamp(margin + ccs - diag, min=0.0)
    eye = torch.eye(ccs.shape[-1], dtype=torch.bool, device=ccs.device)[None]
    cost_ccs = torch.where(eye, torch.zeros_like(cost_ccs), cost_ccs).amax(dim=-1)
    return alpha * torch.sum(cost_ccr) + beta * torch.sum(cost_ccs)
