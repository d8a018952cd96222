"""Auxiliary losses (counterpart of ``d2r_tpu/ops/losses_extra.py``;
SURVEY.md section 2.7).

Checked-in-but-dead on the reference's live path, like the JAX package's:
none is part of the default training objective. Pure functions over
tensors, differentiable by autograd:

* :func:`soft_contrastive_loss`: bidirectional MildTriple ranking (ref:
  models/XModules.py:146-197).
* :func:`diff_loss`: the inverse mean distance between batch-whitened views
  (ref: models/XModules.py:558-585; the reference divides 1 by the mean,
  reproduced as written).
* :func:`labeled_js_div`: the sarcasm variant's JS divergence (ref:
  models/unimo_model.py:8-26), its quirks as written.
* :func:`supcon_loss`: supervised contrastive (ref:
  models/unimo_model.py:29-135).
"""

from __future__ import annotations

from typing import Optional

import torch

from d2r_tpu_torch.ops.losses import kl_div_batchmean


def soft_contrastive_loss(emb1: torch.Tensor, emb2: torch.Tensor, alpha: float,
                          margin: float = 0.0, max_violation: bool = False,
                          threshold_hetero: float = 1.0,
                          threshold_homo: float = 1.0) -> torch.Tensor:
    """Bidirectional MildTriple ranking loss over (B, D) embeddings."""

    def compute(a, b, thr_a, thr_b):
        scores = a @ b.T
        if max_violation:
            sa, sb = a @ a.T, b @ b.T
            mask = ((sa > thr_a) & (sa < 1 - 1e-6)) | ((sb > thr_b) & (sb < 1 - 1e-6))
            scores = torch.where(mask, torch.zeros_like(scores), scores)
        d = torch.diagonal(scores)[:, None]
        cost = torch.clamp(margin + scores - d, min=0.0)
        eye = torch.eye(scores.shape[0], dtype=torch.bool, device=scores.device)
        cost = torch.where(eye, torch.zeros_like(cost), cost)
        if max_violation:
            cost = torch.max(cost, dim=1).values
        return alpha * torch.sum(cost)

    return (compute(emb1, emb2, threshold_hetero, threshold_homo)
            + compute(emb2, emb1, threshold_hetero, threshold_homo))


def diff_loss(input1: torch.Tensor, input2: torch.Tensor) -> torch.Tensor:
    """1 / mean ||x1 - x2|| of the batch-centred, row-normalised views (the
    norms held constant in the backward, as the reference detaches them)."""
    b = input1.shape[0]
    x1 = input1.reshape(b, -1)
    x2 = input2.reshape(b, -1)
    x1 = x1 - torch.mean(x1, dim=0, keepdim=True)
    x2 = x2 - torch.mean(x2, dim=0, keepdim=True)
    x1 = x1 / (torch.linalg.norm(x1, dim=1, keepdim=True).detach() + 1e-6)
    x2 = x2 / (torch.linalg.norm(x2, dim=1, keepdim=True).detach() + 1e-6)
    return 1.0 / torch.mean(torch.linalg.norm(x1 - x2, dim=1))


def labeled_js_div(p_output: torch.Tensor, q_output: torch.Tensor, labels: torch.Tensor,
                   get_softmax: bool = True) -> torch.Tensor:
    """KL(batchmean) of log p against the label-flipped q, plus half the
    reference's regulariser ``(1/(||0.5-q||+margin) + (1/||0.5-p||) +
    margin)/2`` (its parenthesisation as written)."""
    margin = 0.5
    labels = labels[:, None].to(torch.float32)
    if get_softmax:
        p = torch.softmax(p_output.float(), dim=1)
        q = torch.softmax(q_output.float(), dim=1)
    else:
        p, q = p_output, q_output
    new_q = labels * q + (1.0 - labels) * (1.0 - q)
    regularizer = (1.0 / (torch.linalg.norm(0.5 - q) + margin)
                   + (1.0 / torch.linalg.norm(0.5 - p)) + margin) / 2.0
    return kl_div_batchmean(torch.log(p), new_q) + 0.5 * regularizer


def supcon_loss(features: torch.Tensor, labels: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                similarity: Optional[torch.Tensor] = None, temperature: float = 0.07,
                base_temperature: float = 0.07, contrast_mode: str = "all") -> torch.Tensor:
    """Supervised contrastive loss over features (B, n_views, D); the
    per-anchor log-probability is multiplied by (1 - similarity) when
    ``similarity`` is given, as the reference does."""
    b, n_views = features.shape[:2]
    feats = features.reshape(b, n_views, -1)
    contrast = torch.cat([feats[:, i] for i in range(n_views)], dim=0)
    dev = features.device
    if labels is not None:
        labels = labels.reshape(-1, 1)
        base_mask = (labels == labels.T).to(torch.float32)
    elif mask is not None:
        base_mask = mask.to(torch.float32)
    else:
        base_mask = torch.eye(b, dtype=torch.float32, device=dev)
    if contrast_mode == "one":
        anchor, anchor_count = feats[:, 0], 1
    else:
        anchor, anchor_count = contrast, n_views

    logits = (anchor @ contrast.T) / temperature
    logits = logits - torch.max(logits, dim=1, keepdim=True).values.detach()
    n = b * anchor_count
    self_mask = 1.0 - torch.eye(n, contrast.shape[0], dtype=torch.float32, device=dev)
    full_mask = base_mask.repeat(anchor_count, n_views) * self_mask
    exp_logits = torch.exp(logits) * self_mask
    log_prob = logits - torch.log(torch.sum(exp_logits, dim=1, keepdim=True))
    mask_sum = torch.sum(full_mask, dim=1)
    mask_sum = torch.where(mask_sum == 0, torch.ones_like(mask_sum), mask_sum)
    mean_log_prob_pos = torch.sum(full_mask * log_prob, dim=1) / mask_sum
    if similarity is not None:
        mean_log_prob_pos = mean_log_prob_pos * (1.0 - similarity)
    loss = -(temperature / base_temperature) * mean_log_prob_pos
    return torch.mean(loss.reshape(anchor_count, b))
