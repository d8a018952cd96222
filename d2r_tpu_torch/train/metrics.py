"""Evaluation metrics (counterpart of ``d2r_tpu/train/metrics.py``).

Numpy implementations of the reference's sklearn weighted accuracy /
precision / recall / F1. Weighted F1 on dev selects the best model.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def _per_class_counts(labels: np.ndarray, preds: np.ndarray, num_classes: int):
    tp = np.zeros(num_classes)
    fp = np.zeros(num_classes)
    fn = np.zeros(num_classes)
    support = np.zeros(num_classes)
    for c in range(num_classes):
        tp[c] = np.sum((preds == c) & (labels == c))
        fp[c] = np.sum((preds == c) & (labels != c))
        fn[c] = np.sum((preds != c) & (labels == c))
        support[c] = np.sum(labels == c)
    return tp, fp, fn, support


def get_four_metrics(
    labels: Sequence[int],
    preds: Sequence[int],
    average: str = "weighted",
    num_classes: int = None,
) -> Dict[str, float]:
    """accuracy, recall, precision, f1 — sklearn 'weighted' semantics
    (zero_division=0)."""
    labels = np.asarray(labels)
    preds = np.asarray(preds)
    if num_classes is None:
        num_classes = int(max(labels.max(initial=0), preds.max(initial=0))) + 1

    acc = float(np.mean(labels == preds)) if len(labels) else 0.0
    tp, fp, fn, support = _per_class_counts(labels, preds, num_classes)

    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 0.0)
        recall = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
        f1 = np.where(precision + recall > 0,
                      2 * precision * recall / np.maximum(precision + recall, 1e-12),
                      0.0)

    if average == "weighted":
        total = support.sum()
        w = support / total if total > 0 else np.zeros_like(support)
        p, r, f = float(precision @ w), float(recall @ w), float(f1 @ w)
    elif average == "macro":
        p, r, f = float(precision.mean()), float(recall.mean()), float(f1.mean())
    elif average == "micro":
        tps, fps, fns = tp.sum(), fp.sum(), fn.sum()
        p = float(tps / (tps + fps)) if tps + fps > 0 else 0.0
        r = float(tps / (tps + fns)) if tps + fns > 0 else 0.0
        f = 2 * p * r / (p + r) if p + r > 0 else 0.0
    else:
        raise ValueError(f"unknown average: {average}")

    return {"accuracy": acc, "recall": r, "precision": p, "f_score": f}
