"""Weighted classification metrics over a leading stack of models.

Counterparts of ``cross_entropy``, ``confusion_matrix``,
``f1_from_confusion``, ``precision_recall_from_confusion`` and
``ttest_vs_chance`` in ``imagined_speech_decoding_tpu/train/metrics.py``.
Every function reduces over the batch axis (the one before the class
axis) and keeps any leading axes, so one call serves a stack of M
models.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted-mean softmax cross-entropy: ``logits (..., B, K)``,
    ``labels (..., B)`` -> ``(...)``; divides by ``max(sum w, 1)``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    if weights is None:
        return nll.mean(dim=-1)
    w = weights.float()
    return (nll * w).sum(dim=-1) / w.sum(dim=-1).clamp_min(1.0)


def confusion_matrix(logits_or_preds: torch.Tensor, labels: torch.Tensor, n_classes: int,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted confusion counts ``(..., K, K)``, rows true and columns
    predicted; takes logits ``(..., B, K)`` or predictions ``(..., B)``."""
    pred = (
        logits_or_preds.argmax(dim=-1)
        if logits_or_preds.dim() > labels.dim()
        else logits_or_preds
    )
    w = torch.ones(labels.shape, device=labels.device) if weights is None else weights.float()
    oh_true = torch.nn.functional.one_hot(labels.long(), n_classes).float() * w.unsqueeze(-1)
    oh_pred = torch.nn.functional.one_hot(pred.long(), n_classes).float()
    return torch.einsum("...nk,...nj->...kj", oh_true, oh_pred)


def f1_from_confusion(cm: torch.Tensor) -> torch.Tensor:
    """Macro F1 of ``cm (..., K, K)`` with sklearn's zero-division rule: a
    class with zero precision and recall scores 0."""
    tp = torch.diagonal(cm, dim1=-2, dim2=-1)
    prec = tp / cm.sum(dim=-2).clamp_min(1e-12)
    rec = tp / cm.sum(dim=-1).clamp_min(1e-12)
    f1 = 2 * prec * rec / (prec + rec).clamp_min(1e-12)
    return f1.mean(dim=-1)


def precision_recall_from_confusion(cm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Macro precision and recall of ``cm (..., K, K)``."""
    tp = torch.diagonal(cm, dim1=-2, dim2=-1)
    prec = (tp / cm.sum(dim=-2).clamp_min(1e-12)).mean(dim=-1)
    rec = (tp / cm.sum(dim=-1).clamp_min(1e-12)).mean(dim=-1)
    return prec, rec


def ttest_vs_chance(accs: np.ndarray, chance: float = 0.2) -> Tuple[float, float]:
    """One-sample, one-sided t-test of per-subject accuracies against
    chance on the host (scipy): ``(t_stat, p_one_sided)``."""
    from scipy import stats

    t, p_two = stats.ttest_1samp(np.asarray(accs, np.float64), chance)
    p_one = p_two / 2.0 if t > 0 else 1.0 - p_two / 2.0
    return float(t), float(p_one)
