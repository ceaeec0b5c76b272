"""Losses of the anonymizer's eval step, reference torch semantics.

Counterparts of ``speech_anonymization_tpu/losses/basic.py`` ``mse_loss``,
``nll_loss`` (utterance-level (B, C) case), ``confusion_loss`` and
``cosine_similarity_loss`` (the ASR utility term).
"""

from __future__ import annotations

import torch

_LN_HALF = -0.6931


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch.nn.MSELoss(reduction='mean')."""
    return torch.mean((pred - target) ** 2)


def nll_loss(log_probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of (B, C) log-probs at (B,) integer targets."""
    if log_probs.ndim != 2:
        raise ValueError(f"nll_loss takes (B, C) log-probs, got shape {tuple(log_probs.shape)}")
    picked = torch.gather(log_probs, 1, targets.long()[:, None])
    return -picked.mean()


def confusion_loss(sex_log_probs: torch.Tensor) -> torch.Tensor:
    """MSE(log-probs, ln(1/2) rounded to -0.6931): pushes sex posteriors to uniform."""
    return torch.mean((sex_log_probs - _LN_HALF) ** 2)


def cosine_similarity_loss(x1: torch.Tensor, x2: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``sum(1 - cos) / T`` over dim 2 of (B, T, D) inputs: the reference divides
    the sum over B*T by T, not by B*T."""
    dot = torch.sum(x1 * x2, dim=2)
    n1 = torch.sqrt(torch.sum(x1 * x1, dim=2))
    n2 = torch.sqrt(torch.sum(x2 * x2, dim=2))
    loss = 1.0 - dot / torch.clamp_min(n1 * n2, eps)
    return torch.sum(loss) / loss.shape[1]
