"""Losses of the anonymizer's eval step, reference torch semantics.

Counterparts of ``speech_anonymization_tpu/losses/basic.py`` ``mse_loss``,
``nll_loss`` (utterance-level (B, C) case), ``confusion_loss``,
``cosine_similarity_loss`` (the ASR utility term) and
``classification_error`` (the gender recipe's error rate).
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


def classification_error(log_probs: torch.Tensor, targets: torch.Tensor,
                         lengths: torch.Tensor | None = None) -> torch.Tensor:
    """The share of argmax predictions that miss their targets
    (``sb.nnet.losses.classification_error``): over (B, C) log-probs (or (B, 1,
    C)) against (B,) targets, or over (B, T, C) against (B, T) within the
    valid prefix of each row (relative ``lengths``, rounded half to even)."""
    if log_probs.ndim == 3 and log_probs.shape[1] == 1:
        log_probs = log_probs[:, 0]
    err = (torch.argmax(log_probs, dim=-1) != targets).to(torch.float32)
    if log_probs.ndim == 2:
        return err.mean()
    t = targets.shape[1]
    if lengths is None:
        mask = torch.ones_like(err)
    else:
        idx = torch.arange(t, device=err.device)[None, :]
        mask = (idx < torch.round(lengths * t)[:, None]).to(torch.float32)
    return (err * mask).sum() / torch.clamp(mask.sum(), min=1.0)
