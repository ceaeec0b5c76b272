"""The recipes' losses, reference torch semantics.

Counterparts of ``speech_anonymization_tpu/losses/basic.py``: ``mse_loss``,
``l1_loss``, ``nll_loss`` ((B, C) log-probs, or (B, T, C) with relative
lengths), ``confusion_loss``, ``cosine_similarity_loss`` (the ASR utility
term), ``classification_error`` (the gender recipe's error rate), and the
ASR and LM recipes' sequence losses: ``kldiv_loss`` (label-smoothed) and
``ctc_loss`` with ``optax.ctc_loss``'s semantics.

Relative lengths become counts as the JAX package rounds them: the f32
product ``len * T`` rounded half to even.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_LN_HALF = -0.6931
CTC_LOG_EPSILON = -1e5  # optax.ctc_loss's log_epsilon: the log of an impossible transition


def _counts(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(B,) relative lengths -> (B,) f32 counts, ``round(len * t)`` half to even."""
    return torch.round(lengths.to(torch.float32) * t)


def length_mask(shape, lengths: torch.Tensor | None, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """(B, T) validity mask from (B,) relative lengths (all valid when None)."""
    b, t = shape[0], shape[1]
    if lengths is None:
        return torch.ones((b, t), dtype=dtype, device=device)
    idx = torch.arange(t, device=lengths.device)[None, :]
    return (idx < _counts(lengths, t)[:, None]).to(dtype)


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch.nn.MSELoss(reduction='mean')."""
    return torch.mean((pred - target) ** 2)


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch.nn.L1Loss(reduction='mean')."""
    return torch.mean(torch.abs(pred - target))


def nll_loss(log_probs: torch.Tensor, targets: torch.Tensor,
             lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Mean negative log-likelihood: of (B, C) log-probs at (B,) integer
    targets, or of (B, T, C) log-probs at (B, T) targets over the valid
    prefix of each row (relative ``lengths``)."""
    if log_probs.ndim == 2:
        picked = torch.gather(log_probs, 1, targets.long()[:, None])
        return -picked.mean()
    if log_probs.ndim != 3 or tuple(targets.shape) != tuple(log_probs.shape[:2]):
        raise ValueError(f"nll_loss takes (B, C) log-probs with (B,) targets or (B, T, C) with (B, T), "
                         f"got {tuple(log_probs.shape)} and {tuple(targets.shape)}")
    picked = torch.gather(log_probs, 2, targets.long()[..., None])[..., 0]
    mask = length_mask(targets.shape, lengths, log_probs.dtype, log_probs.device)
    return -torch.sum(picked * mask) / torch.clamp(torch.sum(mask), min=1.0)


def kldiv_loss(log_probs: torch.Tensor, targets: torch.Tensor, lengths: torch.Tensor | None = None,
               label_smoothing: float = 0.1, reduction: str = "batchmean",
               pad_idx: int = 0) -> torch.Tensor:
    """The label-smoothed sequence cost (``sb.nnet.losses.kldiv_loss``,
    SpeechBrain 0.5): ``(1 - ls) * NLL + ls * mean_c(-log p)`` per token of
    (B, T, C) log-probs, masked to each row's valid prefix; ``batchmean`` sums
    over tokens and divides by B, ``mean`` by the valid tokens, else the sum.
    ``pad_idx`` is unused, as in the JAX package."""
    b = log_probs.shape[0]
    picked = torch.gather(log_probs, 2, targets.long()[..., None])[..., 0]
    reg = -torch.mean(log_probs, dim=-1)
    per_token = (1.0 - label_smoothing) * (-picked) + label_smoothing * reg
    mask = length_mask(targets.shape, lengths, log_probs.dtype, log_probs.device)
    total = torch.sum(per_token * mask)
    if reduction == "batchmean":
        return total / b
    if reduction == "mean":
        return total / torch.clamp(torch.sum(mask), min=1.0)
    return total


def ctc_counts(input_lengths, t: int, target_lengths, u: int) -> tuple[np.ndarray, np.ndarray]:
    """The frame and label counts ``ctc_loss`` takes from relative lengths, on
    the host: ``round(len * T)`` in f32, half to even, as int64 arrays."""
    f32 = np.float32
    in_n = np.round(np.asarray(input_lengths, f32) * f32(t)).astype(np.int64)
    tg_n = np.round(np.asarray(target_lengths, f32) * f32(u)).astype(np.int64)
    return in_n, tg_n


def _fits(targets: np.ndarray, in_n: np.ndarray, tg_n: np.ndarray) -> np.ndarray:
    """(B,) bool: each row's frames cover its labels plus a blank between
    each pair of repeated labels."""
    out = np.empty(len(in_n), bool)
    for i, (n, k) in enumerate(zip(in_n, tg_n)):
        row = targets[i, :k]
        out[i] = n >= k + int(np.sum(row[1:] == row[:-1]))
    return out


def ctc_feasible(targets, input_lengths, t: int, target_lengths) -> np.ndarray:
    """(B,) bool, on the host from numpy (or CPU) values: whether some CTC
    alignment over ``t`` frames fits each row."""
    targets = np.asarray(targets)
    return _fits(targets, *ctc_counts(input_lengths, t, target_lengths, targets.shape[1]))


def ctc_loss_plain(log_probs: torch.Tensor, logit_paddings: torch.Tensor, labels: torch.Tensor,
                   label_paddings: torch.Tensor, blank_id: int = 0,
                   log_epsilon: float = CTC_LOG_EPSILON) -> torch.Tensor:
    """``optax.ctc_loss`` in plain torch: the per-sequence losses (B,) of
    (B, T, C) logits (log-softmaxed here, as optax does), with (B, T) and
    (B, N) float paddings (1 = pad), by the same log-space forward recursion,
    an impossible transition costing ``log_epsilon``. A row no alignment fits
    gets a finite loss of about ``-log_epsilon`` per missing frame."""
    logprobs = torch.log_softmax(log_probs, dim=-1)
    b, _, c = logprobs.shape
    n = labels.shape[1]
    labellens = n - torch.sum(label_paddings, dim=1).to(torch.int64)
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(logprobs.dtype), (0, 1))
    phi_all = logprobs[:, :, blank_id].transpose(0, 1)  # (T, B)
    one_hot = F.one_hot(labels.long(), c).to(logprobs.dtype)
    emit_all = torch.einsum("btk,bnk->tbn", logprobs, one_hot)  # (T, B, N)
    pads = logit_paddings.to(logprobs.dtype).transpose(0, 1)  # (T, B)

    def update_phi(phi, added):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], dim=-1)

    phi = torch.full((b, n + 1), log_epsilon, dtype=logprobs.dtype, device=logprobs.device)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), log_epsilon, dtype=logprobs.dtype, device=logprobs.device)
    for t in range(logprobs.shape[1]):
        prev_phi_orig = phi
        prev_phi = update_phi(phi, emit + log_epsilon * repeat)
        lp_emit, lp_phi, pad = emit_all[t], phi_all[t][:, None], pads[t][:, None]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit, emit + lp_emit)
        next_phi = update_phi(prev_phi + lp_phi, emit + lp_phi + log_epsilon * (1.0 - repeat))
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    phi_last = update_phi(phi, emit)
    return -torch.gather(phi_last, 1, labellens[:, None])[:, 0]


def ctc_loss(log_probs: torch.Tensor, targets: torch.Tensor, input_lengths: torch.Tensor,
             target_lengths: torch.Tensor, blank_index: int = 0, reduction: str = "batchmean",
             host: tuple | None = None) -> torch.Tensor:
    """CTC (``sb.nnet.losses.ctc_loss``) with ``optax.ctc_loss``'s semantics,
    as the JAX package computes it: (B, T, C) log-probs (log-softmaxed again,
    as optax does), (B, U) targets, relative input and target lengths;
    ``batchmean`` is the sum of the per-row losses over B, ``mean`` their mean
    per label, else the sum.

    Rows that an alignment fits go through ``F.ctc_loss`` (equal to optax's
    there). A row that none fits gets optax's finite ~1e5 loss and its
    gradient from :func:`ctc_loss_plain`, where ``F.ctc_loss`` would give
    inf. Which rows are which, and the frame and label counts, come from
    ``host``: the batch's ``(targets, input_lengths, target_lengths)`` as
    numpy, the values the tensors hold, so nothing is read back from the
    device (``F.ctc_loss`` takes its lengths on the host); without it they
    are read back."""
    b, t, _ = log_probs.shape
    u = targets.shape[1]
    if host is None:
        host = tuple(x.cpu().numpy() for x in (targets, input_lengths, target_lengths))
    in_n, tg_n = ctc_counts(host[1], t, host[2], u)
    feasible = _fits(np.asarray(host[0]), in_n, tg_n)
    dev = log_probs.device
    logprobs = torch.log_softmax(log_probs, dim=-1)
    per_seq = torch.zeros(b, dtype=log_probs.dtype, device=dev)
    ok = np.flatnonzero(feasible)
    if len(ok):
        rows = torch.as_tensor(ok, device=dev)
        lp = logprobs.index_select(0, rows).transpose(0, 1)  # (T, b_ok, C)
        per_seq = per_seq.index_put((rows,), F.ctc_loss(
            lp, targets.index_select(0, rows).long(), torch.from_numpy(in_n[ok]), torch.from_numpy(tg_n[ok]),
            blank=blank_index, reduction="none"))
    bad = np.flatnonzero(~feasible)
    if len(bad):
        rows = torch.as_tensor(bad, device=dev)
        pads = [torch.as_tensor(np.arange(n)[None, :] >= c[bad][:, None], dtype=logprobs.dtype, device=dev)
                for n, c in ((t, in_n), (u, tg_n))]
        per_seq = per_seq.index_put((rows,), ctc_loss_plain(
            log_probs.index_select(0, rows), pads[0], targets.index_select(0, rows), pads[1], blank_index))
    if reduction == "batchmean":
        return torch.sum(per_seq) / b
    if reduction == "mean":
        labels = torch.as_tensor(np.maximum(tg_n, 1), dtype=per_seq.dtype, device=dev)
        return torch.mean(per_seq / labels)
    return torch.sum(per_seq)


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
