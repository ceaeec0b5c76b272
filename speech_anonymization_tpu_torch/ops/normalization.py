"""Streaming global input normalization with functional state.

Counterpart of ``speech_anonymization_tpu/ops/normalization.py``
(SpeechBrain ``InputNormalization``, ``norm_type: global``): masked
per-utterance mean/std, a running mean of them folded in while
``epoch < update_until_epoch``, then ``(x - glob_mean) / glob_std``. The
sequential per-utterance update has the closed form
``new = (count*old + sum(utt_stats)) / (count + B)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..parallel.mesh import psum


class NormalizerState(NamedTuple):
    """Running global statistics."""

    count: torch.Tensor      # scalar fp32: utterances folded in
    glob_mean: torch.Tensor  # (D,)
    glob_std: torch.Tensor   # (D,)


class InputNormalizer:
    """Global mean/variance normalizer with epoch-gated stat freezing.

    With a ``mesh`` (set by ``parallel.use_mesh``), an update folds in the
    global batch: the per-utterance sums and the utterance count summed over
    the ranks."""

    mesh = None

    def __init__(self, dim: int = 80, update_until_epoch: int = 4, eps: float = 1e-10,
                 mean_norm: bool = True, std_norm: bool = True):
        self.dim = dim
        self.update_until_epoch = update_until_epoch
        self.eps = eps
        self.mean_norm = mean_norm
        self.std_norm = std_norm

    def init_state(self, device: str | torch.device = "cuda") -> NormalizerState:
        return NormalizerState(
            count=torch.zeros((), dtype=torch.float32, device=device),
            glob_mean=torch.zeros(self.dim, dtype=torch.float32, device=device),
            glob_std=torch.ones(self.dim, dtype=torch.float32, device=device),
        )

    def _utterance_stats(self, x: torch.Tensor, lengths: torch.Tensor | None):
        """Masked per-utterance mean/std: (B, T, D) -> ((B, D), (B, D))."""
        t = x.shape[1]
        if lengths is None:
            mean = x.mean(dim=1)
            std = x.std(dim=1, unbiased=True)
        else:
            n = torch.round(lengths * t).to(x.dtype)
            idx = torch.arange(t, dtype=x.dtype, device=x.device)[None, :]
            mask = (idx < n[:, None]).to(x.dtype)[:, :, None]
            n_c = torch.clamp(n, min=2.0)[:, None]
            mean = (x * mask).sum(dim=1) / n_c
            var = (mask * (x - mean[:, None, :]) ** 2).sum(dim=1) / (n_c - 1.0)
            std = torch.sqrt(torch.clamp(var, min=0.0))
        return mean, torch.clamp(std, min=self.eps)

    def __call__(
        self,
        state: NormalizerState,
        x: torch.Tensor,
        lengths: torch.Tensor | None = None,
        epoch: int = 0,
        training: bool = False,
    ) -> tuple[torch.Tensor, NormalizerState]:
        """Normalize (B, T, D); returns (normalized, new_state).

        When ``training`` and ``epoch < update_until_epoch`` the running stats
        are updated before they are applied, so a batch's own statistics
        already influence its normalization (the reference's behavior).
        """
        if training:
            mean, std = self._utterance_stats(x, lengths)
            gate = float(epoch < self.update_until_epoch)
            sums = psum(torch.cat([mean.sum(dim=0), std.sum(dim=0), mean.new_full((1,), x.shape[0])]), self.mesh)
            d = mean.shape[-1]
            sum_mean, sum_std, b = sums[:d], sums[d:2 * d], sums[2 * d]
            n_new = b * gate
            total = state.count + n_new
            denom = torch.clamp(total, min=1.0)
            new_mean = (state.count * state.glob_mean + gate * sum_mean) / denom
            new_std = (state.count * state.glob_std + gate * sum_std) / denom
            # before any update, the global stats are the identity transform
            first = total > 0
            new_mean = torch.where(first, new_mean, state.glob_mean)
            new_std = torch.where(first, new_std, state.glob_std)
            state = NormalizerState(total, new_mean, new_std)
        out = x
        if self.mean_norm:
            out = out - state.glob_mean
        if self.std_norm:
            out = out / torch.clamp(state.glob_std, min=self.eps)
        return out, state
