"""Plain log-mel front end, global normalizer and SpecAugment.

SpeechBrain 0.5 ``Fbank`` as the reference recipe configures it (convae.yaml:
n_fft 400, 25 ms periodic Hamming window, 10 ms hop, centre zero padding,
power spectrum, 80 HTK triangular mel filters, ``10 log10(max(x, 1e-10))``,
a batch-global 80 dB floor), ``InputNormalization`` (global, per-utterance
mean and unbiased std averaged over the utterances folded in) and the
feature-domain SpecAugment on given draws (piecewise-linear time warp,
frequency and time masks filled with the utterance's mean).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .numerics import EXACT, Precision

HOP, WIN, N_FFT, N_MELS, SAMPLE_RATE = 160, 400, 400, 80, 16000


def _mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, np.float64) / 700.0)


def _hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, np.float64) / 2595.0) - 1.0)


def mel_matrix(n_mels: int = N_MELS) -> np.ndarray:
    """(n_fft/2 + 1, n_mels) triangular filters, SpeechBrain's symmetric form."""
    freqs = np.linspace(0, SAMPLE_RATE // 2, N_FFT // 2 + 1)
    hz = _hz(np.linspace(_mel(0.0), _mel(SAMPLE_RATE / 2), n_mels + 2))
    band = (hz[1:] - hz[:-1])[:-1]
    slope = (freqs[:, None] - hz[1:-1][None, :]) / band[None, :]
    return np.maximum(0.0, np.minimum(slope + 1.0, 1.0 - slope))


def dft_matrix() -> np.ndarray:
    """(win, 2 * bins): [w cos | -w sin], the window folded in."""
    k = np.arange(WIN, dtype=np.float64)
    f = np.arange(N_FFT // 2 + 1, dtype=np.float64)
    w = 0.54 - 0.46 * np.cos(2.0 * math.pi * k / WIN)
    ang = 2.0 * math.pi * np.outer(k, f) / N_FFT
    return np.concatenate([w[:, None] * np.cos(ang), -w[:, None] * np.sin(ang)], axis=1)


def frames(wavs: torch.Tensor) -> torch.Tensor:
    """(B, L) -> (B, 1 + L // hop, win), zero padded win/2 on the left."""
    t = 1 + wavs.shape[1] // HOP
    need = (t - 1) * HOP + WIN
    x = torch.nn.functional.pad(wavs, (WIN // 2, max(0, need - WIN // 2 - wavs.shape[1])))
    return x.unfold(1, WIN, HOP)[:, :t]


def fbank(wavs: torch.Tensor, p: Precision = EXACT) -> torch.Tensor:
    """(B, L) waveforms -> (B, T, 80) log-mel features, float32."""
    dev = wavs.device
    dft = torch.as_tensor(dft_matrix(), dtype=torch.float32, device=dev)
    mel = torch.as_tensor(mel_matrix(), dtype=torch.float32, device=dev)
    spec = p.matmul("frontend", frames(wavs).float(), dft)
    bins = mel.shape[0]
    power = spec[..., :bins] ** 2 + spec[..., bins:] ** 2
    db = 10.0 * torch.log10(torch.clamp(p.matmul("frontend", power, mel), min=1e-10))
    return torch.maximum(db, db.max() - 80.0)


def utterance_stats(x: torch.Tensor, lens: torch.Tensor, eps: float = 1e-10):
    """Per utterance, over its valid frames: mean and unbiased std, (B, D) each."""
    t = x.shape[1]
    n = torch.round(lens * t)
    m = (torch.arange(t, device=x.device)[None, :] < n[:, None]).to(x.dtype)[:, :, None]
    n = torch.clamp(n, min=2.0)[:, None]
    mean = (x * m).sum(1) / n
    var = (m * (x - mean[:, None]) ** 2).sum(1) / (n - 1.0)
    return mean, torch.clamp(torch.sqrt(torch.clamp(var, min=0.0)), min=eps)


class Normalizer:
    """The global statistics: a running mean over utterances of their
    means and stds, folded in batch by batch (epochs below 4)."""

    def __init__(self, dim: int = N_MELS, device="cpu"):
        self.count = 0.0
        self.mean = torch.zeros(dim, device=device)
        self.std = torch.ones(dim, device=device)

    def update(self, x: torch.Tensor, lens: torch.Tensor) -> None:
        mean, std = utterance_stats(x, lens)
        total = self.count + x.shape[0]
        self.mean = (self.count * self.mean + mean.sum(0)) / total
        self.std = (self.count * self.std + std.sum(0)) / total
        self.count = total

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) / torch.clamp(self.std, min=1e-10)


def pad_time(x: torch.Tensor, multiple: int = 36) -> torch.Tensor:
    pad = (-x.shape[1]) % multiple
    return torch.nn.functional.pad(x, (0, 0, 0, pad)) if pad else x


def time_warp(x: torch.Tensor, centre: int, shift: int) -> torch.Tensor:
    """Frames [0, c) stretched onto [0, c + w) and [c, T) onto [c + w, T),
    sampled by linear interpolation."""
    t = x.shape[1]
    c, w = float(centre), float(shift)
    i = torch.arange(t, dtype=torch.float32, device=x.device)
    src = torch.where(i < c + w, i * c / max(c + w, 1.0),
                      c + (i - (c + w)) * (t - c) / max(t - c - w, 1.0))
    lo = torch.clamp(src.floor().long(), 0, t - 1)
    hi = torch.clamp(lo + 1, 0, t - 1)
    frac = (src - lo.float())[None, :, None]
    return x[:, lo] * (1.0 - frac) + x[:, hi] * frac


def _covered(widths: torch.Tensor, starts: torch.Tensor, size: int) -> torch.Tensor:
    idx = torch.arange(size, device=widths.device)[None, None, :]
    return ((idx >= starts[..., None]) & (idx < (starts + widths)[..., None])).any(1)


def spec_augment(x: torch.Tensor, warp, freq, time) -> torch.Tensor:
    """SpecAugment on the draws: ``warp`` (centre, shift), ``freq`` and
    ``time`` (widths, starts) of shape (B, n_masks); masks take each
    utterance's mean over time and frequency, taken after the warp."""
    x = time_warp(x, *warp)
    fill = x.mean(dim=(1, 2), keepdim=True)
    dev = x.device
    fm = _covered(freq[0].to(dev), freq[1].to(dev), x.shape[2])
    x = torch.where(fm[:, None, :], fill, x)
    tm = _covered(time[0].to(dev), time[1].to(dev), x.shape[1])
    return torch.where(tm[:, :, None], fill, x)
