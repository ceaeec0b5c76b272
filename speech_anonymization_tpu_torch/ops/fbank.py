"""Log-mel filterbank frontend, (B, L) waveforms -> (B, T, n_mels).

Counterpart of ``speech_anonymization_tpu/ops/fbank.py``: SpeechBrain 0.5
``Fbank`` semantics (25 ms periodic Hamming window, 10 ms hop, n_fft 400,
center zero padding, power spectrum, 80 symmetric-triangle HTK mel filters,
``10*log10(clamp(x, 1e-10))`` and a batch-global ``top_db=80`` floor). The
window is folded into the DFT matrices, so the spectrum is a matrix product;
the frames -> mel-power step is the K1 kernel (:mod:`.fbank_kernel`), and
framing and the dB epilogue stay plain PyTorch around it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import pmax
from .fbank_kernel import fused_fbank, prepare_dft


def _to_mel(hz: np.ndarray | float) -> np.ndarray:
    """HTK mel scale used by the reference Filterbank."""
    return 2595.0 * np.log10(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


def _to_hz(mel: np.ndarray | float) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank_matrix(
    n_fft: int = 400,
    n_mels: int = 80,
    sample_rate: int = 16000,
    f_min: float = 0.0,
    f_max: float = 8000.0,
) -> np.ndarray:
    """(n_fft//2+1, n_mels) SpeechBrain symmetric-triangle filterbank (not librosa's)."""
    all_freqs = np.linspace(0, sample_rate // 2, n_fft // 2 + 1)
    hz = _to_hz(np.linspace(_to_mel(f_min), _to_mel(f_max), n_mels + 2))
    band = (hz[1:] - hz[:-1])[:-1]
    slope = (all_freqs[:, None] - hz[1:-1][None, :]) / band[None, :]
    return np.maximum(0.0, np.minimum(slope + 1.0, -slope + 1.0)).astype(np.float32)


def dft_matrices(n_fft: int = 400, win_length: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT matrices (win_length, n_fft//2+1) for cos and -sin.

    The periodic Hamming window is folded in (computed in float64, then cast).
    """
    win_length = n_fft if win_length is None else win_length
    k = np.arange(win_length, dtype=np.float64)
    f = np.arange(n_fft // 2 + 1, dtype=np.float64)
    window = 0.54 - 0.46 * np.cos(2.0 * np.pi * k / win_length)
    angle = 2.0 * np.pi * np.outer(k, f) / n_fft
    cos_m = (window[:, None] * np.cos(angle)).astype(np.float32)
    sin_m = (window[:, None] * -np.sin(angle)).astype(np.float32)
    return cos_m, sin_m


def num_frames(n_samples: int, hop_length: int = 160, center: bool = True, win_length: int = 400) -> int:
    """Frame count matching torch.stft."""
    if center:
        return 1 + n_samples // hop_length
    return 1 + (n_samples - win_length) // hop_length


def frame_signal(
    wav: torch.Tensor, win_length: int = 400, hop_length: int = 160, center: bool = True
) -> torch.Tensor:
    """Frame (B, L) waveforms into a (B, T, win_length) view, zero padded."""
    n_samples = wav.shape[-1]
    pad_left = win_length // 2 if center else 0
    t_out = num_frames(n_samples, hop_length, center, win_length)
    needed = (t_out - 1) * hop_length + win_length
    x = F.pad(wav, (pad_left, max(0, needed - pad_left - n_samples)))
    return x.unfold(-1, win_length, hop_length)[:, :t_out]


@dataclasses.dataclass(frozen=True)
class FbankConfig:
    """The reference Fbank defaults (convae.yaml:93-95)."""

    sample_rate: int = 16000
    n_fft: int = 400
    n_mels: int = 80
    win_length: int = 400
    hop_length: int = 160
    f_min: float = 0.0
    f_max: float = 8000.0
    log_mel: bool = True
    amin: float = 1e-10
    top_db: float = 80.0
    center: bool = True
    # 'batch': the reference's batch-global top_db floor; 'none': no floor
    top_db_mode: str = "batch"


class Fbank(nn.Module):
    """(B, L) or (L,) waveforms -> (B, T, n_mels) log-mel features.

    With a ``mesh`` (set by ``parallel.use_mesh``), the ``top_db`` floor is
    the global batch's: the max over every rank's shard. K1's output is per
    row, so that is the fbank's only cross-rank step."""

    mesh = None

    def __init__(self, config: FbankConfig = FbankConfig(), device: str | torch.device = "cuda"):
        super().__init__()
        self.config = config
        cos_m, sin_m = dft_matrices(config.n_fft, config.win_length)
        mel = mel_filterbank_matrix(
            config.n_fft, config.n_mels, config.sample_rate, config.f_min, config.f_max
        )
        dft = np.concatenate([cos_m, sin_m], axis=1)
        self.register_buffer("dft", torch.as_tensor(dft, device=device), persistent=False)
        self.register_buffer("mel", torch.as_tensor(mel, device=device), persistent=False)
        # K1's DFT operand: its TF32 halves in mma-fragment order, made once
        self.register_buffer("dft_frag", prepare_dft(self.dft), persistent=False)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        if wav.ndim == 1:
            return self(wav[None])[0]
        cfg = self.config
        frames = frame_signal(wav, cfg.win_length, cfg.hop_length, cfg.center).contiguous()
        mel = fused_fbank(frames, self.dft, self.mel, self.dft_frag)
        if not cfg.log_mel:
            return mel
        x_db = 10.0 * torch.log10(torch.clamp(mel, min=cfg.amin))
        if cfg.top_db is not None and cfg.top_db_mode == "batch":
            x_db = torch.maximum(x_db, pmax(x_db.max(), self.mesh) - cfg.top_db)
        return x_db
