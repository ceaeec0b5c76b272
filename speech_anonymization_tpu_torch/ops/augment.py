"""Waveform-domain augmentations: additive noise, speed perturbation, chunk and
frequency dropout.

Counterpart of ``speech_anonymization_tpu/ops/augment.py`` (the reference's
gender_classifier.yaml:72-84):

  * :class:`EnvCorrupt` (``noise_prob`` 1, SNR 0..15 dB, babble and reverb
    off): :func:`add_noise`, white noise (or a clip of a noise bank) scaled to
    a per-utterance SNR over the valid samples;
  * :class:`TimeDomainSpecAugment` (speeds 95/100/105): :func:`speed_perturb`
    -> :func:`drop_freq` -> :func:`drop_chunk`;
  * :class:`SpeedPerturb`: the speed change alone.

Every transform keeps the padded shape (B, L): a speed change re-stretches
each row in place by linear interpolation and scales its relative length.

Each is a deterministic core that takes its random draws, and a ``draw``
method that makes them from a ``torch.Generator`` on the CPU (so a card run
and a CPU run from one seed draw alike), as ``ops/specaugment.py`` does; a
test can feed the JAX package's own draws. Traps kept from the JAX package:
the window is the symmetric Hamming window (``jnp.hamming``), ``jnp.convolve``
flips its kernel where ``F.conv1d`` correlates, the length mask rounds half
to even, and ``drop_chunk`` ignores the lengths.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class NoiseDraws(NamedTuple):
    snr: torch.Tensor               # (B, 1) dB in [snr_low, snr_high)
    noise: torch.Tensor | None      # (B, L) unit normal, without a noise bank
    pick: torch.Tensor | None       # (B,) clip indices, with a noise bank


class FreqDraws(NamedTuple):
    count: torch.Tensor             # (B,) notches used, in [0, drop_count_high]
    centers: torch.Tensor           # (B, drop_count_high) in [0.05, 0.45)


class ChunkDraws(NamedTuple):
    count: torch.Tensor             # (B, 1) chunks used, in [0, drop_count_high]
    starts: torch.Tensor            # (B, drop_count_high) in [0, max(L - drop_length_high, 1))
    lengths: torch.Tensor           # (B, drop_count_high) in [drop_length_low, drop_length_high)


class TimeDomainDraws(NamedTuple):
    speed: torch.Tensor             # (B,) index into the speeds
    freq: FreqDraws
    chunk: ChunkDraws


def _uniform(shape, low: float, high: float, generator: torch.Generator | None) -> torch.Tensor:
    """Uniform float32 draws in [low, high), on the CPU."""
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    return (low + u * (high - low)).to(torch.float32)


def length_mask(n_samples: int, lens: torch.Tensor) -> torch.Tensor:
    """(B,) relative lengths -> (B, n_samples) float mask of the valid prefix
    (``round`` half to even, as ``jnp.round``)."""
    idx = torch.arange(n_samples, device=lens.device)[None, :]
    return (idx < torch.round(lens * n_samples)[:, None]).to(torch.float32)


def add_noise(wavs: torch.Tensor, lens: torch.Tensor, draws: NoiseDraws,
              noise_bank: torch.Tensor | None = None) -> torch.Tensor:
    """Additive noise at the drawn per-utterance SNR (dB), over the valid samples."""
    b, t = wavs.shape
    dev = wavs.device
    mask = length_mask(t, lens)
    if noise_bank is not None:
        clips = noise_bank[draws.pick.to(noise_bank.device)].to(dev)
        reps = -(-t // clips.shape[1])
        noise = clips.repeat(1, reps)[:, :t]
    else:
        noise = draws.noise.to(dev)
    n_valid = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
    sig_pow = ((wavs * mask) ** 2).sum(dim=1, keepdim=True) / n_valid
    noise_pow = ((noise * mask) ** 2).sum(dim=1, keepdim=True) / n_valid
    target = sig_pow / torch.pow(10.0, draws.snr.to(dev) / 10.0)
    scale = torch.sqrt(target / torch.clamp(noise_pow, min=1e-14))
    return wavs + scale * noise * mask


def speed_perturb(wavs: torch.Tensor, lens: torch.Tensor, pick: torch.Tensor,
                  speeds=(95, 100, 105)) -> tuple[torch.Tensor, torch.Tensor]:
    """Speed ``speeds[pick]`` % per row: ``out[i] = in[i * s / 100]`` by linear
    interpolation, the relative length scaled by 100 / s (at most 1); -> (wavs, lens)."""
    b, t = wavs.shape
    dev = wavs.device
    rate = (torch.tensor(speeds, dtype=torch.float32, device=dev) / 100.0)[pick.to(dev)]
    pos = torch.arange(t, dtype=torch.float32, device=dev)[None, :] * rate[:, None]
    i0 = torch.clamp(torch.floor(pos).long(), 0, t - 1)
    i1 = torch.clamp(i0 + 1, 0, t - 1)
    frac = pos - i0.to(torch.float32)
    out = torch.gather(wavs, 1, i0) * (1.0 - frac) + torch.gather(wavs, 1, i1) * frac
    new_lens = torch.clamp(lens / rate, max=1.0)
    return out * length_mask(t, new_lens), new_lens


def drop_chunk(wavs: torch.Tensor, draws: ChunkDraws) -> torch.Tensor:
    """Zero the first ``count`` drawn chunks of each row (the lengths are not read)."""
    t = wavs.shape[1]
    dev = wavs.device
    count, starts, length = (x.to(dev) for x in draws)
    idx = torch.arange(t, device=dev)[None, None, :]
    active = torch.arange(starts.shape[1], device=dev)[None, :, None] < count[:, :, None]
    in_chunk = (idx >= starts[:, :, None]) & (idx < (starts + length)[:, :, None]) & active
    return torch.where(in_chunk.any(dim=1), torch.zeros((), dtype=wavs.dtype, device=dev), wavs)


def _grouped_conv(x: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Row b of (B, W) ``x`` correlated with row b of (B, K) ``kernels``
    ('valid'): one grouped convolution, ``groups=B``."""
    return F.conv1d(x[None], kernels[:, None, :], groups=x.shape[0])[0]


def notch_kernels(draws: FreqDraws, band_width: float = 0.05, filter_len: int = 101,
                  device: str | torch.device = "cpu") -> torch.Tensor:
    """(B, filter_len) FIR kernels: the delta, convolved (``jnp.convolve``
    'same') with each of the row's first ``count`` notches (the delta minus a
    Hamming-windowed band-pass around the drawn centre)."""
    count, centers = draws.count.to(device), draws.centers.to(device)
    b, n_drop = centers.shape
    half = filter_len // 2
    n = torch.arange(filter_len, dtype=torch.float32, device=device) - half
    window = torch.hamming_window(filter_len, periodic=False, dtype=torch.float32, device=device)
    delta = torch.where(n == 0, 1.0, 0.0)
    kern = delta.expand(b, filter_len)
    for j in range(n_drop):
        f1 = centers[:, j:j + 1] - band_width / 2
        f2 = centers[:, j:j + 1] + band_width / 2
        band = (2 * f2 * torch.sinc(2 * f2 * n) - 2 * f1 * torch.sinc(2 * f1 * n)) * window
        notch = delta - band
        # jnp.convolve(kern, notch, "same"): the full convolution (notch
        # flipped), its centre filter_len samples
        full = _grouped_conv(F.pad(kern, (filter_len - 1, filter_len - 1)), notch.flip(1))
        start = (full.shape[1] - filter_len) // 2
        kern = torch.where((j < count)[:, None], full[:, start:start + filter_len], kern)
    return kern


def drop_freq(wavs: torch.Tensor, draws: FreqDraws, band_width: float = 0.05,
              filter_len: int = 101) -> torch.Tensor:
    """Notch the drawn frequency bands: each row through its own FIR kernel
    (:func:`notch_kernels`), zero-padded by ``filter_len // 2`` each side, as
    one grouped ``F.conv1d``."""
    half = filter_len // 2
    kernels = notch_kernels(draws, band_width, filter_len, wavs.device)
    return _grouped_conv(F.pad(wavs, (half, half)), kernels)[:, :wavs.shape[1]]


class EnvCorrupt:
    """Additive-noise corruption (gender_classifier.yaml:72-78): the reference's
    noise at an SNR drawn in [noise_snr_low, noise_snr_high) dB."""

    def __init__(self, noise_snr_low: float = 0.0, noise_snr_high: float = 15.0,
                 noise_bank: torch.Tensor | None = None, **_):
        self.snr_low = noise_snr_low
        self.snr_high = noise_snr_high
        self.noise_bank = noise_bank

    def draw(self, shape, generator: torch.Generator | None = None) -> NoiseDraws:
        """The draws for (B, L) waveforms: the SNRs, then the noise (or the clips)."""
        b, t = shape
        snr = _uniform((b, 1), self.snr_low, self.snr_high, generator)
        if self.noise_bank is not None:
            return NoiseDraws(snr, None, torch.randint(0, self.noise_bank.shape[0], (b,), generator=generator))
        return NoiseDraws(snr, torch.randn((b, t), generator=generator), None)

    def __call__(self, wavs: torch.Tensor, lens: torch.Tensor, draws: NoiseDraws | None = None,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        if draws is None:
            draws = self.draw(wavs.shape, generator)
        return add_noise(wavs, lens, draws, self.noise_bank)


class SpeedPerturb:
    """The speed change alone (convae.yaml:285-287)."""

    def __init__(self, sample_rate: int = 16000, speeds=(95, 100, 105)):
        self.speeds = tuple(speeds)

    def draw(self, shape, generator: torch.Generator | None = None) -> torch.Tensor:
        return torch.randint(0, len(self.speeds), (shape[0],), generator=generator)

    def __call__(self, wavs: torch.Tensor, lens: torch.Tensor, draws: torch.Tensor | None = None,
                 generator: torch.Generator | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        if draws is None:
            draws = self.draw(wavs.shape, generator)
        return speed_perturb(wavs, lens, draws, self.speeds)


class TimeDomainSpecAugment:
    """speed perturb -> drop_freq -> drop_chunk (gender_classifier.yaml:82-84), at
    the JAX package's settings: up to 2 notches of width 0.05 (101 taps), up to
    3 chunks of 1,000-2,000 samples."""

    FREQ_DROPS, CHUNK_DROPS, CHUNK_LOW, CHUNK_HIGH = 2, 3, 1000, 2000

    def __init__(self, sample_rate: int = 16000, speeds=(95, 100, 105), **_):
        self.speeds = tuple(speeds)

    def draw(self, shape, generator: torch.Generator | None = None) -> TimeDomainDraws:
        """The draws for (B, L) waveforms: speed, then the notches, then the chunks."""
        b, t = shape
        speed = torch.randint(0, len(self.speeds), (b,), generator=generator)
        freq = FreqDraws(torch.randint(0, self.FREQ_DROPS + 1, (b,), generator=generator),
                         _uniform((b, self.FREQ_DROPS), 0.05, 0.45, generator))
        n = self.CHUNK_DROPS
        chunk = ChunkDraws(torch.randint(0, n + 1, (b, 1), generator=generator),
                           torch.randint(0, max(t - self.CHUNK_HIGH, 1), (b, n), generator=generator),
                           torch.randint(self.CHUNK_LOW, self.CHUNK_HIGH, (b, n), generator=generator))
        return TimeDomainDraws(speed, freq, chunk)

    def __call__(self, wavs: torch.Tensor, lens: torch.Tensor, draws: TimeDomainDraws | None = None,
                 generator: torch.Generator | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        if draws is None:
            draws = self.draw(wavs.shape, generator)
        wavs, lens = speed_perturb(wavs, lens, draws.speed, self.speeds)
        wavs = drop_freq(wavs, draws.freq)
        return drop_chunk(wavs, draws.chunk), lens
