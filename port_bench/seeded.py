"""Everything a run draws from its ``--seed``: weights, waveforms, labels,
tokens and SpecAugment draws, on the run's device.

Weights: one normal draw for all of a model's leaves, shaped by the
leaves' kinds in one multiply-add: He-scaled kernels (std sqrt(2 / fan_in)),
embeddings at std 1/sqrt(width), norm scales near 1, biases and norm
offsets near 0, BatchNorm statistics away from their initial values. The
draw lands in a dict the benchmark keeps and is copied into the program's
module; the reference reads the dict.

Waveforms: speech-like, so that the features have formants and pauses: a
glottal pulse train (harmonics of an f0 that glides between 90 and 250 Hz)
through two resonances, under a syllable-rate envelope, plus noise.
"""

from __future__ import annotations

import math

import torch

SAMPLE_RATE = 16000
_MIX = 0x9E3779B97F4A7C15


def generator(seed: int, tag: int, device) -> torch.Generator:
    """A generator for one purpose (``tag``) of one seed."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + tag * _MIX) % (2 ** 63))


def _leaf_law(name: str, t: torch.Tensor) -> tuple[float, float]:
    """(std, mean) of a leaf's draw."""
    if name.endswith("running_mean"):
        return 0.1, 0.0
    if name.endswith("running_var"):
        return 0.1, 1.0
    if t.ndim >= 2:
        if "embed" in name:
            return 1.0 / math.sqrt(t.shape[-1]), 0.0
        return math.sqrt(2.0 / (t.numel() // t.shape[0])), 0.0
    if name.endswith("weight"):
        return 0.1, 1.0
    return 0.02, 0.0


def draw_weights(module: torch.nn.Module, seed: int, tag: int, device) -> dict:
    """Draw every float leaf of ``module``'s state dict from the seed and copy
    it into the module. -> {name: the benchmark's own tensor}."""
    leaves = {k: v for k, v in module.state_dict().items() if v.is_floating_point()}
    counts = [v.numel() for v in leaves.values()]
    laws = [_leaf_law(k, v) for k, v in leaves.items()]
    c = torch.tensor(counts, device=device)
    std = torch.repeat_interleave(torch.tensor([s for s, _ in laws], device=device), c)
    mean = torch.repeat_interleave(torch.tensor([m for _, m in laws], device=device), c)
    flat = torch.randn(sum(counts), generator=generator(seed, tag, device), device=device)
    flat = torch.addcmul(mean, flat, std)
    out, at = {}, 0
    for (k, v), n in zip(leaves.items(), counts):
        out[k] = flat[at:at + n].view(v.shape)
        at += n
    with torch.no_grad():
        for k, v in module.state_dict().items():
            if k in out:
                v.copy_(out[k])
    return out


def waveforms(b: int, samples: int, seed: int, tag: int, device) -> torch.Tensor:
    """(b, samples) speech-like waveforms, float32, peak 0.5."""
    g = generator(seed, tag, device)
    t = torch.arange(samples, device=device, dtype=torch.float32) / SAMPLE_RATE
    u = torch.rand(b, 8, generator=g, device=device)
    f0 = 90.0 + 160.0 * u[:, :1] + 20.0 * torch.sin(2 * math.pi * (0.3 + 0.5 * u[:, 1:2]) * t)
    phase = 2 * math.pi * torch.cumsum(f0 / SAMPLE_RATE, dim=1)
    k = torch.arange(1, 31, device=device, dtype=torch.float32)[:, None, None]
    hz = k * f0[None]
    f1, f2 = 300.0 + 600.0 * u[:, 2:3], 900.0 + 1500.0 * u[:, 3:4]
    gain = (1.0 / (1.0 + ((hz - f1) / 150.0) ** 2) + 0.5 / (1.0 + ((hz - f2) / 250.0) ** 2)) / k
    voiced = (gain * torch.sin(k * phase[None])).sum(0)
    env = torch.clamp(torch.sin(2 * math.pi * (2.0 + 3.0 * u[:, 4:5]) * t + 6.0 * u[:, 5:6]), min=0.0) ** 2
    noise = torch.randn(b, samples, generator=g, device=device)
    x = env * voiced + 0.02 * noise
    return 0.5 * x / x.abs().amax(1, keepdim=True)


def ints(shape, low: int, high: int, seed: int, tag: int, device) -> torch.Tensor:
    return torch.randint(low, high, shape, generator=generator(seed, tag, device), device=device)


def spec_augment_draws(b: int, t: int, d: int, seed: int, tag: int, aug: dict):
    """SpecAugment's draws for a (b, t, d) batch, on the CPU, for the
    settings ``aug`` (the configuration's ``specaugment``): the warp (centre
    in [window + 1, t - window - 1), shift in [-window, window]), then each
    mask's width in [0, width] and start in [0, size - width)."""
    g = generator(seed, tag, "cpu")
    window = aug["time_warp_window"]

    def rand_int(shape, low, high):
        return (low + torch.floor(torch.rand(shape, generator=g, dtype=torch.float64) * (high - low))).long()

    warp = (int(rand_int((), window + 1, t - window - 1)), int(rand_int((), -window, window + 1)))

    def masks(n, width, size):
        widths = rand_int((b, n), 0, width + 1)
        return widths, rand_int((b, n), 0, torch.clamp(size - widths, min=1))

    return (warp, masks(aug["n_freq_mask"], aug["freq_mask_width"], d),
            masks(aug["n_time_mask"], aug["time_mask_width"], t))
