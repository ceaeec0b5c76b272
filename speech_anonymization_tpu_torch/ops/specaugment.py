"""Feature-domain SpecAugment: time warp, frequency masks, time masks.

Counterpart of ``speech_anonymization_tpu/ops/specaugment.py`` (the
reference's SpeechBrain ``SpecAugment`` at convae.yaml:273-287: warp window
5, 2 frequency masks of width <= 30, 2 time masks of width <= 40, masked
values replaced by the per-utterance mean). The time warp is the JAX
package's piecewise-linear remap with linear interpolation, not
SpeechBrain's bicubic resize.

The random draws (:class:`SpecAugmentDraws`) come from a ``torch.Generator``
(:meth:`SpecAugment.draw`), or from the caller, so a test can feed the JAX
package's draws and get its output.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SpecAugmentDraws(NamedTuple):
    """One call's random choices; ``None`` where the transform is off (or the
    input too short to warp)."""

    warp: tuple[int, int] | None            # centre c in [window+1, T-window-1), shift in [-window, window]
    freq: tuple[torch.Tensor, torch.Tensor] | None  # (widths, starts), each (B, n_freq_mask) ints
    time: tuple[torch.Tensor, torch.Tensor] | None  # (widths, starts), each (B, n_time_mask) ints


def _randint(shape, low, high, generator: torch.Generator | None) -> torch.Tensor:
    """Uniform ints in [low, high) elementwise (``high`` may be a tensor), on the CPU."""
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    return (low + torch.floor(u * (high - low))).long()


def _masks(widths: torch.Tensor, starts: torch.Tensor, size: int) -> torch.Tensor:
    """(B, n) widths and starts -> (B, size) bool: any mask covers the index."""
    idx = torch.arange(size, device=widths.device)[None, None, :]
    starts, widths = starts[..., None], widths[..., None]
    return ((idx >= starts) & (idx < starts + widths)).any(dim=1)


def time_warp(feats: torch.Tensor, centre: int, shift: int) -> torch.Tensor:
    """Stretch frames [0, c) to [0, c+w) and [c, T) to [c+w, T), keeping T:
    a piecewise-linear fractional index remap with linear interpolation."""
    t = feats.shape[1]
    c, w = float(centre), float(shift)
    i = torch.arange(t, dtype=torch.float32, device=feats.device)
    src = torch.where(i < c + w,
                      i * c / max(c + w, 1.0),
                      c + (i - (c + w)) * (t - c) / max(t - c - w, 1.0))
    i0 = torch.clamp(torch.floor(src).long(), 0, t - 1)
    i1 = torch.clamp(i0 + 1, 0, t - 1)
    frac = (src - i0.to(torch.float32))[None, :, None]
    return feats[:, i0] * (1.0 - frac) + feats[:, i1] * frac


class SpecAugment:
    def __init__(self, time_warp: bool = True, time_warp_window: int = 5, freq_mask: bool = True,
                 n_freq_mask: int = 2, freq_mask_width: int = 30, time_mask: bool = True,
                 n_time_mask: int = 2, time_mask_width: int = 40, replace_with_zero: bool = False,
                 generator: torch.Generator | None = None):
        self.do_time_warp = time_warp
        self.time_warp_window = time_warp_window
        self.do_freq_mask = freq_mask
        self.n_freq_mask = n_freq_mask
        self.freq_mask_width = freq_mask_width
        self.do_time_mask = time_mask
        self.n_time_mask = n_time_mask
        self.time_mask_width = time_mask_width
        self.replace_with_zero = replace_with_zero
        self.generator = generator

    def _warps(self, t: int) -> bool:
        return self.do_time_warp and t > 2 * self.time_warp_window + 2

    def draw(self, shape, generator: torch.Generator | None = None) -> SpecAugmentDraws:
        """The draws for a (B, T, D) input, from ``generator`` (default: the
        one given at construction), on the CPU: warp, then the frequency
        masks (widths, starts), then the time masks."""
        g = generator if generator is not None else self.generator
        b, t, d = shape
        win = self.time_warp_window
        warp = None
        if self._warps(t):
            c = int(_randint((), win + 1, t - win - 1, g))
            warp = (c, int(_randint((), -win, win + 1, g)))

        def masks(on, n, width, size):
            if not on:
                return None
            widths = _randint((b, n), 0, width + 1, g)
            return widths, _randint((b, n), 0, torch.clamp(size - widths, min=1), g)

        return SpecAugmentDraws(warp, masks(self.do_freq_mask, self.n_freq_mask, self.freq_mask_width, d),
                                masks(self.do_time_mask, self.n_time_mask, self.time_mask_width, t))

    def __call__(self, feats: torch.Tensor, draws: SpecAugmentDraws | None = None) -> torch.Tensor:
        """(B, T, D) -> augmented (B, T, D); ``draws`` default to :meth:`draw`'s."""
        if draws is None:
            draws = self.draw(feats.shape)
        if self._warps(feats.shape[1]):
            feats = time_warp(feats, *draws.warp)
        fill = (torch.zeros((), dtype=feats.dtype, device=feats.device) if self.replace_with_zero
                else feats.mean(dim=(1, 2), keepdim=True))
        dev = feats.device
        if self.do_freq_mask:
            fmask = _masks(draws.freq[0].to(dev), draws.freq[1].to(dev), feats.shape[2])
            feats = torch.where(fmask[:, None, :], fill, feats)
        if self.do_time_mask:
            tmask = _masks(draws.time[0].to(dev), draws.time[1].to(dev), feats.shape[1])
            feats = torch.where(tmask[:, :, None], fill, feats)
        return feats
