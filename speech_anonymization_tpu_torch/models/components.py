"""Shared model components, in PyTorch's channels-first layout.

Counterparts of ``speech_anonymization_tpu/models/components.py``. The JAX
package re-creates torch's conv padding rules in flax (``Conv1dTorch``,
``ConvTranspose1dTorch``); the port uses ``nn.Conv1d`` and
``nn.ConvTranspose1d`` directly, and torch's ``nn.PixelShuffle`` for
``pixel_shuffle_2d`` (the same semantics, in NCHW). :class:`BatchNorm` is
flax's ``BatchNorm`` in training.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel.mesh import psum


def glu(x: torch.Tensor) -> torch.Tensor:
    """The reference's custom 'GLU': ``x * sigmoid(x)``, i.e. SiLU.

    NOT the dimension-halving gated linear unit (models/ConvAutoEncoder.py:
    113-120 in the reference).
    """
    return x * torch.sigmoid(x)


def instance_norm(features: int, eps: float = 1e-5) -> nn.InstanceNorm1d:
    """Per-(sample, channel) norm over time: biased variance, affine, no running stats."""
    return nn.InstanceNorm1d(features, eps=eps, affine=True)


def instance_norm_2d(features: int, eps: float = 1e-5) -> nn.InstanceNorm2d:
    """Per-(sample, channel) norm over (H, W): biased variance, affine, no running stats."""
    return nn.InstanceNorm2d(features, eps=eps, affine=True)


class BatchNorm(nn.BatchNorm1d):
    """``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)`` on (B, C) or (B, C, W).

    Eval: torch's ``BatchNorm1d`` on the running statistics. Train: the batch
    statistics as flax computes them (mean, and the biased variance as
    ``max(0, E[x^2] - E[x]^2)``), ``(x - mean) * (rsqrt(var + eps) * weight) +
    bias``, and the running statistics moved toward the batch's at flax's
    momentum 0.9 (torch's 0.1), the running variance toward the BIASED batch
    variance (torch's ``BatchNorm1d`` takes the unbiased one).

    The train statistics are sums of x and x^2 over a count. With a ``mesh``
    of more than one rank on ``data`` (set by ``parallel.use_mesh``), they are
    the global batch's, as JAX's jit over a sharded batch computes them: the
    sums and the count summed over the ranks by a differentiable all-reduce,
    so the gradient flows through the global mean and variance
    (``nn.SyncBatchNorm`` would move the running variance toward the
    unbiased one).
    """

    mesh = None

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        axes = [0, *range(2, x.ndim)]
        shape = [1, -1] + [1] * (x.ndim - 2)
        c = x.shape[1]
        count = torch.full((1,), x.numel() // c, dtype=x.dtype, device=x.device)
        sums = psum(torch.cat([x.sum(dim=axes), (x * x).sum(dim=axes), count]), self.mesh)
        mean = sums[:c] / sums[2 * c]
        var = torch.clamp(sums[c:2 * c] / sums[2 * c] - mean * mean, min=0.0)
        with torch.no_grad():
            keep = 1.0 - self.momentum  # flax's momentum
            self.running_mean.copy_(keep * self.running_mean + (1.0 - keep) * mean)
            self.running_var.copy_(keep * self.running_var + (1.0 - keep) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class PixelShuffle1D(nn.Module):
    """The reference's 3-D 'PixelShuffle' (models/ConvAutoEncoder.py:122-133):
    (B, C, W) -> (B, C/r, r*W), a reshape in channels-first layout."""

    def __init__(self, upscale_factor: int = 2):
        super().__init__()
        self.upscale_factor = upscale_factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, w = x.shape
        r = self.upscale_factor
        return x.reshape(b, c // r, r * w)
