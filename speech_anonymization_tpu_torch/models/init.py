"""flax's default initialisers for the port's anonymizer models.

Every anonymizer family and sex head of the JAX package takes flax's
defaults: ``lecun_normal`` kernels (a normal truncated at two standard
deviations, scaled to variance 1/fan_in) and zero biases; norm layers start
at scale 1 and bias 0 (and BatchNorm's statistics at mean 0, variance 1).
:func:`flax_init_` gives a port module the same distribution, with fan_in
counted as flax counts it on its own kernel layout: ``(in,) + kernel`` for a
convolution or a dense layer (torch's ``weight[0].numel()``), and
``kernel x in_channels`` for a transposed convolution, whose flax kernel is
(k, in, out) (torch's own count for its (in, out, k) weight would give
k x out instead). The draws come from a CPU ``torch.Generator`` and are then
copied to the module's device, so one seed gives the same weights on the CPU
and on the card.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# the standard deviation of a unit normal truncated to [-2, 2] (flax's
# variance_scaling divides by it so that the kernel keeps variance 1/fan_in)
TRUNCATED_STD = 0.87962566103423978

_KERNELS = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.Linear)
_NORMS = (nn.BatchNorm1d, nn.InstanceNorm1d, nn.InstanceNorm2d, nn.LayerNorm)


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator | None = None) -> nn.Module:
    """Fill every kernel, bias and norm parameter of ``module`` in place, as
    flax initialises them; the kernels in module order from ``generator``
    (torch's default generator when None)."""
    for sub in module.modules():
        if isinstance(sub, _KERNELS):
            w = sub.weight
            # torch's ConvTranspose1d weight is (in, out, k), flax's kernel (k, in, out)
            fan_in = w.shape[0] * w.shape[2] if isinstance(sub, nn.ConvTranspose1d) else w[0].numel()
            std = math.sqrt(1.0 / fan_in) / TRUNCATED_STD
            draw = torch.empty(w.shape, dtype=torch.float32)
            nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            w.copy_(draw)
            if sub.bias is not None:
                sub.bias.zero_()
        elif isinstance(sub, _NORMS):
            if sub.weight is not None:
                sub.weight.fill_(1.0)
                sub.bias.zero_()
            if isinstance(sub, nn.BatchNorm1d):
                sub.running_mean.zero_()
                sub.running_var.fill_(1.0)
    return module
