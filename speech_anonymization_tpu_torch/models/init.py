"""flax's default initialisers for the port's models.

Every anonymizer family and sex head of the JAX package, and its transformer
ASR and LM, take flax's defaults: ``lecun_normal`` kernels (a normal
truncated at two standard deviations, scaled to variance 1/fan_in) and zero
biases; norm layers start at scale 1 and bias 0 (and BatchNorm's statistics
at mean 0, variance 1); token embeddings ``nn.Embed``'s ``default_embed_init``,
an untruncated normal of variance 1/features.
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


def truncated_normal(shape, std: float, generator: torch.Generator | None = None) -> torch.Tensor:
    """A normal of ``std`` truncated at two standard deviations, on the CPU in
    f32: drawn whole, then only the elements outside redrawn until none is
    (``nn.init.trunc_normal_`` redraws the whole tensor each round, seconds
    for a 161 M-parameter model, and its algorithm differs between torch
    versions)."""
    out = torch.empty(shape, dtype=torch.float32).normal_(0.0, std, generator=generator)
    while True:
        bad = out.abs() > 2.0 * std
        n = int(bad.sum())
        if not n:
            return out
        out[bad] = torch.empty(n).normal_(0.0, std, generator=generator)


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator | None = None) -> nn.Module:
    """Fill every kernel, bias, norm and embedding parameter of ``module`` in
    place, as flax initialises them; the kernels and embeddings in module
    order from ``generator`` (torch's default generator when None)."""
    for sub in module.modules():
        if isinstance(sub, nn.Embedding):
            w = sub.weight
            w.copy_(torch.empty(w.shape).normal_(0.0, math.sqrt(1.0 / w.shape[1]), generator=generator))
        elif isinstance(sub, _KERNELS):
            w = sub.weight
            # torch's ConvTranspose1d weight is (in, out, k), flax's kernel (k, in, out)
            fan_in = w.shape[0] * w.shape[2] if isinstance(sub, nn.ConvTranspose1d) else w[0].numel()
            w.copy_(truncated_normal(w.shape, math.sqrt(1.0 / fan_in) / TRUNCATED_STD, generator))
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
