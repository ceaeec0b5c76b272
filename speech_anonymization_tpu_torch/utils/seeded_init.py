"""Deterministic random weights from a numpy seed, independent of device.

Used where no trained checkpoint exists (the GPU smoke run). Convolutions and
linear layers draw weights from ``N(0, 2/fan_in)`` (He scaling, so the signal
survives the deep ReLU heads and their outputs depend on the input) and
biases from ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``; norm layers draw affine
parameters near (1, 0) and, for BatchNorm, running statistics away from their
initial values so that eval-mode normalization is exercised. Embeddings draw
from ``N(0, 1/dim)``: the transformer scales them by ``sqrt(dim)``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_AFFINE = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.Linear)
_NORMS = (nn.BatchNorm1d, nn.InstanceNorm1d, nn.LayerNorm)


@torch.no_grad()
def seeded_init_(module: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter and BatchNorm buffer of ``module`` in place."""
    rng = np.random.default_rng(seed)

    def fill(t: torch.Tensor, values: np.ndarray) -> None:
        t.copy_(torch.from_numpy(values.astype(np.float32)))

    for sub in module.modules():
        if isinstance(sub, _AFFINE):
            fan_in = sub.weight[0].numel()
            fill(sub.weight, np.sqrt(2.0 / fan_in) * rng.standard_normal(tuple(sub.weight.shape)))
            fill(sub.bias, rng.uniform(-1.0, 1.0, tuple(sub.bias.shape)) / np.sqrt(fan_in))
        elif isinstance(sub, nn.Embedding):
            fill(sub.weight, rng.standard_normal(tuple(sub.weight.shape)) / np.sqrt(sub.embedding_dim))
        elif isinstance(sub, _NORMS):
            n = tuple(sub.weight.shape)  # (F', C) for SBConvFrontEnd's norms
            fill(sub.weight, 1.0 + 0.1 * rng.standard_normal(n))
            fill(sub.bias, 0.1 * rng.standard_normal(n))
            if isinstance(sub, nn.BatchNorm1d):
                fill(sub.running_mean, 0.1 * rng.standard_normal(n))
                fill(sub.running_var, rng.uniform(0.5, 1.5, n))
    return module
