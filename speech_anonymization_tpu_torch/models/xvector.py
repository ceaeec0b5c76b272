"""X-vector embedding model and classifier head (the privacy evaluator).

Counterpart of ``speech_anonymization_tpu/models/xvector.py`` (reference
models/external_gender_classifiers.py:24-183). Public inputs keep the JAX
layout, (B, T, in_channels) features and (B, E) embeddings. ``convs[i]``,
``norms[i]`` and ``dense[i]`` hold flax's ``Conv_i``, ``BatchNorm_i`` and
``Dense_i``. The norms are ``components.BatchNorm``: in train mode they use
and keep the statistics as flax's ``BatchNorm`` does (the running variance
moves toward the biased batch variance; torch's ``BatchNorm1d`` takes the
unbiased one). The layers keep torch's default initialisation; the gender
recipe draws a fresh model's weights with ``models/init.py`` ``flax_init_``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pooling import statistics_pooling
from .components import BatchNorm


class Xvector(nn.Module):
    """5 dilated conv blocks (Conv 'same' -> LeakyReLU -> BN) -> stats pooling -> Dense."""

    def __init__(
        self,
        in_channels: int = 80,
        tdnn_channels: Sequence[int] = (512, 512, 512, 512, 1500),
        tdnn_kernel_sizes: Sequence[int] = (5, 3, 3, 1, 1),
        tdnn_dilations: Sequence[int] = (1, 2, 3, 1, 1),
        lin_neurons: int = 128,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        ins = (in_channels, *tdnn_channels[:-1])
        self.pads = [((k - 1) * d // 2, (k - 1) * d - (k - 1) * d // 2)
                     for k, d in zip(tdnn_kernel_sizes, tdnn_dilations)]
        self.convs = nn.ModuleList(
            nn.Conv1d(i, o, k, dilation=d)
            for i, o, k, d in zip(ins, tdnn_channels, tdnn_kernel_sizes, tdnn_dilations)
        )
        self.norms = nn.ModuleList(BatchNorm(o, eps=1e-5) for o in tdnn_channels)
        self.dense = nn.ModuleList([nn.Linear(2 * tdnn_channels[-1], lin_neurons)])
        self.to(device)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor | None = None) -> torch.Tensor:
        """(B, T, in_channels) -> (B, lin_neurons) embeddings."""
        x = x.transpose(1, 2)
        for conv, norm, pad in zip(self.convs, self.norms, self.pads):
            x = norm(F.leaky_relu(conv(F.pad(x, pad)), negative_slope=0.01))
        return self.dense[0](statistics_pooling(x.transpose(1, 2), lengths))


class XvectorClassifier(nn.Module):
    """LeakyReLU, BN, ``lin_blocks`` x (Dense, LeakyReLU, BN), Dense, log-softmax.
    ``in_features``: the embedding width (default ``lin_neurons``; flax infers
    it from the input)."""

    def __init__(self, lin_blocks: int = 1, lin_neurons: int = 128, out_neurons: int = 2,
                 in_features: int | None = None, device: str | torch.device = "cuda"):
        super().__init__()
        widths = [in_features or lin_neurons] + [lin_neurons] * lin_blocks
        self.norms = nn.ModuleList(BatchNorm(w, eps=1e-5) for w in widths)
        self.dense = nn.ModuleList(
            [nn.Linear(w, lin_neurons) for w in widths[:-1]]
            + [nn.Linear(lin_neurons, out_neurons)]
        )
        self.to(device)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        h = self.norms[0](F.leaky_relu(emb, negative_slope=0.01))
        for dense, norm in zip(self.dense[:-1], self.norms[1:]):
            h = norm(F.leaky_relu(dense(h), negative_slope=0.01))
        return F.log_softmax(self.dense[-1](h), dim=-1)
