"""Adversarial sex classifiers behind the gradient-reversal layer.

Counterparts of ``speech_anonymization_tpu/models/classifiers.py``
(reference models/ConvAutoEncoder.py:30-110, models/FullyConnected.py:65-116).
Each returns (B, 2) log-probs and reverses the gradient flowing back into the
anonymizer's bottleneck. The BatchNorms are :class:`~.components.BatchNorm`
(flax's statistics in training). ``norms[i]``, ``convs[i]`` and ``dense[i]``
hold flax's ``BatchNorm_i``, ``Conv1dTorch_i`` and ``Dense_i``. A head inside
a fresh anonymizer family starts from flax's initialisers: the family's
constructor applies ``models/init.py`` to all of its modules, the head's too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.grl import grad_reverse
from ..ops.pooling import statistics_pooling
from .components import BatchNorm


class TDNNSexClassifier(nn.Module):
    """GRL -> BN -> 3 VALID dilated convs (ReLU, BN) -> stats pooling -> MLP -> log-softmax.

    Input: the ConvAE bottleneck in NCW, (B, 128, W).
    """

    def __init__(self, num_classes: int = 2, channels: int = 128, grl_scale: float = 1.0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.grl_scale = grl_scale
        self.convs = nn.ModuleList(
            nn.Conv1d(channels, channels, k, dilation=d)
            for k, d in ((5, 1), (3, 2), (3, 3))
        )
        widths = (channels, channels, channels, channels, 128, 64)
        self.norms = nn.ModuleList(BatchNorm(w) for w in widths)
        self.dense = nn.ModuleList([
            nn.Linear(2 * channels, 128),
            nn.Linear(128, 64),
            nn.Linear(64, num_classes),
        ])
        self.to(device)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor | None = None) -> torch.Tensor:
        x = self.norms[0](grad_reverse(x, self.grl_scale))
        for conv, norm in zip(self.convs, self.norms[1:4]):
            x = norm(F.relu(conv(x)))
        h = statistics_pooling(x.transpose(1, 2), lengths)
        h = self.norms[4](F.relu(self.dense[0](h)))
        h = self.norms[5](F.relu(self.dense[1](h)))
        return F.log_softmax(self.dense[2](h), dim=-1)


def _channels_last_norm(norm: BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """Apply a BatchNorm over the last axis of (B, W, C) (or (B, C)) input."""
    return norm(x) if x.ndim == 2 else norm(x.transpose(1, 2)).transpose(1, 2)


class SexClassifier1D(nn.Module):
    """GRL -> BN -> per-step MLP 128->256->256 -> stats pooling -> deep MLP
    (256 BN ReLU, 128 ReLU, 32 BN ReLU, 2) -> log-softmax.

    Input channels-last, (B, W, 128), or pooled, (B, 128) (read as W = 1).
    The CycleGAN generator's head.
    """

    def __init__(self, num_classes: int = 2, in_features: int = 128, grl_scale: float = 1.0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.grl_scale = grl_scale
        self.norms = nn.ModuleList(BatchNorm(w) for w in (in_features, 256, 32))
        self.dense = nn.ModuleList(
            nn.Linear(i, o) for i, o in ((in_features, 256), (256, 256), (512, 256), (256, 128),
                                         (128, 32), (32, num_classes))
        )
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = grad_reverse(x, self.grl_scale)
        if x.ndim == 2:
            x = x[:, None, :]
        x = _channels_last_norm(self.norms[0], x)
        h = F.relu(self.dense[1](F.relu(self.dense[0](x))))
        h = self.dense[2](statistics_pooling(h))
        h = F.relu(self.norms[1](h))
        h = self.dense[4](F.relu(self.dense[3](h)))
        h = F.relu(self.norms[2](h))
        return F.log_softmax(self.dense[5](h), dim=-1)


class FullyConnSexClassifier(nn.Module):
    """GRL -> BN(20) -> per-frame MLP 20->40->40 -> stats pooling -> MLP
    80->40 BN ReLU ->40 ReLU ->20 BN ->2 -> log-softmax, on the FC bottleneck
    (B, T, 20), channels-last."""

    def __init__(self, num_classes: int = 2, bottleneck_dim: int = 20, grl_scale: float = 1.0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.grl_scale = grl_scale
        self.norms = nn.ModuleList(BatchNorm(w) for w in (bottleneck_dim, 40, 20))
        self.dense = nn.ModuleList(
            nn.Linear(i, o) for i, o in ((bottleneck_dim, 40), (40, 40), (80, 40), (40, 40),
                                         (40, 20), (20, num_classes))
        )
        self.to(device)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor | None = None) -> torch.Tensor:
        x = _channels_last_norm(self.norms[0], grad_reverse(x, self.grl_scale))
        h = F.relu(self.dense[1](F.relu(self.dense[0](x))))
        h = self.dense[2](statistics_pooling(h, lengths))
        h = F.relu(self.norms[1](h))
        h = self.norms[2](self.dense[4](F.relu(self.dense[3](h))))
        return F.log_softmax(self.dense[5](h), dim=-1)


class DummyFullyConnSexClassifier(nn.Module):
    """Debug head (models/FullyConnected.py:106-116): GRL -> Dense(512) ReLU -> Dense(2)."""

    def __init__(self, num_classes: int = 2, in_features: int = 1024, grl_scale: float = 1.0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.grl_scale = grl_scale
        self.dense = nn.ModuleList([nn.Linear(in_features, 512), nn.Linear(512, num_classes)])
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.dense[0](grad_reverse(x, self.grl_scale)))
        return F.log_softmax(self.dense[1](h), dim=-1)
