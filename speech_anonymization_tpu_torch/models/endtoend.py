"""End-to-end conv reconstruction anonymizer (no internal sex head).

Counterpart of ``speech_anonymization_tpu/models/endtoend.py``
``ConvReconstruction`` (reference models/EndToEnd.py:36-87): one conv
encoder/decoder over the flattened (B, 1, T*80) signal. Its sex signal is the
frozen external x-vector classifier's on the reconstruction
(``FeatureClassifier.log_probs``), so the recipe's loss subtracts the sex and
confusion terms instead of reversing a gradient.
"""

from __future__ import annotations

import torch
from torch import nn

from .components import glu, instance_norm
from .init import flax_init_


class ConvReconstruction(nn.Module):
    """Conv(1->32,k15) IN GLU; Conv(32->64,k5,s2) IN GLU; Conv(64->64,k5) IN GLU;
    ConvT(64->32,k5,s2,op1) IN GLU; Conv(32->1,k15). T*80 must be even.

    ``convs[i]`` hold flax's ``Conv1dTorch_i``, ``up`` ``ConvTranspose1dTorch_0``
    and ``norms[i]`` ``InstanceNorm_i``. A fresh model starts from flax's
    initialisers (``models/init.py``).
    """

    def __init__(self, generator: torch.Generator | None = None, device: str | torch.device = "cuda"):
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Conv1d(1, 32, 15, padding=7), nn.Conv1d(32, 64, 5, stride=2, padding=2),
            nn.Conv1d(64, 64, 5, padding=2), nn.Conv1d(32, 1, 15, padding=7),
        ])
        self.up = nn.ConvTranspose1d(64, 32, 5, stride=2, padding=2, output_padding=1)
        self.norms = nn.ModuleList(instance_norm(c) for c in (32, 64, 64, 32))
        flax_init_(self, generator)
        self.to(device)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, T, 80) -> (B, T, 80)."""
        b, t, d = feats.shape
        x = feats.reshape(b, 1, t * d)
        for conv, norm in zip(self.convs[:3], self.norms[:3]):
            x = glu(norm(conv(x)))
        x = glu(self.norms[3](self.up(x)))
        return self.convs[3](x).reshape(b, t, d)
