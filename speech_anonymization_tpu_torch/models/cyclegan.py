"""CycleGAN-VC2-style 2-D gated generator (alternative anonymizer).

Counterpart of ``speech_anonymization_tpu/models/cyclegan.py`` (reference
models/ConvAutoEncoder.py:204-486), in NCHW. The live forward: (B, T, F) ->
(B, 1, F, T); a gated conv (128 channels, kernel (5, 15)); two gated
stride-2 downsamples (256 channels); the sex head on the time-major map
projected to 128 (``sex_head_proj``, the JAX package's working design for the
reference's dead head) through ``SexClassifier1D``; two pixel-shuffle
upsamples (1024 -> 256, 512 -> 128 channels) and a (5, 15) conv back to one
channel. Every conv pads symmetrically by half its kernel. ``ResidualLayer``
is not in the live forward at reference HEAD and is kept for parity. A fresh
generator starts from flax's initialisers (``models/init.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .classifiers import SexClassifier1D
from .components import glu, instance_norm, instance_norm_2d
from .init import flax_init_

_K_LONG = (5, 15)


def _conv2d(c_in: int, c_out: int, kernel, stride: int = 1) -> nn.Conv2d:
    kh, kw = kernel
    return nn.Conv2d(c_in, c_out, kernel, stride=stride, padding=(kh // 2, kw // 2))


class DownSampleGenerator(nn.Module):
    """(conv + IN)(x) * sigmoid((conv_gates + IN)(x)), kernel 5, stride 2, pad 2.

    ``convs[i]``/``norms[i]`` hold flax's ``Conv_i``/``InstanceNorm_i``.
    """

    def __init__(self, c_in: int, features: int, kernel_size: int = 5, stride: int = 2):
        super().__init__()
        k = (kernel_size, kernel_size)
        self.convs = nn.ModuleList(_conv2d(c_in, features, k, stride) for _ in range(2))
        self.norms = nn.ModuleList(instance_norm_2d(features) for _ in range(2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norms[0](self.convs[0](x))
        return h * torch.sigmoid(self.norms[1](self.convs[1](x)))


class ResidualLayer(nn.Module):
    """Two-branch gated 1-D residual block on (B, C_in, W) (not in the live forward)."""

    def __init__(self, in_features: int, out_features: int, kernel_size: int = 3, padding: int = 1):
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Conv1d(in_features, out_features, kernel_size, padding=padding),
            nn.Conv1d(in_features, out_features, kernel_size, padding=padding),
            nn.Conv1d(out_features, in_features, kernel_size, padding=padding),
        ])
        self.norms = nn.ModuleList([instance_norm(out_features), instance_norm(out_features),
                                    instance_norm(in_features)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norms[0](self.convs[0](x))
        gated = h * torch.sigmoid(self.norms[1](self.convs[1](x)))
        return x + self.norms[2](self.convs[2](gated))


class CycleGANGenerator(nn.Module):
    """(B, T, 80) -> ((B, T, 80) reconstruction, (B, 2) sex log-probs); T % 4 == 0.

    ``convs[i]`` hold flax's ``Conv_i`` (the gated pair, the two upsample
    convs, the last conv), ``down[i]`` ``DownSampleGenerator_i`` and
    ``norms[i]`` ``InstanceNorm_i``.
    """

    def __init__(self, num_classes: int = 2, feature_dim: int = 80, grl_scale: float = 1.0,
                 generator: torch.Generator | None = None, device: str | torch.device = "cuda"):
        super().__init__()
        self.convs = nn.ModuleList([
            _conv2d(1, 128, _K_LONG), _conv2d(1, 128, _K_LONG),
            _conv2d(256, 1024, (5, 5)), _conv2d(256, 512, (5, 5)), _conv2d(128, 1, _K_LONG),
        ])
        self.down = nn.ModuleList([DownSampleGenerator(128, 256), DownSampleGenerator(256, 256)])
        self.sex_head_proj = nn.Linear(256 * (feature_dim // 4), 128)
        self.sex_classifier = SexClassifier1D(num_classes, grl_scale=grl_scale, device=device)
        self.norms = nn.ModuleList([instance_norm_2d(256), instance_norm_2d(128)])
        flax_init_(self, generator)
        self.to(device)

    def forward(self, feats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = feats.transpose(1, 2)[:, None]                      # (B, 1, F, T)
        conv1 = self.convs[0](x) * torch.sigmoid(self.convs[1](x))
        d2 = self.down[1](self.down[0](conv1))                  # (B, 256, F/4, T/4)
        b, c, h, w = d2.shape
        clf_in = self.sex_head_proj(d2.permute(0, 3, 2, 1).reshape(b, w, h * c))
        sex_log_probs = self.sex_classifier(clf_in)
        u = glu(self.norms[0](F.pixel_shuffle(self.convs[2](d2), 2)))
        u = glu(self.norms[1](F.pixel_shuffle(self.convs[3](u), 2)))
        out = self.convs[4](u)[:, 0]                            # (B, F, T)
        return out.transpose(1, 2), sex_log_probs
