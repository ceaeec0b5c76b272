"""The anonymizer autoencoders: ``apply(feats) -> (reconstruction, sex log-probs)``.

Counterparts of ``speech_anonymization_tpu/models/autoencoders.py``:
``ConvAutoencoder`` (reference models/ConvAutoEncoder.py:136-200), which runs
over the flattened feature signal, (B, T, 80) -> (B, 1, T*80) in NCW, and
the per-frame ``FullyConnectedAutoencoder`` and its debug twin
``DummyFullyConnectedAutoencoder`` (models/FullyConnected.py:118-209). Each
returns the reconstruction in the (B, T, 80) layout and (B, 2) sex log-probs.
Module names mirror the flax ones so the weight bridge (``utils/convert.py``)
maps them one to one. ``model.train()`` gives flax's ``train=True``. A fresh
model starts from flax's initialisers (``models/init.py``), drawn from
``generator`` when one is given.

Without autograd (``torch.no_grad()``, as ``anonymize`` and the evaluation
run it), each ConvAutoencoder block ``glu(norm(conv(x)))`` runs the
convolution without its bias and K8 (``ops/norm_silu.py``) adds the bias,
normalises and applies the SiLU in one pass: the kernel on the card, its
plain twin on the CPU. With autograd the modules run as they are.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import norm_silu as k8  # called as k8.norm_silu: the benchmark's recorders wrap that name
from .classifiers import FullyConnSexClassifier, TDNNSexClassifier
from .components import glu, instance_norm
from .init import flax_init_


def _without_bias(conv: nn.Conv1d | nn.ConvTranspose1d, x: torch.Tensor) -> torch.Tensor:
    if isinstance(conv, nn.ConvTranspose1d):
        return F.conv_transpose1d(x, conv.weight, None, conv.stride, conv.padding, conv.output_padding,
                                  conv.groups, conv.dilation)
    return F.conv1d(x, conv.weight, None, conv.stride, conv.padding, conv.dilation, conv.groups)


def _block(conv, norm: nn.InstanceNorm1d | None, x: torch.Tensor, fused: bool) -> torch.Tensor:
    """``glu(norm(conv(x)))``, or ``glu(conv(x))`` without a norm; ``fused``:
    the bias, the norm and the SiLU in K8."""
    if not fused:
        y = conv(x)
        return glu(y if norm is None else norm(y))
    if norm is None:
        return k8.norm_silu(_without_bias(conv, x), conv.bias)
    return k8.norm_silu(_without_bias(conv, x), conv.bias, norm.weight, norm.bias, norm.eps)


class ConvAutoencoder(nn.Module):
    """Encoder Conv(1->32,k15) GLU; Conv(32->64,k5,s2) IN GLU; Conv(64->64,k5) IN GLU;
    Conv(64->128,k5,s2) IN GLU; Conv(128->128,k5) IN GLU. The TDNN sex head reads
    the 128-channel bottleneck. Decoder Conv(128->128); ConvT(128->64,s2,op1) IN GLU;
    Conv(64->64); ConvT(64->32,s2,op1) IN GLU; Conv(32->1,k15). T*80 must be
    divisible by 4.
    """

    def __init__(self, num_classes: int = 2, grl_scale: float = 1.0,
                 generator: torch.Generator | None = None, device: str | torch.device = "cuda"):
        super().__init__()
        self.enc_conv0 = nn.Conv1d(1, 32, 15, padding=7)
        self.enc_conv1 = nn.Conv1d(32, 64, 5, stride=2, padding=2)
        self.enc_in1 = instance_norm(64)
        self.enc_conv2 = nn.Conv1d(64, 64, 5, padding=2)
        self.enc_in2 = instance_norm(64)
        self.enc_conv3 = nn.Conv1d(64, 128, 5, stride=2, padding=2)
        self.enc_in3 = instance_norm(128)
        self.enc_conv4 = nn.Conv1d(128, 128, 5, padding=2)
        self.enc_in4 = instance_norm(128)
        self.sex_classifier = TDNNSexClassifier(num_classes, grl_scale=grl_scale, device=device)
        self.dec_conv0 = nn.Conv1d(128, 128, 5, padding=2)
        self.dec_up1 = nn.ConvTranspose1d(128, 64, 5, stride=2, padding=2, output_padding=1)
        self.dec_in1 = instance_norm(64)
        self.dec_conv1 = nn.Conv1d(64, 64, 5, padding=2)
        self.dec_up2 = nn.ConvTranspose1d(64, 32, 5, stride=2, padding=2, output_padding=1)
        self.dec_in2 = instance_norm(32)
        self.dec_conv2 = nn.Conv1d(32, 1, 15, padding=7)
        flax_init_(self, generator)
        self.to(device)

    def _encode(self, feats: torch.Tensor) -> torch.Tensor:
        b, t, d = feats.shape
        fused = not torch.is_grad_enabled()  # K8 has no backward
        x = _block(self.enc_conv0, None, feats.reshape(b, 1, t * d), fused)
        x = _block(self.enc_conv1, self.enc_in1, x, fused)
        x = _block(self.enc_conv2, self.enc_in2, x, fused)
        x = _block(self.enc_conv3, self.enc_in3, x, fused)
        return _block(self.enc_conv4, self.enc_in4, x, fused)  # (B, 128, T*80/4)

    def _decode(self, bottleneck: torch.Tensor, shape: torch.Size) -> torch.Tensor:
        fused = not torch.is_grad_enabled()
        y = _block(self.dec_up1, self.dec_in1, self.dec_conv0(bottleneck), fused)
        y = _block(self.dec_up2, self.dec_in2, self.dec_conv1(y), fused)
        return self.dec_conv2(y).reshape(shape)

    def forward(self, feats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, T, 80) -> (reconstruction (B, T, 80), sex log-probs (B, 2))."""
        bottleneck = self._encode(feats)
        sex_log_probs = self.sex_classifier(bottleneck)
        return self._decode(bottleneck, feats.shape), sex_log_probs

    def anonymize(self, feats: torch.Tensor) -> torch.Tensor:
        """Inference path: encoder and decoder without the adversarial head."""
        return self._decode(self._encode(feats), feats.shape)


_FC_WIDTHS = ((None, 60), (60, 40), (40, 20), (20, 40), (40, 60), (60, None))


def _fc_stack(feature_dim: int) -> nn.ModuleList:
    """flax's ``Dense_0`` ... ``Dense_5``: 80->60->40->20 and 20->40->60->80."""
    return nn.ModuleList(nn.Linear(i or feature_dim, o or feature_dim) for i, o in _FC_WIDTHS)


def _fc_encode(dense: nn.ModuleList, feats: torch.Tensor) -> torch.Tensor:
    return dense[2](F.relu(dense[1](F.relu(dense[0](feats)))))


def _fc_decode(dense: nn.ModuleList, bottleneck: torch.Tensor) -> torch.Tensor:
    return dense[5](F.relu(dense[4](F.relu(dense[3](bottleneck)))))


class FullyConnectedAutoencoder(nn.Module):
    """Per-frame MLP 80->60->40->20 / 20->40->60->80 (ReLU between); the
    ``FullyConnSexClassifier`` reads the (B, T, 20) bottleneck."""

    def __init__(self, feature_dim: int = 80, num_classes: int = 2, grl_scale: float = 1.0,
                 generator: torch.Generator | None = None, device: str | torch.device = "cuda"):
        super().__init__()
        self.dense = _fc_stack(feature_dim)
        self.sex_classifier = FullyConnSexClassifier(num_classes, grl_scale=grl_scale, device=device)
        flax_init_(self, generator)
        self.to(device)

    def forward(self, feats: torch.Tensor, lengths: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        bottleneck = _fc_encode(self.dense, feats)
        sex_log_probs = self.sex_classifier(bottleneck, lengths)
        return _fc_decode(self.dense, bottleneck), sex_log_probs


class DummyFullyConnectedAutoencoder(nn.Module):
    """Debug AE: the FC stack, and "log-probs" that are ``uniform(0, 1)`` draws
    of shape (B, 2), copied as they are (the reference emits ``torch.rand``).

    The draws come from ``generator`` (on the CPU, so a card run and a CPU
    run from one seed draw alike), or from the caller (``sex_draws``).
    """

    def __init__(self, feature_dim: int = 80, num_classes: int = 2,
                 generator: torch.Generator | None = None, device: str | torch.device = "cuda"):
        super().__init__()
        self.num_classes = num_classes
        self.generator = generator
        self.dense = _fc_stack(feature_dim)
        flax_init_(self)
        self.to(device)

    def forward(self, feats: torch.Tensor, sex_draws: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        if sex_draws is None:
            sex_draws = torch.rand((feats.shape[0], self.num_classes), generator=self.generator)
        recon = _fc_decode(self.dense, _fc_encode(self.dense, feats))
        return recon, sex_draws.to(feats.device)
