"""The precision every product of the plain reference is computed in.

The reference runs in float32 with TF32 off, the precision the
configurations state. Its control runs the same code with the operands of
each product rounded one step lower: ``tf32`` rounds both operands of a
float32 product to TF32's 10-bit mantissa (to nearest, ties away from zero,
as ``cvt.rna.tf32.f32``), ``fp8`` to float8 e4m3 under one scale a tensor
(the step below bfloat16, for the language model whose products the
configuration runs in bfloat16). The rounding is explicit, so the control
reads the same on the CPU and on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8 e4m3fn


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


ROUNDERS = {"fp32": lambda x: x, "tf32": tf32_round, "fp8": fp8_round}


class Precision:
    """Which rounding each part takes: ``parts`` maps a part name ("asr",
    "lm", "frontend", ...) to a key of ROUNDERS; unnamed parts take
    ``default``. Rounding is applied to the inputs of products only, through
    :meth:`linear`, :meth:`conv1d`, :meth:`conv2d`, :meth:`conv_transpose1d`,
    :meth:`matmul` and :meth:`einsum`; the rounding is outside autograd's
    view (a straight-through copy), so gradients flow as through the
    unrounded product."""

    def __init__(self, default: str = "fp32", **parts: str):
        self.default, self.parts = default, parts

    def round(self, part: str, x: torch.Tensor) -> torch.Tensor:
        kind = self.parts.get(part, self.default)
        if kind == "fp32":
            return x
        r = ROUNDERS[kind](x.detach())
        return x + (r - x).detach() if x.requires_grad else r

    def linear(self, part, x, w, b=None):
        return F.linear(self.round(part, x), self.round(part, w), b)

    def conv1d(self, part, x, w, b=None, **kw):
        return F.conv1d(self.round(part, x), self.round(part, w), b, **kw)

    def conv2d(self, part, x, w, b=None, **kw):
        return F.conv2d(self.round(part, x), self.round(part, w), b, **kw)

    def conv_transpose1d(self, part, x, w, b=None, **kw):
        return F.conv_transpose1d(self.round(part, x), self.round(part, w), b, **kw)

    def matmul(self, part, a, b):
        return torch.matmul(self.round(part, a), self.round(part, b))

    def einsum(self, part, eq, a, b):
        return torch.einsum(eq, self.round(part, a), self.round(part, b))


EXACT = Precision()
