"""Exact top-k for the beam-search expansion.

Counterpart of ``speech_anonymization_tpu/decoding/topk.py``
``fast_top_k_counted``. There, a certified approximate shortlist stands in
for the TPU's slow sort; ``torch.topk`` is exact on the card, so the port
keeps only the ``(values, indices, fell_back)`` contract, with ``fell_back``
always 0.

Tie order: ``lax.top_k`` puts the lowest index first among equal values and
``torch.topk`` promises no order. On the CPU (the parity tests' path) the
port takes a stable descending sort instead, which orders ties as
``lax.top_k`` does.
"""

from __future__ import annotations

import torch


def fast_top_k_counted(x: torch.Tensor, k: int):
    """Top ``k`` of (B, M) ``x`` over the last axis, sorted descending, plus a
    zero int32 fallback count (the shortlist certificate is not ported)."""
    if x.device.type == "cpu":
        values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
        values, indices = values[..., :k], indices[..., :k]
    else:
        values, indices = torch.topk(x, k, dim=-1)
    return values, indices, torch.zeros((), dtype=torch.int32, device=x.device)
