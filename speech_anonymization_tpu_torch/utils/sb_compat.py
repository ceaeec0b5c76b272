"""Readers for the reference's SpeechBrain-format torch checkpoint files.

Counterpart of ``speech_anonymization_tpu/utils/sb_compat.py``. The
reference's runs save one torch pickle per recoverable: ``normalizer.ckpt``
({count, glob_mean, glob_std, spk_dict_*}), ``noam_scheduler.ckpt``
({losses, n_steps, normalize}), ``counter.ckpt`` (an int as text), and model
state dicts. These readers turn them into the port's state objects.
``torch.load`` runs with ``map_location="cpu", weights_only=False``, as the
JAX package's does: the files hold plain Python containers, which torch 2.6
and later refuse by default.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops.normalization import NormalizerState


def _torch_load(path: str) -> Any:
    return torch.load(path, map_location="cpu", weights_only=False)


def load_normalizer_ckpt(path: str, device: str | torch.device = "cuda") -> NormalizerState:
    """SpeechBrain ``InputNormalization`` checkpoint -> a ``NormalizerState``
    of f32 tensors on ``device``."""
    d = _torch_load(path)
    return NormalizerState(
        count=torch.tensor(float(d["count"]), dtype=torch.float32, device=device),
        glob_mean=torch.as_tensor(np.asarray(d["glob_mean"], np.float32), device=device),
        glob_std=torch.as_tensor(np.asarray(d["glob_std"], np.float32), device=device),
    )


def load_noam_ckpt(path: str, scheduler=None) -> dict:
    """SpeechBrain ``NoamScheduler`` checkpoint -> its dict; with
    ``scheduler`` (the port's ``NoamScheduler``), also sets its ``n_steps``,
    ``current_lr`` (``lr_at(max(n_steps, 1))``) and ``losses``."""
    d = _torch_load(path)
    n_steps = int(d.get("n_steps", 0))
    if scheduler is not None:
        scheduler.n_steps = n_steps
        scheduler.current_lr = scheduler.lr_at(max(n_steps, 1))
        scheduler.losses = list(d.get("losses", []))
    return d


def load_counter_ckpt(path: str) -> int:
    """An ``EpochCounter`` checkpoint: an int as text."""
    with open(path) as f:
        return int(f.read().strip())


def load_state_dict_ckpt(path: str) -> dict:
    """A torch state dict (or a module) checkpoint -> {key: numpy array}."""
    d = _torch_load(path)
    if hasattr(d, "state_dict"):
        d = d.state_dict()
    return {k: v.detach().cpu().numpy() if hasattr(v, "detach") else v for k, v in d.items()}
