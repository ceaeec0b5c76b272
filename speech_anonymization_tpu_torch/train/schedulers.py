"""Learning-rate schedulers with SpeechBrain's semantics, host-side state.

Counterparts of ``speech_anonymization_tpu/train/schedulers.py``:
``NoamScheduler`` (convae.yaml: lr_initial 1.0, 25,000 warmup steps, model
size 768; advanced once per optimizer update) and ``ReduceLROnPlateau``
(gender_classifier.yaml: factor 0.5, patience 2, no halving before epoch 2;
stepped once per epoch on the valid loss). Each returns plain Python floats,
which the optimizers take as their lr.
"""

from __future__ import annotations

import math


class NoamScheduler:
    """lr = lr_initial * model_size^-0.5 * min(n^-0.5, n * warmup^-1.5)."""

    def __init__(self, lr_initial: float = 1.0, n_warmup_steps: int = 25000, model_size: int = 768):
        self.lr_initial = lr_initial
        self.n_warmup_steps = n_warmup_steps
        self.normalize = model_size ** (-0.5)
        self.n_steps = 0
        self.current_lr = lr_initial
        self.losses: list[float] = []  # a reference checkpoint's, kept as read (utils/sb_compat.py)

    def __call__(self) -> float:
        """Advance one optimizer update; return the new lr."""
        self.n_steps += 1
        self.current_lr = self.lr_initial * self._lr_factor(self.n_steps)
        return self.current_lr

    def _lr_factor(self, step: int) -> float:
        return self.normalize * min(step ** (-0.5), step * self.n_warmup_steps ** (-1.5))

    def lr_at(self, step: int) -> float:
        return self.lr_initial * self._lr_factor(max(step, 1))

    def state_dict(self) -> dict:
        return {"n_steps": self.n_steps, "current_lr": self.current_lr}

    def load_state_dict(self, d: dict) -> None:
        self.n_steps = int(d["n_steps"])
        self.current_lr = float(d["current_lr"])


class ReduceLROnPlateau:
    """Multiply the lr by ``factor`` after more than ``patience`` epochs without
    a better valid loss, from epoch ``dont_halve_until_epoch`` on."""

    def __init__(self, lr_initial: float = 1e-3, factor: float = 0.5, patience: int = 2,
                 dont_halve_until_epoch: int = 2, lr_min: float = 1e-8):
        self.lr = lr_initial
        self.factor = factor
        self.patience = patience
        self.dont_halve_until_epoch = dont_halve_until_epoch
        self.lr_min = lr_min
        self.best_loss = math.inf
        self.bad_epochs = 0

    def __call__(self, epoch: int, loss: float) -> tuple[float, float]:
        """-> (old_lr, new_lr)."""
        old_lr = self.lr
        if loss < self.best_loss:
            self.best_loss = loss
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        if epoch >= self.dont_halve_until_epoch and self.bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.lr_min)
            self.bad_epochs = 0
        return old_lr, self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best_loss": self.best_loss, "bad_epochs": self.bad_epochs}

    def load_state_dict(self, d: dict) -> None:
        self.lr = float(d["lr"])
        self.best_loss = float(d["best_loss"])
        self.bad_epochs = int(d["bad_epochs"])
