"""Brain-style training engine: the epoch and stage loop with hooks.

Counterpart of ``speech_anonymization_tpu/train/brain.py`` (SpeechBrain's
``Brain.fit`` / ``evaluate`` skeleton): stage hooks (``on_stage_start``,
``on_stage_end``, ``on_fit_start``, ``on_evaluate_start``), per-epoch train
and valid loops, the average stage loss, time-based interval checkpoints and
a profiler window. ``step`` counts the epoch's micro-batches: reset each
epoch, counted before ``fit_batch``.

One difference: the JAX package reads every micro-batch's loss back to the
host (``float(self.fit_batch(...))``). Here each loss is added on its device,
in float64 and in the same order, and the sum is read once a stage: every
f32 loss converts to float64 exactly, so the stage loss equals the JAX
package's Python-float sum on the same losses.
"""

from __future__ import annotations

import enum
from typing import Iterable

import torch

from .checkpoint import Checkpointer
from .profiler import StepTimer, TraceProfiler


class Stage(enum.Enum):
    TRAIN = enum.auto()
    VALID = enum.auto()
    TEST = enum.auto()


def _mean_loss(total: torch.Tensor | None, count: int) -> float:
    return float(total) / count if count else 0.0


def _add(total: torch.Tensor | None, loss) -> torch.Tensor:
    loss = torch.as_tensor(loss).detach().to(torch.float64)
    return loss if total is None else total + loss


class Brain:
    def __init__(self, hparams: dict | None = None, checkpointer: Checkpointer | None = None,
                 ckpt_interval_minutes: float | None = None):
        self.hparams = dict(hparams or {})
        self.checkpointer = checkpointer
        self.ckpt_interval_minutes = ckpt_interval_minutes
        self.step = 0
        self.train_stats: dict = {}
        self.step_timer = StepTimer()
        profile_dir = self.hparams.get("profile_dir")
        self.profiler = (
            TraceProfiler(profile_dir, int(self.hparams.get("profile_start_step", 10)),
                          int(self.hparams.get("profile_num_steps", 10)))
            if profile_dir else None
        )

    # -- subclass responsibilities -------------------------------------------

    def fit_batch(self, batch, epoch: int):
        """-> the micro-batch's loss (a device scalar or a float)."""
        raise NotImplementedError

    def evaluate_batch(self, batch, stage: Stage):
        raise NotImplementedError

    def on_fit_start(self):
        """Called once before training."""

    def on_stage_start(self, stage: Stage, epoch: int | None = None):
        pass

    def on_stage_end(self, stage: Stage, stage_loss: float, epoch: int | None = None):
        pass

    def on_evaluate_start(self, max_key: str | None = None, min_key: str | None = None):
        """Checkpoint selection (averaging) before the test stage."""

    # -- loops ------------------------------------------------------------------

    def fit(self, epoch_counter, train_set: Iterable, valid_set: Iterable | None = None,
            progressbar: bool = False):
        self.on_fit_start()
        for epoch in epoch_counter:
            self.on_stage_start(Stage.TRAIN, epoch)
            if hasattr(train_set, "set_epoch"):
                train_set.set_epoch(epoch)
            total, count = None, 0
            self.step = 0
            for batch in train_set:
                self.step += 1
                if self.profiler is not None:
                    self.profiler.maybe_start(self.step)
                self.step_timer.start()
                total = _add(total, self.fit_batch(batch, epoch))
                self.step_timer.stop()
                if self.profiler is not None:
                    self.profiler.maybe_stop(self.step)
                count += 1
                if self.checkpointer is not None and self.ckpt_interval_minutes:
                    self.checkpointer.maybe_save_interval({"epoch": epoch, "intra_epoch": True},
                                                          self.ckpt_interval_minutes)
            train_loss = _mean_loss(total, count)
            self.train_stats = {"loss": train_loss}
            self.on_stage_end(Stage.TRAIN, train_loss, epoch)

            if valid_set is not None:
                self.on_stage_start(Stage.VALID, epoch)
                total, count = None, 0
                for batch in valid_set:
                    total = _add(total, self.evaluate_batch(batch, Stage.VALID))
                    count += 1
                self.on_stage_end(Stage.VALID, _mean_loss(total, count), epoch)

    def evaluate(self, test_set: Iterable, max_key: str | None = None,
                 min_key: str | None = None) -> float:
        self.on_evaluate_start(max_key=max_key, min_key=min_key)
        self.on_stage_start(Stage.TEST, None)
        total, count = None, 0
        for batch in test_set:
            total = _add(total, self.evaluate_batch(batch, Stage.TEST))
            count += 1
        avg = _mean_loss(total, count)
        self.on_stage_end(Stage.TEST, avg, None)
        return avg
