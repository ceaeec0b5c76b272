"""Step timing and trace capture around a window of training steps.

Counterpart of ``speech_anonymization_tpu/train/profiler.py``: ``StepTimer``
as it is, and ``TraceProfiler`` on ``torch.profiler`` (CPU and, where a card
is present, CUDA activity), written as a Chrome trace under ``logdir``.
Wired into ``Brain.fit`` through hparams::

    profile_dir: /path/to/traces   # a trace of steps 10..20
    profile_start_step: 10
    profile_num_steps: 10
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch


class StepTimer:
    """Host-side per-step wall-time aggregator. Under ``Brain.fit`` a step's
    loss stays on its device, so on a card the time is what the host takes
    to launch the micro-batch's work, not the device's time for it (the JAX
    package's ``Brain`` reads each loss back, and so times both)."""

    def __init__(self):
        self.durations: list[float] = []
        self._t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is not None:
            self.durations.append(time.perf_counter() - self._t0)
            self._t0 = None

    def summary(self) -> dict:
        if not self.durations:
            return {}
        d = np.asarray(self.durations)
        return {
            "steps": len(d),
            "mean_ms": float(d.mean() * 1e3),
            "p50_ms": float(np.percentile(d, 50) * 1e3),
            "p90_ms": float(np.percentile(d, 90) * 1e3),
            "max_ms": float(d.max() * 1e3),
        }


class TraceProfiler:
    """``torch.profiler`` capture over a step window -> ``<logdir>/trace.json``."""

    def __init__(self, logdir: str, start_step: int = 10, num_steps: int = 10):
        self.logdir = logdir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof: torch.profiler.profile | None = None
        self._done = False

    def maybe_start(self, step: int):
        if not self._done and self._prof is None and step >= self.start_step:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()

    def maybe_stop(self, step: int):
        if self._prof is not None and step >= self.stop_step:
            self.close()

    def close(self):
        if self._prof is not None:
            self._prof.stop()
            os.makedirs(self.logdir, exist_ok=True)
            self._prof.export_chrome_trace(os.path.join(self.logdir, "trace.json"))
            self._prof = None
            self._done = True
