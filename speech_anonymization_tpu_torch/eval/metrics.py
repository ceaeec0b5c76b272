"""Host-side metric aggregators (numpy), the port's copy of
``speech_anonymization_tpu/eval/metrics.py`` ``MetricStats``,
``AccuracyStats`` and ``SimilarityMetricsStats``. Callers pass numpy arrays (``tensor.cpu().numpy()``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np


class MetricStats:
    """Accumulates per-item scores of an arbitrary metric function."""

    def __init__(self, metric: Callable | None = None):
        self.metric = metric
        self.clear()

    def clear(self):
        self.scores: list[float] = []
        self.ids: list[str] = []
        self.summary: dict = {}

    def append(self, ids, *args, **kwargs):
        scores = np.atleast_1d(np.asarray(self.metric(*args, **kwargs)))
        self.ids.extend(ids)
        self.scores.extend(float(s) for s in scores)

    def summarize(self, field: str | None = None):
        avg = float(np.mean(self.scores)) if self.scores else 0.0
        self.summary = {"average": avg}
        if field is not None:
            return self.summary[field]
        return self.summary


class AccuracyStats:
    """Running categorical accuracy over (B, C) or (B, T, C) log-prob batches."""

    def __init__(self):
        self.correct = 0.0
        self.total = 0.0

    def append(self, log_probs, targets, lengths=None):
        lp = np.asarray(log_probs)
        tg = np.asarray(targets)
        # tolerate a leading singleton wrapper (the reference unsqueezes)
        while lp.ndim > tg.ndim + 1:
            lp = lp[0]
        while tg.ndim >= 1 and lp.ndim == tg.ndim and tg.shape[0] == 1:
            tg = tg[0]
            lp = lp[0]
        pred = lp.argmax(axis=-1)
        if lengths is None or pred.ndim == 1:
            self.correct += float((pred == tg).sum())
            self.total += float(pred.size)
        else:
            t = pred.shape[1]
            n = np.round(np.asarray(lengths) * t)
            mask = np.arange(t)[None, :] < n[:, None]
            self.correct += float(((pred == tg) & mask).sum())
            self.total += float(mask.sum())

    def summarize(self) -> float:
        return self.correct / self.total if self.total else 0.0


class SimilarityMetricsStats:
    """Mean of per-utterance similarity scores (utility retention)."""

    def __init__(self):
        self.clear()

    def clear(self):
        self.scores: list[float] = []
        self.value = 0.0
        self.denom = 0

    def append(self, scores):
        arr = np.atleast_1d(np.asarray(scores, np.float64))
        self.scores.extend(float(s) for s in arr)
        self.value += float(arr.sum())
        self.denom += arr.shape[0]

    def peek(self) -> float:
        return self.value / max(self.denom, 1)

    def summarize(self) -> float:
        return float(np.mean(self.scores)) if self.scores else 0.0
