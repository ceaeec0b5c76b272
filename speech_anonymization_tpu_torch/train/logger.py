"""File + stdout stats logger with the reference's ``train_log.txt`` line format.

Counterpart of ``speech_anonymization_tpu/train/logger.py`` (SpeechBrain's
``FileTrainLogger``): the same lines for the same stats, e.g.
``epoch: 29, lr: 3.92e-04, steps: 124920, optimizer: Adam - train loss:
9.63e-01 - valid loss: 1.02, valid ACC: 5.00e-01, ...``.
"""

from __future__ import annotations

import os
from typing import Mapping


def _format_value(v) -> str:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return str(v)
    if f == int(f) and abs(f) < 1e5 and isinstance(v, int):
        return str(v)
    # SpeechBrain: 2 significant-digit scientific for small, plain otherwise
    if abs(f) < 0.01 or abs(f) >= 1e5:
        return f"{f:.2e}"
    return f"{f:.2f}"


class FileTrainLogger:
    def __init__(self, save_file: str, precision: int = 2):
        self.save_file = save_file
        self.precision = precision
        os.makedirs(os.path.dirname(os.path.abspath(save_file)), exist_ok=True)

    def _stats_string(self, stats: Mapping, prefix: str | None = None) -> str:
        return ", ".join(f"{f'{prefix} {k}' if prefix else k}: {_format_value(v)}"
                         for k, v in stats.items())

    def log_stats(self, stats_meta: Mapping, train_stats: Mapping | None = None,
                  valid_stats: Mapping | None = None, test_stats: Mapping | None = None,
                  verbose: bool = True):
        parts = [self._stats_string(stats_meta)]
        for prefix, stats in (("train", train_stats), ("valid", valid_stats), ("test", test_stats)):
            if stats is not None:
                parts.append(self._stats_string(stats, prefix))
        line = " - ".join(parts)
        with open(self.save_file, "a") as f:
            f.write(line + "\n")
        if verbose:
            print(line)
