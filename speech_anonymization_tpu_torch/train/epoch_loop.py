"""Epoch counter, a checkpoint recoverable so a resumed run continues at the
right epoch. Counterpart of ``speech_anonymization_tpu/train/epoch_loop.py``
(SpeechBrain's ``EpochCounter``)."""

from __future__ import annotations


class EpochCounter:
    def __init__(self, limit: int):
        self.limit = int(limit)
        self.current = 0

    def __iter__(self):
        while self.current < self.limit:
            self.current += 1
            yield self.current

    def state_dict(self):
        return {"current": self.current, "limit": self.limit}

    def load_state_dict(self, d):
        self.current = int(d["current"])
