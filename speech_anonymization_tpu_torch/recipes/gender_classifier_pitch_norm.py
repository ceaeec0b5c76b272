"""The pitch-normalized gender classifier recipe.

Counterpart of ``speech_anonymization_tpu/recipes/gender_classifier_pitch_norm.py``
(the reference's gender_classifier_train_pitch_norm.py): the gender recipe
(``recipes/gender_classifier.py``) with an audio pipeline that
pitch-normalizes every waveform before its features (``data/pitch.py``: the
native vocoder's analysis, the voiced F0 mean shifted to ``pitch_target_f0``,
500 Hz, resynthesis), asking whether pitch alone carries the sex signal.
Each normalized waveform is cached as a WAV under ``pitch_cache_dir``
(default ``<save_folder>/pitch_cache``), keyed by the sha1 of its path and
the method, so later epochs read it back::

    python -m speech_anonymization_tpu_torch.recipes.gender_classifier_pitch_norm
        configs/gender_classifier_pitch_norm.yaml [--key value ...] [--device cuda|cpu]
"""

from __future__ import annotations

import hashlib
import os
from typing import Sequence

import numpy as np

from ..data.audio import read_audio, write_wav
from ..data.pitch import pitch_normalize
from . import gender_classifier as base


def make_pitch_pipeline(cache_dir: str | None = None, target_f0: float = 500.0,
                        sample_rate: int = 16000, method: str = "world"):
    """A dataset pipeline: WAV path -> the pitch-normalized float32 waveform,
    through the cache when ``cache_dir`` is given. ``method``: ``world`` (the
    full vocoder) or ``psola``. ``sample_rate`` is unused: each file's own
    rate is the vocoder's."""

    def audio_pipeline(wav_path):
        if cache_dir:
            key = hashlib.sha1((wav_path + ":" + method).encode()).hexdigest()[:16]
            cached = os.path.join(cache_dir, key + ".wav")
            if os.path.exists(cached):
                return read_audio(cached)
        sig, sr = read_audio(wav_path, return_sr=True)
        out = pitch_normalize(sig, sr, target_f0, method=method)
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
            write_wav(cached, out, sr)
        return out.astype(np.float32)

    return audio_pipeline


def _pipeline(hparams: dict):
    return make_pitch_pipeline(
        cache_dir=hparams.get("pitch_cache_dir") or os.path.join(hparams["save_folder"], "pitch_cache"),
        target_f0=float(hparams.get("pitch_target_f0", 500.0)),
        sample_rate=int(hparams.get("sample_rate", 16000)),
        method=str(hparams.get("pitch_method", "world")),
    )


def main(argv: Sequence[str] | None = None) -> base.GenderBrain:
    """The gender recipe's :func:`~.gender_classifier.main` on pitch-normalized
    audio (``pitch_target_f0``, ``pitch_method``, ``pitch_cache_dir``)."""
    return base.run(argv, "pitch-norm gender classifier recipe", make_pipeline=_pipeline)


if __name__ == "__main__":
    main()
