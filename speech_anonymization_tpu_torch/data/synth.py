"""Synthetic formant-speech corpus generator (LibriSpeech layout).

Counterpart of ``speech_anonymization_tpu/data/synth.py``, a copy: the same
seed writes the same WAV bytes.

The build environment ships no LibriSpeech audio, so reduced-scale
reproductions of the reference's research rows (EXPERIMENTS.md) and the
non-overfit test gates run on this corpus instead: gendered speakers
(F0 M~115 Hz / F~210 Hz, female formants ~1.12x — the vocal-tract-length
cue), and every WORD is a FIXED phone sequence so the audio actually
carries the transcript (an ASR can only beat chance if acoustics and
words correlate). Output layout matches what ``prepare_librispeech``
scans (<root>/<split>/<spk>/<chap>/*.wav + .trans.txt + SPEAKERS.TXT).

No counterpart in the reference (it has no tests/fixtures — SURVEY.md §4);
this is the rebuild's substitute for real data.
"""

from __future__ import annotations

import os

import numpy as np

from .audio import write_wav

SR = 16000

# phone inventory: vowel-like formant targets (Hz) — speaker formant_scale
# multiplies them, F0 comes from the speaker
PHONES = {
    "AA": (730, 1090, 2440), "IY": (270, 2290, 3010), "UW": (300, 870, 2240),
    "EH": (530, 1840, 2480), "AO": (570, 840, 2410), "AE": (660, 1720, 2410),
    "ER": (490, 1350, 1690), "IH": (390, 1990, 2550), "AH": (640, 1190, 2390),
    "OW": (450, 1030, 2380), "EY": (400, 2100, 2700), "AY": (680, 1300, 2500),
}
WORD_PHONES = {
    "HELLO": ("EH", "AH", "OW"),
    "WORLD": ("ER", "AH", "UW"),
    "SPEECH": ("IY", "IH", "IY"),
    "MODEL": ("AO", "AH", "EH"),
    "TEST": ("EH", "AE", "IH"),
    "AUDIO": ("AA", "IY", "OW"),
    "SIGNAL": ("IH", "AE", "AH"),
    "VOICE": ("AO", "AY", "IY"),
}
WORDS = list(WORD_PHONES)


def _phone_wave(rng, f0, formants, scale, dur, declination):
    t = np.arange(dur) / SR
    f1, f2, f3 = (f * scale for f in formants)
    f0 = f0 * (1.0 + 0.04 * rng.standard_normal()) * declination

    def env(f):
        return (
            1.0 * np.exp(-0.5 * ((f - f1) / 120.0) ** 2)
            + 0.6 * np.exp(-0.5 * ((f - f2) / 180.0) ** 2)
            + 0.25 * np.exp(-0.5 * ((f - f3) / 250.0) ** 2)
            + 0.01
        )

    x = np.zeros(dur)
    k = 1
    while k * f0 < 4500:
        # mild vibrato so harmonics are not laser lines
        phase = 2 * np.pi * k * f0 * t * (1 + 0.003 * np.sin(2 * np.pi * 5.0 * t))
        x += env(k * f0) * np.cos(phase + rng.uniform(0, 2 * np.pi))
        k += 1
    x *= 0.22 / (np.abs(x).max() + 1e-9)
    a = np.minimum(1.0, np.minimum(t / 0.02, (dur / SR - t) / 0.03).clip(0.05))
    return x * a


def _utterance(rng, f0_base, formant_scale, words):
    """Formant-synthesized 'speech' FOR a word sequence: each word is its
    fixed phone sequence (WORD_PHONES) with per-speaker F0/formant scale,
    F0 declination + jitter, short inter-word pauses, breath noise."""
    pieces = []
    n_phones = sum(len(WORD_PHONES[w]) for w in words)
    i = 0
    for w in words:
        for ph in WORD_PHONES[w]:
            dur = int(rng.uniform(0.10, 0.16) * SR)
            decl = 1.0 - 0.1 * i / max(n_phones, 1)
            pieces.append(_phone_wave(rng, f0_base, PHONES[ph], formant_scale, dur, decl))
            i += 1
        if rng.random() < 0.6:
            pieces.append(np.zeros(int(rng.uniform(0.02, 0.07) * SR)))
    out = np.concatenate(pieces)
    out = out + 0.004 * rng.standard_normal(len(out))
    return out.astype(np.float32)


def build_corpus(root, n_train_spk=8, n_test_spk=5, utts=10, words_per_utt=4,
                 seed=0):
    """M/F speakers with disjoint test speakers (wide enough that ACC rows
    are not quantized to coarse steps). F0: M ~ N(115, 12), F ~ N(210, 18);
    female formants scaled ~1.12x (vocal-tract length cue). Returns
    ``(speakers, total_seconds)``."""
    rng = np.random.default_rng(seed)
    speakers = {}
    sid = 100
    for split, n_spk in (("train-clean", n_train_spk), ("test-clean", n_test_spk)):
        for i in range(n_spk):
            for sex in ("M", "F"):
                f0 = rng.normal(115, 12) if sex == "M" else rng.normal(210, 18)
                scale = rng.normal(1.0, 0.03) if sex == "M" else rng.normal(1.12, 0.03)
                speakers[str(sid)] = (split, sex, max(80.0, f0), scale)
                sid += 1
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "SPEAKERS.TXT"), "w") as f:
        f.write("; speaker | sex | subset\n")
        for spk, (split, sex, _, _) in speakers.items():
            f.write(f"{spk} | {sex} | {split}\n")
    total_s = 0.0
    for spk, (split, sex, f0, scale) in speakers.items():
        chap_dir = os.path.join(root, split, spk, "100")
        os.makedirs(chap_dir, exist_ok=True)
        lines = []
        for u in range(utts):
            utt_id = f"{spk}-100-{u:04d}"
            words = list(rng.choice(WORDS, size=words_per_utt))
            wav = _utterance(rng, f0, scale, words)
            total_s += len(wav) / SR
            write_wav(os.path.join(chap_dir, utt_id + ".wav"), wav, SR)
            lines.append(f"{utt_id} " + " ".join(words))
        with open(os.path.join(chap_dir, f"{spk}-100.trans.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return speakers, total_s
