"""LibriSpeech scanner -> CSV manifests with speaker sex labels.

Counterpart of ``speech_anonymization_tpu/data/librispeech.py``, a copy that
writes the same CSV bytes. It replaces the ``librispeech_prepare.prepare_librispeech`` recipe helper the
reference imports from its (empty) speechbrain submodule
(gender_classifier_train.py:49-50, called via run_on_main at
speechbrain_convae_train.py:534-546). Produces one CSV per split with the
columns the recipes consume: ID, duration, wav, spk_id, sex (-> 'gender'),
wrd; supports split merging (merge_lst/merge_name) and skip_prep.

LibriSpeech layout: <root>/<split>/<spk>/<chapter>/<spk>-<chapter>-<utt>.flac
plus <spk>-<chapter>.trans.txt and a root SPEAKERS.TXT carrying the sex of
each speaker. Synthetic fixtures may use .wav — both extensions are scanned.
"""

from __future__ import annotations

import csv
import os

from .audio import audio_duration

CSV_FIELDS = ["ID", "duration", "wav", "spk_id", "sex", "wrd"]


def read_speakers_file(path: str) -> dict[str, str]:
    """SPEAKERS.TXT -> {speaker_id: 'M'|'F'}."""
    sexes: dict[str, str] = {}
    if not os.path.exists(path):
        return sexes
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            if line.startswith(";"):
                continue
            parts = [p.strip() for p in line.split("|")]
            if len(parts) >= 2 and parts[0]:
                sexes[parts[0]] = parts[1]
    return sexes


def _read_transcripts(chapter_dir: str) -> dict[str, str]:
    words: dict[str, str] = {}
    for entry in os.listdir(chapter_dir):
        if entry.endswith(".trans.txt"):
            with open(os.path.join(chapter_dir, entry)) as f:
                for line in f:
                    utt_id, _, text = line.strip().partition(" ")
                    if utt_id:
                        words[utt_id] = text
    return words


def scan_split(data_folder: str, split: str, speaker_sex: dict[str, str]) -> list[dict]:
    split_dir = os.path.join(data_folder, split)
    rows = []
    if not os.path.isdir(split_dir):
        raise FileNotFoundError(f"split directory missing: {split_dir}")
    for spk in sorted(os.listdir(split_dir)):
        spk_dir = os.path.join(split_dir, spk)
        if not os.path.isdir(spk_dir):
            continue
        for chapter in sorted(os.listdir(spk_dir)):
            chap_dir = os.path.join(spk_dir, chapter)
            if not os.path.isdir(chap_dir):
                continue
            transcripts = _read_transcripts(chap_dir)
            for entry in sorted(os.listdir(chap_dir)):
                if not entry.endswith((".flac", ".wav")):
                    continue
                utt_id = os.path.splitext(entry)[0]
                path = os.path.join(chap_dir, entry)
                rows.append(
                    {
                        "ID": utt_id,
                        "duration": round(audio_duration(path), 4),
                        "wav": path,
                        "spk_id": spk,
                        "sex": speaker_sex.get(spk, "M"),
                        "wrd": transcripts.get(utt_id, ""),
                    }
                )
    return rows


def _write_csv(path: str, rows: list[dict]):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=CSV_FIELDS)
        writer.writeheader()
        writer.writerows(rows)


def prepare_librispeech(
    data_folder: str,
    tr_splits=(),
    dev_splits=(),
    te_splits=(),
    save_folder: str | None = None,
    merge_lst=(),
    merge_name: str | None = None,
    skip_prep: bool = False,
):
    """Scan splits and write per-split CSVs (plus an optional merged train CSV).

    Signature mirrors the reference call site (gender_classifier_train.py:
    321-333) so recipe configs translate one-to-one.
    """
    if skip_prep:
        return
    save_folder = save_folder or data_folder
    speaker_sex = read_speakers_file(os.path.join(data_folder, "SPEAKERS.TXT"))
    merged_rows = []
    for split in list(tr_splits) + list(dev_splits) + list(te_splits):
        rows = scan_split(data_folder, split, speaker_sex)
        _write_csv(os.path.join(save_folder, f"{split}.csv"), rows)
        if split in set(merge_lst):
            merged_rows.extend(rows)
    if merge_name and merged_rows:
        out = merge_name if os.path.isabs(merge_name) else os.path.join(save_folder, os.path.basename(merge_name))
        _write_csv(out, merged_rows)
