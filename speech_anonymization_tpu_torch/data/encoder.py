"""Categorical label encoder with on-disk persistence.

Counterpart of ``speech_anonymization_tpu/data/encoder.py``, a copy.
Reference: sb.dataio.encoder.CategoricalEncoder
(gender_classifier_train.py:266,278-296) persisted as label_encoder.txt
with lines like ``'M' => 0`` (results/gender_classifier/1230/save/
label_encoder.txt:1-2). File format kept compatible so reference artifacts
can be read.
"""

from __future__ import annotations

import os


class CategoricalEncoder:
    def __init__(self):
        self.lab2ind: dict[str, int] = {}
        self.ind2lab: dict[int, str] = {}

    def __len__(self):
        return len(self.lab2ind)

    def add_label(self, label: str) -> int:
        if label not in self.lab2ind:
            idx = len(self.lab2ind)
            self.lab2ind[label] = idx
            self.ind2lab[idx] = label
        return self.lab2ind[label]

    def update_from_iterable(self, iterable):
        for label in iterable:
            self.add_label(str(label))

    def encode_label(self, label: str) -> int:
        return self.lab2ind[str(label)]

    def decode_index(self, index: int) -> str:
        return self.ind2lab[int(index)]

    def save(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            for lab, ind in sorted(self.lab2ind.items(), key=lambda kv: kv[1]):
                f.write(f"'{lab}' => {ind}\n")

    def load(self, path: str):
        self.lab2ind.clear()
        self.ind2lab.clear()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("="):
                    continue
                lab, _, ind = line.rpartition("=>")
                lab = lab.strip().strip("'\"")
                try:
                    idx = int(ind.strip())
                except ValueError:
                    continue
                self.lab2ind[lab] = idx
                self.ind2lab[idx] = lab

    def load_or_create(self, path: str, from_iterables=(), output_key=None, from_didatasets=()):
        """Load if the file exists, else build from data and save.

        Mirrors the reference call (gender_classifier_train.py:291-296).
        ``from_didatasets`` + ``output_key`` extracts that key per item.
        """
        if os.path.exists(path):
            self.load(path)
            return
        for it in from_iterables:
            self.update_from_iterable(it)
        for ds in from_didatasets:
            self.update_from_iterable(ds.raw_values(output_key))
        self.save(path)
