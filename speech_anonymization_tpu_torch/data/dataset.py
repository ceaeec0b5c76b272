"""CSV-manifest dataset with lazy per-item pipelines and padded batching.

Counterpart of ``speech_anonymization_tpu/data/dataset.py`` (SpeechBrain's
DynamicItemDataset / PaddedBatch / SaveableDataLoader stack), a copy:
``from_csv`` + ``add_dynamic_item`` + ``set_output_keys`` +
``filtered_sorted``, padded numpy batches carrying relative lengths, and the
same batches in the same order for the same seed and epoch
(``np.random.default_rng(seed + epoch)``).

  * bucketing: a batch's time axis is padded up to a bucket length
    (``bucket_map``), so batches come in a handful of shapes (the anonymizer
    recipe picks buckets that keep T a multiple of 36 frames);
  * the loader tracks its position for checkpoint resume (the reference
    checkpoints ``dataloader-TRAIN`` the same way).
"""

from __future__ import annotations

import csv
import math
from typing import Any, Callable, Iterable, Mapping, Sequence

import numpy as np


class DynamicItem:
    def __init__(self, takes: Sequence[str], provides: Sequence[str], func: Callable):
        self.takes = list(takes)
        self.provides = list(provides)
        self.func = func


def takes(*keys):
    def deco(f):
        f._takes = list(keys)
        return f

    return deco


def provides(*keys):
    def deco(f):
        f._provides = list(keys)
        return f

    return deco


class DynamicItemDataset:
    """id -> raw fields; dynamic items compute derived fields on access."""

    def __init__(self, data: Mapping[str, dict]):
        self.data = {str(k): dict(v) for k, v in data.items()}
        self.ids = list(self.data.keys())
        self.pipeline: list[DynamicItem] = []
        self.output_keys: list[str] = []

    # -- construction --------------------------------------------------------

    @classmethod
    def from_csv(cls, csv_path: str, replacements: Mapping[str, str] | None = None):
        replacements = replacements or {}
        data = {}
        with open(csv_path, newline="") as f:
            for row in csv.DictReader(f):
                item_id = row.pop("ID", None) or row.pop("id")
                for k, v in row.items():
                    for name, value in replacements.items():
                        if isinstance(v, str):
                            v = v.replace("$" + name, value).replace("{" + name + "}", value)
                    row[k] = v
                if "duration" in row:
                    row["duration"] = float(row["duration"])
                data[item_id] = row
        return cls(data)

    def add_dynamic_item(self, func: Callable, takes=None, provides=None):
        takes = takes if takes is not None else getattr(func, "_takes")
        provides = provides if provides is not None else getattr(func, "_provides")
        if isinstance(takes, str):
            takes = [takes]
        if isinstance(provides, str):
            provides = [provides]
        self.pipeline.append(DynamicItem(takes, provides, func))

    def set_output_keys(self, keys: Sequence[str]):
        self.output_keys = list(keys)

    # -- filtering / sorting --------------------------------------------------

    def filtered_sorted(
        self,
        sort_key: str | None = None,
        reverse: bool = False,
        key_min_value: Mapping[str, float] | None = None,
        key_max_value: Mapping[str, float] | None = None,
        select_n: int | None = None,
    ) -> "DynamicItemDataset":
        ids = list(self.ids)
        for key, v in (key_min_value or {}).items():
            ids = [i for i in ids if float(self.data[i][key]) >= v]
        for key, v in (key_max_value or {}).items():
            ids = [i for i in ids if float(self.data[i][key]) <= v]
        if sort_key is not None:
            ids.sort(key=lambda i: self.data[i][sort_key], reverse=reverse)
        if select_n is not None:
            ids = ids[:select_n]
        sub = DynamicItemDataset({i: self.data[i] for i in ids})
        sub.ids = ids
        sub.pipeline = self.pipeline
        sub.output_keys = self.output_keys
        return sub

    def raw_values(self, key: str):
        return [item[key] for item in self.data.values()]

    # -- access ---------------------------------------------------------------

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, index: int) -> dict:
        item_id = self.ids[index]
        computed = dict(self.data[item_id])
        computed["id"] = item_id
        for di in self.pipeline:
            args = [computed[k] for k in di.takes]
            out = di.func(*args)
            if len(di.provides) == 1:
                computed[di.provides[0]] = out
            else:
                # generator-style multi-provides (reference text_pipeline,
                # speechbrain_convae_train.py:494-503)
                values = list(out) if not isinstance(out, tuple) else list(out)
                for k, v in zip(di.provides, values):
                    computed[k] = v
        if self.output_keys:
            return {k: computed[k] for k in self.output_keys}
        return computed


def _bucket_length(n: int, buckets: Sequence[int] | None) -> int:
    if not buckets:
        return n
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def make_buckets(min_len: int, max_len: int, growth: float = 1.3) -> list[int]:
    """Geometric grid of padded lengths: few batch shapes, low waste."""
    out = [min_len]
    while out[-1] < max_len:
        out.append(int(math.ceil(out[-1] * growth)))
    return out


class PaddedBatch:
    """Batch dict: variable-length arrays padded + relative lengths.

    ``batch.sig`` -> (padded (B, T) float array, (B,) relative lengths),
    matching the reference PaddedBatch contract (``wavs, wav_lens =
    batch.sig``, speechbrain_convae_train.py:46).
    """

    def __init__(self, items: list[dict], padded_keys=None, bucket_map: Mapping[str, Sequence[int]] | None = None):
        self._keys = list(items[0].keys())
        bucket_map = bucket_map or {}
        for key in self._keys:
            values = [it[key] for it in items]
            first = values[0]
            if isinstance(first, np.ndarray) and first.ndim >= 1:
                lens = np.asarray([v.shape[0] for v in values], np.int64)
                max_len = _bucket_length(int(lens.max()), bucket_map.get(key))
                shape = (len(values), max_len) + first.shape[1:]
                padded = np.zeros(shape, first.dtype)
                for i, v in enumerate(values):
                    padded[i, : v.shape[0]] = v
                rel = (lens / max_len).astype(np.float32)
                setattr(self, key, (padded, rel))
            elif isinstance(first, (int, np.integer)):
                setattr(self, key, np.asarray(values, np.int32))
            elif isinstance(first, (float, np.floating)):
                setattr(self, key, np.asarray(values, np.float32))
            else:
                setattr(self, key, values)

    def keys(self):
        return self._keys

    def __len__(self):
        first = getattr(self, self._keys[0])
        if isinstance(first, tuple):
            return first[0].shape[0]
        return len(first)


class SaveableDataLoader:
    """Batching loader with optional shuffling and position checkpointing."""

    def __init__(
        self,
        dataset: DynamicItemDataset,
        batch_size: int = 1,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        bucket_map: Mapping[str, Sequence[int]] | None = None,
        collate_fn: Callable | None = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.bucket_map = bucket_map
        self.collate_fn = collate_fn or (lambda items: PaddedBatch(items, bucket_map=bucket_map))
        self.epoch = 0
        self._position = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        n_batches = len(self)
        start = self._position
        for b in range(start, n_batches):
            self._position = b
            idx = order[b * self.batch_size : (b + 1) * self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                break
            yield self.collate_fn([self.dataset[int(i)] for i in idx])
        self._position = 0

    def state_dict(self):
        return {"position": self._position, "epoch": self.epoch}

    def load_state_dict(self, d):
        self._position = int(d["position"])
        self.epoch = int(d["epoch"])
