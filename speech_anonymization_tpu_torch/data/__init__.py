"""The host-side input pipeline: the port's own copy of the JAX package's
``data/`` (audio IO, CSV datasets and loaders, LibriSpeech manifests, the
unigram tokenizer, the label encoder and the synthetic corpus)."""

from .audio import read_audio, write_wav
from .encoder import CategoricalEncoder
from .dataset import DynamicItemDataset, PaddedBatch, SaveableDataLoader
from .librispeech import prepare_librispeech

__all__ = [
    "read_audio",
    "write_wav",
    "CategoricalEncoder",
    "DynamicItemDataset",
    "PaddedBatch",
    "SaveableDataLoader",
    "prepare_librispeech",
]
