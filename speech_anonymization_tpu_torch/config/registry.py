"""Constructor registry for the YAML config system.

Counterpart of ``speech_anonymization_tpu/config/registry.py``: the
reference's HyperPyYAML instantiates ARBITRARY python objects from YAML tags
(``!new:speechbrain.lobes.features.Fbank``), an arbitrary-code-execution
config format. Here tags resolve only against:

  * explicitly registered names (the ``register`` decorator, and the
    builtins below: the JAX package's names, mapped to the port's classes),
  * dotted paths inside the ``speech_anonymization_tpu_torch`` package (never
    the JAX package's ``speech_anonymization_tpu.``).

Every name the JAX package registers is registered here, with the same kind
of target (a class, a factory, or the function itself).
"""

from __future__ import annotations

import importlib
from typing import Any

REGISTRY: dict[str, Any] = {}

_ALLOWED_PREFIXES = ("speech_anonymization_tpu_torch.",)


def register(name: str | None = None):
    def deco(obj):
        REGISTRY[name or obj.__name__] = obj
        return obj

    return deco


def resolve_path(path: str) -> Any:
    """Resolve a tag path to a callable/class via registry or package import."""
    if path in REGISTRY:
        return REGISTRY[path]
    if path.startswith(_ALLOWED_PREFIXES):
        module_path, _, attr = path.rpartition(".")
        mod = importlib.import_module(module_path)
        return getattr(mod, attr)
    raise KeyError(
        f"config tag '{path}' is not registered and not inside "
        f"{_ALLOWED_PREFIXES}; register it with config.register()"
    )


def _register_builtins():
    """Names usable directly in configs (what the reference's yamls pull from
    torch/speechbrain), mapped to the port's classes."""
    import math

    from .. import losses as L
    from ..data.encoder import CategoricalEncoder
    from ..eval.metrics import AccuracyStats, MetricStats, SimilarityMetricsStats
    from ..eval.wer import ErrorRateStats
    from ..models import (
        ConvAutoencoder,
        ConvReconstruction,
        CycleGANGenerator,
        FullyConnectedAutoencoder,
        Xvector,
        XvectorClassifier,
    )
    from ..ops.augment import EnvCorrupt, SpeedPerturb, TimeDomainSpecAugment
    from ..ops.fbank import Fbank, FbankConfig
    from ..ops.normalization import InputNormalizer
    from ..ops.specaugment import SpecAugment
    from ..train.checkpoint import Checkpointer
    from ..train.epoch_loop import EpochCounter
    from ..train.logger import FileTrainLogger
    from ..train.schedulers import NoamScheduler, ReduceLROnPlateau

    def fbank(sample_rate=16000, n_fft=400, n_mels=80, device="cuda", **kw):
        return Fbank(FbankConfig(sample_rate=sample_rate, n_fft=n_fft, n_mels=n_mels, **kw), device=device)

    REGISTRY.update({
        "Fbank": fbank,
        "InputNormalization": InputNormalizer,
        "SpecAugment": SpecAugment,
        "EnvCorrupt": EnvCorrupt,
        "TimeDomainSpecAugment": TimeDomainSpecAugment,
        "SpeedPerturb": SpeedPerturb,
        "NoamScheduler": NoamScheduler,
        "ReduceLROnPlateau": ReduceLROnPlateau,
        "EpochCounter": EpochCounter,
        "FileTrainLogger": FileTrainLogger,
        "Checkpointer": Checkpointer,
        "AccuracyStats": AccuracyStats,
        "MetricStats": MetricStats,
        "SimilarityMetricsStats": SimilarityMetricsStats,
        "ErrorRateStats": ErrorRateStats,
        "CategoricalEncoder": CategoricalEncoder,
        "ConvAutoencoder": ConvAutoencoder,
        "ConvReconstruction": ConvReconstruction,
        "CycleGANGenerator": CycleGANGenerator,
        "FullyConnectedAutoencoder": FullyConnectedAutoencoder,
        "Xvector": Xvector,
        "XvectorClassifier": XvectorClassifier,
        "mse_loss": lambda **kw: L.mse_loss,
        "l1_loss": lambda **kw: L.l1_loss,
        "nll_loss": lambda **kw: L.nll_loss,
        "kldiv_loss": L.kldiv_loss,
        "ctc_loss": L.ctc_loss,
        "cosine_similarity_loss": lambda **kw: L.cosine_similarity_loss,
        "confusion_loss": lambda **kw: L.confusion_loss,
        "classification_error": lambda **kw: L.classification_error,
        "MILoss": L.MILoss,
        "min": min,
        "max": max,
        "math.sqrt": math.sqrt,
    })


_register_builtins()
