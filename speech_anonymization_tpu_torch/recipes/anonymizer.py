"""The anonymizer's inference and scoring path (no training yet).

Counterpart of the evaluation half of ``speech_anonymization_tpu/recipes/
anonymizer.py`` (``SexAnonymizationBrain``), for the ConvAutoencoder:

  * :func:`features`: fbank -> global normalizer -> pad T to a multiple of 36;
  * :func:`eval_step`: the full forward, the loss terms and the weighted total
    (the GRL sign convention: every term is added; no ASR, so utility is 0);
  * :func:`anonymize`: fbank -> normalizer -> ``ConvAutoencoder.anonymize``,
    the composition ``bench.py`` times;
  * :func:`evaluate_batch`: ``eval_step`` plus the scores: internal sex ACC,
    the frozen x-vector's ACC on clean and reconstructed features, and
    utility: with an ASR bundle (``recipes/asr_bundle.py``), the similarity
    of the ASR encoder outputs and, at the test stage, the WER of the beam
    decodes of both; without one, the recon-vs-clean feature cosine
    similarity as a proxy.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..eval.evaluator import FeatureClassifier
from ..eval.metrics import AccuracyStats, SimilarityMetricsStats
from ..losses.basic import confusion_loss, mse_loss, nll_loss
from ..models.autoencoders import ConvAutoencoder
from ..ops.fbank import Fbank
from ..ops.normalization import InputNormalizer, NormalizerState
from .asr_bundle import ASRBundle

# (recon, sex, utility, confusion): the recipe's defaults for evaluation
DEFAULT_WEIGHTS = (1.0, 0.0, 0.0, 0.0)


def pad_time_to_multiple(feats: torch.Tensor, multiple: int = 36) -> torch.Tensor:
    """Zero-pad (B, T, D) features at the end of T to a multiple of ``multiple``."""
    pad = (-feats.shape[1]) % multiple
    return F.pad(feats, (0, 0, 0, pad)) if pad else feats


def features(fbank: Fbank, normalizer: InputNormalizer, norm_state: NormalizerState,
             wavs: torch.Tensor, lens: torch.Tensor, epoch: int = 0, training: bool = False,
             pad_multiple: int = 36) -> tuple[torch.Tensor, NormalizerState]:
    """(B, L) waveforms -> (normalized, padded (B, T', 80) features, new normalizer state)."""
    feats, new_state = normalizer(norm_state, fbank(wavs), lens, epoch, training=training)
    return pad_time_to_multiple(feats, pad_multiple), new_state


def total_loss(recon_loss, sex_loss, utility, confusion, weights: Sequence[float]):
    """Weighted sum; the GRL models add the sex and confusion terms."""
    w_recon, w_sex, w_util, w_conf = weights
    return w_recon * recon_loss + w_sex * sex_loss + w_util * utility + w_conf * confusion


@torch.no_grad()
def eval_step(model: ConvAutoencoder, fbank: Fbank, normalizer: InputNormalizer,
              norm_state: NormalizerState, wavs: torch.Tensor, lens: torch.Tensor,
              labels: torch.Tensor, weights: Sequence[float] = DEFAULT_WEIGHTS, epoch: int = 0):
    """-> (loss, sex_log_probs (B, 2), recon (B, T', 80), clean (B, T', 80)).

    Puts ``model`` in eval mode (BatchNorm reads its running statistics).
    """
    clean, _ = features(fbank, normalizer, norm_state, wavs, lens, epoch)
    recon, sex_lp = model.eval()(clean)
    b = clean.shape[0]
    recon_loss = mse_loss(recon.reshape(b, -1), clean.reshape(b, -1))
    utility = torch.zeros((), device=clean.device)
    loss = total_loss(recon_loss, nll_loss(sex_lp, labels), utility, confusion_loss(sex_lp), weights)
    return loss, sex_lp, recon, clean


@torch.no_grad()
def anonymize(model: ConvAutoencoder, fbank: Fbank, normalizer: InputNormalizer,
              norm_state: NormalizerState, wavs: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """(B, L) waveforms -> (B, T, 80) anonymized features (frozen normalizer stats)."""
    feats, _ = normalizer(norm_state, fbank(wavs), lens, training=False)
    return model.eval().anonymize(feats)


class EvalMetrics:
    """The recipe's per-stage aggregators (``on_stage_start`` in the JAX recipe);
    an ASR bundle's ``start_test`` adds ``wer_metric`` and ``wer_metric2``."""

    def __init__(self):
        self.sex_acc = AccuracyStats()
        self.sex_acc_extern = AccuracyStats()
        self.sex_acc_extern_orig = AccuracyStats()
        self.utility_similarity = SimilarityMetricsStats()


def cosine_similarity(recon: np.ndarray, clean: np.ndarray) -> np.ndarray:
    """Per-utterance cosine similarity of flattened (B, T, D) features."""
    num = (recon * clean).sum(axis=(1, 2))
    den = np.linalg.norm(recon.reshape(len(recon), -1), axis=1) * np.linalg.norm(
        clean.reshape(len(clean), -1), axis=1
    )
    return num / np.maximum(den, 1e-8)


def evaluate_batch(model: ConvAutoencoder, fbank: Fbank, normalizer: InputNormalizer,
                   norm_state: NormalizerState, wavs: torch.Tensor, lens: torch.Tensor,
                   labels: torch.Tensor, metrics: EvalMetrics,
                   external_classifier: FeatureClassifier | None = None,
                   weights: Sequence[float] = DEFAULT_WEIGHTS, epoch: int = 0,
                   asr_bundle: ASRBundle | None = None, ids: Sequence[str] = (),
                   words: Sequence[str] = (), stage: str = "test") -> torch.Tensor:
    """One evaluation batch: :func:`eval_step`, then ACC, ACC_ext and utility.

    With ``asr_bundle`` (whose ``start_test`` has run on ``metrics`` for the
    test stage), utility is the bundle's: encoder similarity, and at
    ``stage == "test"`` the WER of both decodes against ``words`` (one
    reference string per utterance, keyed by ``ids``).
    """
    loss, sex_lp, recon, clean = eval_step(model, fbank, normalizer, norm_state, wavs, lens,
                                           labels, weights, epoch)
    labels_np = labels.cpu().numpy()
    metrics.sex_acc.append(sex_lp.cpu().numpy(), labels_np)
    if external_classifier is not None:
        lp_orig, _, _ = external_classifier.classify_feats(clean)
        metrics.sex_acc_extern_orig.append(lp_orig.cpu().numpy(), labels_np)
        lp_recon, _, _ = external_classifier.classify_feats(recon)
        metrics.sex_acc_extern.append(lp_recon.cpu().numpy(), labels_np)
    if asr_bundle is not None:
        asr_bundle.eval_batch(metrics, ids, words, recon, clean, lens, stage)
    else:
        metrics.utility_similarity.append(cosine_similarity(recon.cpu().numpy(),
                                                            clean.cpu().numpy()))
    return loss
