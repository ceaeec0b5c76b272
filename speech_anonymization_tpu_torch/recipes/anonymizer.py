"""The adversarial anonymizer: training step, inference and scoring.

Counterpart of ``speech_anonymization_tpu/recipes/anonymizer.py``
(``SexAnonymizationBrain``):

  * :class:`AnonymizerTrainer`: the train half, for every ``model_type``
    (convae, fcae, endtoend, cyclegan): fbank -> normalizer (updating its
    statistics until ``update_until_epoch``) -> pad T -> SpecAugment on a
    copy -> the model in train mode (BatchNorm on batch statistics, the GRL in
    front of the sex head) -> the loss terms (recon MSE against the clean
    copy, sex NLL, confusion, and the frozen ASR's utility when an
    ``ASRBundle`` is attached) -> the weighted total -> gradients averaged
    over ``gradient_accumulation`` micro-batches -> at the count, one of three
    updates by the ``adversarial_schedule`` phase: the generator's Adam on the
    non-classifier parameters, the classifier's Adam on the sex head's, or
    (``all``) the generator's Adam on every parameter; each masks, clips by
    the global norm and takes Noam's lr;
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

The trainer mirrors the JAX recipe where its behaviour is easy to "fix":
  (a) a masked Adam updates EVERY parameter with the masked (zeroed)
      gradients, so its moments decay and its count advances everywhere, and
      after an ``all`` phase a ``generator`` phase still moves the sex head
      through the generator optimizer's moments;
  (b) the non-finite guard (loss or clipped-gradient norm) keeps the
      parameters but lets the optimizer state advance;
  (c) the BatchNorm running statistics and the normalizer state update on
      every micro-batch, stepping or not;
  (d) the clip's global norm is taken over the masked gradients;
  (e) Adam's eps is 1e-9, so its first update is +-lr wherever |g| >> eps.
"""

from __future__ import annotations

import math
import warnings
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..eval.evaluator import FeatureClassifier
from ..eval.metrics import AccuracyStats, SimilarityMetricsStats
from ..losses.basic import confusion_loss, mse_loss, nll_loss
from ..models.autoencoders import ConvAutoencoder, FullyConnectedAutoencoder
from ..models.cyclegan import CycleGANGenerator
from ..models.endtoend import ConvReconstruction
from ..ops.fbank import Fbank
from ..ops.normalization import InputNormalizer, NormalizerState
from ..ops.specaugment import SpecAugmentDraws
from ..train.schedulers import NoamScheduler
from ..train.state import TrainState, adam_like_reference, apply_updates, clip_by_global_norm, global_norm
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


MODEL_TYPES = {
    "convae": ConvAutoencoder,
    "fcae": FullyConnectedAutoencoder,
    "endtoend": ConvReconstruction,
    "cyclegan": CycleGANGenerator,
}

DEFAULT_SCHEDULE = [
    # the reference's HEAD schedule (speechbrain_convae_train.py:212-235)
    {"weights": {"recon": 0.0, "sex": 0.8, "utility": 0.2, "confusion": 0.0}, "train": "generator"},
    {"weights": {"recon": 0.0, "sex": 0.5, "utility": 0.0, "confusion": 0.0}, "train": "sex_classifier"},
]


def is_classifier_param(name: str) -> bool:
    """The sex head's parameters: ``sex_classifier`` or ``sex_head`` in the path."""
    return "sex_classifier" in name or "sex_head" in name


class AnonymizerTrainer:
    """The adversarial training step of ``SexAnonymizationBrain``.

    ``hparams`` holds the recipe's keys: ``model_type``, ``grl_scale``,
    ``adversarial_schedule`` (default: one ``all`` phase from the top-level
    ``*_loss_weight`` keys), ``adversarial_schedule_unit`` (``epoch`` or
    ``step``, with ``adversarial_schedule_steps``), ``gradient_accumulation``,
    ``gradient_clipping``, ``seed`` (the augmentation's generator), and the
    built objects ``compute_features`` (an ``Fbank``), ``normalize`` (an
    ``InputNormalizer``), ``augmentation`` (a ``SpecAugment`` or None) and
    ``noam_annealing`` (a ``NoamScheduler``). The model is built here, on
    ``device``; load weights into ``self.model`` before training. The frozen
    ASR (utility) and external classifier (endtoend's sex signal) are
    attached as they are and take no gradient.
    """

    def __init__(self, hparams: dict, external_classifier: FeatureClassifier | None = None,
                 asr_bundle: ASRBundle | None = None, device: str | torch.device = "cuda"):
        self.hparams = hparams
        self.device = torch.device(device)
        self.model_type = hparams.get("model_type", "convae")
        self.fbank = hparams.get("compute_features") or Fbank(device=device)
        self.normalizer = hparams.get("normalize") or InputNormalizer(dim=80)
        kw = {"grl_scale": float(hparams["grl_scale"])} if (
            "grl_scale" in hparams and self.model_type != "endtoend") else {}
        self.model = MODEL_TYPES[self.model_type](**kw, device=device)
        self.noam = hparams.get("noam_annealing") or NoamScheduler()
        self.schedule = hparams.get("adversarial_schedule") or [{
            "weights": {
                "recon": hparams.get("recon_loss_weight", 1.0),
                "sex": hparams.get("sex_loss_weight", 0.0),
                "utility": hparams.get("utility_loss_weight", 0.0),
                "confusion": hparams.get("confusion_loss_weight", 0.0),
            },
            "train": "all",
        }]
        self.schedule_unit = hparams.get("adversarial_schedule_unit", "epoch")
        self.grad_accum = int(hparams.get("gradient_accumulation", 1))
        self.clip = hparams.get("gradient_clipping", 5.0)
        if self.model_type == "endtoend" and external_classifier is None:
            # without the frozen evaluator the sex and confusion terms are
            # gradient-free constants: nothing adversarial is trained
            if not hparams.get("allow_endtoend_without_evaluator"):
                raise ValueError(
                    "model_type=endtoend requires a trained external classifier (or "
                    "allow_endtoend_without_evaluator: true, to run with a constant sex loss)")
            warnings.warn("model_type=endtoend without an external classifier: the sex loss is "
                          "a chance-level CONSTANT (no adversarial gradient)", stacklevel=2)
        self.external_classifier = external_classifier
        self.asr_bundle = asr_bundle
        for frozen in ((asr_bundle.model,) if asr_bundle is not None else ()) + (
                (external_classifier.embedding_model, external_classifier.classifier)
                if external_classifier is not None else ()):
            frozen.requires_grad_(False)
        self.augmentation = hparams.get("augmentation")
        self.generator = torch.Generator().manual_seed(int(hparams.get("seed", 0)))
        self.pad_multiple = 1 if self.model_type == "fcae" else 36
        self.params = dict(self.model.named_parameters())
        clf = {k: float(is_classifier_param(k)) for k in self.params}
        self.masks = {"generator": {k: 1.0 - m for k, m in clf.items()}, "sex_classifier": clf,
                      "all": {k: 1.0 for k in self.params}}
        self.gen_opt, self.clf_opt = adam_like_reference(), adam_like_reference()
        self.state = TrainState.create(
            self.params, {"gen": self.gen_opt.init(self.params), "clf": self.clf_opt.init(self.params)},
            self.normalizer.init_state(device))
        self.step = 0  # micro-batches this epoch, as Brain.fit counts them
        self.metrics: dict = {}  # the last micro-batch's loss terms (device scalars)

    # -- pure compute ------------------------------------------------------------

    def _apply_model(self, feats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if self.model_type == "endtoend":
            recon = self.model(feats)
            return recon, self._external_log_probs(recon)
        return self.model(feats)

    def _external_log_probs(self, feats: torch.Tensor) -> torch.Tensor:
        if self.external_classifier is None:
            return torch.full((feats.shape[0], 2), math.log(0.5), device=feats.device)
        return self.external_classifier.log_probs(feats)

    def _features(self, wavs, lens, epoch: int, train: bool,
                  draws: SpecAugmentDraws | None = None):
        """-> (clean, augmented, new normalizer state); ``clean`` is taken
        before the augmentation."""
        clean, new_norm = features(self.fbank, self.normalizer, self.state.norm_state, wavs, lens,
                                   epoch, train, self.pad_multiple)
        feats = clean
        if train and self.augmentation is not None:
            if draws is None:
                draws = self.augmentation.draw(clean.shape, self.generator)
            feats = self.augmentation(clean, draws)
        return clean, feats, new_norm

    def _loss_terms(self, batch, epoch: int, train: bool, draws: SpecAugmentDraws | None = None):
        """-> (recon_loss, sex_loss, utility, confusion, new normalizer state)."""
        wavs, lens, labels = batch[:3]
        clean, aug, new_norm = self._features(wavs, lens, epoch, train, draws)
        recon, sex_lp = self._apply_model(aug)
        b = clean.shape[0]
        recon_loss = mse_loss(recon.reshape(b, -1), clean.reshape(b, -1))
        if self.asr_bundle is not None and train:
            utility = self.asr_bundle.utility_loss(clean, recon, lens, batch[3])
        else:
            utility = torch.zeros((), device=clean.device)
        return recon_loss, nll_loss(sex_lp, labels), utility, confusion_loss(sex_lp), new_norm

    def _total(self, recon_loss, sex_loss, utility, confusion, weights: Sequence[float]):
        if self.model_type == "endtoend":
            # no GRL: the external classifier's terms are subtracted
            w_recon, w_sex, w_util, w_conf = weights
            return w_recon * recon_loss - w_sex * sex_loss + w_util * utility - w_conf * confusion
        return total_loss(recon_loss, sex_loss, utility, confusion, weights)

    # -- update ----------------------------------------------------------------------

    def update(self, batch, lr: float, epoch: int, weights: Sequence[float], train_mode: str,
               draws: SpecAugmentDraws | None = None) -> dict:
        """One micro-batch: gradients into the accumulation buffer; at the
        count, the ``train_mode`` update (``generator``, ``sex_classifier`` or
        ``all``) at ``lr``. -> the loss terms, ``loss`` and ``stepped``."""
        batch = tuple(x.to(self.device) for x in batch)
        self.model.train()
        recon_loss, sex_loss, utility, confusion, new_norm = self._loss_terms(batch, epoch, True, draws)
        loss = self._total(recon_loss, sex_loss, utility, confusion, weights)
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(self.params[k]) if g is None else g
                 for k, g in zip(names, grads)}
        self.state.norm_state = new_norm
        stepped = self.state.accumulate(grads, self.grad_accum)
        if stepped:
            self._apply(loss.detach(), lr, train_mode)
        return {"recon_loss": recon_loss.detach(), "sex_loss": sex_loss.detach(),
                "utility_loss": utility.detach(), "confusion_loss": confusion.detach(),
                "loss": loss.detach(), "stepped": stepped}

    @torch.no_grad()
    def _apply(self, loss: torch.Tensor, lr: float, train_mode: str) -> None:
        opt_key, opt = ("clf", self.clf_opt) if train_mode == "sex_classifier" else ("gen", self.gen_opt)
        mask = self.masks[train_mode]
        g = {k: a * mask[k] for k, a in self.state.accum_grads.items()}
        if self.clip is not None:
            g, gnorm = clip_by_global_norm(g, float(self.clip))
        else:
            gnorm = global_norm(g.values())
        finite = torch.isfinite(gnorm) & torch.isfinite(loss)
        updates, self.state.opt_state[opt_key] = opt.update(g, self.state.opt_state[opt_key], lr)
        apply_updates(self.params, updates, keep=finite)
        self.state.reset_accumulation()

    # -- schedule ----------------------------------------------------------------------

    def _phase(self, epoch: int) -> dict:
        if self.schedule_unit == "step":
            steps = int(self.hparams.get("adversarial_schedule_steps", 200))
            return self.schedule[(self.step // steps) % len(self.schedule)]
        return self.schedule[epoch % len(self.schedule)]

    def fit_batch(self, batch, epoch: int, draws: SpecAugmentDraws | None = None) -> torch.Tensor:
        """One training micro-batch, ``(wavs, lens, labels[, tokens_bos])``;
        -> its loss (a device scalar). Noam advances only on a micro-batch that
        steps; the accumulation count is the host's, so nothing is read back."""
        self.step += 1
        phase = self._phase(epoch)
        w = phase["weights"]
        weights = [float(np.float32(w.get(k, 0.0))) for k in ("recon", "sex", "utility", "confusion")]
        will_step = self.state.accum_count + 1 >= self.grad_accum
        lr = self.noam() if will_step else self.noam.current_lr
        self.metrics = self.update(batch, lr, epoch, weights, phase.get("train", "all"), draws)
        return self.metrics["loss"]
