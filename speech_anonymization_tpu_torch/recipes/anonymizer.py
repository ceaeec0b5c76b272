"""The adversarial anonymizer: training step, epoch loop, inference and scoring.

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
    the global norm and takes Noam's lr. Its ``eval_batch`` evaluates through
    the same loss terms and total (fcae pads T to 1, the others to 36;
    endtoend subtracts the sex and confusion terms of the external classifier);
  * :class:`SexAnonymizationBrain`: the trainer under ``Brain.fit`` /
    ``evaluate`` with the JAX recipe's hooks: per stage the internal ACC,
    ACC_external (the frozen x-vector on the reconstruction), ACC_external_orig
    (on the clean features) and Utility_Retention; at the test stage WER and
    WER_orig (with an ASR bundle) and MI_bits (``measure_mi``); the valid
    stage's ``train_log.txt`` line and checkpoint (top 5 by
    Utility_Retention, ACC_external and ACC_dist, in the JAX package's
    format); before the test stage the checkpoint average (``avg_utility``)
    or the ``valid_frontier`` pick;
  * :func:`features`: fbank -> global normalizer -> pad T to a multiple of 36;
  * :func:`eval_step`: the ConvAutoencoder's full forward, the loss terms and
    the weighted total (the GRL sign convention: every term is added; no
    ASR, so utility is 0);
  * :func:`anonymize`: fbank -> normalizer -> ``ConvAutoencoder.anonymize``,
    the composition ``bench.py`` times;
  * :func:`evaluate_batch`: ``eval_step`` plus :func:`score_batch`, the scores:
    internal sex ACC, the frozen x-vector's ACC on clean and reconstructed
    features, and utility: with an ASR bundle (``recipes/asr_bundle.py``), the
    similarity of the ASR encoder outputs and, at the test stage, the WER of
    the beam decodes of both; without one, the recon-vs-clean feature cosine
    similarity as a proxy;
  * :func:`main`, the recipe's entry point, with :func:`dataio_prepare` and
    :func:`make_loaders`: a corpus on disk and a YAML config in, a trained
    and scored anonymizer out::

        python -m speech_anonymization_tpu_torch.recipes.anonymizer configs/convae.yaml
            --data_folder <LibriSpeech> --model_type convae [--eval_only] [--device cuda|cpu]

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
import os
import sys
import warnings
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..config import load_config, parse_arguments
from ..data import DynamicItemDataset, SaveableDataLoader, prepare_librispeech, read_audio
from ..data.prefetch import PrefetchLoader
from ..data.tokenizer import UnigramTokenizer
from ..eval.evaluator import FeatureClassifier
from ..eval.metrics import AccuracyStats, SimilarityMetricsStats
from ..losses.basic import confusion_loss, mse_loss, nll_loss
from ..losses.mi import GroupSamplingMI
from ..models.autoencoders import ConvAutoencoder, FullyConnectedAutoencoder
from ..models.cyclegan import CycleGANGenerator
from ..models.endtoend import ConvReconstruction
from ..ops.fbank import Fbank
from ..ops.normalization import InputNormalizer, NormalizerState
from ..ops.specaugment import SpecAugmentDraws
from ..parallel.mesh import (Mesh, all_gather_concat, data_parallel_grads, initialize_distributed,
                             is_main_process, local_rows, psum, run_on_main, use_mesh)
from ..train.brain import Brain, Stage
from ..train.checkpoint import Checkpointer, PytreeRecoverable, average_checkpoints
from ..train.epoch_loop import EpochCounter
from ..train.experiment import create_experiment_directory
from ..train.logger import FileTrainLogger
from ..train.schedulers import NoamScheduler
from ..train.state import TrainState, adam_like_reference, kept_step
from ..utils.convert import (anonymizer_batch_stats, anonymizer_state_dict, anonymizer_variables,
                             normalizer_state, normalizer_tree)
from ..utils.profiler import span
from .asr_bundle import ASRBundle, load_asr_bundle

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


def score_batch(metrics: EvalMetrics, sex_lp: torch.Tensor, recon: torch.Tensor,
                clean: torch.Tensor, labels: torch.Tensor, lens: torch.Tensor,
                external_classifier: FeatureClassifier | None = None,
                asr_bundle: ASRBundle | None = None, ids: Sequence[str] = (),
                words: Sequence[str] = (), stage: str = "test", mesh: Mesh | None = None) -> None:
    """An evaluated batch into ``metrics``: the internal sex ACC, the x-vector's
    ACC on clean and reconstructed features, and utility (the ASR bundle's, or
    without one the feature cosine similarity). Under a ``mesh`` the batch is
    this rank's shard: the rank scores its own rows, and the per-row results
    and labels are gathered over the ranks before they enter ``metrics``."""
    rows = lambda x: all_gather_concat(x.cpu().numpy(), mesh)  # noqa: E731
    labels_np = rows(labels)
    metrics.sex_acc.append(rows(sex_lp), labels_np)
    if external_classifier is not None:
        with span("eval.xvector"):
            lp_orig, _, _ = external_classifier.classify_feats(clean)
            metrics.sex_acc_extern_orig.append(rows(lp_orig), labels_np)
            lp_recon, _, _ = external_classifier.classify_feats(recon)
            metrics.sex_acc_extern.append(rows(lp_recon), labels_np)
    if asr_bundle is not None:
        asr_bundle.eval_batch(metrics, ids, words, recon, clean, lens, stage, mesh)
    else:
        metrics.utility_similarity.append(all_gather_concat(
            cosine_similarity(recon.cpu().numpy(), clean.cpu().numpy()), mesh))


def evaluate_batch(model: ConvAutoencoder, fbank: Fbank, normalizer: InputNormalizer,
                   norm_state: NormalizerState, wavs: torch.Tensor, lens: torch.Tensor,
                   labels: torch.Tensor, metrics: EvalMetrics,
                   external_classifier: FeatureClassifier | None = None,
                   weights: Sequence[float] = DEFAULT_WEIGHTS, epoch: int = 0,
                   asr_bundle: ASRBundle | None = None, ids: Sequence[str] = (),
                   words: Sequence[str] = (), stage: str = "test") -> torch.Tensor:
    """One evaluation batch: :func:`eval_step`, then :func:`score_batch`.

    With ``asr_bundle`` (whose ``start_test`` has run on ``metrics`` for the
    test stage), utility is the bundle's: encoder similarity, and at
    ``stage == "test"`` the WER of both decodes against ``words`` (one
    reference string per utterance, keyed by ``ids``).
    """
    with span("eval.batch"):
        with span("eval.anonymize"):
            loss, sex_lp, recon, clean = eval_step(model, fbank, normalizer, norm_state, wavs, lens,
                                                   labels, weights, epoch)
        score_batch(metrics, sex_lp, recon, clean, labels, lens, external_classifier, asr_bundle,
                    ids, words, stage)
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
    ``device``, from flax's initialisers drawn from ``seed`` (as a fresh JAX
    run starts from flax's; ``models/init.py``); a checkpoint's or converted
    weights may be loaded into ``self.model`` before training. The frozen
    ASR (utility) and external classifier (endtoend's sex signal) are
    attached as they are and take no gradient.

    ``mesh``: data parallelism over its ``data`` axis, as the JAX brain's
    ``mesh=`` (``parallel/mesh.py``). Each rank is given its shard of the
    global batch, and every value JAX computes over the global batch is
    computed over it here: the fbank's floor, the normalizer's update and the
    head's BatchNorm statistics by collectives (the mesh set on them once,
    here); each loss term as this rank's share of the global mean, the
    gradients summed over the ranks in one all-reduce before they are
    accumulated, and the loss terms summed for the finite guard and the
    logs; the SpecAugment draws made for the global batch from the one
    seeded generator, each rank taking its rows. Every rank takes the
    identical update.
    """

    def __init__(self, hparams: dict, external_classifier: FeatureClassifier | None = None,
                 asr_bundle: ASRBundle | None = None, device: str | torch.device = "cuda",
                 mesh: Mesh | None = None):
        self.hparams = hparams
        self.device = torch.device(device)
        self.mesh = mesh
        self.dp = mesh.size("data") if mesh is not None else 1
        self.model_type = hparams.get("model_type", "convae")
        self.fbank = hparams.get("compute_features") or Fbank(device=device)
        self.normalizer = hparams.get("normalize") or InputNormalizer(dim=80)
        kw = {"grl_scale": float(hparams["grl_scale"])} if (
            "grl_scale" in hparams and self.model_type != "endtoend") else {}
        # a fresh model: flax's initialisers, drawn from the run's seed
        init_gen = torch.Generator().manual_seed(int(hparams.get("seed", 0)))
        self.model = MODEL_TYPES[self.model_type](**kw, generator=init_gen, device=device)
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
        use_mesh(mesh, self.fbank, self.normalizer, self.model)

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
        before the augmentation. ``draws`` are the global batch's."""
        clean, new_norm = features(self.fbank, self.normalizer, self.state.norm_state, wavs, lens,
                                   epoch, train, self.pad_multiple)
        feats = clean
        if train and self.augmentation is not None:
            if draws is None:
                draws = self.augmentation.draw((clean.shape[0] * self.dp, *clean.shape[1:]), self.generator)
            feats = self.augmentation(clean, local_rows(draws, self.mesh))
        return clean, feats, new_norm

    def _loss_terms(self, batch, epoch: int, train: bool, draws: SpecAugmentDraws | None = None):
        """-> (recon_loss, sex_loss, utility, confusion, sex log-probs, recon,
        clean features, new normalizer state). The four terms are this rank's
        shares of the global batch's: each mean over rows divided by the ranks
        (equal shards; one rank: the mean itself); the cosine utility, a sum
        over rows divided by T, is its share as it is."""
        wavs, lens, labels = batch[:3]
        clean, aug, new_norm = self._features(wavs, lens, epoch, train, draws)
        recon, sex_lp = self._apply_model(aug)
        b = clean.shape[0]
        recon_loss = mse_loss(recon.reshape(b, -1), clean.reshape(b, -1)) / self.dp
        if self.asr_bundle is not None and train:
            utility = self.asr_bundle.utility_loss(clean, recon, lens, batch[3])
            if self.asr_bundle.utility_kind != "cosine":
                utility = utility / self.dp
        else:
            utility = torch.zeros((), device=clean.device)
        sex_loss, confusion = nll_loss(sex_lp, labels) / self.dp, confusion_loss(sex_lp) / self.dp
        return recon_loss, sex_loss, utility, confusion, sex_lp, recon, clean, new_norm

    def _total(self, recon_loss, sex_loss, utility, confusion, weights: Sequence[float]):
        if self.model_type == "endtoend":
            # no GRL: the external classifier's terms are subtracted
            w_recon, w_sex, w_util, w_conf = weights
            return w_recon * recon_loss - w_sex * sex_loss + w_util * utility - w_conf * confusion
        return total_loss(recon_loss, sex_loss, utility, confusion, weights)

    @torch.no_grad()
    def eval_batch(self, batch, epoch: int, weights: Sequence[float]):
        """One evaluation batch ``(wavs, lens, labels)`` through the train
        step's own loss terms (frozen normalizer, eval mode, no utility term)
        and total: -> (loss, sex log-probs, recon, clean)."""
        self.model.eval()
        recon_loss, sex_loss, utility, confusion, sex_lp, recon, clean, _ = self._loss_terms(
            tuple(x.to(self.device) for x in batch[:3]), epoch, False)
        loss = psum(self._total(recon_loss, sex_loss, utility, confusion, weights), self.mesh)
        return loss, sex_lp, recon, clean

    # -- update ----------------------------------------------------------------------

    def update(self, batch, lr: float, epoch: int, weights: Sequence[float], train_mode: str,
               draws: SpecAugmentDraws | None = None) -> dict:
        """One micro-batch: gradients into the accumulation buffer; at the
        count, the ``train_mode`` update (``generator``, ``sex_classifier`` or
        ``all``) at ``lr``. -> the loss terms, ``loss`` and ``stepped``."""
        with span("train.micro_batch"):
            batch = tuple(x.to(self.device) for x in batch)
            self.model.train()
            with span("train.forward"):
                recon_loss, sex_loss, utility, confusion, _, _, _, new_norm = self._loss_terms(
                    batch, epoch, True, draws)
                loss = self._total(recon_loss, sex_loss, utility, confusion, weights)
            with span("train.backward"):
                grads, terms = data_parallel_grads(loss, (recon_loss, sex_loss, utility, confusion, loss),
                                                   self.params, self.mesh)
            self.state.norm_state = new_norm
            with span("train.accumulate"):
                stepped = self.state.accumulate(grads, self.grad_accum)
            if stepped:
                with span("train.optimizer"):
                    self._apply(terms[4], lr, train_mode)
        metrics = dict(zip(("recon_loss", "sex_loss", "utility_loss", "confusion_loss", "loss"), terms))
        return {**metrics, "stepped": stepped}

    @torch.no_grad()
    def _apply(self, loss: torch.Tensor, lr: float, train_mode: str) -> None:
        opt_key, opt = ("clf", self.clf_opt) if train_mode == "sex_classifier" else ("gen", self.gen_opt)
        mask = self.masks[train_mode]
        g = {k: a * mask[k] for k, a in self.state.accum_grads.items()}
        self.state.opt_state[opt_key] = kept_step(self.params, g, opt, self.state.opt_state[opt_key], lr, loss,
                                                  self.clip)
        self.state.reset_accumulation()

    # -- schedule ----------------------------------------------------------------------

    def _phase(self, epoch: int) -> dict:
        if self.schedule_unit == "step":
            steps = int(self.hparams.get("adversarial_schedule_steps", 200))
            return self.schedule[(self.step // steps) % len(self.schedule)]
        return self.schedule[epoch % len(self.schedule)]

    def fit_batch(self, batch, epoch: int, draws: SpecAugmentDraws | None = None) -> torch.Tensor:
        """One training micro-batch, ``(wavs, lens, labels[, tokens_bos])``;
        -> its loss (a device scalar). Counts ``step``, then :meth:`train_batch`."""
        self.step += 1
        return self.train_batch(batch, epoch, draws)

    def train_batch(self, batch, epoch: int, draws: SpecAugmentDraws | None = None) -> torch.Tensor:
        """:meth:`fit_batch` at the current ``step``, which the caller has
        counted (``Brain.fit`` does). Noam advances only on a micro-batch that
        steps; the accumulation count is the host's, so nothing is read back."""
        phase = self._phase(epoch)
        w = phase["weights"]
        weights = [float(np.float32(w.get(k, 0.0))) for k in ("recon", "sex", "utility", "confusion")]
        will_step = self.state.accum_count + 1 >= self.grad_accum
        lr = self.noam() if will_step else self.noam.current_lr
        self.metrics = self.update(batch, lr, epoch, weights, phase.get("train", "all"), draws)
        return self.metrics["loss"]


def _flat(tree: dict, prefix: str = "") -> dict:
    """A nested map -> {"a/b/c": leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@torch.no_grad()
def copy_into(targets: dict, state: dict) -> None:
    """Copy ``state``'s numpy leaves into the tensors ``targets`` (same keys,
    or KeyError), across devices."""
    if set(targets) != set(state):
        raise KeyError(f"checkpoint and model disagree on {sorted(set(targets) ^ set(state))[:8]}")
    for k, v in state.items():
        targets[k].copy_(torch.from_numpy(np.ascontiguousarray(v)))


def set_model_params(model: torch.nn.Module, params: dict) -> None:
    """An anonymizer's flax ``params`` tree (a checkpoint's ``model``) into ``model``."""
    copy_into(dict(model.named_parameters()), anonymizer_state_dict({"params": params}))


def model_state_tree(model: torch.nn.Module) -> dict:
    """An anonymizer's BatchNorm statistics as the JAX recipe's ``model_state`` tree."""
    stats = anonymizer_batch_stats(model)
    return {"batch_stats": stats} if stats else {}


def set_model_state(model: torch.nn.Module, model_state: dict) -> None:
    copy_into(_flat(anonymizer_batch_stats(model)), _flat(model_state.get("batch_stats", {})))


def frontier_pick(ckpts: list, min_utility: float):
    """The ``valid_frontier`` checkpoint: among ``ckpts`` whose meta has
    ACC_external and Utility_Retention, those with Utility_Retention >=
    ``min_utility`` (else the most useful one), the one whose ACC_external is
    nearest chance (ties: the higher utility). -> (pick, pool size, scored
    count); pick None when no checkpoint is scored."""
    scored = [c for c in ckpts if "ACC_external" in c.meta and "Utility_Retention" in c.meta]
    if not scored:
        return None, 0, 0
    ok = [c for c in scored if c.meta["Utility_Retention"] >= min_utility]
    pool = ok or [max(scored, key=lambda c: c.meta["Utility_Retention"])]
    pick = min(pool, key=lambda c: (abs(c.meta["ACC_external"] - 0.5), -c.meta["Utility_Retention"]))
    return pick, len(pool), len(scored)


class SexAnonymizationBrain(Brain):
    """The anonymizer recipe's epoch loop: :class:`AnonymizerTrainer`'s step
    under ``Brain.fit`` / ``evaluate``, with the JAX recipe's hooks.

    ``hparams`` holds :class:`AnonymizerTrainer`'s keys and ``train_logger`` (a
    ``FileTrainLogger``), ``epoch_counter`` (an ``EpochCounter``), the
    evaluation weights (the top-level ``*_loss_weight`` keys), ``measure_mi``
    and ``mi_iterations``, ``wer_file``, ``eval_ckpt_select`` (``avg_utility``
    or ``valid_frontier``) and ``eval_ckpt_min_utility``. A batch is the JAX
    recipe's ``PaddedBatch`` duck type: ``.sig = (wavs, lens)``, ``.gender``,
    ``.id``, ``.wrd`` and, for the utility term, ``.tokens_bos = (tokens, lens)``.
    Call :meth:`init_state` before a checkpointer saves or recovers.

    ``mesh``: the trainer's data parallelism (each batch this rank's shard);
    each rank scores its own rows of an evaluation batch (the decodes, the
    classifiers) and the per-row results are gathered over the ranks before
    they enter the stage's statistics (``score_batch``), so every rank's
    valid and test statistics are the global batch's. The valid stage's log line and
    checkpoint come from rank 0 alone, as in the JAX recipe.
    """

    def __init__(self, hparams: dict, checkpointer: Checkpointer | None = None,
                 external_classifier: FeatureClassifier | None = None,
                 asr_bundle: ASRBundle | None = None, device: str | torch.device = "cuda",
                 mesh: Mesh | None = None):
        self.trainer = AnonymizerTrainer(hparams, external_classifier, asr_bundle, device, mesh)
        self.mesh = mesh
        super().__init__(hparams, checkpointer, hparams.get("ckpt_interval_minutes"))
        self.device = self.trainer.device
        self.model = self.trainer.model
        self.noam = self.trainer.noam
        self.external_classifier = external_classifier
        self.asr_bundle = asr_bundle
        self.train_logger: FileTrainLogger = hparams["train_logger"]
        self.epoch_counter: EpochCounter = hparams["epoch_counter"]
        self.metrics = EvalMetrics()
        self._mi_feats: list = []
        self._mi_labels: list = []

    @property
    def step(self) -> int:
        """The trainer's micro-batch count, which its schedule reads."""
        return self.trainer.step

    @step.setter
    def step(self, value: int) -> None:
        self.trainer.step = value

    # -- state ---------------------------------------------------------------------

    def init_state(self) -> None:
        """Register the recoverables under the JAX recipe's names, in its
        trees: ``model`` (the params), ``model_state`` (``{"batch_stats": ...}``,
        empty for endtoend), ``normalizer``, ``counter``, ``noam_scheduler``.
        No optimizer state is saved: a resumed run starts Adam afresh."""
        if self.checkpointer is None:
            return
        self.checkpointer.add_recoverable("model", PytreeRecoverable(self._params_tree,
                                                                      self._set_params))
        self.checkpointer.add_recoverable("model_state", PytreeRecoverable(self._model_state,
                                                                            self._set_model_state))
        self.checkpointer.add_recoverable("normalizer", PytreeRecoverable(
            lambda: normalizer_tree(self.trainer.state.norm_state), self._set_normalizer))
        self.checkpointer.add_recoverable("counter", self.epoch_counter)
        self.checkpointer.add_recoverable("noam_scheduler", self.noam)

    def _params_tree(self) -> dict:
        """The parameters as the JAX recipe's ``model`` tree."""
        return anonymizer_variables(self.model)["params"]

    def _set_params(self, params: dict) -> None:
        set_model_params(self.model, params)

    def _model_state(self) -> dict:
        """The BatchNorm statistics as the JAX recipe's ``model_state`` tree."""
        return model_state_tree(self.model)

    def _set_model_state(self, model_state: dict) -> None:
        set_model_state(self.model, model_state)

    def _set_normalizer(self, tree: dict) -> None:
        self.trainer.state.norm_state = normalizer_state(tree, self.device)

    # -- batches -------------------------------------------------------------------

    def _device_batch(self, batch) -> tuple:
        wavs, lens = batch.sig
        out = (torch.as_tensor(wavs, dtype=torch.float32, device=self.device),
               torch.as_tensor(lens, dtype=torch.float32, device=self.device),
               torch.as_tensor(np.asarray(batch.gender), dtype=torch.int64, device=self.device))
        if self.asr_bundle is not None and hasattr(batch, "tokens_bos"):
            out += (torch.as_tensor(batch.tokens_bos[0], dtype=torch.int64, device=self.device),)
        return out

    def fit_batch(self, batch, epoch: int) -> torch.Tensor:
        return self.trainer.train_batch(self._device_batch(batch), epoch)

    def evaluate_batch(self, batch, stage: Stage) -> torch.Tensor:
        db = self._device_batch(batch)
        weights = [float(np.float32(self.hparams.get(k, d))) for k, d in (
            ("recon_loss_weight", 1.0), ("sex_loss_weight", 0.0), ("utility_loss_weight", 0.0),
            ("confusion_loss_weight", 0.0))]
        loss, sex_lp, recon, clean = self.trainer.eval_batch(db, self.epoch_counter.current, weights)
        if stage == Stage.TEST and self.hparams.get("measure_mi"):
            # the time-mean of the reconstruction, pooled for the test-set MI
            self._mi_feats.append(all_gather_concat(recon.cpu().numpy().mean(axis=1), self.mesh))
            self._mi_labels.append(all_gather_concat(db[2].cpu().numpy(), self.mesh))
        score_batch(self.metrics, sex_lp, recon, clean, db[2], db[1], self.external_classifier,
                    self.asr_bundle, getattr(batch, "id", ()), getattr(batch, "wrd", ()),
                    "test" if stage == Stage.TEST else "valid", self.mesh)
        return loss

    # -- hooks ---------------------------------------------------------------------

    def on_stage_start(self, stage: Stage, epoch: int | None = None) -> None:
        if stage != Stage.TRAIN:
            self.metrics = EvalMetrics()
            self._mi_feats, self._mi_labels = [], []
            if stage == Stage.TEST and self.asr_bundle is not None:
                self.asr_bundle.start_test(self.metrics)

    def on_stage_end(self, stage: Stage, stage_loss: float, epoch: int | None = None) -> None:
        if stage == Stage.TRAIN:
            return
        m = self.metrics
        stats = {
            "loss": stage_loss,
            "ACC": m.sex_acc.summarize(),
            "ACC_external": m.sex_acc_extern.summarize(),
            "ACC_external_orig": m.sex_acc_extern_orig.summarize(),
            "Utility_Retention": m.utility_similarity.summarize(),
        }
        if stage == Stage.VALID:
            if not is_main_process():
                return
            self.train_logger.log_stats(
                {"epoch": epoch, "lr": self.noam.current_lr, "steps": self.noam.n_steps,
                 "optimizer": "Adam"},
                train_stats=self.train_stats, valid_stats=stats)
            if self.checkpointer is not None:
                self.checkpointer.save_and_keep_only(
                    {"ACC_external": stats["ACC_external"],
                     # closest to chance: min-ACC retention alone can prune the
                     # epochs nearest 0.5 that valid_frontier selection wants
                     "ACC_dist": abs(stats["ACC_external"] - 0.5),
                     "Utility_Retention": stats["Utility_Retention"], "epoch": epoch},
                    max_keys=["Utility_Retention"], min_keys=["ACC_external", "ACC_dist"],
                    num_to_keep=5)
        else:
            if self.asr_bundle is not None:
                stats["WER"] = self.asr_bundle.finish_test(m, self.hparams.get("wer_file"))
                if getattr(m, "wer_metric2", None) and m.wer_metric2.utts:
                    stats["WER_orig"] = m.wer_metric2.summarize("error_rate")
            if self.hparams.get("measure_mi") and self._mi_feats:
                x = np.concatenate(self._mi_feats)
                y = np.concatenate(self._mi_labels)
                n_per = min(int(np.sum(y == 0)), int(np.sum(y == 1)))
                gs = GroupSamplingMI(n_samples=n_per, n_classes=2,
                                     n_iterations=int(self.hparams.get("mi_iterations", 20)))
                _, mi_mean, _ = gs(torch.from_numpy(x).to(self.device), y, y, seed=0)
                stats["MI_bits"] = float(mi_mean)
            self.train_logger.log_stats({"Epoch loaded": self.epoch_counter.current}, test_stats=stats)
            self.test_stats = stats

    def on_evaluate_start(self, max_key: str | None = None, min_key: str | None = None) -> None:
        """Checkpoint selection before the test stage. ``avg_utility`` (the
        default): the parameters averaged over the checkpoints ranked by the
        key. ``valid_frontier``: the one checkpoint, among those with
        Utility_Retention >= ``eval_ckpt_min_utility`` (0.85; else the most
        useful), whose valid ACC_external is nearest chance (ties: the higher
        utility); its parameters only, not its BatchNorm statistics, as the
        JAX recipe restores them."""
        if self.checkpointer is None:
            return
        template = self._params_tree()
        if str(self.hparams.get("eval_ckpt_select", "avg_utility")) == "valid_frontier":
            pick, pool_n, kept_n = frontier_pick(self.checkpointer.find_checkpoints(),
                                                 float(self.hparams.get("eval_ckpt_min_utility", 0.85)))
            if pick is not None:
                self.selected_ckpt_meta = {**pick.meta, "pool_n": pool_n, "kept_n": kept_n}
                print(f"[eval_ckpt_select=valid_frontier] epoch {pick.meta.get('epoch')}: valid "
                      f"ACC_external={pick.meta['ACC_external']:.3f} "
                      f"Utility={pick.meta['Utility_Retention']:.3f}")
                self._set_params(average_checkpoints([pick], "model", template))
                return
        ckpts = self.checkpointer.find_checkpoints(max_key=max_key, min_key=min_key)
        if ckpts:
            self._set_params(average_checkpoints(ckpts, "model", template))


def dataio_prepare(hparams: dict, tokenizer: UnigramTokenizer | None = None):
    """The train, valid and test datasets with the recipe's pipelines: ``sig``
    (the waveform), ``gender`` (M 0, F 1) and ``wrd``, and with a tokenizer
    ``tokens_bos``/``tokens_eos``/``tokens``. Train is ordered by ``sorting``;
    valid and test by duration. -> (train, valid, {test name: dataset})."""
    data_folder = hparams["data_folder"]
    train_data = DynamicItemDataset.from_csv(hparams["train_csv"], {"data_root": data_folder})
    sorting = hparams.get("sorting", "random")
    if sorting == "ascending":
        train_data = train_data.filtered_sorted(sort_key="duration")
    elif sorting == "descending":
        train_data = train_data.filtered_sorted(sort_key="duration", reverse=True)
    valid_data = DynamicItemDataset.from_csv(hparams["valid_csv"], {"data_root": data_folder})
    valid_data = valid_data.filtered_sorted(sort_key="duration")
    test_csvs = hparams["test_csv"]
    if isinstance(test_csvs, str):
        test_csvs = [test_csvs]
    test_datasets = {}
    for csv_file in test_csvs:
        name = os.path.splitext(os.path.basename(csv_file))[0]
        ds = DynamicItemDataset.from_csv(csv_file, {"data_root": data_folder})
        test_datasets[name] = ds.filtered_sorted(sort_key="duration")

    sex_to_int = {"M": 0, "F": 1}
    for ds in [train_data, valid_data] + list(test_datasets.values()):
        ds.add_dynamic_item(lambda wav: read_audio(wav), takes=["wav"], provides=["sig"])
        ds.add_dynamic_item(lambda sex: np.int64(sex_to_int[sex]), takes=["sex"], provides=["gender"])
        keys = ["id", "sig", "gender", "wrd"]
        if tokenizer is not None:
            bos = int(hparams.get("bos_index", 1))
            eos = int(hparams.get("eos_index", 2))

            def tokens_pipeline(wrd):
                ids = tokenizer.encode_as_ids(wrd)
                return (np.asarray([bos] + ids, np.int64), np.asarray(ids + [eos], np.int64),
                        np.asarray(ids, np.int64))

            ds.add_dynamic_item(tokens_pipeline, takes=["wrd"], provides=["tokens_bos", "tokens_eos", "tokens"])
            keys += ["tokens_bos", "tokens_eos", "tokens"]
        ds.set_output_keys(keys)
    return train_data, valid_data, test_datasets


def make_loaders(hparams: dict, train_data, valid_data, test_datasets):
    """-> (train loader, valid loader, {test name: loader}). Waveforms are padded
    to buckets of (36k - 1) * 160 samples, so a batch's fbank has a multiple of
    36 frames; the train loader shuffles (``sorting: random``, from ``seed`` and
    the epoch) and drops a last part batch; ``prefetch_batches`` > 0 wraps each
    loader in a :class:`PrefetchLoader` of ``loader_threads`` threads."""
    batch_size = int(hparams.get("batch_size", 3))
    durations = [float(d) for d in train_data.raw_values("duration")] or [1.0]
    sr = int(hparams.get("sample_rate", 16000))
    max_len = int(max(durations) * sr) + sr // 10
    buckets = []
    k = 1
    while True:
        b = (36 * k - 1) * 160
        buckets.append(b)
        if b >= max_len:
            break
        k += 1
    bucket_map = {"sig": buckets}
    seed = int(hparams.get("seed", 0))
    prefetch = int(hparams.get("prefetch_batches", 0) or 0)

    def mk(ds, shuffle):
        loader = SaveableDataLoader(ds, batch_size=batch_size, shuffle=shuffle, seed=seed,
                                    bucket_map=bucket_map, drop_last=shuffle)
        if prefetch:
            loader = PrefetchLoader(loader, prefetch, int(hparams.get("loader_threads", 4)))
        return loader

    loaders = {name: mk(ds, False) for name, ds in test_datasets.items()}
    return mk(train_data, hparams.get("sorting", "random") == "random"), mk(valid_data, False), loaders


def set_tf32(enabled: bool) -> None:
    """TF32 for CUDA matmuls and cuDNN convolutions, on or off."""
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled


def resolve_device(name: str, device: str | None) -> str:
    """A recipe's ``--device`` (default ``cuda``); on the card TF32 goes off.
    Stops (``SystemExit``) when no card is there for ``cuda``: a recipe never
    falls back to the CPU."""
    device = str(device or "cuda")
    if device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise SystemExit(f"{name}: no CUDA device; pass --device cpu to run on the CPU")
        set_tf32(False)
    elif device != "cpu":
        raise SystemExit(f"{name}: unknown --device {device!r} (cuda or cpu)")
    return device


def launch(device: str) -> bool:
    """A recipe's multi-process launch, before anything touches the device:
    ``initialize_distributed`` from the ``SATPU_*`` environment (a no-op
    without it), over NCCL on the card and gloo on the CPU."""
    return initialize_distributed(backend="nccl" if device.startswith("cuda") else "gloo")


def prepare_data(hparams: dict) -> None:
    """The LibriSpeech CSVs of ``hparams``' splits, written by rank 0 while the
    other ranks wait (``run_on_main``)."""
    run_on_main(
        prepare_librispeech,
        data_folder=hparams["data_folder"],
        tr_splits=hparams.get("train_splits", []),
        dev_splits=hparams.get("dev_splits", []),
        te_splits=hparams.get("test_splits", []),
        save_folder=hparams["data_folder"],
        merge_lst=hparams.get("train_splits", []),
        merge_name=hparams.get("train_csv"),
        skip_prep=hparams.get("skip_prep", False),
    )


def main(argv: Sequence[str] | None = None) -> SexAnonymizationBrain:
    """The anonymizer recipe, end to end: ``<config.yaml> [--key value ...]
    [--eval_only] [--device cuda|cpu]``, the JAX recipe's command line.

    Runs on the card (``cuda``) unless ``--device cpu`` is given; with no CUDA
    device and no ``--device cpu`` it stops with an error (it never falls back
    to the CPU). On the card TF32 is turned off, for cuBLAS and cuDNN, before
    anything is built: a run trains and scores in fp32, as the JAX package's
    CPU reference and the port's parity tolerances do.

    Steps: the config (with the overrides, its objects built on the device);
    the experiment directory; the LibriSpeech CSVs; with
    ``asr_checkpoint_dir``, the tokenizer (``tokenizer_path``, or
    ``<asr_checkpoint_dir>/../tokenizer.json``), the frozen ASR bundle (with the
    LM of ``lm_checkpoint_dir``); the external x-vector classifier of
    ``external_classifier_dir``; the checkpointer (``async_checkpointing``);
    the brain (a fresh model from flax's initialisers at ``seed``); the newest
    checkpoint recovered; ``fit`` unless ``--eval_only``; then each test set
    evaluated on the checkpoints ranked by Utility_Retention, its WER written to
    ``wer_<name>.txt``. Returns the brain.

    Several processes (``SATPU_COORDINATOR``, ``SATPU_NUM_PROCESSES``,
    ``SATPU_PROCESS_ID``, or ``SATPU_MULTIHOST=1`` under ``torchrun``; see
    :func:`launch`): rank 0 prepares the CSVs while the others wait, and
    writes the valid stage's log lines and checkpoints. As in the JAX recipe,
    no mesh is given to the brain: each process trains on its own loader's
    batches, and only those side effects are gated.
    """
    config_path, run_opts, overrides = parse_arguments(list(argv) if argv is not None else sys.argv[1:])
    device = resolve_device("anonymizer recipe", run_opts.get("device"))
    launch(device)
    hparams = load_config(config_path, overrides, device=device)
    create_experiment_directory(hparams["output_folder"], config_path, overrides)
    prepare_data(hparams)
    tokenizer = None
    asr_dir = hparams.get("asr_checkpoint_dir")
    if asr_dir:
        tok_path = hparams.get("tokenizer_path") or os.path.join(os.path.dirname(asr_dir), "tokenizer.json")
        tokenizer = UnigramTokenizer().Load(tok_path)

    train_data, valid_data, test_datasets = dataio_prepare(hparams, tokenizer=tokenizer)
    train_loader, valid_loader, test_loaders = make_loaders(hparams, train_data, valid_data, test_datasets)

    asr_bundle = load_asr_bundle(hparams, tokenizer, device) if tokenizer is not None else None
    external = None
    ext_dir = hparams.get("external_classifier_dir")
    if ext_dir and os.path.isdir(ext_dir):
        external = FeatureClassifier.from_checkpoint(
            ext_dir, emb_dim=int(hparams.get("evaluator_emb_dim", 128)), device=device)

    checkpointer = Checkpointer(os.path.join(hparams["save_folder"], "ckpts"),
                                async_writes=bool(hparams.get("async_checkpointing", True)))
    brain = SexAnonymizationBrain(hparams, checkpointer, external_classifier=external,
                                  asr_bundle=asr_bundle, device=device)
    brain.init_state()
    checkpointer.recover_if_possible()

    if not run_opts.get("eval_only", False):
        brain.fit(hparams["epoch_counter"], train_loader, valid_loader)

    for name, loader in test_loaders.items():
        brain.hparams["wer_file"] = os.path.join(hparams["output_folder"], f"wer_{name}.txt")
        brain.evaluate(loader, max_key="Utility_Retention")
    checkpointer.wait()
    return brain


if __name__ == "__main__":
    main()
