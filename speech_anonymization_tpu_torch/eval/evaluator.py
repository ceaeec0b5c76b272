"""Feature-level inference classifier: the frozen x-vector privacy evaluator.

Counterpart of ``speech_anonymization_tpu/eval/evaluator.py``
``FeatureClassifier`` (normalize -> Xvector -> classifier over fbank
features), built from modules, from converted flax variables, or from a
gender-recipe checkpoint directory in the JAX package's format
(:meth:`FeatureClassifier.from_checkpoint`). ``log_probs`` is
the differentiable path (the JAX recipe's ``_external_log_probs``),
``classify_feats`` the scoring one.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..models.xvector import Xvector, XvectorClassifier
from ..ops.normalization import InputNormalizer, NormalizerState
from ..train.checkpoint import recover_trees
from ..utils.convert import indexed_state_dict, load_numpy_state


class FeatureClassifier:
    """Frozen (normalize -> Xvector -> classifier) head over (B, T, D) fbanks."""

    def __init__(
        self,
        embedding_model: Xvector,
        classifier: XvectorClassifier,
        norm_state: NormalizerState,
        normalizer: InputNormalizer | None = None,
        renormalize: bool = False,
    ):
        """``renormalize=False`` (default): the inputs are taken to be already
        normalized, and the internal normalization is the identity. That is
        the reference's actual behavior (its evaluator Pretrainer never loads
        the normalizer stats, evaluator_inference.yaml:63-71). Set
        ``renormalize=True`` to apply ``norm_state`` to raw fbanks.
        """
        self.embedding_model = embedding_model.eval()
        self.classifier = classifier.eval()
        self.norm_state = norm_state
        self.normalizer = normalizer or InputNormalizer(dim=80)
        self.renormalize = renormalize

    @classmethod
    def from_flax(
        cls,
        embedding_variables: Mapping,
        classifier_variables: Mapping,
        norm_state: NormalizerState,
        n_mels: int = 80,
        emb_dim: int = 128,
        n_classes: int = 2,
        device: str | torch.device = "cuda",
        renormalize: bool = False,
    ) -> "FeatureClassifier":
        """Build from flax variable trees (numpy leaves) of Xvector and XvectorClassifier."""
        emb = Xvector(in_channels=n_mels, lin_neurons=emb_dim, device=device)
        clf = XvectorClassifier(lin_neurons=emb_dim, out_neurons=n_classes, device=device)
        load_numpy_state(emb, indexed_state_dict(embedding_variables))
        load_numpy_state(clf, indexed_state_dict(classifier_variables))
        return cls(emb, clf, norm_state, InputNormalizer(dim=n_mels), renormalize)

    @classmethod
    def from_checkpoint(
        cls,
        save_dir: str,
        emb_dim: int = 128,
        n_mels: int = 80,
        n_classes: int = 2,
        min_key: str | None = "error",
        device: str | torch.device = "cuda",
    ) -> "FeatureClassifier":
        """Load the frozen evaluator from a gender-recipe checkpoint directory
        (``<save_folder>/ckpts``), the checkpoint with the least ``min_key``:
        its ``embedding_model``, ``classifier``, ``model_state`` (both models'
        BatchNorm statistics) and ``normalizer``. The normalizer is kept but,
        as in the JAX package, not applied (``renormalize=False``)."""
        trees = recover_trees(save_dir, ("embedding_model", "classifier", "model_state", "normalizer"),
                              min_key=min_key)
        state = trees["model_state"]
        norm = NormalizerState(*(torch.from_numpy(np.array(trees["normalizer"][k], np.float32)).to(device)
                                 for k in NormalizerState._fields))
        return cls.from_flax({"params": trees["embedding_model"], **state["embedding_model"]},
                             {"params": trees["classifier"], **state["classifier"]}, norm, n_mels,
                             emb_dim, n_classes, device)

    def log_probs(self, feats: torch.Tensor, lens: torch.Tensor | None = None) -> torch.Tensor:
        """(B, T, D) fbanks -> (B, C) log-probs, differentiable in ``feats``
        (the endtoend anonymizer's sex signal; the evaluator stays frozen)."""
        if self.renormalize:
            feats, _ = self.normalizer(self.norm_state, feats, lens, training=False)
        return self.classifier(self.embedding_model(feats, lens))

    @torch.no_grad()
    def classify_feats(self, feats: torch.Tensor, lens: torch.Tensor | None = None):
        """(B, T, D) fbanks -> (log_probs (B, C), score (B,), index (B,))."""
        log_probs = self.log_probs(feats, lens)
        score, index = torch.max(log_probs, dim=-1)
        return log_probs, score, index

    __call__ = classify_feats
