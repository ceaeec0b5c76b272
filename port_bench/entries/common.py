"""Pieces the entries share: the program's models at a configuration's widths
with weights drawn from the seed, device synchronisation, and the gaps the
checks report."""

from __future__ import annotations

import random

import torch

from .. import seeded

# one tag a weight set, so that each model's draw is its own
TAGS = {"ae": 1, "xvector": 2, "xvector_clf": 3, "asr": 4, "lm": 5}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def anonymizer(seed: int, device):
    from speech_anonymization_tpu_torch.models.autoencoders import ConvAutoencoder

    ae = ConvAutoencoder(device=device)
    return ae, seeded.draw_weights(ae, seed, TAGS["ae"], device)


def evaluator(seed: int, device):
    from speech_anonymization_tpu_torch.models.xvector import Xvector, XvectorClassifier

    with torch.device(device):
        emb, clf = Xvector(device=device), XvectorClassifier(device=device)
    return (emb, clf, seeded.draw_weights(emb, seed, TAGS["xvector"], device),
            seeded.draw_weights(clf, seed, TAGS["xvector_clf"], device))


def asr_model(cfg: dict, seed: int, device):
    from speech_anonymization_tpu_torch.models.asr import ASRModel

    with torch.device(device):
        asr = ASRModel(input_feats=80, d_model=cfg["d_model"], nhead=cfg["nhead"],
                       num_encoder_layers=cfg["num_encoder_layers"],
                       num_decoder_layers=cfg["num_decoder_layers"], d_ffn=cfg["d_ffn"],
                       output_neurons=cfg["vocab"], device=device)
    return asr.eval(), seeded.draw_weights(asr, seed, TAGS["asr"], device)


def language_model(cfg: dict, seed: int, device):
    from speech_anonymization_tpu_torch.models.transformer import TransformerLM

    with torch.device(device):
        lm = TransformerLM(vocab=cfg["vocab"], d_model=cfg["lm_d_model"], nhead=cfg["lm_nhead"],
                           num_layers=cfg["lm_num_layers"], d_ffn=cfg["lm_d_ffn"], device=device)
    return lm.eval(), seeded.draw_weights(lm, seed, TAGS["lm"], device)


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|; NaN anywhere reads as infinity."""
    got, want = got.double(), want.double().to(got.device)
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def abs_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double().to(got.device)
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - want).abs().max())


class Sample:
    """One call's outputs kept per batch of the pool, drawn uniformly over
    that batch's calls from the seed (a reservoir of one): ``offer(k, out)``
    after every call."""

    def __init__(self, seed: int):
        self.rng = random.Random(seed)
        self.kept: dict = {}
        self.seen: dict = {}

    def offer(self, k: int, out) -> None:
        self.seen[k] = self.seen.get(k, 0) + 1
        if self.rng.random() * self.seen[k] < 1.0:
            self.kept[k] = out

    def clear(self) -> None:
        self.kept.clear()
        self.seen.clear()


class StubTokenizer:
    """Token ids as words: the WER is taken over id strings."""

    def decode_ids(self, ids) -> str:
        return " ".join(str(int(i)) for i in ids)
