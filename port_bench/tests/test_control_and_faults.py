"""The comparison that decides ``correct`` fails where it should: the
control (the reference in the precision below the configuration's, in the
program's place) fails at least one number of each cell, and each fault a
cell can have, planted in the program underneath a whole run, makes
``correct`` false."""

import importlib

import pytest
import torch

from port_bench import control
from port_bench import run as bench

from . import tiny
from .test_bench_files import CELLS, KEPT


@pytest.mark.parametrize("name", CELLS + KEPT)
def test_control_fails_a_number(name):
    c = tiny.cell(name)
    bench.prepare("cpu")
    got = control.readings(c, 11, 0.2, "cpu")
    assert any(got["control"][k] > c.limits[k] for k in c.limits), got
    assert all(got["program"][k] <= c.limits[k] for k in c.limits), got


def _half_rows(x):
    h = x.shape[0] // 2
    return torch.cat([x[:h], x[:h].mean(0, keepdim=True).expand(x.shape[0] - h, *x.shape[1:])])


def fault_anonymize_half_batch(mp):
    from speech_anonymization_tpu_torch.recipes import anonymizer

    real = anonymizer.anonymize
    mp.setattr(anonymizer, "anonymize", lambda m, f, n, s, w, l: _half_rows(real(m, f, n, s, w[: len(w) // 2],
                                                                                   l[: len(l) // 2]).repeat(2, 1, 1)))


def fault_anonymize_altered(mp):
    from speech_anonymization_tpu_torch.recipes import anonymizer

    real = anonymizer.anonymize

    def altered(*a):
        out = real(*a)
        out[0, 0, 0] += 0.05 * float(out.abs().max())
        return out

    mp.setattr(anonymizer, "anonymize", altered)


def fault_decode_half_batch(mp):
    from speech_anonymization_tpu_torch.recipes import asr_bundle

    real = asr_bundle.beam_search

    def half(att, enc, lens, ctc, cfg, **kw):
        h = enc.shape[0] // 2
        init, step, reorder = att
        out = real(att, enc[:h], lens[:h], ctc[:h], cfg, **kw)
        return tuple(torch.cat([o, o]) if torch.is_tensor(o) else o for o in out)

    mp.setattr(asr_bundle, "beam_search", half)


def fault_decode_token_altered(mp):
    from speech_anonymization_tpu_torch.recipes import asr_bundle

    real = asr_bundle.beam_search

    def altered(*a, **kw):
        tokens, lengths, scores, *rest = real(*a, **kw)
        tokens = tokens.clone()
        tokens[:, 0] = 3 + (tokens[:, 0] - 2) % 40
        return (tokens, lengths, scores, *rest)

    mp.setattr(asr_bundle, "beam_search", altered)


def _patch_top_k(mp, pick):
    beam_search = importlib.import_module("speech_anonymization_tpu_torch.decoding.beam_search")
    real = beam_search.fast_top_k_counted

    def top_k(x, k):
        vals, idx, fell_back = real(x, k + 1)
        vals, idx = pick(vals, idx, k)
        return vals.contiguous(), idx.contiguous(), fell_back

    mp.setattr(beam_search, "fast_top_k_counted", top_k)


def fault_decode_second_best(mp):
    """The search keeps the candidates ranked 2 to k + 1: never the best."""
    _patch_top_k(mp, lambda vals, idx, k: (vals[:, 1:], idx[:, 1:]))


def fault_decode_beam_of_one(mp):
    """The search keeps its best candidate k times: a beam of one."""
    _patch_top_k(mp, lambda vals, idx, k: (vals[:, :1].expand(-1, k), idx[:, :1].expand(-1, k)))


def fault_train_state_unchanged(mp):
    from speech_anonymization_tpu_torch.recipes import anonymizer

    mp.setattr(anonymizer, "kept_step", lambda params, grads, opt, state, *a: state)


def fault_train_half_batch(mp):
    from speech_anonymization_tpu_torch.ops.specaugment import SpecAugmentDraws
    from speech_anonymization_tpu_torch.recipes import anonymizer

    real = anonymizer.AnonymizerTrainer.update

    def half(self, batch, lr, epoch, weights, train_mode, draws=None):
        h = batch[0].shape[0] // 2
        cut = lambda pair: tuple(x[:h] for x in pair)  # noqa: E731
        return real(self, tuple(x[:h] for x in batch), lr, epoch, weights, train_mode,
                    SpecAugmentDraws(draws.warp, cut(draws.freq), cut(draws.time)))

    mp.setattr(anonymizer.AnonymizerTrainer, "update", half)


def _patch_apply(mp, make):
    from speech_anonymization_tpu_torch.recipes import anonymizer

    mp.setattr(anonymizer.AnonymizerTrainer, "_apply", make(anonymizer.AnonymizerTrainer._apply))


def fault_train_head_unmasked(mp):
    """The generator phase trains the sex head too."""
    def make(real):
        def apply(self, loss, lr, train_mode):
            if train_mode == "generator":
                self.masks = {**self.masks, "generator": self.masks["all"]}
            return real(self, loss, lr, train_mode)
        return apply

    _patch_apply(mp, make)


def fault_train_classifier_state_unchanged(mp):
    """The sex classifier's update leaves its parameters and state as they were."""
    def make(real):
        def apply(self, loss, lr, train_mode):
            if train_mode == "sex_classifier":
                return self.state.reset_accumulation()
            return real(self, loss, lr, train_mode)
        return apply

    _patch_apply(mp, make)


def fault_train_classifier_half_batch(mp):
    """The sex classifier's phase takes half of each batch, the mean over the rest."""
    from speech_anonymization_tpu_torch.ops.specaugment import SpecAugmentDraws
    from speech_anonymization_tpu_torch.recipes import anonymizer

    real = anonymizer.AnonymizerTrainer.update

    def half(self, batch, lr, epoch, weights, train_mode, draws=None):
        if train_mode != "sex_classifier":
            return real(self, batch, lr, epoch, weights, train_mode, draws)
        h = batch[0].shape[0] // 2
        cut = lambda pair: tuple(x[:h] for x in pair)  # noqa: E731
        return real(self, tuple(x[:h] for x in batch), lr, epoch, weights, train_mode,
                    SpecAugmentDraws(draws.warp, cut(draws.freq), cut(draws.time)))

    mp.setattr(anonymizer.AnonymizerTrainer, "update", half)


FAULTS = {"convae.anon_b32": [fault_anonymize_half_batch, fault_anonymize_altered],
          "asr_lm.eval_d2": [fault_decode_half_batch, fault_decode_token_altered],
          "asr_lm.eval_d1": [fault_decode_half_batch, fault_decode_token_altered, fault_decode_second_best,
                             fault_decode_beam_of_one],
          "convae.train_b8": [fault_train_state_unchanged, fault_train_half_batch, fault_train_head_unmasked,
                              fault_train_classifier_state_unchanged, fault_train_classifier_half_batch]}


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS + KEPT for f in FAULTS[n]],
                         ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_fault_makes_the_run_incorrect(name, fault, monkeypatch):
    fault(monkeypatch)
    result = tiny.run(name)
    assert not result["correct"], result["checks"]
