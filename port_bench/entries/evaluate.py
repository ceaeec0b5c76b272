"""The test-stage evaluation of an anonymizer: ``recipes/anonymizer.py``
``evaluate_batch`` with the frozen x-vector evaluator and the ASR bundle
(and its LM) at ``stage="test"``.

A unit of work is one batch: the anonymizer's full forward, the x-vector on
the clean and the reconstructed features, the ASR encoder's similarity and
two beam decodes. What the timed calls produced is kept for one call of
each batch of the pool, drawn from the seed: the clean features and the reconstruction as the
evaluator received them, its log-probs, the sex head's log-probs, the
encoder similarities, and both decodes' hypotheses and scores, read where
the recipe hands them on (the evaluator's and the bundle's calls, the
metrics' appends). The check recomputes all of it with the plain
reference from the waveforms and the drawn weights and compares: each
hypothesis's score with the score the models give it, and, on the mix's
``search_rows`` utterances of each kept batch, drawn from the seed, for both
feature sets, how far that score falls below the best that the reference's
own beam search finds.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from .. import flops, seeded
from ..reference import beam_search, frontend, models, scoring
from . import common


class Entry:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from speech_anonymization_tpu_torch.eval.evaluator import FeatureClassifier
        from speech_anonymization_tpu_torch.eval.metrics import AccuracyStats
        from speech_anonymization_tpu_torch.ops.fbank import Fbank
        from speech_anonymization_tpu_torch.ops.normalization import InputNormalizer
        from speech_anonymization_tpu_torch.recipes import anonymizer as recipe
        from speech_anonymization_tpu_torch.recipes.asr_bundle import ASRBundle

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.recipe = recipe
        b, samples = mix["batch"], mix["samples"]
        self.ae, self.w_ae = common.anonymizer(seed, device)
        emb, clf, self.w_emb, self.w_clf = common.evaluator(seed, device)
        self.asr, self.w_asr = common.asr_model(cfg, seed, device)
        self.lm, self.w_lm = common.language_model(cfg, seed, device) if cfg["lm_weight"] > 0 else (None, None)
        self.fbank, self.normalizer = Fbank(device=device), InputNormalizer(dim=80)
        self.pool = [seeded.waveforms(b, samples, seed, 100 + i, device) for i in range(mix["pool"])]
        self.lens = torch.ones(b, device=device)
        self.labels = [seeded.ints((b,), 0, 2, seed, 200 + i, device) for i in range(mix["pool"])]
        words = seeded.ints((mix["pool"], b, mix["reference_words"]), 3, cfg["vocab"], seed, 300, "cpu")
        self.words = [[" ".join(map(str, row.tolist())) for row in batch] for batch in words]
        # the frozen normalizer: its statistics of the pool's first batch
        _, self.norm_state = self.normalizer(self.normalizer.init_state(device), self.fbank(self.pool[0]),
                                             self.lens, 0, training=True)
        self.ext = FeatureClassifier(emb, clf, self.normalizer.init_state(device), self.normalizer)
        hp = {k: cfg[k] for k in ("test_beam_size", "ctc_weight_decode", "temperature", "temperature_lm",
                                  "lm_weight", "decode_cache_dtype", "bos_index", "eos_index", "blank_index")}
        self.bundle = ASRBundle(self.asr, common.StubTokenizer(), hp, lm=self.lm)
        self.metrics = recipe.EvalMetrics()
        self.bundle.start_test(self.metrics)
        self.steps = max(int(cfg["max_decode_ratio"] * flops.enc_frames(flops.frames(samples))), 1)
        self.sample = common.Sample(seed)
        self.kept = self.sample.kept
        self._record(AccuracyStats)
        self.unit = {"audio_s": b * samples / seeded.SAMPLE_RATE, "decode_steps": 2 * self.steps,
                     "flops": flops.evaluate_batch(b, samples, {**cfg, "beam_size": cfg["test_beam_size"]},
                                                   cfg["lm_weight"] > 0)}
        self.call(0)  # the one batch that warms every shape
        self.sample.clear()

    def _record(self, accuracy_stats) -> None:
        """Keep what the recipe hands on, per call, without changing it."""
        cur = self.current = {}
        decode, classify = self.bundle._decode_test, self.ext.classify_feats

        def decode_kept(feats, lens):
            out = decode(feats, lens)
            cur.setdefault("decodes", []).append(out[:3])
            return out

        def classify_kept(feats, lens=None):
            out = classify(feats, lens)
            cur.setdefault("ext", []).append((feats, out[0]))
            return out

        class SexAccuracy(accuracy_stats):
            def append(self, log_probs, targets, lengths=None):
                cur["sex_lp"] = np.asarray(log_probs)
                return super().append(log_probs, targets, lengths)

        self.bundle._decode_test, self.ext.classify_feats = decode_kept, classify_kept
        self.metrics.sex_acc = SexAccuracy()

    def call(self, i: int) -> dict:
        k = i % len(self.pool)
        self.current.clear()
        sims = len(self.metrics.utility_similarity.scores)
        self.recipe.evaluate_batch(self.ae, self.fbank, self.normalizer, self.norm_state, self.pool[k], self.lens,
                                   self.labels[k], self.metrics, self.ext, asr_bundle=self.bundle,
                                   ids=[f"u{k}_{j}" for j in range(len(self.lens))], words=self.words[k],
                                   stage="test")
        common.sync(self.device)
        self.sample.offer(k, {**self.current, "sims": self.metrics.utility_similarity.scores[sims:]})
        return self.unit

    def release(self) -> None:
        del self.bundle, self.ext, self.asr, self.lm, self.ae

    def _scoring_cfg(self) -> dict:
        return {k: self.cfg[k] for k in ("bos_index", "eos_index", "blank_index", "ctc_weight_decode", "lm_weight",
                                         "temperature", "temperature_lm")}

    def _rows(self) -> dict:
        """The mix's ``search_rows`` utterances of each kept batch that the
        reference's own search decodes, drawn from the seed."""
        rng = random.Random(self.seed)
        return {k: sorted(rng.sample(range(len(self.lens)), self.mix.get("search_rows", 0))) for k in sorted(self.kept)}

    @torch.no_grad()
    def reference_outputs(self, p, rows: dict | None = None) -> dict:
        """The kept batches' outputs by the reference in precision ``p``, as
        the timed calls keep the program's: the decodes those of its own beam
        search, for both feature sets, on the utterances ``rows[k]`` of each
        batch k (all where None); with the encoder states (``encs``)."""
        cfg, lens = self.cfg, self.lens
        norm = frontend.Normalizer(device=self.device)
        norm.update(frontend.fbank(self.pool[0], p), lens)
        out = {}
        for k in sorted(self.kept):
            clean = frontend.pad_time(norm(frontend.fbank(self.pool[k], p)))
            recon, sex_lp = models.autoencoder(self.w_ae, clean, p=p)
            encs = [models.asr_encode(self.w_asr, f, lens, cfg["nhead"], p) for f in (recon, clean)]
            r, o = (e.reshape(len(lens), -1).double() for e in encs)
            out[k] = {"ext": [(f, models.xvector_log_probs(self.w_emb, self.w_clf, f, p)) for f in (clean, recon)],
                      "sex_lp": sex_lp.cpu().numpy(),
                      "sims": ((r * o).sum(1) / (r.norm(dim=1) * o.norm(dim=1)).clamp_min(1e-8)).tolist(),
                      "encs": encs, "rows": list(range(len(lens))) if rows is None else rows[k]}
        # the searches in batches of at most 8 utterances, for memory
        which = [(k, d, j) for k in out for d in range(2) for j in out[k]["rows"]]
        found = []
        for at in range(0, len(which), 8):
            part = which[at:at + 8]
            found.append(beam_search.beam_search(
                self.w_asr, self.w_lm, torch.cat([out[k]["encs"][d][j:j + 1] for k, d, j in part]),
                torch.stack([lens[j] for _, _, j in part]), self._scoring_cfg(), cfg["test_beam_size"],
                self.steps, cfg["nhead"], cfg["lm_nhead"], p))
        if not found:
            return out
        tokens, lengths, scores = (torch.cat(x) for x in zip(*found))
        for k in out:
            pick = [[i for i, (k2, d2, _) in enumerate(which) if (k2, d2) == (k, d)] for d in range(2)]
            out[k]["decodes"] = [(tokens[i], lengths[i], scores[i]) for i in pick]
        return out

    @torch.no_grad()
    def check(self, p) -> dict:
        """The reference on each kept batch; -> {number: value}."""
        lens, cfg = self.lens, self.cfg
        want = self.reference_outputs(p, self._rows())
        gaps = {"features": 0.0, "reconstruction": 0.0, "sex_head": 0.0, "xvector": 0.0, "similarity": 0.0,
                "decode_score": 0.0}
        for k, got in sorted(self.kept.items()):
            ref = want[k]
            (f_clean, lp_clean), (f_recon, lp_recon) = got["ext"]
            (w_clean, wlp_clean), (w_recon, wlp_recon) = ref["ext"]
            gaps["features"] = max(gaps["features"], common.rel_gap(f_clean, w_clean))
            gaps["reconstruction"] = max(gaps["reconstruction"], common.rel_gap(f_recon, w_recon))
            gaps["sex_head"] = max(gaps["sex_head"], common.abs_gap(torch.as_tensor(got["sex_lp"]),
                                                                    torch.as_tensor(ref["sex_lp"])))
            gaps["xvector"] = max(gaps["xvector"], common.abs_gap(lp_clean, wlp_clean),
                                  common.abs_gap(lp_recon, wlp_recon))
            gaps["similarity"] = max(gaps["similarity"], common.abs_gap(torch.tensor(got["sims"]),
                                                                        torch.tensor(ref["sims"])))
            idx = got.get("rows", list(range(len(lens))))
            for d, ((tokens, lengths, score), enc) in enumerate(zip(got["decodes"], ref["encs"])):
                # each hypothesis's score, as the models fix it
                rescored = scoring.rescore(self.w_asr, self.w_lm, enc[idx], lens[idx], tokens, lengths,
                                           self._scoring_cfg(), self.steps, cfg["nhead"], cfg["lm_nhead"], p)
                gaps["decode_score"] = max(gaps["decode_score"], common.abs_gap(score, rescored))
                if "decodes" in ref:
                    # how far, by that score, the hypothesis falls below the
                    # best that the reference's own search finds
                    short = ref["decodes"][d][2].double().cpu() - rescored[[idx.index(j) for j in ref["rows"]]].cpu()
                    gaps["search_gap"] = max(gaps.get("search_gap", 0.0), float(short.max().clamp_min(0.0)))
        return gaps
