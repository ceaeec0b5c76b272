"""Anonymization: ``recipes/anonymizer.py`` ``anonymize`` (log-mel features,
the frozen normalizer, the ConvAutoencoder's encoder and decoder).

A unit of work is one call on one batch of the pool. The reconstruction of
one call on each batch, drawn from the seed, is kept; the check recomputes it with the plain
reference from the waveforms and the drawn weights, the normalizer's
statistics included.
"""

from __future__ import annotations

import torch

from .. import flops, seeded
from ..reference import frontend, models
from . import common


class Entry:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from speech_anonymization_tpu_torch.ops.fbank import Fbank
        from speech_anonymization_tpu_torch.ops.normalization import InputNormalizer
        from speech_anonymization_tpu_torch.recipes import anonymizer as recipe

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.anonymize = recipe.anonymize
        b, samples = mix["batch"], mix["samples"]
        self.ae, self.w_ae = common.anonymizer(seed, device)
        self.fbank, self.normalizer = Fbank(device=device), InputNormalizer(dim=80)
        self.pool = [seeded.waveforms(b, samples, seed, 100 + i, device) for i in range(mix["pool"])]
        self.lens = torch.ones(b, device=device)
        _, self.norm_state = self.normalizer(self.normalizer.init_state(device), self.fbank(self.pool[0]),
                                             self.lens, 0, training=True)
        self.unit = {"audio_s": b * samples / seeded.SAMPLE_RATE, "flops": flops.anonymize(b, samples)}
        self.sample = common.Sample(seed)
        self.kept = self.sample.kept
        self.call(0)
        self.sample.clear()

    def call(self, i: int) -> dict:
        k = i % len(self.pool)
        self.sample.offer(k, self.anonymize(self.ae, self.fbank, self.normalizer, self.norm_state, self.pool[k],
                                            self.lens))
        common.sync(self.device)
        return self.unit

    def release(self) -> None:
        del self.ae

    @torch.no_grad()
    def reference_outputs(self, p) -> dict:
        """The kept batches' reconstructions by the reference in precision ``p``."""
        norm = frontend.Normalizer(device=self.device)
        norm.update(frontend.fbank(self.pool[0], p), self.lens)
        return {k: models.anonymize(self.w_ae, norm(frontend.fbank(self.pool[k], p)), p) for k in sorted(self.kept)}

    def check(self, p) -> dict:
        want = self.reference_outputs(p)
        return {"reconstruction": max(common.rel_gap(got, want[k]) for k, got in self.kept.items())}
