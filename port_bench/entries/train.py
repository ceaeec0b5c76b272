"""The adversarial anonymizer's training step: ``recipes/anonymizer.py``
``AnonymizerTrainer.fit_batch`` at the configuration's schedule, with the
frozen ASR's utility term.

A unit of work is one micro-batch. The phases of the schedule alternate
every ``micro_batches_per_phase`` micro-batches (the epoch argument flips),
each micro-batch with SpecAugment draws from the seed. Set-up builds one
trainer and drives it through its first updates, up to and with the other
phase's first (``gradient_accumulation`` micro-batches on distinct batches
an update: at convae's schedule two generator updates, then the sex
classifier's), keeping every micro-batch's loss, the gradient each
optimizer took at its first update (its first moment then, over 1 - b1)
and the parameters after each update; then it hands the same trainer, every
shape warm, to the window. The check recomputes those updates with the
plain reference from the drawn weights, waveforms and draws.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import flops, seeded
from ..reference import training
from . import common


class Entry:
    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from speech_anonymization_tpu_torch.ops.fbank import Fbank
        from speech_anonymization_tpu_torch.ops.normalization import InputNormalizer
        from speech_anonymization_tpu_torch.ops.specaugment import SpecAugment, SpecAugmentDraws
        from speech_anonymization_tpu_torch.recipes import anonymizer as recipe
        from speech_anonymization_tpu_torch.recipes.asr_bundle import ASRBundle
        from speech_anonymization_tpu_torch.train.schedulers import NoamScheduler

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.draws_t = SpecAugmentDraws
        b, samples, n_tok = cfg["batch_size"], mix["samples"], mix["tokens"]
        self.asr, self.w_asr = common.asr_model(cfg, seed, device)
        hp = {"model_type": "convae", "adversarial_schedule": cfg["adversarial_schedule"],
              "gradient_accumulation": cfg["gradient_accumulation"],
              "gradient_clipping": cfg["gradient_clipping"], "seed": 0,
              "compute_features": Fbank(device=device), "normalize": InputNormalizer(dim=80),
              "augmentation": SpecAugment(**cfg["specaugment"]),
              "noam_annealing": NoamScheduler(cfg["lr_initial"], cfg["n_warmup_steps"], cfg["noam_model_size"])}
        bundle = ASRBundle(self.asr, common.StubTokenizer(), {"decode_cache_dtype": "float32"},
                           utility_kind="mse")
        self.trainer = recipe.AnonymizerTrainer(hp, asr_bundle=bundle, device=device)
        self.w_ae = seeded.draw_weights(self.trainer.model, seed, common.TAGS["ae"], device)
        self.pool = []
        for i in range(mix["pool"]):
            tokens = seeded.ints((b, n_tok), 3, cfg["vocab"], seed, 400 + i, device)
            tokens[:, 0] = cfg["bos_index"]
            self.pool.append((seeded.waveforms(b, samples, seed, 100 + i, device), torch.ones(b, device=device),
                              seeded.ints((b,), 0, 2, seed, 200 + i, device), tokens))
        self.t_feat = -(-flops.frames(samples) // 36) * 36
        self.per_phase = mix["micro_batches_per_phase"]
        unit = {"audio_s": b * samples / seeded.SAMPLE_RATE}
        self.units = [{**unit, "flops": flops.train_micro_batch(b, samples, n_tok, cfg, bool(ph["weights"]["utility"]))}
                      for ph in cfg["adversarial_schedule"]]
        # the first updates, through the other phase's first, kept for the check
        k = cfg["gradient_accumulation"]
        self.updates = self.per_phase // k + 1
        params = self.trainer.params
        self.names = list(params)
        b1 = float(np.float32(0.9))
        self.kept = {"losses": [], "grads": {}, "params": []}
        for u in range(self.updates):
            self.kept["losses"] += [float(self._fit(i)) for i in range(u * k, (u + 1) * k)]
            opt = self._phases()[u][2]
            if opt not in self.kept["grads"]:
                mu = self.trainer.state.opt_state[opt].mu
                self.kept["grads"][opt] = {n: (mu[n] / np.float32(1 - b1)).detach().clone() for n in params}
            self.kept["params"].append({n: p.detach().clone() for n, p in params.items()})
        common.sync(device)
        self.next = self.updates * k

    def draws(self, i: int):
        return seeded.spec_augment_draws(self.cfg["batch_size"], self.t_feat, 80, self.seed, 1000 + i,
                                         self.cfg["specaugment"])

    def _fit(self, i: int):
        batch = self.pool[i % len(self.pool)]
        epoch = (i // self.per_phase) % len(self.cfg["adversarial_schedule"])
        return self.trainer.fit_batch(batch, epoch, self.draws_t(*self.draws(i)))

    def call(self, i: int) -> dict:
        j = self.next + i
        self._fit(j)
        common.sync(self.device)
        return self.units[(j // self.per_phase) % len(self.units)]

    def release(self) -> None:
        del self.trainer

    def _phases(self) -> list:
        """Each kept update's (loss weights, the leaves its mask leaves out,
        its optimizer's name): the sex head's leaves are those named
        ``sex_classifier`` or ``sex_head``."""
        cfg, k = self.cfg, self.cfg["gradient_accumulation"]
        names = self.names
        head = {n for n in names if "sex_classifier" in n or "sex_head" in n}
        out = []
        for u in range(self.updates):
            phase = cfg["adversarial_schedule"][(u * k // self.per_phase) % len(cfg["adversarial_schedule"])]
            weights = [float(np.float32(phase["weights"][n])) for n in ("recon", "sex", "utility", "confusion")]
            masked = {"generator": head, "sex_classifier": set(names) - head}.get(phase["train"], set())
            out.append((weights, masked, "clf" if phase["train"] == "sex_classifier" else "gen"))
        return out

    def reference_outputs(self, p) -> dict:
        """The kept updates by the reference in precision ``p``, as set-up keeps the program's."""
        k = self.cfg["gradient_accumulation"]
        n = self.updates * k
        losses, grads, after = training.updates(self.w_ae, self.names, self.w_asr,
                                                [self.pool[i % len(self.pool)] for i in range(n)],
                                                [self.draws(i) for i in range(n)], self._phases(), self.cfg, p)
        return {"losses": losses, "grads": grads, "params": after}

    def _masked(self, out: dict) -> float:
        """The largest gradient or parameter change that a phase's mask keeps at nought."""
        worst, before, seen = 0.0, self.w_ae, set()
        for (_, masked, opt), after in zip(self._phases(), out["params"]):
            for n in masked:
                worst = max(worst, float((after[n] - before[n]).abs().max()))
                if opt not in seen:
                    worst = max(worst, float(out["grads"][opt][n].abs().max()))
            seen.add(opt)
            before = after
        return worst

    def check(self, p) -> dict:
        want, got = self.reference_outputs(p), self.kept
        loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["losses"], want["losses"]))
        # each optimizer's first gradient over the leaves its phase trains,
        # less those whose reference gradient is under a thousandth of the
        # median leaf's (a conv bias under an instance norm: nought but for
        # rounding, moved by Adam's sign alone)
        firsts: dict = {}
        for _, masked, opt in self._phases():
            firsts.setdefault(opt, masked)
        grad_gap, live = 0.0, set()
        for opt, masked in firsts.items():
            g_norm = {n: float(g.double().norm()) for n, g in want["grads"][opt].items() if n not in masked}
            med = float(np.median(list(g_norm.values())))
            kept = [n for n in g_norm if g_norm[n] > 1e-3 * med]
            live.update(kept)
            for n in kept:
                gap = abs(float(got["grads"][opt][n].double().norm()) - g_norm[n]) / max(g_norm[n], med)
                grad_gap = max(grad_gap, gap)
        d_ref = {n: float((want["params"][-1][n] - self.w_ae[n]).double().norm()) for n in live}
        d_got = {n: float((got["params"][-1][n] - self.w_ae[n]).double().norm()) for n in live}
        med_d = float(np.median(list(d_ref.values())))
        step_gap = max(abs(d_got[n] - d_ref[n]) / max(d_ref[n], med_d) for n in live)
        return {"loss": loss_gap, "first_gradient": grad_gap, "parameter_change": step_gap,
                "masked": self._masked(got)}
