"""Hold the anonymizer's training step on the card to the same step on the CPU.

Used by ``chip_smoke.py`` (phases ``train``, ``train_parity`` and
``distributed``) and by ``tests/test_torch_cuda.py``; the CPU parity tests
against the JAX package (``tests/torch_train_helpers.py``) and of the
data-parallel ranks (``tests/test_torch_parallel.py``) take their
tolerances, waveforms and per-tensor checks from here too. A cycle is
recorded on the CPU by :func:`cycle_record` and two records of one cycle
from the same start are held to each other by :func:`compare_records`
(card and CPU, ranks and one process, the port and the JAX package).
:func:`compare_cycle` builds one trainer on the card and one on the CPU from
the same weights (``make_trainer(device)`` builds each; the card's weights
are copied to the CPU's), runs one accumulation cycle of the same batches on
both (the SpecAugment draws come from each trainer's host generator, seeded
alike, so they are equal), and checks, at the CPU parity tests' tolerances:

  * after every micro-batch: the loss terms (recon and utility rtol 1e-5, the
    sex and confusion terms and the total 2e-3: the sex head's pooled
    BatchNorm is f32-limited), the BatchNorm running statistics (within 1e-4
    of each tensor's largest element), the normalizer state (rtol and atol
    1e-4: the fbank is K1 on the card, held to its twin at 1e-4) and, before
    the update, the accumulated gradients (within 3e-2 of each tensor's
    largest element with the sex term in the loss, 1e-4 without);
  * after the update: the Adam count, moments (3e-2, or 2e-4) and the
    parameters: where the first moment is resolved, within what the moments'
    gaps carry into the step (+ 1e-6); elsewhere (trap e: the step is +-lr by
    a sign that rounding decides) only |step| <= lr, and those elements are
    counted (``sign_only``).

:func:`compare_gender_step` (on :func:`gender_record` and
:func:`compare_gender_records`) does the same for the gender recipe's
``GenderBrain``: one micro-batch (accumulation 1) on the card and on the CPU
from the same seeded weights and the same draws: the loss (LOSS_RTOL), the
error (equal), the statistics and the normalizer as above, Adam's count, its
moments within SEX_MOMENT_RTOL (at full width the x-vector's TDNN gradients
are f32-limited: a CPU f32 run lies up to ~7e-3 of a tensor's largest
element from float64, through the pooled standard deviations;
``tests/test_torch_gender.py::test_full_width_gradients_are_f32_limited``)
and the parameters as above.

Run with TF32 off (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` False).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..models.xvector import Xvector, XvectorClassifier
from ..ops.augment import EnvCorrupt, TimeDomainSpecAugment
from ..ops.fbank import Fbank
from ..ops.normalization import InputNormalizer
from ..ops.specaugment import SpecAugment
from ..recipes.anonymizer import DEFAULT_SCHEDULE
from ..train.epoch_loop import EpochCounter
from ..train.schedulers import NoamScheduler, ReduceLROnPlateau

# loss terms: recon and utility agree to 1e-5. The sex head's last
# BatchNorms normalize the pooled features over the batch, and those differ
# little from utterance to utterance (InstanceNorm precedes them), so an f32
# rounding of the bottleneck grows ~100x there: each package's (or device's)
# f32 sex log-probs lie up to ~5e-4 from a float64 run of the same weights
# (tests/test_torch_anonymizer_models.py::test_head_log_probs_are_f32_limited).
LOSS_RTOL = 1e-5
SEX_RTOL = 2e-3
# accumulated gradients and Adam moments, per tensor, relative to the
# tensor's largest element: the recon and utility terms' agree to ~1e-5; a
# loss with the sex term reaches ~1.5e-2 (the head's f32 limit, above)
GRAD_RTOL, MOMENT_RTOL = 1e-4, 2e-4
SEX_GRAD_RTOL, SEX_MOMENT_RTOL = 3e-2, 3e-2
STATS_RTOL = 1e-4  # BatchNorm running statistics, per tensor, relative to its largest element
NORM_RTOL = 1e-4  # the normalizer's statistics of dB features: K1 against its twin is held at 1e-4
# a gradient below this share of the largest one anywhere is rounding noise
# (a bias before an InstanceNorm or a train-mode BatchNorm: exactly zero in
# exact arithmetic, ~1e-9 to 1e-5 of the largest in f32)
NOISE = 1e-4
STEP_ATOL = 1e-6  # on top of what the moments' gaps carry into an Adam step


def speechlike(batch: int, n: int, seed: int) -> np.ndarray:
    """(batch, n) 16 kHz waveforms: harmonic voiced signals, each with its own
    pitch, loudness and envelope, over noise. Utterances that differ as speech
    does keep the sex head's batch statistics of pooled features apart; white
    noise makes them near-equal, where the head's f32 gradients lose most of
    their digits."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    out = []
    for _ in range(batch):
        f0, amp = rng.uniform(90, 260), rng.uniform(0.02, 0.3)
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 6) * t + rng.uniform(0, 6))
        voiced = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in range(1, 12)) * env
        out.append(amp * voiced + rng.uniform(0.005, 0.05) * rng.standard_normal(n))
    return np.stack(out).astype(np.float32)


def convae_hparams(device, schedule=DEFAULT_SCHEDULE, noam: NoamScheduler | None = None) -> dict:
    """convae.yaml's training: seed 8886 (the SpecAugment generator's), the
    adversarial schedule by epoch, accumulation 3, clip 5, SpecAugment, the
    normalizer updating until epoch 4, Noam."""
    return {"model_type": "convae", "adversarial_schedule": schedule,
            "adversarial_schedule_unit": "epoch", "gradient_accumulation": 3,
            "gradient_clipping": 5.0, "seed": 8886, "compute_features": Fbank(device=device),
            "normalize": InputNormalizer(dim=80, update_until_epoch=4),
            "augmentation": SpecAugment(), "noam_annealing": noam or NoamScheduler()}


def gender_hparams(device, augment: bool = True, **widths) -> dict:
    """gender_classifier.yaml's objects on ``device`` (the x-vector at full
    width unless ``widths`` say otherwise: ``tdnn_channels``, ``lin_neurons``),
    with EnvCorrupt and TimeDomainSpecAugment when ``augment``."""
    emb = widths.get("lin_neurons", 128)
    return {"compute_features": Fbank(device=device), "mean_var_norm": InputNormalizer(dim=80),
            "embedding_model": Xvector(**widths, device=device),
            "classifier": XvectorClassifier(lin_neurons=emb, device=device),
            "lr_annealing": ReduceLROnPlateau(1e-3), "epoch_counter": EpochCounter(1), "train_logger": None,
            "env_corrupt": EnvCorrupt() if augment else None,
            "augmentation": TimeDomainSpecAugment() if augment else None,
            "gradient_accumulation": 1, "gradient_clipping": 5.0, "lr_start": 1e-3, "seed": 1230}


def train_batch(b: int, samples: int, seed: int, device="cpu", vocab: int = 5000, tokens: int = 40,
                speech: bool = True) -> tuple:
    """(waveforms, relative lengths (all 1), alternating sex labels,
    tokens_bos): speech-like utterances (or white noise at 0.1) and seeded
    token ids below ``vocab``, each row starting with bos 1."""
    rng = np.random.default_rng(seed)
    wavs = torch.from_numpy(speechlike(b, samples, seed) if speech else
                            (rng.standard_normal((b, samples)) * 0.1).astype(np.float32))
    ids = np.concatenate([np.ones((b, 1)), rng.integers(3, vocab, (b, tokens - 1))], 1)
    return tuple(x.to(device) for x in (wavs, torch.ones(b), torch.arange(b) % 2,
                                        torch.from_numpy(ids.astype(np.int64))))


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().double().cpu().numpy()
    return np.asarray(x, np.float64)


def noise_floor(want: dict) -> float:
    return NOISE * max((float(np.abs(_np(w)).max()) for w in want.values()), default=0.0)


def tensor_gaps(got: dict, want: dict, rtol: float, what: str, failures: list) -> float:
    """Per tensor |got - want| <= rtol * max|want| + the noise floor (else a
    line in ``failures``); -> the largest gap relative to its tensor's
    largest element, over the tensors above the noise floor."""
    floor = noise_floor(want)
    worst = 0.0
    for k, w in want.items():
        g, w = _np(got[k]), _np(w)
        scale = float(np.abs(w).max())
        gap = float(np.abs(g - w).max())
        if not gap <= rtol * scale + floor:
            failures.append(f"{what} {k}: gap {gap} > {rtol} x {scale} + {floor}")
        if scale > floor:
            worst = max(worst, gap / scale)
    return worst


def step_gaps(name: str, got, want, start, mu: tuple, nu: tuple, count: int, lr: float, floor: float,
              failures: list) -> tuple[int, float]:
    """One parameter tensor after ``count`` Adam steps at ``lr``: ``got`` and
    ``want`` from ``start``, with the moments ``mu`` and ``nu`` as (got,
    want). Where the first moment is resolved, the two may differ by what the
    moments' gaps carry into the step lr * m / (sqrt(v) + eps), plus
    STEP_ATOL. Elsewhere (its gap to ``want``'s reaches its size, or the whole
    tensor is rounding noise, below ``floor``) Adam's step is +-lr by a sign
    that rounding decides (trap e): those elements are held only to |step|
    <= lr per update and counted. -> (sign-only elements, the largest gap
    over the resolved ones); a line in ``failures`` for each breach."""
    g, w, p0 = _np(got), _np(want), _np(start)
    bc1, bc2 = 1 - 0.9 ** count, 1 - 0.98 ** count
    m, dm = _np(mu[1]) / bc1, np.abs(_np(mu[0]) - _np(mu[1])) / bc1
    v, dv = _np(nu[1]) / bc2, np.abs(_np(nu[0]) - _np(nu[1])) / bc2
    loose = (np.abs(m) <= 4 * dm) | (np.abs(m).max() * bc1 <= floor)
    root = np.sqrt(v) + 1e-9
    tol = 2 * lr * (dm / root + np.abs(m) * dv / (2 * root * np.maximum(v, 1e-30))) + STEP_ATOL
    over = (np.abs(g - w) - tol)[~loose]
    if over.size and over.max() > 0:
        failures.append(f"parameters {name}: {int((over > 0).sum())} elements beyond the step's "
                        f"tolerance, by up to {float(over.max())}")
    if not np.all(np.abs(g - p0)[loose] <= count * lr * 1.01 + 1e-7):
        failures.append(f"parameters {name}: an unresolved element moved more than lr")
    return int((loose & (m != 0)).sum()), float(np.abs(g - w)[~loose].max(initial=0.0))


def _stats(model: torch.nn.Module) -> dict:
    return {k: v for k, v in model.state_dict().items() if k.endswith(("running_mean", "running_var"))}


def _params(trainer) -> dict:
    return {k: p.detach().clone() for k, p in trainer.model.named_parameters()}


def _cpu(tensors: dict) -> dict:
    return {k: v.detach().clone().cpu() for k, v in tensors.items()}


def cycle_record(trainer, batches: Sequence[tuple], epoch: int, draws: Sequence | None = None) -> dict:
    """Run one accumulation cycle of ``batches`` (each on the trainer's
    device; ``draws``, the SpecAugment draws of each, or None for the
    trainer's own) and record, on the CPU, what :func:`compare_records`
    holds: after every micro-batch the loss terms, the BatchNorm statistics,
    the normalizer state and (before the update) the accumulated gradients;
    after it the optimizer's count and moments, the parameters and Noam's lr."""
    if len(batches) != trainer.grad_accum:
        raise ValueError(f"one cycle is {trainer.grad_accum} micro-batches, got {len(batches)}")
    phase = trainer._phase(epoch)
    micro = []
    for i, batch in enumerate(batches):
        trainer.fit_batch(batch, epoch, None if draws is None else draws[i])
        micro.append({"metrics": {k: float(v) for k, v in trainer.metrics.items() if k != "stepped"},
                      "stats": _cpu(_stats(trainer.model)),
                      "norm": [t.detach().clone().cpu() for t in trainer.state.norm_state],
                      "accum": _cpu(trainer.state.accum_grads) if i < len(batches) - 1 else None})
    opt_key = "clf" if phase.get("train") == "sex_classifier" else "gen"
    opt = trainer.state.opt_state[opt_key]
    return {"micro": micro, "opt_key": opt_key, "count": opt.count, "mu": _cpu(opt.mu), "nu": _cpu(opt.nu),
            "params": _cpu(_params(trainer)), "lr": trainer.noam.current_lr,
            "sex_on": any(phase["weights"].get(k, 0.0) for k in ("sex", "confusion"))}


def compare_records(got: dict, want: dict, start: dict, what: str = "got and want",
                    lr_rtol: float = 0.0) -> dict:
    """Two :func:`cycle_record`s of one cycle from the same ``start``
    parameters, held at the CPU parity tests' tolerances (the module's
    docstring). Noam's lr must be equal; ``lr_rtol`` > 0 only where one record
    is the JAX package's, whose lr is a float32. -> the gaps; raises
    AssertionError listing every check beyond its tolerance."""
    grad_rtol, moment_rtol = (SEX_GRAD_RTOL, SEX_MOMENT_RTOL) if want["sex_on"] else (GRAD_RTOL, MOMENT_RTOL)
    report: dict = {"loss_rel_gap": {}, "grad_rel_gap": 0.0, "stats_rel_gap": 0.0}
    failures: list = []
    for i, (g_mb, w_mb) in enumerate(zip(got["micro"], want["micro"])):
        for k in ("recon_loss", "sex_loss", "utility_loss", "confusion_loss", "loss"):
            g, w = g_mb["metrics"][k], w_mb["metrics"][k]
            rtol = LOSS_RTOL if k in ("recon_loss", "utility_loss") else SEX_RTOL
            if not abs(g - w) <= rtol * abs(w) + 1e-7:
                failures.append(f"micro-batch {i}: {k} {g} against {w} beyond rtol {rtol}")
            report["loss_rel_gap"][k] = max(report["loss_rel_gap"].get(k, 0.0), abs(g - w) / max(abs(w), 1e-30))
        report["stats_rel_gap"] = max(report["stats_rel_gap"], tensor_gaps(
            g_mb["stats"], w_mb["stats"], STATS_RTOL, "BatchNorm statistics", failures))
        for name, g, w in zip(("count", "glob_mean", "glob_std"), g_mb["norm"], w_mb["norm"]):
            gap = float(np.abs(_np(g) - _np(w)).max())
            report["norm_max_abs_gap"] = max(report.get("norm_max_abs_gap", 0.0), gap)
            if not np.allclose(_np(g), _np(w), rtol=NORM_RTOL, atol=NORM_RTOL):
                failures.append(f"micro-batch {i}: normalizer {name} differs by {gap}")
        if w_mb["accum"] is not None:
            report["grad_rel_gap"] = max(report["grad_rel_gap"], tensor_gaps(
                g_mb["accum"], w_mb["accum"], grad_rtol, "accumulated grads", failures))
    if got["count"] != want["count"] or want["count"] == 0 or got["opt_key"] != want["opt_key"]:
        raise AssertionError(f"{what}: Adam {got['opt_key']} count {got['count']}, "
                             f"{want['opt_key']} {want['count']}")
    report["mu_rel_gap"] = tensor_gaps(got["mu"], want["mu"], moment_rtol, "Adam mu", failures)
    report["nu_rel_gap"] = tensor_gaps(got["nu"], want["nu"], moment_rtol, "Adam nu", failures)
    count, lr = want["count"], want["lr"]
    if abs(got["lr"] - lr) > lr_rtol * lr:
        raise AssertionError(f"{what}: Noam lr {got['lr']} against {lr}")
    floor = noise_floor(want["mu"])
    sign_only, worst = 0, 0.0
    for k in want["params"]:
        n, gap = step_gaps(k, got["params"][k], want["params"][k], start[k], (got["mu"][k], want["mu"][k]),
                           (got["nu"][k], want["nu"][k]), count, lr, floor, failures)
        sign_only, worst = sign_only + n, max(worst, gap)
    report.update(param_max_abs_gap=worst, sign_only=sign_only,
                  params=sum(_np(p).size for p in want["params"].values()), tolerances={
                      "loss_rtol": LOSS_RTOL, "sex_rtol": SEX_RTOL, "grad_rtol": grad_rtol,
                      "moment_rtol": moment_rtol, "stats_rtol": STATS_RTOL, "norm_rtol": NORM_RTOL,
                      "lr": lr})
    if failures:
        raise AssertionError(f"{what} disagree ({len(failures)} checks): " + "; ".join(failures)
                             + f"; report {report}")
    return report


def compare_cycle(make_trainer: Callable, batches: Sequence[tuple], epoch: int,
                  device: str = "cuda") -> dict:
    """One accumulation cycle of ``batches`` on ``device`` and on the CPU from
    the same weights (:func:`cycle_record`, :func:`compare_records`); -> the
    gaps; raises AssertionError (listing every check beyond its tolerance)."""
    card, cpu = make_trainer(device), make_trainer("cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})
    start = {k: _np(p) for k, p in _params(cpu).items()}
    got = cycle_record(card, [tuple(x.to(device) for x in b) for b in batches], epoch)
    want = cycle_record(cpu, [tuple(x.cpu() for x in b) for b in batches], epoch)
    return compare_records(got, want, start, "card and CPU")


def _gender_state(brain) -> tuple[dict, dict]:
    stats = {f"{name}.{k}": v for name in ("embedding_model", "classifier")
             for k, v in getattr(brain, name).state_dict().items() if k.endswith(("running_mean", "running_var"))}
    return {k: p.detach().clone() for k, p in brain.params.items()}, stats


def gender_record(brain, batch: tuple, draws) -> dict:
    """One ``GenderBrain`` micro-batch, ``(wavs, lens, labels)`` on the
    brain's device, with ``draws`` (the global batch's); recorded on the CPU:
    the loss, the error, the BatchNorm statistics, the normalizer state,
    Adam's count and moments, the parameters and the lr."""
    loss = float(brain.fit_batch(batch, 0, draws))
    params, stats = _gender_state(brain)
    opt = brain.state.opt_state["adam"]
    return {"loss": loss, "error": float(brain.metrics["error"]), "params": _cpu(params), "stats": _cpu(stats),
            "norm": [t.detach().clone().cpu() for t in brain.state.norm_state], "count": opt.count,
            "mu": _cpu(opt.mu), "nu": _cpu(opt.nu), "lr": brain.lr_annealing.lr}


def compare_gender_records(got: dict, want: dict, start: dict, what: str = "got and want") -> dict:
    """Two :func:`gender_record`s of one micro-batch from the same ``start``
    parameters: the loss (LOSS_RTOL), the error (equal), the statistics and
    the normalizer as :func:`compare_records` holds them, Adam's count, its
    moments within SEX_MOMENT_RTOL and the parameters by :func:`step_gaps`.
    -> the gaps; raises AssertionError listing every check beyond its tolerance."""
    failures: list = []
    g, w = got["loss"], want["loss"]
    if not abs(g - w) <= LOSS_RTOL * abs(w) + 1e-7:
        failures.append(f"loss {g} against {w} beyond rtol {LOSS_RTOL}")
    if got["error"] != want["error"]:
        failures.append(f"error {got['error']} against {want['error']}")
    report = {"loss_rel_gap": abs(g - w) / max(abs(w), 1e-30), "errors": (got["error"], want["error"]),
              "stats_rel_gap": tensor_gaps(got["stats"], want["stats"], STATS_RTOL, "BatchNorm statistics",
                                           failures)}
    for name, a, b in zip(("count", "glob_mean", "glob_std"), got["norm"], want["norm"]):
        gap = float(np.abs(_np(a) - _np(b)).max())
        report["norm_max_abs_gap"] = max(report.get("norm_max_abs_gap", 0.0), gap)
        if not np.allclose(_np(a), _np(b), rtol=NORM_RTOL, atol=NORM_RTOL):
            failures.append(f"normalizer {name} differs by {gap}")
    if got["count"] != want["count"] or want["count"] != 1:
        raise AssertionError(f"{what}: Adam counts {got['count']}, {want['count']}")
    report["mu_rel_gap"] = tensor_gaps(got["mu"], want["mu"], SEX_MOMENT_RTOL, "Adam mu", failures)
    report["nu_rel_gap"] = tensor_gaps(got["nu"], want["nu"], SEX_MOMENT_RTOL, "Adam nu", failures)
    floor = noise_floor(want["mu"])
    sign_only, worst = 0, 0.0
    for k in want["params"]:
        n, gap = step_gaps(k, got["params"][k], want["params"][k], start[k], (got["mu"][k], want["mu"][k]),
                           (got["nu"][k], want["nu"][k]), 1, want["lr"], floor, failures)
        sign_only, worst = sign_only + n, max(worst, gap)
    report.update(param_max_abs_gap=worst, sign_only=sign_only,
                  params=sum(_np(p).size for p in want["params"].values()))
    if failures:
        raise AssertionError(f"{what} disagree ({len(failures)} checks): " + "; ".join(failures)
                             + f"; report {report}")
    return report


def compare_gender_step(make_brain: Callable, batch: tuple, device: str = "cuda") -> dict:
    """One ``GenderBrain`` micro-batch, ``(wavs, lens, labels)``, on ``device``
    and on the CPU: ``make_brain(device)`` builds each (the same seeded
    weights, accumulation 1), the CPU brain's draws feed both. -> the gaps;
    raises AssertionError listing every check beyond its tolerance."""
    card, cpu = make_brain(device), make_brain("cpu")
    start, _ = _gender_state(cpu)
    got_start, _ = _gender_state(card)
    if any(not torch.equal(got_start[k].cpu(), v) for k, v in start.items()):
        raise AssertionError("the card and CPU brains start from different weights")
    start = _cpu(start)
    draws = cpu.draw(batch[0].shape)
    got = gender_record(card, tuple(x.to(device) for x in batch), draws)
    want = gender_record(cpu, tuple(x.cpu() for x in batch), draws)
    return compare_gender_records(got, want, start, "card and CPU")
