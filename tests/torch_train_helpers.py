"""Shared pieces of the port's training parity tests against the JAX package:
the JAX package's SpecAugment draws for a key, a JAX recipe and a port
trainer on the same weights, and the comparisons with their tolerances."""

from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

from speech_anonymization_tpu.ops.fbank import Fbank as JaxFbank
from speech_anonymization_tpu.ops.normalization import InputNormalizer as JaxNormalizer
from speech_anonymization_tpu.ops.specaugment import SpecAugment as JaxSpecAugment
from speech_anonymization_tpu.recipes.anonymizer import SexAnonymizationBrain
from speech_anonymization_tpu.train.schedulers import NoamScheduler as JaxNoam
from speech_anonymization_tpu_torch.ops.fbank import Fbank
from speech_anonymization_tpu_torch.ops.normalization import InputNormalizer
from speech_anonymization_tpu_torch.ops.specaugment import SpecAugment, SpecAugmentDraws
from speech_anonymization_tpu_torch.recipes.anonymizer import AnonymizerTrainer
from speech_anonymization_tpu_torch.tools.train_parity import (
    LOSS_RTOL,
    SEX_GRAD_RTOL,
    SEX_MOMENT_RTOL,
    SEX_RTOL,
    STATS_RTOL,
    noise_floor,
    step_gaps,
    tensor_gaps,
)
from speech_anonymization_tpu_torch.train.schedulers import NoamScheduler
from speech_anonymization_tpu_torch.utils.convert import anonymizer_state_dict, load_numpy_state
from tests.torch_port_helpers import perturbed, to_numpy

# The tolerances, the noise floor and the Adam step's check are the card
# parity's (tools/train_parity.py states each and why). LR: Noam's lr here.
LR = 1e-3


def jax_draws(key, shape, aug: JaxSpecAugment) -> SpecAugmentDraws:
    """The draws ``JaxSpecAugment.__call__(key, feats)`` makes, for the port."""
    b, t, d = shape
    k_warp, k_f, k_t = jax.random.split(key, 3)
    warp = None
    win = aug.time_warp_window
    if aug.do_time_warp and t > 2 * win + 2:
        k_c, k_w = jax.random.split(k_warp)
        warp = (int(jax.random.randint(k_c, (), win + 1, t - win - 1)),
                int(jax.random.randint(k_w, (), -win, win + 1)))

    def masks(key, n, width, size):
        k_w, k_s = jax.random.split(key)
        widths = jax.random.randint(k_w, (b, n), 0, width + 1)
        starts = jax.random.randint(k_s, (b, n), 0, jnp.maximum(size - widths, 1))
        return torch.from_numpy(np.array(widths)).long(), torch.from_numpy(np.array(starts)).long()

    return SpecAugmentDraws(warp,
                            masks(k_f, aug.n_freq_mask, aug.freq_mask_width, d) if aug.do_freq_mask else None,
                            masks(k_t, aug.n_time_mask, aug.time_mask_width, t) if aug.do_time_mask else None)


def hparams(model_type, schedule, accum, augment: bool, port: bool, **extra) -> dict:
    aug_kw = dict(time_warp=True, time_warp_window=5, freq_mask=True, n_freq_mask=2, time_mask=True,
                  n_time_mask=2, replace_with_zero=False, freq_mask_width=30, time_mask_width=40)
    if port:
        objs = {"compute_features": Fbank(device="cpu"), "normalize": InputNormalizer(dim=80),
                "augmentation": SpecAugment(**aug_kw) if augment else None,
                "noam_annealing": NoamScheduler(LR, 1, 1)}
    else:
        objs = {"compute_features": JaxFbank(), "normalize": JaxNormalizer(dim=80),
                "augmentation": JaxSpecAugment(**aug_kw) if augment else None,
                "noam_annealing": JaxNoam(LR, 1, 1), "train_logger": None, "epoch_counter": None}
    # Noam at lr_initial 1e-3, one warmup step, model size 1: lr 1e-3, then
    # 1e-3 / sqrt(n): an lr at which an Adam step shows in f32 weights
    return {"model_type": model_type, "adversarial_schedule": schedule,
            "gradient_accumulation": accum, "gradient_clipping": 5.0, **objs, **extra}


class Pair:
    """The JAX recipe and the port's trainer from the same (perturbed) weights.

    The JAX brain compiles its update once; :meth:`reset` restores both
    sides to the start, so one brain serves several tests.
    """

    def __init__(self, model_type, schedule, accum, batch, augment=False, jax_kw=None,
                 port_kw=None, seed=3, **extra):
        self.brain = SexAnonymizationBrain(hparams(model_type, schedule, accum, augment, False, **extra),
                                           **(jax_kw or {}))
        # flax's eager init compiles op by op (~10 s for the CycleGAN): jit it
        object.__setattr__(self.brain.model, "init",
                           jax.jit(self.brain.model.init, static_argnames="train"))
        self.brain.init_state(tuple(jnp.asarray(x) for x in batch[:3]))
        state = self.brain.state
        v = perturbed({"params": state.params, **state.model_state}, seed)
        self.variables = v
        self.start = to_numpy({"params": v["params"], "model_state": {k: w for k, w in v.items()
                                                                         if k != "params"},
                               "norm_state": state.norm_state, "opt_state": state.opt_state})
        self.model_type, self.schedule, self.accum, self.augment = model_type, schedule, accum, augment
        self.extra, self.port_kw = extra, port_kw or {}
        self._spy()
        self.reset()

    def _spy(self):
        orig = self.brain._train_step
        self.captured = {}

        def spy(state, db, lr, epoch, weights, train_mode, key):
            self.captured.update(lr=float(lr), weights=np.asarray(weights), key=key)
            new_state, metrics = orig(state, db, lr, epoch, weights, train_mode, key)
            self.captured["metrics"] = metrics
            return new_state, metrics

        self.brain._train_step = spy

    def reset(self):
        s, brain = self.start, self.brain
        brain.state = brain.state.replace(
            step=jnp.zeros((), jnp.int32), params=jax.tree_util.tree_map(jnp.asarray, s["params"]),
            model_state=jax.tree_util.tree_map(jnp.asarray, s["model_state"]),
            norm_state=jax.tree_util.tree_map(jnp.asarray, s["norm_state"]),
            opt_state=jax.tree_util.tree_map(jnp.asarray, s["opt_state"]),
            accum_grads=jax.tree_util.tree_map(jnp.zeros_like, s["params"]),
            accum_count=jnp.zeros((), jnp.int32))
        brain._host_accum = 0
        brain._rng = jax.random.PRNGKey(0)
        brain.noam.load_state_dict({"n_steps": 0, "current_lr": LR})
        self.trainer = AnonymizerTrainer(
            hparams(self.model_type, self.schedule, self.accum, self.augment, True, **self.extra),
            device="cpu", **self.port_kw)
        load_numpy_state(self.trainer.model, anonymizer_state_dict(self.variables))

    def fit(self, batch, epoch: int, port_batch=None):
        """One micro-batch on both sides (the port takes JAX's augmentation
        draws); -> (JAX metrics, port metrics as floats)."""
        ns = types.SimpleNamespace(sig=(batch[0], batch[1]), gender=batch[2])
        if len(batch) > 3:
            ns.tokens_bos = (batch[3], None)
        self.brain.fit_batch(ns, epoch)
        want = {k: float(v) for k, v in self.captured["metrics"].items()}
        draws = None
        if self.augment:
            aug = self.brain.augmentation
            t = -(-(1 + batch[0].shape[1] // 160) // self.trainer.pad_multiple) * self.trainer.pad_multiple
            draws = jax_draws(self.captured["key"], (batch[0].shape[0], t, 80), aug)
        tr = self.trainer
        will_step = tr.state.accum_count + 1 >= tr.grad_accum
        tb = tuple(torch.from_numpy(np.array(x)) for x in (port_batch or batch))
        tr.fit_batch(tb, epoch, draws=draws)
        got = {k: v if isinstance(v, bool) else float(v) for k, v in tr.metrics.items()}
        assert got["stepped"] == bool(want["stepped"]) == will_step
        assert abs(tr.noam.current_lr - self.captured["lr"]) <= 1e-6 * self.captured["lr"]
        return want, got


def assert_losses(want: dict, got: dict, sex_rtol: float = SEX_RTOL):
    for k in ("recon_loss", "utility_loss", "loss"):
        rtol = sex_rtol if k == "loss" else LOSS_RTOL
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-7, err_msg=k)
    for k in ("sex_loss", "confusion_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=sex_rtol, atol=1e-7, err_msg=k)


def jax_tree(tree) -> dict:
    """A params-shaped flax tree (grads, moments) -> the port's names."""
    return anonymizer_state_dict({"params": to_numpy(tree)})


def assert_tensors(got: dict, want: dict, rtol: float, what: str):
    """Per tensor: |got - want| <= rtol * max|want| (+ the noise floor)."""
    failures: list = []
    tensor_gaps(got, want, rtol, what, failures)
    assert not failures, failures


def jax_params(pair) -> dict:
    """The JAX brain's parameters and BatchNorm statistics, by the port's names."""
    s = pair.brain.state
    return anonymizer_state_dict({"params": to_numpy(s.params), **to_numpy(s.model_state)})


def bn_stats(module) -> dict:
    return {k: v for k, v in module.state_dict().items() if k.endswith(("running_mean", "running_var"))}


def check_micro_batch(pair, want_metrics, got_metrics, check_accum: bool, grad_rtol=SEX_GRAD_RTOL):
    assert_losses(want_metrics, got_metrics)
    s, want = pair.brain.state, jax_params(pair)
    tr = pair.trainer
    bn = bn_stats(tr.model)
    assert bn or pair.model_type == "endtoend"  # ConvReconstruction has no BatchNorm
    assert_tensors(bn, {k: want[k] for k in bn}, STATS_RTOL, "BatchNorm running stats")
    js, ps = to_numpy(s.norm_state), tr.state.norm_state
    assert float(ps.count) == float(js.count)
    np.testing.assert_allclose(ps.glob_mean.numpy(), js.glob_mean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ps.glob_std.numpy(), js.glob_std, rtol=1e-5, atol=1e-5)
    assert tr.state.accum_count == int(s.accum_count)
    if check_accum:
        assert_tensors(tr.state.accum_grads, jax_tree(s.accum_grads), grad_rtol, "accumulated grads")


def adam_state(pair, key):
    inner = pair.brain.state.opt_state[key].inner_state[0]
    return int(inner.count), jax_tree(inner.mu), jax_tree(inner.nu)


def check_update(pair, opt_key, start_params, lr, moment_rtol=SEX_MOMENT_RTOL):
    tr = pair.trainer
    count, mu, nu = adam_state(pair, opt_key)
    got = tr.state.opt_state[opt_key]
    assert got.count == count
    assert_tensors(got.mu, mu, moment_rtol, "Adam mu")
    assert_tensors(got.nu, nu, moment_rtol, "Adam nu")
    other = "clf" if opt_key == "gen" else "gen"
    assert tr.state.opt_state[other].count == adam_state(pair, other)[0]
    want = jax_params(pair)
    params = dict(tr.model.named_parameters())
    floor, failures, sign_only = noise_floor(mu), [], 0
    for k, p in params.items():
        sign_only += step_gaps(k, p, want[k], start_params[k], (got.mu[k], mu[k]), (got.nu[k], nu[k]),
                               count, lr, floor, failures)[0]
    assert not failures, failures
    total = sum(p.numel() for p in params.values())
    return sign_only, total
