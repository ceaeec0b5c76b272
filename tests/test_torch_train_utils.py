"""The port's training utilities against the JAX package (CPU): Noam and
ReduceLROnPlateau (values over 50 steps and through ``state_dict``), the
global-norm clip, the functional Adam and SGD against optax, the
accumulation buffer, and SpecAugment (with JAX's draws equal to JAX's
output; reproducible from its own generator)."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_anonymization_tpu.ops.specaugment import SpecAugment as JaxSpecAugment
from speech_anonymization_tpu.ops.specaugment import time_warp as jax_time_warp
from speech_anonymization_tpu.train.schedulers import NoamScheduler as JaxNoam
from speech_anonymization_tpu.train.schedulers import ReduceLROnPlateau as JaxPlateau
from speech_anonymization_tpu.train.state import (
    adam_like_reference as jax_adam,
    clip_by_global_norm as jax_clip,
    sgd_like_reference as jax_sgd,
)
from speech_anonymization_tpu_torch.ops.specaugment import SpecAugment, time_warp
from speech_anonymization_tpu_torch.recipes.anonymizer import AnonymizerTrainer
from speech_anonymization_tpu_torch.train import (
    NoamScheduler,
    ReduceLROnPlateau,
    TrainState,
    adam_like_reference,
    apply_updates,
    clip_by_global_norm,
    sgd_like_reference,
)
from tests.torch_port_helpers import t
from tests.torch_train_helpers import jax_draws

SHAPES = {"w": (6, 5), "b": (5,), "z": (3,)}


def _grads(rng, scale=1.0, zero=()):
    return {k: (np.zeros(s) if k in zero else scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("kw", [{}, {"lr_initial": 2.0, "n_warmup_steps": 10, "model_size": 256}])
def test_noam_matches_jax_and_resumes(kw):
    ours, ref = NoamScheduler(**kw), JaxNoam(**kw)
    for _ in range(25):
        assert ours() == ref()
        assert ours.current_lr == ref.current_lr
    resumed = NoamScheduler(**kw)
    resumed.load_state_dict(ours.state_dict())
    for _ in range(25):
        assert resumed() == ref() == ours()
    assert ours.lr_at(7) == ref.lr_at(7) and ours.lr_at(0) == ref.lr_at(0)


def test_plateau_matches_jax_and_resumes():
    losses = np.random.default_rng(0).uniform(0.5, 1.5, 50)
    losses[10:20] = 0.4  # a stall: no improvement for 9 epochs
    ours, ref = ReduceLROnPlateau(), JaxPlateau()
    for epoch, loss in enumerate(losses[:25]):
        assert ours(epoch, float(loss)) == ref(epoch, float(loss))
    resumed = ReduceLROnPlateau()
    resumed.load_state_dict(ours.state_dict())
    for epoch, loss in enumerate(losses[25:], start=25):
        want = ref(epoch, float(loss))
        assert ours(epoch, float(loss)) == want == resumed(epoch, float(loss))
    assert ref.lr < 1e-3  # the schedule halved at least once


@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_clip_by_global_norm_matches_jax(scale):
    g = _grads(np.random.default_rng(1), scale)
    want, want_norm = jax_clip({k: jnp.asarray(v) for k, v in g.items()}, 5.0)
    got, norm = clip_by_global_norm({k: t(v) for k, v in g.items()}, 5.0)
    np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-12)
    assert (float(norm) > 5.0) == (scale == 10.0)


def _optax_run(opt, grads_seq, lr):
    params = {k: jnp.zeros(s) for k, s in SHAPES.items()}
    state = opt.init(params)
    ups = []
    for g in grads_seq:
        state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        u, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        ups.append({k: np.asarray(v) for k, v in u.items()})
    return ups, state


def test_adam_matches_optax():
    """Five updates at lr 1e-3; "z" gets zero gradients (a masked group):
    its moments stay zero but the count advances for it too (trap a)."""
    rng = np.random.default_rng(2)
    seq = [_grads(rng, zero=("z",)) for _ in range(5)]
    want_ups, want = _optax_run(jax_adam(), seq, 1e-3)
    opt = adam_like_reference()
    params = {k: torch.zeros(s) for k, s in SHAPES.items()}
    state = opt.init(params)
    for g, wu in zip(seq, want_ups):
        ups, state = opt.update({k: t(v) for k, v in g.items()}, state, 1e-3)
        for k in SHAPES:
            np.testing.assert_allclose(ups[k].numpy(), wu[k], rtol=1e-5, atol=1e-12)
    inner = want.inner_state[0]
    assert state.count == int(inner.count) == 5
    for k in SHAPES:
        np.testing.assert_allclose(state.mu[k].numpy(), np.asarray(inner.mu[k]), rtol=1e-6)
        np.testing.assert_allclose(state.nu[k].numpy(), np.asarray(inner.nu[k]), rtol=1e-6)
    assert not state.mu["z"].any() and not ups["z"].any()


def test_sgd_matches_optax():
    rng = np.random.default_rng(3)
    seq = [_grads(rng) for _ in range(4)]
    want_ups, want = _optax_run(jax_sgd(), seq, 2.5e-5)
    opt = sgd_like_reference()
    state = opt.init({k: torch.zeros(s) for k, s in SHAPES.items()})
    for g, wu in zip(seq, want_ups):
        ups, state = opt.update({k: t(v) for k, v in g.items()}, state, 2.5e-5)
        for k in SHAPES:
            np.testing.assert_allclose(ups[k].numpy(), wu[k], rtol=1e-6, atol=1e-14)


def test_apply_updates_keeps_params_when_told():
    params = {k: torch.ones(s) for k, s in SHAPES.items()}
    ups = {k: torch.full(s, 0.5) for k, s in SHAPES.items()}
    apply_updates(params, ups, keep=torch.tensor(False))
    assert all(bool((p == 1).all()) for p in params.values())
    apply_updates(params, ups, keep=torch.tensor(True))
    assert all(bool((p == 1.5).all()) for p in params.values())


def test_accumulation_buffer_counts_and_resets():
    state = TrainState.create({k: torch.zeros(s) for k, s in SHAPES.items()})
    g = {k: torch.full(s, 3.0) for k, s in SHAPES.items()}
    assert [state.accumulate(g, 3) for _ in range(3)] == [False, False, True]
    assert all(torch.allclose(a, torch.full_like(a, 3.0)) for a in state.accum_grads.values())
    state.reset_accumulation()
    assert state.accum_count == 0
    assert not any(a.any() for a in state.accum_grads.values())


def test_new_modules_default_to_the_card():
    from speech_anonymization_tpu_torch import models

    for cls in (AnonymizerTrainer, models.FullyConnectedAutoencoder,
                models.DummyFullyConnectedAutoencoder, models.CycleGANGenerator,
                models.ConvReconstruction, models.SexClassifier1D, models.FullyConnSexClassifier,
                models.DummyFullyConnSexClassifier):
        assert inspect.signature(cls.__init__).parameters["device"].default == "cuda", cls


AUG_CASES = {
    "default": {},
    "zero_fill": {"replace_with_zero": True},
    "no_warp": {"time_warp": False},
    "masks_only_freq": {"time_warp": False, "time_mask": False},
}


@pytest.mark.parametrize("case", list(AUG_CASES))
@pytest.mark.parametrize("t_frames", [72, 11])
def test_specaugment_with_jax_draws_matches_jax(case, t_frames):
    """T 11 is too short to warp (<= 2 * window + 2): only the masks apply."""
    kw = AUG_CASES[case]
    feats = np.random.default_rng(4).standard_normal((3, t_frames, 80)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jaug = JaxSpecAugment(**kw)
    want = np.asarray(jax.jit(jaug.__call__)(key, jnp.asarray(feats)))
    got = SpecAugment(**kw)(t(feats), jax_draws(key, feats.shape, jaug))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert not np.array_equal(want, feats)


@pytest.mark.parametrize("centre,shift", [(20, 5), (30, -5), (6, 0), (60, 3)])
def test_time_warp_matches_jax(centre, shift, monkeypatch):
    """The remap at a given centre and shift: JAX's ``time_warp`` with its two
    ``randint`` draws replaced by these values."""
    feats = np.random.default_rng(5).standard_normal((2, 72, 8)).astype(np.float32)
    vals = iter([centre, shift])
    monkeypatch.setattr(jax.random, "randint", lambda *a, **k: jnp.asarray(next(vals)))
    want = np.asarray(jax_time_warp(jax.random.PRNGKey(0), jnp.asarray(feats), 5))
    np.testing.assert_allclose(time_warp(t(feats), centre, shift).numpy(), want, rtol=1e-6, atol=1e-6)


def test_specaugment_draws_come_from_its_generator():
    feats = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 72, 80)).astype(np.float32))
    out = [SpecAugment(generator=torch.Generator().manual_seed(s))(feats) for s in (1, 1, 2)]
    assert torch.equal(out[0], out[1]) and not torch.equal(out[0], out[2])
    aug = SpecAugment()
    d1 = aug.draw(feats.shape, torch.Generator().manual_seed(3))
    d2 = aug.draw(feats.shape, torch.Generator().manual_seed(3))
    assert d1.warp == d2.warp and all(torch.equal(a, b) for a, b in zip(d1.freq + d1.time, d2.freq + d2.time))
    widths, starts = d1.time
    assert int(widths.max()) <= 40 and bool((starts + widths <= 72).all())
    c, w = d1.warp
    assert 6 <= c < 66 and -5 <= w <= 5
