"""The port's waveform augmentations (``ops/augment.py``) against the JAX
package's ``ops/augment.py``, on the JAX package's own random draws (its
``jax.random.split`` chain reproduced in ``tests/torch_port_helpers.py``):
``add_noise`` (EnvCorrupt), ``speed_perturb``, ``drop_freq``, ``drop_chunk``
and ``TimeDomainSpecAugment``'s composition; then the port's own draws (their
ranges, and one seed drawing alike); and ``classification_error`` with and
without a lengths mask.

Tolerances: ``drop_chunk`` and the speed change's lengths exactly; the speed
change's samples within 1e-6 (the same gathers and products; the lengths'
mask is exact); ``add_noise`` within 1e-6 (the SNR's ``10 ** (snr / 10)``
and the power sums may differ by an f32 ulp); ``drop_freq`` within 1e-6 on
waveforms of amplitude ~0.3 (two 101-tap convolutions summed in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_anonymization_tpu.losses import classification_error as jax_classification_error
from speech_anonymization_tpu.ops import augment as jax_augment
from speech_anonymization_tpu_torch.losses import classification_error
from speech_anonymization_tpu_torch.ops import augment
from tests.torch_port_helpers import jax_noise_draws, jax_time_domain_draws, t

B, N = 4, 8000
LENS = np.array([1.0, 0.8, 0.55, 0.3], np.float32)
ATOL = 1e-6


def _wavs(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    tt = np.arange(N) / 16000.0
    f0 = rng.uniform(90, 260, (B, 1))
    return (0.2 * np.sin(2 * np.pi * f0 * tt) + 0.05 * rng.standard_normal((B, N))).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_add_noise_on_jax_draws(seed):
    key = jax.random.PRNGKey(seed)
    wavs = _wavs(seed)
    want = jax_augment.add_noise(key, jnp.asarray(wavs), jnp.asarray(LENS), 0.0, 15.0)
    got = augment.add_noise(t(wavs), t(LENS), jax_noise_draws(key, B, N, 0.0, 15.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    # the padding stays untouched
    pad = np.arange(N)[None] >= np.round(LENS * N)[:, None]
    assert np.array_equal(got.numpy()[pad], wavs[pad])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_speed_perturb_on_jax_draws(seed):
    key = jax.random.PRNGKey(seed)
    wavs = _wavs(seed)
    want, want_lens = jax_augment.speed_perturb(key, jnp.asarray(wavs), jnp.asarray(LENS), (95, 100, 105))
    pick = t(jax.random.randint(key, (B,), 0, 3)).long()
    got, got_lens = augment.speed_perturb(t(wavs), t(LENS), pick, (95, 100, 105))
    assert np.array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drop_chunk_on_jax_draws(seed):
    key = jax.random.PRNGKey(seed)
    wavs = _wavs(seed)
    want = jax_augment.drop_chunk(key, jnp.asarray(wavs), jnp.asarray(LENS))
    keys = jax.random.split(key, 3)
    draws = augment.ChunkDraws(t(jax.random.randint(keys[0], (B, 1), 0, 4)).long(),
                               t(jax.random.randint(keys[1], (B, 3), 0, N - 2000)).long(),
                               t(jax.random.randint(keys[2], (B, 3), 1000, 2000)).long())
    got = augment.drop_chunk(t(wavs), draws)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_drop_freq_on_jax_draws(seed):
    key = jax.random.PRNGKey(seed)
    wavs = _wavs(seed)
    want = jax_augment.drop_freq(key, jnp.asarray(wavs))
    k_count, k_freq = jax.random.split(key)
    draws = augment.FreqDraws(t(jax.random.randint(k_count, (B,), 0, 3)).long(),
                              t(jax.random.uniform(k_freq, (B, 2), minval=0.05, maxval=0.45)))
    got = augment.drop_freq(t(wavs), draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_notch_kernels_follow_jnp_convolve():
    """Two notches combined: the kernel flips in ``jnp.convolve``; a
    non-symmetric first factor would show a missing flip, so the combination
    is checked on the Hamming window's exact symmetry too."""
    draws = augment.FreqDraws(torch.tensor([2, 1, 0]), torch.tensor([[0.1, 0.3], [0.2, 0.4], [0.3, 0.1]]))
    k = augment.notch_kernels(draws)
    assert torch.equal(k[2], (torch.arange(101) == 50).float())
    window = torch.hamming_window(101, periodic=False, dtype=torch.float32)
    # the symmetric window, within two f32 ulps below 1 (the cosines round apart)
    np.testing.assert_allclose(window.numpy(), np.asarray(jnp.hamming(101)), rtol=0, atol=2.4e-7)
    assert torch.allclose(k, k.flip(1), atol=1e-7)


@pytest.mark.parametrize("seed", [0, 5])
def test_env_corrupt_and_time_domain_specaugment_on_jax_draws(seed):
    """The classes' calls, composed as the gender recipe composes them."""
    k_env, k_aug = jax.random.split(jax.random.PRNGKey(seed))
    wavs = _wavs(seed)
    jw, jl = jnp.asarray(wavs), jnp.asarray(LENS)
    noisy = jax_augment.EnvCorrupt(noise_snr_low=0.0, noise_snr_high=15.0)(k_env, jw, jl)
    want, want_lens = jax_augment.TimeDomainSpecAugment(speeds=[95, 100, 105])(
        k_aug, jnp.concatenate([jw, noisy]), jnp.concatenate([jl, jl]))

    env = augment.EnvCorrupt(noise_snr_low=0.0, noise_snr_high=15.0)
    p_noisy = env(t(wavs), t(LENS), jax_noise_draws(k_env, B, N))
    np.testing.assert_allclose(p_noisy.numpy(), np.asarray(noisy), rtol=0, atol=ATOL)
    got, got_lens = augment.TimeDomainSpecAugment(speeds=[95, 100, 105])(
        torch.cat([t(wavs), p_noisy]), torch.cat([t(LENS), t(LENS)]), jax_time_domain_draws(k_aug, 2 * B, N))
    assert np.array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2 * ATOL)


def test_port_draws_ranges_and_seeding():
    aug = augment.TimeDomainSpecAugment()
    env = augment.EnvCorrupt(noise_snr_low=2.0, noise_snr_high=9.0)
    shape = (64, N)
    d = aug.draw(shape, torch.Generator().manual_seed(3))
    assert d.speed.min() >= 0 and d.speed.max() <= 2 and len(d.speed.unique()) == 3
    assert d.freq.count.min() >= 0 and d.freq.count.max() <= 2
    assert float(d.freq.centers.min()) >= 0.05 and float(d.freq.centers.max()) < 0.45
    assert d.chunk.count.shape == (64, 1) and d.chunk.count.max() <= 3
    assert d.chunk.starts.min() >= 0 and d.chunk.starts.max() < N - 2000
    assert d.chunk.lengths.min() >= 1000 and d.chunk.lengths.max() < 2000
    e = env.draw(shape, torch.Generator().manual_seed(3))
    assert float(e.snr.min()) >= 2.0 and float(e.snr.max()) < 9.0 and e.noise.shape == shape
    assert abs(float(e.noise.std()) - 1.0) < 0.01
    again = aug.draw(shape, torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(torch.utils._pytree.tree_leaves(d),
                                                 torch.utils._pytree.tree_leaves(again)))
    # a noise bank: the clips are picked, tiled and cut to the length
    bank = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    banked = augment.EnvCorrupt(noise_bank=bank)
    nd = banked.draw((2, 10), torch.Generator().manual_seed(0))
    assert nd.noise is None and nd.pick.shape == (2,) and nd.pick.max() < 3
    out = banked(torch.ones(2, 10), torch.ones(2), nd)
    assert out.shape == (2, 10) and torch.isfinite(out).all()


def test_speed_perturb_class_and_lengths():
    sp = augment.SpeedPerturb(speeds=(90, 110))
    wavs, lens = torch.ones(2, 1000), torch.tensor([1.0, 0.5])
    out, new = sp(wavs, lens, torch.tensor([0, 1]))
    np.testing.assert_allclose(new.numpy(), [1.0, 0.5 / 1.1], rtol=1e-6)
    assert out[1, :round(1000 * 0.5 / 1.1)].eq(1).all() and out[1, 460:].eq(0).all()


@pytest.mark.parametrize("shape,lengths", [((6, 2), None), ((5, 1, 3), None), ((3, 7, 4), None),
                                           ((3, 7, 4), [1.0, 0.5, 0.3])])
def test_classification_error_matches_jax(shape, lengths):
    rng = np.random.default_rng(len(shape) + (lengths is not None))
    lp = rng.standard_normal(shape).astype(np.float32)
    tshape = shape[:1] if len(shape) == 2 or shape[1] == 1 else shape[:2]
    targets = rng.integers(0, shape[-1], tshape)
    lens = None if lengths is None else np.asarray(lengths, np.float32)
    want = jax_classification_error(jnp.asarray(lp), jnp.asarray(targets),
                                    None if lens is None else jnp.asarray(lens))
    got = classification_error(t(lp), t(targets), None if lens is None else t(lens))
    assert float(got) == pytest.approx(float(want), abs=1e-7)
