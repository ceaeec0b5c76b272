"""Shared fixtures of the PyTorch port's parity tests: seeded numpy inputs and
flax variables with every normalization parameter moved off its init value.

Importing this module caps torch's intra-op threads at 1 in the process: the
suite runs several worker processes on one host, and each worker's torch
would otherwise start a thread per core."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)


def to_numpy(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def perturbed(variables, seed: int):
    """Flax variables (numpy) with norm scales/biases and BatchNorm stats randomised,
    so a swapped or misplaced parameter shows in the outputs."""
    rng = np.random.default_rng(seed)
    out = to_numpy(variables)

    def visit(node):
        for key, value in node.items():
            if isinstance(value, dict):
                visit(value)
            elif key == "scale":
                node[key] = (1.0 + 0.1 * rng.standard_normal(value.shape)).astype(np.float32)
            elif key == "bias":
                node[key] = (0.1 * rng.standard_normal(value.shape)).astype(np.float32)
            elif key == "mean":
                node[key] = (0.1 * rng.standard_normal(value.shape)).astype(np.float32)
            elif key == "var":
                node[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)

    visit(out)
    return out


def rand_wav(batch: int, n: int, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((batch, n)) * 0.1).astype(np.float32)


def t(x) -> torch.Tensor:
    """A writable CPU tensor copy of ``x``."""
    return torch.from_numpy(np.array(x))


def random_variables(init, *args, seed: int, **kwargs):
    """Flax variables of ``init(*args, **kwargs)``'s shapes, traced (not
    compiled: flax's init compiles its whole graph, seconds for a full model)
    and filled from ``seed``: weights ~ N(0, 0.1^2), then :func:`perturbed`'s
    norm parameters and statistics."""
    shapes = jax.eval_shape(functools.partial(init, **kwargs), *args)
    rng = np.random.default_rng(seed)
    filled = jax.tree_util.tree_map(
        lambda s: (0.1 * rng.standard_normal(s.shape)).astype(s.dtype), shapes)
    return perturbed(filled, seed)


def shape_init(cls):
    """``cls`` with an ``init`` that returns zeros of its variables' shapes,
    traced, not compiled. For a JAX loader whose template is overwritten
    from a checkpoint: the load is what is under test, not the init."""

    class ShapeInit(cls):
        def init(self, *args, **kwargs):
            shapes = jax.eval_shape(functools.partial(super().init, **kwargs), *args)
            return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)

    return ShapeInit


def jax_noise_draws(key, b: int, n: int, snr_low: float = 0.0, snr_high: float = 15.0):
    """The draws the JAX package's ``add_noise(key, ...)`` makes (white noise),
    as the port's ``NoiseDraws``: its key split into (snr, pick, noise)."""
    from speech_anonymization_tpu_torch.ops.augment import NoiseDraws

    k_snr, _, k_noise = jax.random.split(key, 3)
    snr = jax.random.uniform(k_snr, (b, 1), minval=snr_low, maxval=snr_high)
    return NoiseDraws(t(snr), t(jax.random.normal(k_noise, (b, n))), None)


def jax_time_domain_draws(key, b: int, n: int, n_speeds: int = 3):
    """The draws of the JAX package's ``TimeDomainSpecAugment()(key, ...)``
    (speed, drop_freq, drop_chunk at their defaults), as the port's
    ``TimeDomainDraws``, by the same ``jax.random.split`` chain."""
    from speech_anonymization_tpu_torch.ops.augment import ChunkDraws, FreqDraws, TimeDomainDraws

    k_speed, k_freq, k_chunk = jax.random.split(key, 3)
    speed = jax.random.randint(k_speed, (b,), 0, n_speeds)
    k_count, k_centre = jax.random.split(k_freq)
    freq = FreqDraws(t(jax.random.randint(k_count, (b,), 0, 3)).long(),
                     t(jax.random.uniform(k_centre, (b, 2), minval=0.05, maxval=0.45)))
    keys = jax.random.split(k_chunk, 3)
    chunk = ChunkDraws(t(jax.random.randint(keys[0], (b, 1), 0, 4)).long(),
                       t(jax.random.randint(keys[1], (b, 3), 0, jnp.maximum(n - 2000, 1))).long(),
                       t(jax.random.randint(keys[2], (b, 3), 1000, 2000)).long())
    return TimeDomainDraws(t(speed).long(), freq, chunk)


def jax_gender_draws(key, b: int, n: int, env: bool, aug: bool):
    """The draws of the JAX ``GenderBrain._forward`` on (b, n) waveforms with
    ``key``: ``env_corrupt`` from its first split, the augmentation (over 2b
    rows with ``env_corrupt``) from its second; as the port's ``GenderDraws``."""
    from speech_anonymization_tpu_torch.recipes.gender_classifier import GenderDraws

    k_env, k_aug = jax.random.split(key)
    rows = 2 * b if env else b
    return GenderDraws(jax_noise_draws(k_env, b, n) if env else None,
                       jax_time_domain_draws(k_aug, rows, n) if aug else None)
