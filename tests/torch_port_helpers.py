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
