"""Mutual-information privacy estimators (k-NN MI between features and labels).

Counterpart of ``speech_anonymization_tpu/losses/mi.py`` (the reference's
utils/ClusterMI.py, utils/GroupSamplingMI.py and utils/mi_loss.py): one
(N, N) cosine-distance matrix per draw, the class-balanced draws' indices
taken on the host from numpy's ``default_rng(seed)`` exactly as the JAX
package takes them (so both packages score the same subsets), and all draws
evaluated as one batched computation. ``MILoss`` returns the mean over draws.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_BIG = 10e6  # the distance given to other-class pairs when the anchor is chosen


def cosine_distance_matrix(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., N, D) -> (..., N, N) pairwise cosine distances ``1 - cos(x_i, x_j)``,
    with an exact zero diagonal."""
    norms = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    xn = x / torch.clamp(norms, min=eps)
    d = 1.0 - torch.clamp(xn @ xn.transpose(-1, -2), -1.0, 1.0)
    return d - torch.diag_embed(torch.diagonal(d, dim1=-2, dim2=-1))


class ClusterMI:
    """k-NN MI estimator between continuous X (N, D) and labels y (N,), in bits:
    ``digamma(N) - <digamma(N_c)>_c + digamma(k) - <digamma(m_i)>_i``. The
    anchor distance is the k-th same-class neighbour's (self included at 0,
    so the (k+1)-th smallest); ``m_i`` counts all points within it, less self."""

    def __init__(self, n_classes: int = 2, k: int = 3):
        if n_classes < 2:
            raise ValueError("ClusterMI needs at least two classes")
        self.k = k
        self.n_classes = n_classes

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return self._mutual_information(x, y)

    def _mutual_information(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Batched over any leading axes: x (..., N, D), y (..., N) -> MI (...)."""
        digamma = torch.special.digamma
        n = x.shape[-2]
        y = y.to(torch.int32)
        f32 = dict(dtype=torch.float32, device=x.device)
        n_dig = digamma(torch.tensor(float(n), **f32))
        counts = torch.stack([torch.sum(y == c, dim=-1) for c in range(self.n_classes)], -1).to(torch.float32)
        avg_nx = torch.sum(counts / n * digamma(counts), dim=-1)

        dists = cosine_distance_matrix(x)
        same = y[..., None, :] == y[..., :, None]
        dists_same = torch.where(same, dists, torch.tensor(_BIG, **f32))
        anchor = -torch.topk(-dists_same, self.k + 1, dim=-1).values[..., -1]
        m_i = torch.sum(dists <= anchor[..., None], dim=-1) - 1
        avg_mi = torch.mean(digamma(torch.clamp(m_i.to(torch.float32), min=1.0)), dim=-1)
        mi = n_dig - avg_nx + digamma(torch.tensor(float(self.k), **f32)) - avg_mi
        return mi / math.log(2.0)


class GroupSamplingMI(ClusterMI):
    """MI over ``n_iterations`` class-balanced draws of ``n_samples`` per group.
    -> (per-draw MI, mean, std with ddof 1)."""

    def __init__(self, n_samples: int = 1, n_classes: int = 2, n_iterations: int = 100, k: int = 3):
        super().__init__(n_classes, k)
        self.n_samples = n_samples
        self.n_iterations = n_iterations

    def __call__(self, x: torch.Tensor, y, groups, seed: int = 0):
        groups = np.asarray(groups)
        per_group = {g: np.flatnonzero(groups == g) for g in np.unique(groups)}
        sample_size = min(self.n_samples, min(len(v) for v in per_group.values()))
        rng = np.random.default_rng(seed)
        idx = np.stack([
            np.concatenate([rng.choice(v, sample_size, replace=False) for v in per_group.values()])
            for _ in range(self.n_iterations)
        ])  # (n_iter, n_groups * sample_size)
        x = torch.as_tensor(x)
        idx_t = torch.from_numpy(idx).to(x.device)
        mi = self._mutual_information(x[idx_t], torch.as_tensor(np.asarray(y), device=x.device)[idx_t])
        return mi, torch.mean(mi), torch.std(mi, correction=1)


class MILoss:
    """The reference's ``loss_mutual_information`` facade on a class-balanced
    minibatch; returns the mean MI over the draws."""

    def __call__(self, x, y, batch_groups, batch_size: int, n_classes: int = 2,
                 samples_set_per_batch: int = 1, seed: int = 0):
        x = torch.as_tensor(x)
        gs = GroupSamplingMI(n_samples=batch_size // samples_set_per_batch, n_classes=n_classes)
        _, mean, _ = gs(x.reshape(x.shape[0], -1), y, batch_groups, seed=seed)
        return mean
