"""Train state and the functional optimizers of the anonymizer's update.

Counterpart of ``speech_anonymization_tpu/train/state.py``:

  * :class:`TrainState`: the gradient-accumulation buffer (grads averaged
    over ``accum_steps`` micro-batches, the optimizer applied at the count;
    convae.yaml's ``gradient_accumulation: 3``), the optimizer states and the
    normalizer's. The parameters and BatchNorm statistics live in the model;
    the count lives on the host, so deciding whether a micro-batch steps
    reads nothing back from the device;
  * :func:`clip_by_global_norm` (``gradient_clipping: 5.0``; norm floor 1e-12);
  * :func:`guarded_step`: ``make_update_fn``'s update at the accumulation
    count (the gender recipe's): clip the buffer, and only where the norm and
    the loss are finite, step the parameters AND the optimizer state;
  * :func:`kept_step`: the anonymizer, ASR and LM recipes' update: clip, the
    optimizer's step (its state advances whatever the check says), the
    parameters kept where the norm or the loss is not finite;
  * :func:`adam_like_reference` (b1 0.9, b2 0.98, eps 1e-9) and
    :func:`sgd_like_reference` (nesterov momentum 0.99): optax's ``adam`` and
    ``sgd`` over an explicit state, keyed by parameter name. The lr is a
    plain float per update (Noam's), as optax's ``inject_hyperparams`` takes it.

The optimizers update EVERY parameter they are given, whatever its gradient:
optax applies a masked Adam to all leaves with zeroed gradients, so the
moments decay and the count advances for each (``torch.optim`` would skip a
parameter whose ``.grad`` is ``None``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

import numpy as np
import torch

Tensors = dict[str, torch.Tensor]


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element of every tensor (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def clip_by_global_norm(grads: Tensors, max_norm: float) -> tuple[Tensors, torch.Tensor]:
    """Scale ``grads`` by ``min(1, max_norm / max(norm, 1e-12))``; -> (clipped, norm)."""
    norm = global_norm(grads.values())
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: g * scale for k, g in grads.items()}, norm


def _f32(x: float) -> float:
    """A hyperparameter as optax's ``inject_hyperparams`` holds it: a float32."""
    return float(np.float32(x))


@dataclasses.dataclass
class AdamState:
    count: int  # updates applied (every update advances it, finite or not)
    mu: Tensors
    nu: Tensors


class Adam:
    """optax.adam: the moments, bias correction by ``1 - b**count``,
    ``mu_hat / (sqrt(nu_hat) + eps)``, scaled by ``-lr``."""

    def __init__(self, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.98, eps: float = 1e-9):
        self.lr, self.b1, self.b2, self.eps = lr, _f32(b1), _f32(b2), _f32(eps)

    def init(self, params: Tensors) -> AdamState:
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
        return AdamState(0, zeros(), zeros())

    @torch.no_grad()
    def update(self, grads: Tensors, state: AdamState, lr: float | None = None
               ) -> tuple[Tensors, AdamState]:
        """-> (updates to add to the parameters, the new state)."""
        lr = _f32(self.lr if lr is None else lr)
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        mu = {k: _f32(1 - b1) * g + b1 * state.mu[k] for k, g in grads.items()}
        nu = {k: _f32(1 - b2) * (g * g) + b2 * state.nu[k] for k, g in grads.items()}
        # 1 - b**count in float32, as optax computes it
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        updates = {k: (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps) * -lr for k in grads}
        return updates, AdamState(count, mu, nu)


@dataclasses.dataclass
class SGDState:
    trace: Tensors


class SGD:
    """optax.sgd with (nesterov) momentum: ``trace = g + m * trace``, the
    update ``g + m * trace`` (nesterov) or ``trace``, scaled by ``-lr``."""

    def __init__(self, lr: float = 2.5e-5, momentum: float = 0.99, nesterov: bool = True):
        self.lr, self.momentum, self.nesterov = lr, _f32(momentum), nesterov

    def init(self, params: Tensors) -> SGDState:
        return SGDState({k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def update(self, grads: Tensors, state: SGDState, lr: float | None = None
               ) -> tuple[Tensors, SGDState]:
        lr = _f32(self.lr if lr is None else lr)
        m = self.momentum
        trace = {k: g + m * state.trace[k] for k, g in grads.items()}
        step = {k: g + m * trace[k] for k, g in grads.items()} if self.nesterov else trace
        return {k: u * -lr for k, u in step.items()}, SGDState(trace)


def adam_like_reference(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.98,
                        eps: float = 1e-9) -> Adam:
    """Adam with the reference's hyperparameters (convae.yaml:203-206)."""
    return Adam(lr, b1, b2, eps)


def sgd_like_reference(lr: float = 2.5e-5, momentum: float = 0.99) -> SGD:
    """Stage-2 SGD (convae.yaml:208-211, nesterov momentum 0.99)."""
    return SGD(lr, momentum, nesterov=True)


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors, keep: torch.Tensor) -> None:
    """``p += u`` in place, for every parameter, where ``keep`` (a device
    bool: the recipe's finite check) holds; else the parameters stay as they
    were. No host sync."""
    for k, p in params.items():
        p.copy_(torch.where(keep, p + updates[k], p))


@dataclasses.dataclass
class TrainState:
    """The optimizer states, the normalizer's state and the
    gradient-accumulation buffer with its (host) count."""

    opt_state: dict[str, Any]
    accum_grads: Tensors
    norm_state: Any = None
    accum_count: int = 0

    @classmethod
    def create(cls, params: Tensors, opt_state: dict[str, Any] | None = None,
               norm_state: Any = None) -> "TrainState":
        return cls(opt_state or {}, {k: torch.zeros_like(p) for k, p in params.items()}, norm_state)

    @torch.no_grad()
    def accumulate(self, grads: Tensors, accum_steps: int) -> bool:
        """Add ``g / accum_steps`` to the buffer; -> whether this micro-batch steps."""
        self.accum_grads = {k: a + grads[k] / accum_steps for k, a in self.accum_grads.items()}
        self.accum_count += 1
        return self.accum_count >= accum_steps

    def reset_accumulation(self) -> None:
        self.accum_grads = {k: torch.zeros_like(a) for k, a in self.accum_grads.items()}
        self.accum_count = 0


@torch.no_grad()
def kept_step(params: Tensors, grads: Tensors, opt: Adam | SGD, opt_state, lr: float, loss: torch.Tensor,
              clip_norm: float | None):
    """The update of the anonymizer, ASR and LM recipes (the JAX recipes'
    ``jnp.where(finite, new, old)`` on the parameters alone): ``grads``
    clipped by their global norm (``clip_norm``, or only measured when None),
    ``opt``'s step from ``opt_state``, and ``params`` updated in place only
    where the norm and ``loss`` are finite, with no host sync. -> the new
    optimizer state, advanced either way."""
    if clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, float(clip_norm))
    else:
        gnorm = global_norm(grads.values())
    updates, new_state = opt.update(grads, opt_state, lr)
    apply_updates(params, updates, keep=torch.isfinite(gnorm) & torch.isfinite(loss))
    return new_state


@torch.no_grad()
def guarded_step(params: Tensors, state: TrainState, opt: Adam | SGD, opt_key: str, lr: float,
                 loss: torch.Tensor, clip_norm: float | None) -> bool:
    """``make_update_fn``'s update, at the accumulation count: the buffer
    clipped by its global norm (``clip_norm``, or only measured when None),
    then, if the norm and ``loss`` are finite, ``opt``'s update of ``params``
    (in place) and of ``state.opt_state[opt_key]``; otherwise the whole
    update is skipped, parameters, moments and count alike. The buffer is
    reset either way. Reads the finite check back to the host (one
    synchronisation an update), since the optimizer's count lives there.
    -> whether the update was applied."""
    g = state.accum_grads
    if clip_norm is not None:
        g, gnorm = clip_by_global_norm(g, float(clip_norm))
    else:
        gnorm = global_norm(g.values())
    finite = bool(torch.isfinite(gnorm) & torch.isfinite(loss))
    if finite:
        updates, state.opt_state[opt_key] = opt.update(g, state.opt_state[opt_key], lr)
        for k, p in params.items():
            p.add_(updates[k])
    state.reset_accumulation()
    return finite
