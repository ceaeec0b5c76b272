"""Tensor parallelism for the ASR over a ``model`` mesh axis, Megatron style.

Counterpart of ``speech_anonymization_tpu/parallel/sharding_rules.py``, whose
rules split the attention heads and the FFN's hidden width over ``model``
(column-parallel q/k/v and first Dense, row-parallel ``out`` and second
Dense) and replicate everything else, XLA inserting the all-reduces. Read
through the port's layout, where ``nn.Linear.weight`` is (out, in):

  * q/k/v weights split dim 0 (their heads); ``out`` weights split dim 1;
  * each FFN's ``dense0`` weight and bias split dim 0, ``dense1``'s weight
    dim 1, in the encoder's and the decoder's layers alike;
  * everything else is replicated, the q/k/v biases too (as in JAX).

:func:`shard_asr_params` keeps this rank's slices and gives the attention and
FFN modules a forward written by hand: local heads (``nhead / tp``), then a
differentiable all-reduce over ``model`` after the row-parallel products,
before their (replicated) bias. A replicated q/k/v bias is read by each rank
for its own heads only, so its gradient lies on those heads' slice:
:func:`reduce_tp_grads` sums it over ``model`` with the other replicated
parameters' (the sum of disjoint slices is their gather). The forward covers
training (``ASRModel.forward``); the cached decode is not tensor-parallel.
No recipe calls this, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..models.transformer import FeedForward, MultiHeadAttention, dropout
from .mesh import Mesh, psum, psum_grads


def asr_param_specs(model: nn.Module) -> dict:
    """{parameter name: the dim it splits over ``model``, or None (replicated)}."""
    split: dict = {}
    for prefix, m in model.named_modules():
        if isinstance(m, MultiHeadAttention):
            split.update({f"{prefix}.{p}.weight": 0 for p in ("q", "k", "v")})
            split[f"{prefix}.out.weight"] = 1
        elif isinstance(m, FeedForward):
            split.update({f"{prefix}.dense0.weight": 0, f"{prefix}.dense0.bias": 0,
                          f"{prefix}.dense1.weight": 1})
    return {name: split.get(name) for name, _ in model.named_parameters()}


class _TensorParallelAttention(MultiHeadAttention):
    """This rank's heads; the ``out`` product all-reduced over the model axis."""

    def heads(self, proj: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, proj.weight, proj.bias[self.tp_rows]).unflatten(-1, (self.nhead, self.d_head))

    def forward(self, q, kv, mask=None, train: bool = False, rng=None):
        ctx = self._context(self.heads(self.q, q), self.heads(self.k, kv), self.heads(self.v, kv), mask,
                            train, rng)
        return psum(F.linear(ctx.flatten(-2), self.out.weight), self.tp_mesh, self.tp_axis) + self.out.bias


class _TensorParallelFeedForward(FeedForward):
    """This rank's hidden units; the ``dense1`` product all-reduced over the model axis."""

    def forward(self, x, train: bool = False, rng=None):
        h = dropout(F.gelu(self.dense0(x), approximate=self.approximate), self.dropout, train, rng)
        return psum(F.linear(h, self.dense1.weight), self.tp_mesh, self.tp_axis) + self.dense1.bias


def shard_asr_params(model: nn.Module, mesh: Mesh, axis: str = "model") -> nn.Module:
    """Keep this rank's slices of ``model``'s split parameters
    (:func:`asr_param_specs`, contiguous blocks in rank order along ``axis``)
    and make its attention and FFN modules tensor-parallel, in place. Each
    rank then backpropagates its data shard's loss divided by the model
    axis's size, and reduces its gradients with :func:`reduce_tp_grads`.
    -> ``model``."""
    tp, i = mesh.size(axis), mesh.index(axis)
    specs = asr_param_specs(model)
    params = dict(model.named_parameters())
    for m in model.modules():
        if isinstance(m, MultiHeadAttention) and m.nhead % tp:
            raise ValueError(f"{m.nhead} heads do not split over {tp} ranks")
        if isinstance(m, FeedForward) and m.dense0.out_features % tp:
            raise ValueError(f"{m.dense0.out_features} FFN units do not split over {tp} ranks")
    for name, dim in specs.items():
        if dim is None:
            continue
        owner, attr = name.rsplit(".", 1)
        kept = params[name].detach().chunk(tp, dim)[i].clone()
        setattr(model.get_submodule(owner), attr, nn.Parameter(kept))
    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            width = m.d_model // tp
            m.__class__ = _TensorParallelAttention  # the same children, a sharded forward
            m.nhead //= tp
            m.tp_rows = slice(i * width, (i + 1) * width)
        elif isinstance(m, FeedForward):
            m.__class__ = _TensorParallelFeedForward
        else:
            continue
        m.tp_mesh, m.tp_axis = mesh, axis
    return model


def reduce_tp_grads(grads: dict, specs: dict, mesh: Mesh, axis: str = "model",
                    data_axis: str = "data") -> dict:
    """Gradients of a tensor-parallel rank summed to the whole job's: the
    replicated parameters' (the q/k/v biases among them) over ``axis`` and
    ``data_axis``, the split parameters' over ``data_axis`` only."""
    replicated = {k: g for k, g in grads.items() if specs[k] is None}
    split = {k: g for k, g in grads.items() if specs[k] is not None}
    out = {**psum_grads(psum_grads(replicated, mesh, axis), mesh, data_axis),
           **psum_grads(split, mesh, data_axis)}
    return {k: out[k] for k in grads}
