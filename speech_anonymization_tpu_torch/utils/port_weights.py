"""Torch checkpoint tensors -> flax-layout numpy trees (numpy only).

The port's own copy of the helpers of
``speech_anonymization_tpu/utils/port_weights.py`` that the reference
checkpoints' loaders need (``utils/reference_ckpts.py``). A loader maps a
SpeechBrain state dict to the JAX package's flax tree first, then through
``utils/convert.py`` into a port module, so one tested bridge carries every
weight. Layout rules:

  torch Linear weight (out, in)          -> flax Dense kernel (in, out)
  torch Conv2d weight (out, in, kh, kw)  -> flax Conv kernel (kh, kw, in, out)
  BatchNorm weight/bias                  -> params scale/bias,
            running_mean/running_var     -> batch_stats mean/var
  Embedding weight (V, D)                -> Embed embedding (V, D)

``port_state_dict`` drives a spec ``{flax_path: (kind, torch_key_prefix)}``
over a state dict (numpy arrays or torch tensors), ``kind`` one of
``linear``, ``conv2d``, ``embedding`` or ``batchnorm``; ``merge_params``
deep-merges the result over a base tree.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def linear_from_torch(weight, bias=None) -> dict:
    out = {"kernel": _np(weight).T}
    if bias is not None:
        out["bias"] = _np(bias)
    return out


def conv2d_from_torch(weight, bias=None) -> dict:
    out = {"kernel": np.transpose(_np(weight), (2, 3, 1, 0))}
    if bias is not None:
        out["bias"] = _np(bias)
    return out


def batchnorm_from_torch(weight, bias, running_mean, running_var) -> tuple[dict, dict]:
    """-> (params {scale, bias}, batch_stats {mean, var})."""
    return ({"scale": _np(weight), "bias": _np(bias)},
            {"mean": _np(running_mean), "var": _np(running_var)})


def embedding_from_torch(weight) -> dict:
    return {"embedding": _np(weight)}


_KIND_FNS = {"linear": linear_from_torch, "conv2d": conv2d_from_torch}


def set_path(tree: dict, path: str, value: Any) -> None:
    """``tree[a][b][c] = value`` for ``path`` "a/b/c", making the inner dicts."""
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def port_state_dict(state_dict: Mapping[str, Any], spec: Mapping[str, tuple]) -> tuple[dict, dict]:
    """Apply a mapping spec -> (params patch, batch_stats patch).

    ``spec``: flax_path -> (kind, torch key prefix). ``batchnorm`` reads the
    prefix's ``.weight``/``.bias``/``.running_mean``/``.running_var``,
    ``embedding`` its ``.weight``, the others ``.weight`` and ``.bias`` when
    present. A missing key raises ``KeyError``.
    """
    params: dict = {}
    stats: dict = {}
    for flax_path, (kind, prefix) in spec.items():
        if kind == "batchnorm":
            p, s = batchnorm_from_torch(*(state_dict[f"{prefix}.{k}"] for k in (
                "weight", "bias", "running_mean", "running_var")))
            for k, v in p.items():
                set_path(params, f"{flax_path}/{k}", v)
            for k, v in s.items():
                set_path(stats, f"{flax_path}/{k}", v)
        elif kind == "embedding":
            set_path(params, f"{flax_path}/embedding",
                     embedding_from_torch(state_dict[prefix + ".weight"])["embedding"])
        else:
            converted = _KIND_FNS[kind](state_dict[prefix + ".weight"], state_dict.get(prefix + ".bias"))
            for k, v in converted.items():
                set_path(params, f"{flax_path}/{k}", v)
    return params, stats


def merge_params(base: dict, patch: dict) -> dict:
    """Deep-merge ``patch`` into ``base`` (returns a new dict)."""
    out = dict(base)
    for k, v in patch.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_params(out[k], v)
        else:
            out[k] = v
    return out
