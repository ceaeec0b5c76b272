"""Weight bridge: flax variables -> the port's PyTorch ``state_dict``s.

Inverts the layout rules of ``speech_anonymization_tpu/utils/port_weights.py``
(kept here as the port's own copy; the port imports nothing of the JAX
package). Inputs are flax variable trees as nested dicts of numpy arrays,
``{"params": ..., "batch_stats": ...}``:

  flax Dense kernel (in, out)          -> Linear weight (out, in)
  flax Conv kernel (k, in, out)        -> Conv1d weight (out, in, k)
  flax ConvTranspose kernel (k, in, out) -> ConvTranspose1d weight (in, out, k),
                                          spatially flipped (lax correlates,
                                          torch convolves)
  BatchNorm scale/bias + batch_stats mean/var -> weight/bias/running_mean/running_var
  InstanceNorm scale/bias              -> weight/bias

Every anonymizer family (:func:`anonymizer_state_dict`: the ConvAutoencoder,
the fully connected pair, the CycleGAN generator, ConvReconstruction) maps
flax's auto-named layers by index (``Conv_i`` -> ``convs.i``, ``BatchNorm_i``
and ``InstanceNorm_i`` -> ``norms.i``, ``Dense_i`` -> ``dense.i``,
``DownSampleGenerator_i`` -> ``down.i``, ``ConvTranspose1dTorch_0`` -> ``up``);
a 4-D flax Conv kernel (kh, kw, in, out) becomes a Conv2d weight (out, in, kh,
kw). A tree without ``batch_stats`` (an optimizer's moments, laid out as the
params) converts to the parameters alone.

:func:`anonymizer_variables` is the inverse, for checkpoints in the JAX
package's format: a port anonymizer -> ``{"params", "batch_stats"}`` in
flax's names and layouts (``batch_stats`` only where the family has
BatchNorm, as flax's init gives; :func:`anonymizer_batch_stats` those
alone), and :func:`normalizer_tree` the normalizer state as flax serializes
its ``NormalizerState`` named tuple. Their leaves are torch tensors that view
the model's own.

And, for the ASR model (:func:`asr_state_dict`) and the LM (:func:`lm_state_dict`):

  flax Conv kernel (kh, kw, in, out)   -> Conv2d weight (out, in, kh, kw)
  DenseGeneral q/k/v kernel (D, H, Dh), bias (H, Dh) -> Linear (H*Dh, D), (H*Dh,)
  DenseGeneral out kernel (H, Dh, D)   -> Linear weight (D, H*Dh)
  LayerNorm scale/bias                 -> weight/bias
  Embed embedding (V, D)               -> Embedding weight (V, D)
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn


def linear_from_flax(p: Mapping) -> dict:
    return {"weight": np.asarray(p["kernel"]).T, "bias": np.asarray(p["bias"])}


def conv1d_from_flax(p: Mapping) -> dict:
    return {"weight": np.transpose(np.asarray(p["kernel"]), (2, 1, 0)), "bias": np.asarray(p["bias"])}


def conv_transpose1d_from_flax(p: Mapping) -> dict:
    kernel = np.asarray(p["kernel"])
    return {"weight": np.transpose(kernel[::-1], (1, 2, 0)), "bias": np.asarray(p["bias"])}


def batchnorm_from_flax(p: Mapping, stats: Mapping | None) -> dict:
    """``stats`` None (a moment tree): the affine parameters only."""
    out = {"weight": np.asarray(p["scale"]), "bias": np.asarray(p["bias"])}
    if stats is not None:
        out.update(running_mean=np.asarray(stats["mean"]), running_var=np.asarray(stats["var"]),
                   num_batches_tracked=np.zeros((), np.int64))
    return out


def instancenorm_from_flax(p: Mapping) -> dict:
    return {"weight": np.asarray(p["scale"]), "bias": np.asarray(p["bias"])}


def _put(out: dict, prefix: str, tensors: dict) -> None:
    for k, v in tensors.items():
        out[f"{prefix}.{k}"] = v


def _indexed_layers(params: Mapping, stats: Mapping, prefix: str) -> dict:
    """Flax auto-named ``Conv_i``/``Conv1dTorch_i``/``BatchNorm_i``/``InstanceNorm_i``/
    ``Dense_i``/``DownSampleGenerator_i``/``ConvTranspose1dTorch_0`` -> ``{prefix}convs.i``
    / ``norms.i`` / ``dense.i`` / ``down.i`` / ``up``."""
    out: dict = {}
    for name, p in params.items():
        kind, idx = name.rsplit("_", 1)
        if kind == "Conv":
            conv = conv2d_from_flax if np.ndim(p["kernel"]) == 4 else conv1d_from_flax
            _put(out, f"{prefix}convs.{idx}", conv(p))
        elif kind == "Conv1dTorch":
            _put(out, f"{prefix}convs.{idx}", conv1d_from_flax(p["Conv_0"]))
        elif kind == "BatchNorm":
            _put(out, f"{prefix}norms.{idx}", batchnorm_from_flax(p, stats.get(name)))
        elif kind == "InstanceNorm":
            _put(out, f"{prefix}norms.{idx}", instancenorm_from_flax(p))
        elif kind == "Dense":
            _put(out, f"{prefix}dense.{idx}", linear_from_flax(p))
        elif kind == "DownSampleGenerator":
            out.update(_indexed_layers(p, {}, f"{prefix}down.{idx}."))
        elif name == "ConvTranspose1dTorch_0":
            _put(out, f"{prefix}up", conv_transpose1d_from_flax(p["ConvTranspose_0"]))
        else:
            raise KeyError(f"no conversion rule for flax layer {name!r}")
    return out


def convae_state_dict(variables: Mapping) -> dict:
    """ConvAutoencoder variables -> ``models.ConvAutoencoder`` state_dict (numpy values)."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    out: dict = {}
    for name, p in params.items():
        if name == "sex_classifier":
            out.update(_indexed_layers(p, stats.get("sex_classifier", {}), "sex_classifier."))
        elif name.startswith(("enc_conv", "dec_conv")):
            _put(out, name, conv1d_from_flax(p["Conv_0"]))
        elif name.startswith("dec_up"):
            _put(out, name, conv_transpose1d_from_flax(p["ConvTranspose_0"]))
        elif name.startswith(("enc_in", "dec_in")):
            _put(out, name, instancenorm_from_flax(p))
        else:
            raise KeyError(f"no conversion rule for flax layer {name!r}")
    return out


def anonymizer_state_dict(variables: Mapping) -> dict:
    """Any anonymizer family's variables (or a moment tree laid out as its
    params) -> the port model's state_dict (numpy values)."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    if "enc_conv0" in params:
        return convae_state_dict(variables)
    out: dict = {}
    indexed: dict = {}
    for name, p in params.items():
        if name == "sex_classifier":
            out.update(_indexed_layers(p, stats.get(name, {}), "sex_classifier."))
        elif name == "sex_head_proj":
            _put(out, name, linear_from_flax(p))
        else:
            indexed[name] = p
    out.update(_indexed_layers(indexed, stats, ""))
    return out


def indexed_state_dict(variables: Mapping) -> dict:
    """Xvector / XvectorClassifier variables -> the port's state_dict (numpy values)."""
    return _indexed_layers(variables["params"], variables.get("batch_stats", {}), "")


def conv2d_from_flax(p: Mapping) -> dict:
    return {"weight": np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)), "bias": np.asarray(p["bias"])}


def layernorm_from_flax(p: Mapping) -> dict:
    return {"weight": np.asarray(p["scale"]), "bias": np.asarray(p["bias"])}


def attention_from_flax(p: Mapping) -> dict:
    """MultiHeadAttention's four DenseGeneral layers -> q/k/v/out Linear layers."""
    out: dict = {}
    for name in ("q", "k", "v"):
        kernel = np.asarray(p[name]["kernel"])
        d = kernel.shape[0]
        _put(out, name, {"weight": kernel.reshape(d, -1).T,
                         "bias": np.asarray(p[name]["bias"]).reshape(-1)})
    kernel = np.asarray(p["out"]["kernel"])
    _put(out, "out", {"weight": kernel.reshape(-1, kernel.shape[-1]).T,
                      "bias": np.asarray(p["out"]["bias"])})
    return out


def _feedforward(p: Mapping) -> dict:
    return {**{f"dense0.{k}": v for k, v in linear_from_flax(p["Dense_0"]).items()},
            **{f"dense1.{k}": v for k, v in linear_from_flax(p["Dense_1"]).items()}}


# per-layer flax submodule -> (port submodule, converter)
_ENCODER_LAYER = {"attn": ("attn", attention_from_flax), "LayerNorm_0": ("ln1", layernorm_from_flax),
                  "FeedForward_0": ("ff", _feedforward), "LayerNorm_1": ("ln2", layernorm_from_flax)}
_DECODER_LAYER = {"self_attn": ("self_attn", attention_from_flax),
                  "cross_attn": ("cross_attn", attention_from_flax),
                  "ln1": ("ln1", layernorm_from_flax), "ln2": ("ln2", layernorm_from_flax),
                  "ln3": ("ln3", layernorm_from_flax), "ff": ("ff", _feedforward)}


def asr_state_dict(variables: Mapping) -> dict:
    """ASRModel variables (non-``sb_compat``) -> ``models.ASRModel`` state_dict (numpy values)."""
    params = variables["params"]
    out: dict = {}
    for name, p in params["cnn"].items():
        kind, idx = name.rsplit("_", 1)
        if kind == "Conv":
            _put(out, f"cnn.convs.{idx}", conv2d_from_flax(p))
        elif kind == "LayerNorm":
            _put(out, f"cnn.norms.{idx}", layernorm_from_flax(p))
        else:
            raise KeyError(f"no conversion rule for flax layer cnn/{name!r}")
    for name, p in params["heads"].items():
        _put(out, f"heads.{name}", linear_from_flax(p))
    for name, p in params["transformer"].items():
        if name == "input_proj":
            _put(out, "transformer.input_proj", linear_from_flax(p))
        elif name == "embed":
            out["transformer.embed.weight"] = np.asarray(p["embedding"])
        elif name.startswith(("enc_", "dec_")):
            kind, idx = name.split("_")
            rules, stack = ((_ENCODER_LAYER, "encoder_layers") if kind == "enc"
                            else (_DECODER_LAYER, "decoder_layers"))
            for sub, sp in p.items():
                port_name, convert = rules[sub]
                _put(out, f"transformer.{stack}.{idx}.{port_name}", convert(sp))
        else:
            raise KeyError(f"no conversion rule for flax layer transformer/{name!r}")
    return out


def lm_state_dict(variables: Mapping) -> dict:
    """TransformerLM variables -> ``models.TransformerLM`` state_dict (numpy values):
    ``embed``, ``layer_{i}`` (the encoder layer's rules) and the head, ``out``
    or, with ``sb_compat``, ``norm``/``out_a``/``out_ln``/``out_b``."""
    out: dict = {}
    for name, p in variables["params"].items():
        if name == "embed":
            out["embed.weight"] = np.asarray(p["embedding"])
        elif name.startswith("layer_"):
            idx = name.split("_")[1]
            for sub, sp in p.items():
                port_name, convert = _ENCODER_LAYER[sub]
                _put(out, f"layers.{idx}.{port_name}", convert(sp))
        elif name in ("out", "out_a", "out_b"):
            _put(out, name, linear_from_flax(p))
        elif name in ("norm", "out_ln"):
            _put(out, name, layernorm_from_flax(p))
        else:
            raise KeyError(f"no conversion rule for flax layer {name!r}")
    return out


def _leaf_to_flax(m: nn.Module, params: bool = True) -> tuple[dict, dict | None]:
    """One layer -> (flax params, flax batch stats or None), as views of the
    layer's own tensors (detached; the ConvTranspose kernel's flip is a new
    tensor); the inverses of the ``*_from_flax`` rules above. A 1-D conv is
    the JAX package's ``Conv1dTorch`` (a flax ``Conv`` inside), a transposed
    one its ``ConvTranspose1dTorch``. ``params=False`` gives the statistics
    alone (params ``{}``)."""
    if isinstance(m, nn.BatchNorm1d):
        return ({"scale": m.weight.detach(), "bias": m.bias.detach()} if params else {},
                {"mean": m.running_mean.detach(), "var": m.running_var.detach()})
    if isinstance(m, _STATELESS):
        if not params:
            return {}, None
        w = m.weight.detach()
        if isinstance(m, nn.Linear):
            return {"kernel": w.T, "bias": m.bias.detach()}, None
        if isinstance(m, nn.Conv1d):
            return {"Conv_0": {"kernel": w.permute(2, 1, 0), "bias": m.bias.detach()}}, None
        if isinstance(m, nn.Conv2d):
            return {"kernel": w.permute(2, 3, 1, 0), "bias": m.bias.detach()}, None
        if isinstance(m, nn.ConvTranspose1d):
            return {"ConvTranspose_0": {"kernel": w.permute(2, 0, 1).flip(0), "bias": m.bias.detach()}}, None
        return {"scale": w, "bias": m.bias.detach()}, None  # InstanceNorm
    return _module_to_flax(m, params)


# layers without batch statistics
_STATELESS = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.InstanceNorm1d, nn.InstanceNorm2d)
# an indexed layer's flax name by its port type (``_indexed_layers``' inverse)
_FLAX_KIND = ((nn.Linear, "Dense"), (nn.Conv1d, "Conv1dTorch"), (nn.Conv2d, "Conv"),
              (nn.BatchNorm1d, "BatchNorm"), ((nn.InstanceNorm1d, nn.InstanceNorm2d), "InstanceNorm"))


def _module_to_flax(module: nn.Module, params: bool = True) -> tuple[dict, dict]:
    """A container of layers -> (params, batch_stats) with flax's names:
    ``convs.i`` / ``norms.i`` / ``dense.i`` by layer type and index, ``down.i``
    -> ``DownSampleGenerator_i``, ``up`` -> ``ConvTranspose1dTorch_0``; named
    children (the ConvAutoencoder's, ``sex_classifier``, ``sex_head_proj``)
    keep their names."""
    tree: dict = {}
    stats: dict = {}
    for name, child in module.named_children():
        if isinstance(child, nn.ModuleList):
            named = []
            for i, layer in enumerate(child):
                kind = next((k for t, k in _FLAX_KIND if isinstance(layer, t)), "DownSampleGenerator")
                named.append((f"{kind}_{i}", layer))
        else:
            named = [("ConvTranspose1dTorch_0" if name == "up" else name, child)]
        for flax_name, layer in named:
            p, s = _leaf_to_flax(layer, params)
            if params:
                tree[flax_name] = p
            if s:
                stats[flax_name] = s
    return tree, stats


def anonymizer_variables(model: nn.Module) -> dict:
    """A port anonymizer (any family) -> its flax variables, as views of the
    model's tensors (a checkpoint's snapshot copies them):
    :func:`anonymizer_state_dict`'s inverse."""
    params, stats = _module_to_flax(model)
    return {"params": params, "batch_stats": stats} if stats else {"params": params}


def anonymizer_batch_stats(model: nn.Module) -> dict:
    """The ``batch_stats`` tree of :func:`anonymizer_variables` alone (``{}``
    for a family without BatchNorm): views of the running statistics."""
    return _module_to_flax(model, params=False)[1]


def normalizer_tree(state) -> dict:
    """A ``NormalizerState`` -> the map flax writes for the JAX package's
    named tuple (views of the state's tensors)."""
    return {"count": state.count.detach(), "glob_mean": state.glob_mean.detach(),
            "glob_std": state.glob_std.detach()}


def load_numpy_state(module: nn.Module, state: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy a numpy state_dict into ``module`` (strict: every key must match)."""
    module.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()}, strict=True
    )
    return module
