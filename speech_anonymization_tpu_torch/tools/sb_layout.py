"""Seeded state dicts in the SpeechBrain layout of the reference's checkpoints.

The reference's published ASR and LM (``asr.ckpt``, ``lm.ckpt``) and its FC-AE
anonymizers' ``model.ckpt`` are not in the repository. To drive
``utils/reference_ckpts.py``'s loaders at full width anyway, this module
holds the files' key-and-shape tables (SpeechBrain 0.5's module tree, at
transformer.yaml's widths by default) and fills them from a seed with
fan-in-scaled normals: a weight of two or more axes draws N(0, 1/fan_in),
fan_in the product of its trailing axes; a norm's weight 1 + N(0, 0.1^2) and
its bias N(0, 0.1^2); a BatchNorm's running mean N(0, 0.1^2) and variance
U(0.5, 1.5); other biases N(0, 0.02^2). The draws come from a CPU
``torch.Generator``, key by key in table order (``write_seeded`` saves one
with ``torch.save``).
"""

from __future__ import annotations

import math
import os

import torch


def _linear(out: dict, prefix: str, n_in: int, n_out: int) -> None:
    out[f"{prefix}.weight"] = (n_out, n_in)
    out[f"{prefix}.bias"] = (n_out,)


def _norm(out: dict, prefix: str, shape) -> None:
    out[f"{prefix}.weight"] = tuple(shape)
    out[f"{prefix}.bias"] = tuple(shape)


def _batchnorm(out: dict, prefix: str, n: int) -> None:
    _norm(out, prefix, (n,))
    out[f"{prefix}.running_mean"] = (n,)
    out[f"{prefix}.running_var"] = (n,)
    out[f"{prefix}.num_batches_tracked"] = ()


def _mha(out: dict, prefix: str, d: int) -> None:
    out[f"{prefix}.att.in_proj_weight"] = (3 * d, d)
    out[f"{prefix}.att.in_proj_bias"] = (3 * d,)
    _linear(out, f"{prefix}.att.out_proj", d, d)


def _encoder_layers(out: dict, prefix: str, layers: int, d: int, d_ffn: int) -> None:
    for i in range(layers):
        p = f"{prefix}.layers.{i}"
        _mha(out, f"{p}.self_att", d)
        _linear(out, f"{p}.pos_ffn.ffn.0", d, d_ffn)
        _linear(out, f"{p}.pos_ffn.ffn.3", d_ffn, d)
        _norm(out, f"{p}.norm1.norm", (d,))
        _norm(out, f"{p}.norm2.norm", (d,))
    _norm(out, f"{prefix}.norm.norm", (d,))


def asr_layout(d_model: int = 768, num_encoder_layers: int = 12, num_decoder_layers: int = 6,
               d_ffn: int = 3072, vocab: int = 5000, n_mels: int = 80) -> dict:
    """``asr.ckpt``: key -> shape. ModuleList slots 0 (the CNN: three one-layer
    ConvBlocks, 1 -> 128 -> 256 -> 512 channels, kernels 3, 3, 1, strides 2, 2,
    1), 1 (TransformerASR), 2 (seq_lin) and 3 (ctc_lin)."""
    out: dict = {}
    f, c_in = n_mels, 1
    for b, (c, k, s) in enumerate(((128, 3, 2), (256, 3, 2), (512, 1, 1))):
        f = (f + 2 * (k // 2) - k) // s + 1
        p = f"0.convblock_{b}.convs"
        out[f"{p}.conv_0.conv.weight"] = (c, c_in, k, k)
        out[f"{p}.conv_0.conv.bias"] = (c,)
        _norm(out, f"{p}.norm_0.norm", (f, c))
        c_in = c
    _linear(out, "1.custom_src_module.layers.0.w", f * c_in, d_model)
    out["1.custom_tgt_module.layers.0.emb.Embedding.weight"] = (vocab, d_model)
    _encoder_layers(out, "1.encoder", num_encoder_layers, d_model, d_ffn)
    for i in range(num_decoder_layers):
        p = f"1.decoder.layers.{i}"
        _mha(out, f"{p}.self_attn", d_model)
        _mha(out, f"{p}.mutihead_attn", d_model)  # SpeechBrain 0.5's spelling
        _linear(out, f"{p}.pos_ffn.ffn.0", d_model, d_ffn)
        _linear(out, f"{p}.pos_ffn.ffn.3", d_ffn, d_model)
        for j in (1, 2, 3):
            _norm(out, f"{p}.norm{j}.norm", (d_model,))
    _norm(out, "1.decoder.norm.norm", (d_model,))
    _linear(out, "2.w", d_model, vocab)
    _linear(out, "3.w", d_model, vocab)
    return out


def lm_layout(d_model: int = 768, num_layers: int = 12, d_ffn: int = 3072, vocab: int = 5000) -> dict:
    """``lm.ckpt`` (a bare TransformerLM: no prefix): key -> shape."""
    out: dict = {"custom_src_module.emb.Embedding.weight": (vocab, d_model)}
    _encoder_layers(out, "encoder", num_layers, d_model, d_ffn)
    _linear(out, "output_proj.layers.0.w", d_model, d_model // 2)
    _norm(out, "output_proj.layers.1.norm", (d_model // 2,))
    _linear(out, "output_proj.layers.2.w", d_model // 2, vocab)
    return out


def fcae_layout(head: bool = True) -> dict:
    """An FC-AE ``model.ckpt``: the 80-60-40-20 encoder and its mirror, and the
    HEAD ``FullyConnSexClassifier`` (``head``) or the 1024-512-2
    ``DummyFullyConnSexClassifier``."""
    out: dict = {}
    for part, widths in (("encoder", (80, 60, 40, 20)), ("decoder", (20, 40, 60, 80))):
        for j in range(3):
            _linear(out, f"0.{part}.{2 * j}", widths[j], widths[j + 1])
    p = "0.sex_classifier"
    if head:
        _batchnorm(out, f"{p}.norm", 20)
        _linear(out, f"{p}.initial.0", 20, 40)
        _linear(out, f"{p}.initial.2", 40, 40)
        _linear(out, f"{p}.classify.0", 80, 40)
        _batchnorm(out, f"{p}.classify.1", 40)
        _linear(out, f"{p}.classify.3", 40, 40)
        _linear(out, f"{p}.classify.5", 40, 20)
        _batchnorm(out, f"{p}.classify.6", 20)
        _linear(out, f"{p}.classify.7", 20, 2)
    else:
        _linear(out, f"{p}.fc1", 1024, 512)
        _linear(out, f"{p}.fc2", 512, 2)
    return out


def classifier_head_layout(emb_dim: int = 128, lin_neurons: int = 128, out_neurons: int = 2) -> dict:
    """The gender classifier's ``classifier.ckpt`` (SpeechBrain ``Classifier``,
    one linear block)."""
    out: dict = {}
    _batchnorm(out, "norm.norm", emb_dim)
    _linear(out, "DNN.block_0.linear.w", emb_dim, lin_neurons)
    _batchnorm(out, "DNN.block_0.norm.norm", lin_neurons)
    _linear(out, "out.w", lin_neurons, out_neurons)
    return out


def seeded_state_dict(layout: dict, seed: int) -> dict:
    """``layout``'s keys filled from ``seed`` (module docstring): f32 CPU tensors,
    ``num_batches_tracked`` an int64 0."""
    g = torch.Generator().manual_seed(seed)
    norms = {k.rsplit(".", 1)[0] for k in layout if k.endswith(".running_mean")}
    out = {}
    for key, shape in layout.items():
        prefix, leaf = key.rsplit(".", 1)
        is_norm = prefix in norms or prefix.endswith(".norm")
        if leaf == "num_batches_tracked":
            out[key] = torch.zeros((), dtype=torch.int64)
        elif leaf == "running_var":
            out[key] = torch.rand(shape, generator=g) + 0.5
        elif leaf == "running_mean" or (is_norm and leaf == "bias"):
            out[key] = 0.1 * torch.randn(shape, generator=g)
        elif is_norm:
            out[key] = 1.0 + 0.1 * torch.randn(shape, generator=g)
        elif len(shape) >= 2:
            out[key] = torch.randn(shape, generator=g) / math.sqrt(math.prod(shape[1:]))
        else:
            out[key] = 0.02 * torch.randn(shape, generator=g)
    return out


def write_seeded(path: str, layout: dict, seed: int) -> dict:
    """:func:`seeded_state_dict` saved with ``torch.save`` at ``path``; returns it."""
    sd = seeded_state_dict(layout, seed)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(sd, path)
    return sd

