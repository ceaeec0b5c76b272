"""Loaders for the reference's own torch checkpoints into the port's modules.

Counterpart of ``speech_anonymization_tpu/utils/reference_ckpts.py``. Each
loader reads a SpeechBrain-layout state dict (``utils/sb_compat.py``
``load_state_dict_ckpt``), maps it to the JAX package's flax tree by the
same specs (numpy, ``utils/port_weights.py``), and loads that tree into a
port module through ``utils/convert.py``, the bridge the parity tests hold:

  * the FC-AE anonymizers' ``model.ckpt`` (keys ``0.encoder.{0,2,4}`` /
    ``0.decoder.{0,2,4}``, the per-frame Linear stack of the reference's
    models/FullyConnected.py:127-142) -> ``FullyConnectedAutoencoder``. Its sex
    classifier is ported only when it is the HEAD ``FullyConnSexClassifier``
    (``0.sex_classifier.initial/norm/classify``); the other variants (the
    1024->512->2 ``DummyFullyConnSexClassifier``, a historical 40->20->2 MLP)
    leave the port's head at its fresh initialisation: recon and anonymize
    never read it;
  * the gender classifier's MLP head ``classifier.ckpt`` (SpeechBrain's
    ``Classifier``) -> ``XvectorClassifier``, its widths read from the file;
  * SpeechBrain's ``TransformerASR`` ``asr.ckpt`` (a ``ModuleList`` [CNN,
    Transformer, seq_lin, ctc_lin]: key prefixes ``0.``-``3.``) ->
    ``ASRModel(sb_compat=True)``, and its ``TransformerLM`` ``lm.ckpt`` (no
    prefix) -> ``TransformerLM(sb_compat=True)``: every parameter from the
    file. torch's packed attention ``in_proj`` is split into q/k/v; SpeechBrain
    0.5 spells the decoder's cross-attention ``mutihead_attn`` (the corrected
    ``multihead_attn`` is read too).

As in the JAX package, the HEAD ``FullyConnSexClassifier``'s input BatchNorm
normalizes each bottleneck channel (the reference's forward reshapes (B, T,
20) to (B, 20, T) instead of transposing, which mixes frames across
channels): outputs match a layout-correct torch model. A missing key raises
``KeyError``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.asr import ASRModel
from ..models.autoencoders import FullyConnectedAutoencoder
from ..models.transformer import TransformerLM
from ..models.xvector import XvectorClassifier
from .convert import anonymizer_state_dict, asr_state_dict, indexed_state_dict, lm_state_dict, load_numpy_state
from .port_weights import conv2d_from_torch, port_state_dict, set_path
from .sb_compat import load_state_dict_ckpt

# -- FC-AE anonymizer (the reference's models/FullyConnected.py:118-159) ------

FCAE_ENC_DEC_SPEC = {
    "Dense_0": ("linear", "0.encoder.0"),
    "Dense_1": ("linear", "0.encoder.2"),
    "Dense_2": ("linear", "0.encoder.4"),
    "Dense_3": ("linear", "0.decoder.0"),
    "Dense_4": ("linear", "0.decoder.2"),
    "Dense_5": ("linear", "0.decoder.4"),
}

# HEAD FullyConnSexClassifier (models/FullyConnected.py:65-104): norm = BN(20)
# on the bottleneck, initial = Linear(20, 40)/ReLU/Linear(40, 40), statistics
# pooling, classify = Linear(80, 40)/BN/ReLU/Linear(40, 40)/ReLU/Linear(40, 20)/
# BN/Linear(20, 2)
FCAE_CLASSIFIER_SPEC = {
    "sex_classifier/BatchNorm_0": ("batchnorm", "0.sex_classifier.norm"),
    "sex_classifier/Dense_0": ("linear", "0.sex_classifier.initial.0"),
    "sex_classifier/Dense_1": ("linear", "0.sex_classifier.initial.2"),
    "sex_classifier/Dense_2": ("linear", "0.sex_classifier.classify.0"),
    "sex_classifier/BatchNorm_1": ("batchnorm", "0.sex_classifier.classify.1"),
    "sex_classifier/Dense_3": ("linear", "0.sex_classifier.classify.3"),
    "sex_classifier/Dense_4": ("linear", "0.sex_classifier.classify.5"),
    "sex_classifier/BatchNorm_2": ("batchnorm", "0.sex_classifier.classify.6"),
    "sex_classifier/Dense_5": ("linear", "0.sex_classifier.classify.7"),
}

# SpeechBrain Classifier (models/external_gender_classifiers.py:118-183)
XVECTOR_CLASSIFIER_SPEC = {
    "BatchNorm_0": ("batchnorm", "norm.norm"),
    "Dense_0": ("linear", "DNN.block_0.linear.w"),
    "BatchNorm_1": ("batchnorm", "DNN.block_0.norm.norm"),
    "Dense_1": ("linear", "out.w"),
}


def load_reference_fcae(model_ckpt: str, device: str | torch.device = "cuda"
                        ) -> tuple[FullyConnectedAutoencoder, bool]:
    """A shipped FC-AE ``model.ckpt`` -> (``FullyConnectedAutoencoder`` on
    ``device``, ``ported_classifier``). Without the HEAD classifier in the
    file, the model's sex head keeps a fresh initialisation (seed 0)."""
    sd = load_state_dict_ckpt(model_ckpt)
    spec = dict(FCAE_ENC_DEC_SPEC)
    head = "0.sex_classifier.classify.7.weight" in sd
    if head:
        spec.update(FCAE_CLASSIFIER_SPEC)
    params, stats = port_state_dict(sd, spec)
    model = FullyConnectedAutoencoder(generator=torch.Generator().manual_seed(0), device=device)
    state = anonymizer_state_dict({"params": params, "batch_stats": stats})
    missing, unexpected = model.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()}, strict=False)
    if unexpected or (head and missing) or not all(k.startswith("sex_classifier.") for k in missing):
        raise KeyError(f"FC-AE checkpoint {model_ckpt}: missing {missing}, unexpected {unexpected}")
    return model, head


def load_reference_classifier_head(classifier_ckpt: str, device: str | torch.device = "cuda"
                                   ) -> XvectorClassifier:
    """A shipped ``classifier.ckpt`` -> ``XvectorClassifier`` on ``device``;
    ``lin_neurons`` (512 for the reference's main gender run, 128 for the
    evaluator stack's), the embedding width and the classes from the file."""
    sd = load_state_dict_ckpt(classifier_ckpt)
    lin_neurons, emb_dim = (int(n) for n in np.shape(sd["DNN.block_0.linear.w.weight"]))
    model = XvectorClassifier(lin_blocks=1, lin_neurons=lin_neurons,
                              out_neurons=int(np.shape(sd["out.w.weight"])[0]), in_features=emb_dim,
                              device=device)
    params, stats = port_state_dict(sd, XVECTOR_CLASSIFIER_SPEC)
    return load_numpy_state(model, indexed_state_dict({"params": params, "batch_stats": stats}))


def find_best_ckpt_dir(save_dir: str) -> str:
    """The last ``CKPT+*`` directory (by name) under a reference ``save/`` directory."""
    dirs = sorted(d for d in os.listdir(save_dir) if d.startswith("CKPT+"))
    if not dirs:
        raise FileNotFoundError(f"no CKPT+* under {save_dir}")
    return os.path.join(save_dir, dirs[-1])


# -- SpeechBrain TransformerASR / TransformerLM (asr.ckpt / lm.ckpt) ----------
#
# The reference's Pretrainer fetches these (convae.yaml:306-317); the layout
# is fixed by SpeechBrain 0.5's modules at transformer.yaml:128-173
# (ConvolutionFrontEnd of 3 one-layer blocks, TransformerASR 768 wide, 8
# heads, 12 + 6 layers, d_ffn 3072, GELU, post-norm, then seq_lin and
# ctc_lin: transformer.yaml:186-187's order).


def _first_key(sd, *names):
    for n in names:
        if n in sd:
            return n
    raise KeyError(f"none of {names} in checkpoint (keys like {list(sd)[:4]}...)")


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _port_mha(params, flax_path, sd, prefix, nhead):
    """SpeechBrain's MultiheadAttention (torch's, as ``.att``, its in_proj
    (3D, D) stacked [q; k; v]) -> the q/k/v (D, H, Dh) and out (H, Dh, D)
    DenseGeneral kernels and their biases."""
    w = _np(sd[prefix + ".att.in_proj_weight"])
    bias = _np(sd[prefix + ".att.in_proj_bias"])
    d = w.shape[1]
    dh = d // nhead
    for i, name in enumerate(("q", "k", "v")):
        set_path(params, f"{flax_path}/{name}/kernel", w[i * d:(i + 1) * d].T.reshape(d, nhead, dh))
        set_path(params, f"{flax_path}/{name}/bias", bias[i * d:(i + 1) * d].reshape(nhead, dh))
    wo = _np(sd[prefix + ".att.out_proj.weight"])
    set_path(params, f"{flax_path}/out/kernel", wo.T.reshape(nhead, dh, d))
    set_path(params, f"{flax_path}/out/bias", _np(sd[prefix + ".att.out_proj.bias"]))


def _port_linear(params, flax_path, sd, prefix):
    set_path(params, f"{flax_path}/kernel", _np(sd[prefix + ".weight"]).T)
    if prefix + ".bias" in sd:
        set_path(params, f"{flax_path}/bias", _np(sd[prefix + ".bias"]))


def _port_layernorm(params, flax_path, sd, prefix):
    set_path(params, f"{flax_path}/scale", _np(sd[prefix + ".weight"]))
    set_path(params, f"{flax_path}/bias", _np(sd[prefix + ".bias"]))


def _port_encoder_stack(params, sd, tprefix, flax_prefix, layer_name, n_layers, nhead):
    """The encoder layers (the ASR's encoder and the LM share one layout)."""
    for i in range(n_layers):
        lt = f"{tprefix}.layers.{i}"
        lf = f"{flax_prefix}{layer_name}{i}"
        _port_mha(params, f"{lf}/attn", sd, f"{lt}.self_att", nhead)
        _port_linear(params, f"{lf}/FeedForward_0/Dense_0", sd, f"{lt}.pos_ffn.ffn.0")
        _port_linear(params, f"{lf}/FeedForward_0/Dense_1", sd, f"{lt}.pos_ffn.ffn.3")
        _port_layernorm(params, f"{lf}/LayerNorm_0", sd, f"{lt}.norm1.norm")
        _port_layernorm(params, f"{lf}/LayerNorm_1", sd, f"{lt}.norm2.norm")


def port_sb_asr_state_dict(sd, nhead: int = 8, num_encoder_layers: int = 12,
                           num_decoder_layers: int = 6) -> dict:
    """An ``asr.ckpt`` state dict -> the params tree of the JAX package's
    ``ASRModel(sb_compat=True)`` (numpy)."""
    p: dict = {}
    for b in range(3):  # the CNN, ModuleList slot 0: 3 ConvBlocks of one layer
        t = f"0.convblock_{b}.convs"
        conv = conv2d_from_torch(sd[f"{t}.conv_0.conv.weight"], sd.get(f"{t}.conv_0.conv.bias"))
        for k, v in conv.items():
            set_path(p, f"cnn/conv_{b}/{k}", v)
        _port_layernorm(p, f"cnn/norm_{b}", sd, f"{t}.norm_0.norm")
    # the Transformer, slot 1
    _port_linear(p, "transformer/input_proj", sd, "1.custom_src_module.layers.0.w")
    emb_key = _first_key(sd, "1.custom_tgt_module.layers.0.emb.Embedding.weight",
                         "1.custom_tgt_module.layers.0.emb.weight")
    set_path(p, "transformer/embed/embedding", _np(sd[emb_key]))
    _port_encoder_stack(p, sd, "1.encoder", "transformer/", "enc_", num_encoder_layers, nhead)
    _port_layernorm(p, "transformer/enc_norm", sd, "1.encoder.norm.norm")
    for i in range(num_decoder_layers):
        lt = f"1.decoder.layers.{i}"
        lf = f"transformer/dec_{i}"
        _port_mha(p, f"{lf}/self_attn", sd, f"{lt}.self_attn", nhead)
        cross = (f"{lt}.mutihead_attn" if f"{lt}.mutihead_attn.att.in_proj_weight" in sd
                 else f"{lt}.multihead_attn")
        _port_mha(p, f"{lf}/cross_attn", sd, cross, nhead)
        _port_linear(p, f"{lf}/ff/Dense_0", sd, f"{lt}.pos_ffn.ffn.0")
        _port_linear(p, f"{lf}/ff/Dense_1", sd, f"{lt}.pos_ffn.ffn.3")
        _port_layernorm(p, f"{lf}/ln1", sd, f"{lt}.norm1.norm")
        _port_layernorm(p, f"{lf}/ln2", sd, f"{lt}.norm2.norm")
        _port_layernorm(p, f"{lf}/ln3", sd, f"{lt}.norm3.norm")
    _port_layernorm(p, "transformer/dec_norm", sd, "1.decoder.norm.norm")
    _port_linear(p, "heads/seq_lin", sd, "2.w")  # slot 2
    _port_linear(p, "heads/ctc_lin", sd, "3.w")  # slot 3
    return p


def port_sb_lm_state_dict(sd, nhead: int = 12, num_layers: int = 12) -> dict:
    """An ``lm.ckpt`` state dict -> the params tree of the JAX package's
    ``TransformerLM(sb_compat=True)`` (numpy)."""
    p: dict = {}
    emb_key = _first_key(sd, "custom_src_module.emb.Embedding.weight", "custom_src_module.emb.weight")
    set_path(p, "embed/embedding", _np(sd[emb_key]))
    _port_encoder_stack(p, sd, "encoder", "", "layer_", num_layers, nhead)
    _port_layernorm(p, "norm", sd, "encoder.norm.norm")
    _port_linear(p, "out_a", sd, "output_proj.layers.0.w")
    _port_layernorm(p, "out_ln", sd, "output_proj.layers.1.norm")
    _port_linear(p, "out_b", sd, "output_proj.layers.2.w")
    return p


def load_reference_asr(asr_ckpt: str, d_model: int = 768, nhead: int = 8, num_encoder_layers: int = 12,
                       num_decoder_layers: int = 6, d_ffn: int = 3072, output_neurons: int = 5000,
                       device: str | torch.device = "cuda") -> ASRModel:
    """An ``asr.ckpt`` (speechbrain/asr-transformer-transformerlm-librispeech's
    layout) -> ``ASRModel(sb_compat=True)`` on ``device``, every parameter
    from the file (a strict load)."""
    tree = port_sb_asr_state_dict(load_state_dict_ckpt(asr_ckpt), nhead=nhead,
                                  num_encoder_layers=num_encoder_layers,
                                  num_decoder_layers=num_decoder_layers)
    model = ASRModel(d_model=d_model, nhead=nhead, num_encoder_layers=num_encoder_layers,
                     num_decoder_layers=num_decoder_layers, d_ffn=d_ffn, output_neurons=output_neurons,
                     sb_compat=True, device=device)
    return load_numpy_state(model, asr_state_dict({"params": tree})).eval()


def load_reference_lm(lm_ckpt: str, d_model: int = 768, nhead: int = 12, num_layers: int = 12,
                      d_ffn: int = 3072, vocab: int = 5000, device: str | torch.device = "cuda"
                      ) -> TransformerLM:
    """An ``lm.ckpt`` -> ``TransformerLM(sb_compat=True)`` on ``device``, every
    parameter from the file (a strict load)."""
    tree = port_sb_lm_state_dict(load_state_dict_ckpt(lm_ckpt), nhead=nhead, num_layers=num_layers)
    lm = TransformerLM(vocab=vocab, d_model=d_model, nhead=nhead, num_layers=num_layers, d_ffn=d_ffn,
                       sb_compat=True, device=device)
    return load_numpy_state(lm, lm_state_dict({"params": tree})).eval()
