"""Frozen ASR attached to the anonymizer: utility loss, encoder similarity and WER.

Counterpart of ``speech_anonymization_tpu/recipes/asr_bundle.py``
``ASRBundle``, with or without a shallow-fusion language model:

  * ``utility_loss``: divergence of the frozen ASR's decoder outputs on
    clean and reconstructed features (MSE or cosine);
  * ``eval_batch``: cosine similarity of the two encoder outputs into the
    utility aggregator and, at the test stage, a beam decode (beam 66, CTC
    0.4, temperature 1.15, length normalization; with ``lm=`` a
    ``TransformerLM`` fused at ``lm_weight`` 0.6, ``temperature_lm`` 1.15, as
    the reference's test decode) of the reconstructed and the clean
    features, scored as WER against the reference words;
  * ``start_test`` / ``finish_test``: the two WER aggregators.

The tokenizer is duck-typed: anything with ``decode_ids(list[int]) -> str``.
The decode's hot path runs the port's kernels. On the card it pages its KV
caches by default, as the JAX package does on its accelerator
(``decode_paged_kv``, default true, under ``use_paged_cache``): K5/K6 for the
cached self-attention, and a beam reorder that gathers an int table.
``decode_paged_kv: false``, and every CPU decode, keep physical caches: K3/K4
for the attention (plain twins on the CPU) and K2 for the reorder. The LM's
cache pages under the same rule with the LM's own width; its stacked K7
weights are made once, here, and a fused paged LM cache on the card (U above
``max_u_whole_row``, page 64) runs each LM step as one K7 launch, in bf16
arithmetic as the JAX package does on its accelerator (``decode_lm_megastep:
false`` keeps the per-layer K6 path). :func:`load_asr_bundle` and
:func:`load_lm` build the bundle and its LM from the asr_train and lm_train
recipes' checkpoint directories, in the JAX package's format.

``decode_cache_dtype`` is ``float32`` (the default), ``bfloat16`` or ``int8``
(the JAX package's quantized serving mode: int8 codes with a scale per
layer, row and position, quantized as each step writes them), at any length:
up to the whole-row bound (``max_u_whole_row(d_model, 2)``, 426 positions at
d_model 768) K5 (paged) or K3 with K2 (physical) take it, above it K6 on the
fused page-64 cache (the LM's step one K7 launch) or K4 with K2.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..decoding import BeamSearchConfig, beam_search, hyps_to_lists
from ..eval.wer import ErrorRateStats
from ..losses import cosine_similarity_loss, mse_loss
from ..models.asr import ASRModel
from ..models.transformer import TransformerLM, beam_reorder_cache, make_kv_cache, use_paged_cache
from ..train.checkpoint import recover_trees
from ..utils.convert import asr_state_dict, load_numpy_state, lm_state_dict

_CACHE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


class ASRBundle:
    def __init__(self, model: ASRModel, tokenizer, hparams: dict, utility_kind: str = "mse",
                 lm: TransformerLM | None = None):
        self.model = model.eval()
        self.lm = lm.eval() if lm is not None else None
        self.tokenizer = tokenizer
        self.hparams = hparams
        self.utility_kind = utility_kind
        self.beam_size = int(hparams.get("test_beam_size", 66))
        # the recipe default float32 keeps the scores stable against the
        # reference's f32 decode; 'bfloat16' halves the cache traffic and
        # 'int8' (quantized serving, codes with per-position scales) halves it again
        self.cache_dtype = _CACHE_DTYPES[hparams.get("decode_cache_dtype", "float32")]
        self.paged_kv = bool(hparams.get("decode_paged_kv", True))
        self.lm_weight = float(hparams.get("lm_weight", 0.6)) if lm is not None else 0.0
        # K7's weights, stacked once per bundle (not once per decode); the
        # kernel takes d_ffn in d_model blocks. decode_lm_megastep: false
        # keeps the per-layer path, as the JAX package's SATPU_LM_MEGA=0.
        self.lm_mega = None
        if (self.lm_weight > 0 and bool(hparams.get("decode_lm_megastep", True))
                and lm.d_ffn % lm.d_model == 0):
            self.lm_mega = lm.prepare_megastep()
        self.cfg = BeamSearchConfig(
            beam_size=self.beam_size,
            bos_index=int(hparams.get("bos_index", 1)),
            eos_index=int(hparams.get("eos_index", 2)),
            blank_index=int(hparams.get("blank_index", 0)),
            ctc_weight=float(hparams.get("ctc_weight_decode", 0.4)),
            lm_weight=self.lm_weight,
            temperature=float(hparams.get("temperature", 1.15)),
            temperature_lm=float(hparams.get("temperature_lm", 1.15)),
            length_normalization=True,
        )

    def _forward_dec(self, feats, lens, tokens_bos):
        enc = self.model.encode(feats, lens)
        return enc, self.model.decode(tokens_bos, enc, lens)

    def utility_loss(self, clean, recon, lens, tokens_bos):
        """Utility term of the anonymizer's train step; gradients reach only
        the reconstruction branch (the clean one runs without a graph)."""
        with torch.no_grad():
            _, dec_o = self._forward_dec(clean, lens, tokens_bos)
        _, dec_r = self._forward_dec(recon, lens, tokens_bos)
        if self.utility_kind == "cosine":
            return cosine_similarity_loss(dec_r, dec_o)
        return mse_loss(dec_r, dec_o)

    @torch.no_grad()
    def _encode(self, feats, lens):
        return self.model.encode(feats, lens)

    def pages(self, n: int, u_max: int, device) -> bool:
        """Whether a decode of ``n`` rows and ``u_max`` positions on ``device``
        pages its caches: ``decode_paged_kv`` and the JAX rule."""
        return self.paged_kv and use_paged_cache(n, u_max, self.model.d_model, self.cache_dtype,
                                                 device)

    def make_cache(self, n: int, u_max: int, device) -> dict:
        m = self.model
        return make_kv_cache(n, u_max, m.num_decoder_layers, m.nhead, m.d_model // m.nhead,
                             self.cache_dtype, device=device, paged=self.pages(n, u_max, device))

    def make_lm_cache(self, n: int, u_max: int, device) -> dict:
        lm = self.lm
        paged = self.paged_kv and use_paged_cache(n, u_max, lm.d_model, self.cache_dtype, device)
        return make_kv_cache(n, u_max, lm.num_layers, lm.nhead, lm.d_model // lm.nhead,
                             self.cache_dtype, lm.pad_index, device=device, paged=paged)

    @torch.no_grad()
    def _decode_test(self, feats, lens):
        """Beam-decode normalized (B, T, F) features -> (tokens, lengths, scores[, stats])."""
        m = self.model
        enc = m.encode(feats, lens)
        p_ctc = torch.log_softmax(m.heads.ctc_logits(enc), dim=-1)
        # cross-attention memory K/V projected once per decode, at the batch
        # level: decode steps group the B * beam query rows over it
        cross = m.cross_kv(enc)
        att_cached = (
            lambda n, u_max: self.make_cache(n, u_max, enc.device),
            lambda state, prev, step: m.decode_step_cached(prev, enc, state, step, lens, cross),
            beam_reorder_cache,
        )
        lm_cached = None
        if self.lm is not None and self.lm_weight > 0:
            lm_cached = (
                lambda n, u_max: self.make_lm_cache(n, u_max, enc.device),
                lambda state, prev, step: self.lm.decode_step(prev, state, step, self.lm_mega),
                beam_reorder_cache,
            )
        max_steps = self.hparams.get("max_decode_steps")
        return beam_search(att_cached, enc, lens, p_ctc, self.cfg,
                           max_steps=int(max_steps) if max_steps else None, lm_cached=lm_cached,
                           return_stats=bool(self.hparams.get("decode_return_stats")))

    # -- anonymizer evaluation hooks ----------------------------------------

    def start_test(self, metrics) -> None:
        metrics.wer_metric = ErrorRateStats()
        metrics.wer_metric2 = ErrorRateStats()

    def eval_batch(self, metrics, ids, words, recon, clean, lens, stage: str) -> None:
        """Encoder similarity into ``metrics.utility_similarity``; at the test
        stage, WER of the reconstructed (``wer_metric``) and the clean
        (``wer_metric2``) features against ``words`` (one string per utterance)."""
        r = self._encode(recon, lens).cpu().numpy().reshape(len(recon), -1)
        o = self._encode(clean, lens).cpu().numpy().reshape(len(clean), -1)
        den = np.linalg.norm(r, axis=1) * np.linalg.norm(o, axis=1)
        metrics.utility_similarity.append((r * o).sum(axis=1) / np.maximum(den, 1e-8))
        if stage == "test":
            target = [w.split(" ") for w in words]
            for feats, agg in ((recon, metrics.wer_metric), (clean, metrics.wer_metric2)):
                toks, lengths = self._decode_test(feats, lens)[:2]
                pred = [self.tokenizer.decode_ids(h).split(" ") for h in hyps_to_lists(toks, lengths)]
                agg.append(ids, pred, target)

    def finish_test(self, metrics, wer_file: str | None = None) -> float:
        if wer_file:
            with open(wer_file, "w") as f:
                metrics.wer_metric.write_stats(f)
        return metrics.wer_metric.summarize("error_rate")


def load_lm(hparams: dict, device: str | torch.device = "cuda") -> TransformerLM | None:
    """The shallow-fusion LM from an lm_train checkpoint directory
    (``lm_checkpoint_dir``; the checkpoint with the least ``loss``), at the
    hparams' widths (``output_neurons``, ``lm_d_model``, ``lm_nhead``,
    ``lm_num_layers``, ``lm_d_ffn``); None when the directory is unset or absent."""
    lm_dir = hparams.get("lm_checkpoint_dir")
    if not lm_dir or not os.path.isdir(lm_dir):
        return None
    lm = TransformerLM(vocab=int(hparams.get("output_neurons", 5000)),
                       d_model=int(hparams.get("lm_d_model", 768)), nhead=int(hparams.get("lm_nhead", 12)),
                       num_layers=int(hparams.get("lm_num_layers", 12)),
                       d_ffn=int(hparams.get("lm_d_ffn", 3072)), device=device)
    params = recover_trees(lm_dir, ("model",), min_key="loss")["model"]
    return load_numpy_state(lm, lm_state_dict({"params": params}))


def load_asr_bundle(hparams: dict, tokenizer, device: str | torch.device = "cuda") -> ASRBundle | None:
    """The frozen bundle from an asr_train checkpoint directory
    (``asr_checkpoint_dir``; the checkpoint with the greatest ``ACC``), at the
    hparams' widths, with the LM of ``lm_checkpoint_dir`` attached when set;
    None when the directory is unset or absent."""
    ckpt_dir = hparams.get("asr_checkpoint_dir")
    if not ckpt_dir or not os.path.isdir(ckpt_dir):
        return None
    model = ASRModel(input_feats=int(hparams.get("n_mels", 80)), d_model=int(hparams.get("d_model", 768)),
                     nhead=int(hparams.get("nhead", 8)),
                     num_encoder_layers=int(hparams.get("num_encoder_layers", 12)),
                     num_decoder_layers=int(hparams.get("num_decoder_layers", 6)),
                     d_ffn=int(hparams.get("d_ffn", 3072)),
                     output_neurons=int(hparams.get("output_neurons", 5000)), device=device)
    params = recover_trees(ckpt_dir, ("model",), max_key="ACC")["model"]
    load_numpy_state(model, asr_state_dict({"params": params}))
    return ASRBundle(model, tokenizer, hparams, hparams.get("utility_loss_kind", "mse"),
                     lm=load_lm(hparams, device))
