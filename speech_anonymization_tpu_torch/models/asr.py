"""ASR model: conv front end + transformer + CTC/seq linear heads.

Counterpart of ``speech_anonymization_tpu/models/asr.py`` ``ASRHeads`` and
``ASRModel``: ``encode`` (the utility-loss and decode input), ``decode``
(full teacher-forced decoder), ``cross_kv`` and ``decode_step_cached`` (the
beam search's step), and ``decode_one_step`` (the full-prefix step, no
cache). ``sb_compat`` builds the layout of the reference's published
SpeechBrain ASR (``utils/reference_ckpts.py`` ``load_reference_asr``). The
model takes normalized features: the reference bypasses the ASR's own
normalization.
"""

from __future__ import annotations

import torch
from torch import nn

from .init import flax_init_
from .transformer import ConvolutionFrontEnd, DropoutRng, SBConvFrontEnd, TransformerASR


class ASRHeads(nn.Module):
    def __init__(self, d_model: int = 768, output_neurons: int = 5000):
        super().__init__()
        self.ctc_lin = nn.Linear(d_model, output_neurons)
        self.seq_lin = nn.Linear(d_model, output_neurons)

    def ctc_logits(self, enc_out):
        return self.ctc_lin(enc_out)

    def seq_logits(self, dec_out):
        return self.seq_lin(dec_out)

    def forward(self, enc_out, dec_out):
        return (torch.log_softmax(self.ctc_lin(enc_out), -1),
                torch.log_softmax(self.seq_lin(dec_out), -1))


class ASRModel(nn.Module):
    """CNN front end + TransformerASR + ctc/seq heads, at ``ASRModel()``'s
    published widths. With ``generator``, a fresh model takes flax's
    initialisers drawn from it (``models/init.py``); without, torch's (the
    weights are then loaded from a checkpoint). ``dropout``: train-mode
    dropout in every attention and feed-forward (``train=True`` with a
    ``DropoutRng``). ``sb_compat``: SpeechBrain's conv front end
    (``SBConvFrontEnd``), exact GELU and the final encoder and decoder
    LayerNorms, for checkpoints ported from the reference's layout."""

    def __init__(self, input_feats: int = 80, d_model: int = 768, nhead: int = 8,
                 num_encoder_layers: int = 12, num_decoder_layers: int = 6, d_ffn: int = 3072,
                 output_neurons: int = 5000, pad_index: int = 0, dropout: float = 0.0,
                 sb_compat: bool = False, generator: torch.Generator | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.d_model, self.nhead, self.num_decoder_layers = d_model, nhead, num_decoder_layers
        self.sb_compat = sb_compat
        self.cnn = SBConvFrontEnd(input_feats) if sb_compat else ConvolutionFrontEnd()
        freq_out = ((input_feats + 1) // 2 + 1) // 2  # two stride-2 convs: 80 -> 20
        self.transformer = TransformerASR(
            input_size=freq_out * 512, tgt_vocab=output_neurons, d_model=d_model, nhead=nhead,
            num_encoder_layers=num_encoder_layers, num_decoder_layers=num_decoder_layers,
            d_ffn=d_ffn, pad_index=pad_index, dropout=dropout, sb_compat=sb_compat)
        self.heads = ASRHeads(d_model, output_neurons)
        if generator is not None:
            flax_init_(self, generator)
        self.to(device)

    def encode(self, feats, wav_lens=None, train: bool = False, rng: DropoutRng | None = None):
        """(B, T, F) normalized feats -> (B, T/4, d_model) encoder states."""
        return self.transformer.encode(self.cnn(feats), wav_lens, train, rng)

    def decode(self, tokens_bos, enc_out, wav_lens=None, train: bool = False,
               rng: DropoutRng | None = None):
        return self.transformer.decode(tokens_bos, enc_out, wav_lens, train, rng)

    def forward(self, feats, tokens_bos, wav_lens=None, train: bool = False,
                rng: DropoutRng | None = None):
        """-> (enc_out, dec_out, p_ctc, p_seq)."""
        enc_out = self.encode(feats, wav_lens, train, rng)
        dec_out = self.decode(tokens_bos, enc_out, wav_lens, train, rng)
        p_ctc, p_seq = self.heads(enc_out, dec_out)
        return enc_out, dec_out, p_ctc, p_seq

    def cross_kv(self, enc_out):
        """Per-layer cross-attention K/V, once per decode."""
        return self.transformer.cross_kv(enc_out)

    def decode_step_cached(self, token, enc_out, cache, step: int, wav_lens=None, cross_kv=None):
        """KV-cached single-step decode: (N,) token -> ((N, V) logits, cache)."""
        hidden, cache = self.transformer.decode_step(token, enc_out, cache, step, wav_lens, cross_kv)
        return self.heads.seq_logits(hidden), cache

    def decode_one_step(self, tokens_prefix, enc_out, wav_lens=None, step: int | None = None):
        """Raw next-token logits (the beam search applies temperature and
        log-softmax): the (N, U) prefix decoded in full, no cache -> (N, V) at
        column ``step`` (the last valid one of a static buffer), or at the last
        column when ``step`` is None."""
        logits = self.heads.seq_logits(self.transformer.decode(tokens_prefix, enc_out, wav_lens))
        return logits[:, -1 if step is None else step]
