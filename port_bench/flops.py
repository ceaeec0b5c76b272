"""Model FLOPs of the cells' work, counted from shapes.

A product of an (m, k) by a (k, n) operand counts 2 m k n, a convolution
2 x (output elements) x (inputs per output), a transposed one 2 x (input
elements) x (outputs per input), as ``torch.utils.flop_counter`` counts
them; elementwise work, softmaxes and norms are not counted. The tests pin
each forward here to that counter over the plain reference at a small size.
"""

from __future__ import annotations

WIN, BINS, N_MELS, HOP = 400, 201, 80, 160


def frames(samples: int) -> int:
    return 1 + samples // HOP


def linear(rows: int, fan_in: int, fan_out: int) -> int:
    return 2 * rows * fan_in * fan_out


def fbank(b: int, samples: int) -> int:
    rows = b * frames(samples)
    return linear(rows, WIN, 2 * BINS) + linear(rows, BINS, N_MELS)


def _conv1d(b, c_in, c_out, k, w_out):
    return 2 * b * c_out * w_out * c_in * k


def _conv_t1d(b, c_in, c_out, k, w_in):
    return 2 * b * w_in * c_in * c_out * k


def ae_encode(b: int, t: int) -> int:
    w = t * N_MELS
    f = _conv1d(b, 1, 32, 15, w)
    for c_in, c_out, s in ((32, 64, 2), (64, 64, 1), (64, 128, 2), (128, 128, 1)):
        w //= s
        f += _conv1d(b, c_in, c_out, 5, w)
    return f


def ae_decode(b: int, t: int) -> int:
    w = t * N_MELS // 4
    f = _conv1d(b, 128, 128, 5, w) + _conv_t1d(b, 128, 64, 5, w)
    w *= 2
    f += _conv1d(b, 64, 64, 5, w) + _conv_t1d(b, 64, 32, 5, w)
    return f + _conv1d(b, 32, 1, 15, 2 * w)


def sex_head(b: int, t: int) -> int:
    w = t * N_MELS // 4
    f = 0
    for k, d in ((5, 1), (3, 2), (3, 3)):
        w -= (k - 1) * d
        f += _conv1d(b, 128, 128, k, w)
    return f + linear(b, 256, 128) + linear(b, 128, 64) + linear(b, 64, 2)


def xvector(b: int, t: int) -> int:
    chans = (N_MELS, 512, 512, 512, 512, 1500)
    f = sum(_conv1d(b, chans[i], chans[i + 1], k, t) for i, k in enumerate((5, 3, 3, 1, 1)))
    return f + linear(b, 3000, 128) + linear(b, 128, 128) + linear(b, 128, 2)


def _conv2d(b, c_in, c_out, k, h, w):
    return 2 * b * c_out * h * w * c_in * k * k


def asr_frontend(b: int, t: int) -> int:
    h, w = t, N_MELS
    f = 0
    for c_in, c_out, k, s in ((1, 128, 3, 2), (128, 256, 3, 2), (256, 512, 1, 1)):
        h, w = -(-h // s), -(-w // s)
        f += _conv2d(b, c_in, c_out, k, h, w)
    return f


def enc_frames(t: int) -> int:
    return -(-(-(-t // 2)) // 2)


def attention(b: int, uq: int, uk: int, m: int) -> int:
    """Scores and weighted sum over all heads: two (uq x dh) by (dh x uk) products a head."""
    return 2 * 2 * b * uq * uk * m


def encoder_layer(b: int, u: int, m: int, f: int) -> int:
    return 4 * linear(b * u, m, m) + attention(b, u, u, m) + linear(b * u, m, f) + linear(b * u, f, m)


def asr_encode(b: int, t: int, c: dict) -> int:
    te, m = enc_frames(t), c["d_model"]
    return (asr_frontend(b, t) + linear(b * te, (N_MELS // 4) * 512, m)
            + c["num_encoder_layers"] * encoder_layer(b, te, m, c["d_ffn"]))


def decoder_layer(b: int, u: int, u_self: int, te: int, m: int, f: int) -> int:
    """u query positions, each over u_self positions (teacher-forced: u_self
    = u) and te encoder frames, with the encoder frames' keys and values."""
    return (6 * linear(b * u, m, m) + 2 * linear(b * te, m, m) + attention(b, u, u_self, m)
            + attention(b, u, te, m) + linear(b * u, m, f) + linear(b * u, f, m))


def asr_decode(b: int, u: int, te: int, c: dict) -> int:
    """Teacher-forced decoder over u tokens, with the sequence head."""
    m = c["d_model"]
    return c["num_decoder_layers"] * decoder_layer(b, u, u, te, m, c["d_ffn"]) + linear(b * u, m, c["vocab"])


def lm_forward(b: int, u: int, c: dict) -> int:
    m = c["lm_d_model"]
    return c["lm_num_layers"] * encoder_layer(b, u, m, c["lm_d_ffn"]) + linear(b * u, m, c["vocab"])


def decode_step(n: int, step: int, te: int, c: dict, lm: bool) -> int:
    """One beam-search step over n rows: the decoder against step + 1 cached
    positions (the cross-attention K/V made once a decode, not here), the
    sequence head, the LM likewise, and the CTC prefix scores of every
    candidate (one (t x v) product a row)."""
    m, f, v = c["d_model"], c["d_ffn"], c["vocab"]
    dec = c["num_decoder_layers"] * (4 * linear(n, m, m) + attention(n, 1, step + 1, m)
                                     + 2 * linear(n, m, m) + attention(n, 1, te, m)
                                     + linear(n, m, f) + linear(n, f, m))
    out = dec + linear(n, m, v) + 2 * n * te * v
    if lm:
        lm_m, lm_f = c["lm_d_model"], c["lm_d_ffn"]
        out += (c["lm_num_layers"] * (4 * linear(n, lm_m, lm_m) + attention(n, 1, step + 1, lm_m)
                                      + linear(n, lm_m, lm_f) + linear(n, lm_f, lm_m)) + linear(n, lm_m, v))
    return out


def beam_decode(b: int, t: int, c: dict, lm: bool) -> int:
    """A decode of b utterances of t frames: the encoder, the CTC head, the
    cross-attention K/V once, then max_decode_ratio x frames steps."""
    te, m = enc_frames(t), c["d_model"]
    n = b * c["beam_size"]
    steps = max(int(c["max_decode_ratio"] * te), 1)
    f = (asr_encode(b, t, c) + linear(b * te, m, c["vocab"])
         + c["num_decoder_layers"] * 2 * linear(b * te, m, m))
    return f + sum(decode_step(n, s, te, c, lm) for s in range(steps))


def anonymize(b: int, samples: int) -> int:
    t = frames(samples)
    return fbank(b, samples) + ae_encode(b, t) + ae_decode(b, t)


def evaluate_batch(b: int, samples: int, c: dict, lm: bool) -> int:
    """The test-stage evaluation of one batch: the anonymizer's full forward,
    the x-vector on clean and reconstructed features, the ASR encoder on
    both, and a decode of each."""
    t = frames(samples)
    t = -(-t // 36) * 36
    return (fbank(b, samples) + ae_encode(b, t) + ae_decode(b, t) + sex_head(b, t) + 2 * xvector(b, t)
            + 2 * asr_encode(b, t, c) + 2 * beam_decode(b, t, c, lm))


def train_micro_batch(b: int, samples: int, tokens: int, c: dict, utility: bool) -> int:
    """One training micro-batch: the anonymizer forward and backward (three
    forwards' worth) and, with the utility term, the frozen ASR's forward on
    the clean features and forward plus input gradients (two forwards'
    worth) on the reconstruction."""
    t = frames(samples)
    t = -(-t // 36) * 36
    f = fbank(b, samples) + 3 * (ae_encode(b, t) + ae_decode(b, t) + sex_head(b, t))
    if utility:
        te = enc_frames(t)
        asr = asr_encode(b, t, c) + asr_decode(b, tokens, te, c) - linear(b * tokens, c["d_model"], c["vocab"])
        f += 3 * asr
    return f
