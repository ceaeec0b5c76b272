"""Plain forward passes of the configurations' models, on a dict of weights.

Weights are read by the names of the published layouts (the keys the
benchmark draws them under): ``ConvAutoencoder`` with its TDNN sex head
(reference models/ConvAutoEncoder.py), the x-vector and its classifier
(models/external_gender_classifiers.py), the transformer ASR (a three-block
conv2d front end, post-norm encoder and decoder, CTC and sequence heads) and
the transformer LM. Float32 products; layer norms at eps 1e-6, tanh GELU,
masked attention scores at -1e9, as the published models' flax layout.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .numerics import EXACT, Precision

LN_EPS = 1e-6
BN_EPS = 1e-5
NEG = -1e9


def silu(x):
    return x * torch.sigmoid(x)


def instance_norm(x, w, b, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w[None, :, None] + b[None, :, None]


def batch_norm(x, P, name, train: bool):
    """flax BatchNorm on (B, C) or (B, C, W): running statistics in eval;
    in training the batch's mean and biased variance E[x^2] - E[x]^2."""
    shape = [1, -1] + [1] * (x.ndim - 2)
    if train:
        axes = [0, *range(2, x.ndim)]
        mean = x.mean(axes)
        var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
    else:
        mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
    return ((x - mean.view(shape)) * torch.rsqrt(var + BN_EPS).view(shape) * P[f"{name}.weight"].view(shape)
            + P[f"{name}.bias"].view(shape))


def stats_pool(x):
    """(B, T, D) -> (B, 2D): mean and unbiased std + 1e-5."""
    return torch.cat([x.mean(1), torch.sqrt(torch.clamp(x.var(1, unbiased=True), min=0.0)) + 1e-5], -1)


class _Reverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.scale * g, None


# -- the anonymizer -------------------------------------------------------------

def _c1(p, P, n, x, **kw):
    return p.conv1d("ae", x, P[f"{n}.weight"], P[f"{n}.bias"], **kw)


def ae_encode(P, feats, p: Precision = EXACT):
    b, t, d = feats.shape
    x = silu(_c1(p, P, "enc_conv0", feats.reshape(b, 1, t * d), padding=7))
    for i, stride in ((1, 2), (2, 1), (3, 2), (4, 1)):
        x = _c1(p, P, f"enc_conv{i}", x, stride=stride, padding=2)
        x = silu(instance_norm(x, P[f"enc_in{i}.weight"], P[f"enc_in{i}.bias"]))
    return x


def ae_decode(P, z, shape, p: Precision = EXACT):
    y = _c1(p, P, "dec_conv0", z, padding=2)
    for up, conv in (("dec_up1", "dec_conv1"), ("dec_up2", None)):
        y = p.conv_transpose1d("ae", y, P[f"{up}.weight"], P[f"{up}.bias"], stride=2, padding=2,
                               output_padding=1)
        i = up[-1]
        y = silu(instance_norm(y, P[f"dec_in{i}.weight"], P[f"dec_in{i}.bias"]))
        if conv:
            y = _c1(p, P, conv, y, padding=2)
    return _c1(p, P, "dec_conv2", y, padding=7).reshape(shape)


def sex_head(P, z, train: bool, p: Precision = EXACT, grl_scale: float = 1.0):
    h = "sex_classifier"
    x = batch_norm(_Reverse.apply(z, grl_scale), P, f"{h}.norms.0", train)
    for i, (k, dil) in enumerate(((5, 1), (3, 2), (3, 3))):
        x = _c1(p, P, f"{h}.convs.{i}", x, dilation=dil)
        x = batch_norm(F.relu(x), P, f"{h}.norms.{i + 1}", train)
    x = stats_pool(x.transpose(1, 2))
    x = batch_norm(F.relu(p.linear("ae", x, P[f"{h}.dense.0.weight"], P[f"{h}.dense.0.bias"])), P,
                   f"{h}.norms.4", train)
    x = batch_norm(F.relu(p.linear("ae", x, P[f"{h}.dense.1.weight"], P[f"{h}.dense.1.bias"])), P,
                   f"{h}.norms.5", train)
    return F.log_softmax(p.linear("ae", x, P[f"{h}.dense.2.weight"], P[f"{h}.dense.2.bias"]), -1)


def autoencoder(P, feats, train: bool = False, p: Precision = EXACT):
    """(B, T, 80) -> (reconstruction, sex log-probs)."""
    z = ae_encode(P, feats, p)
    return ae_decode(P, z, feats.shape, p), sex_head(P, z, train, p)


def anonymize(P, feats, p: Precision = EXACT):
    return ae_decode(P, ae_encode(P, feats, p), feats.shape, p)


# -- the x-vector evaluator -------------------------------------------------------

XVECTOR_LAYERS = ((5, 1), (3, 2), (3, 3), (1, 1), (1, 1))


def xvector_log_probs(E, C, feats, p: Precision = EXACT):
    """Frozen evaluator: (B, T, 80) features -> (B, 2) log-probs."""
    x = feats.transpose(1, 2)
    for i, (k, d) in enumerate(XVECTOR_LAYERS):
        lo = (k - 1) * d // 2
        x = p.conv1d("xvector", F.pad(x, (lo, (k - 1) * d - lo)), E[f"convs.{i}.weight"],
                     E[f"convs.{i}.bias"], dilation=d)
        x = batch_norm(F.leaky_relu(x, 0.01), E, f"norms.{i}", False)
    emb = p.linear("xvector", stats_pool(x.transpose(1, 2)), E["dense.0.weight"], E["dense.0.bias"])
    h = batch_norm(F.leaky_relu(emb, 0.01), C, "norms.0", False)
    h = batch_norm(F.leaky_relu(p.linear("xvector", h, C["dense.0.weight"], C["dense.0.bias"]), 0.01), C,
                   "norms.1", False)
    return F.log_softmax(p.linear("xvector", h, C["dense.1.weight"], C["dense.1.bias"]), -1)


# -- transformers -------------------------------------------------------------------

def positions(n: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device) * (-math.log(10000.0) / d))
    pe = torch.zeros(n, d, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def _lin(p, part, P, n, x):
    return p.linear(part, x, P[f"{n}.weight"], P[f"{n}.bias"])


def layer_norm(P, n, x):
    return F.layer_norm(x, x.shape[-1:], P[f"{n}.weight"], P[f"{n}.bias"], LN_EPS)


def attention(p, part, P, n, x, kv, mask, nhead):
    b, u, d = x.shape
    dh = d // nhead
    q = _lin(p, part, P, f"{n}.q", x).view(b, u, nhead, dh)
    k = _lin(p, part, P, f"{n}.k", kv).view(b, kv.shape[1], nhead, dh)
    v = _lin(p, part, P, f"{n}.v", kv).view(b, kv.shape[1], nhead, dh)
    s = p.einsum(part, "bqhd,bkhd->bhqk", q, k) / math.sqrt(dh)
    if mask is not None:
        s = s.masked_fill(~mask, NEG)
    ctx = p.einsum(part, "bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    return _lin(p, part, P, f"{n}.out", ctx.reshape(b, u, d))


def feed_forward(p, part, P, n, x):
    return _lin(p, part, P, f"{n}.dense1", F.gelu(_lin(p, part, P, f"{n}.dense0", x), approximate="tanh"))


def encoder_layer(p, part, P, n, x, mask, nhead):
    x = layer_norm(P, f"{n}.ln1", x + attention(p, part, P, f"{n}.attn", x, x, mask, nhead))
    return layer_norm(P, f"{n}.ln2", x + feed_forward(p, part, P, f"{n}.ff", x))


def _same(size, k, s):
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def asr_frontend(P, feats, p: Precision = EXACT):
    """Three conv2d (SAME padding) -> LayerNorm over channels -> SiLU blocks:
    (B, T, 80) -> (B, T / 4, 20 * 512)."""
    h = feats[:, None]
    for i, (k, s) in enumerate(((3, 2), (3, 2), (1, 1))):
        tl, th = _same(h.shape[2], k, s)
        fl, fh = _same(h.shape[3], k, s)
        h = p.conv2d("asr", F.pad(h, (fl, fh, tl, th)), P[f"cnn.convs.{i}.weight"], P[f"cnn.convs.{i}.bias"],
                     stride=s)
        h = silu(layer_norm(P, f"cnn.norms.{i}", h.permute(0, 2, 3, 1))).permute(0, 3, 1, 2)
    b, c, t, f = h.shape
    return h.permute(0, 2, 3, 1).reshape(b, t, f * c)


def length_mask(lens, t):
    return torch.arange(t, device=lens.device)[None, :] < torch.round(lens * t)[:, None]


def asr_encode(P, feats, lens, nhead: int, p: Precision = EXACT):
    x = asr_frontend(P, feats, p)
    t, d = x.shape[1], x.shape[2]
    x = _lin(p, "asr", P, "transformer.input_proj", x)
    x = x + positions(t, x.shape[-1], x.device)[None]
    mask = length_mask(lens, t)[:, None, None, :]
    i = 0
    while f"transformer.encoder_layers.{i}.ln1.weight" in P:
        x = encoder_layer(p, "asr", P, f"transformer.encoder_layers.{i}", x, mask, nhead)
        i += 1
    return x


def ctc_log_probs(P, enc, p: Precision = EXACT):
    return torch.log_softmax(_lin(p, "asr", P, "heads.ctc_lin", enc), -1)


def asr_decode(P, tokens, enc, lens, nhead: int, p: Precision = EXACT, pad: int = 0):
    """Teacher-forced decoder: (B, U) tokens -> (B, U, d_model) states."""
    u = tokens.shape[1]
    d = enc.shape[-1]
    x = F.embedding(tokens, P["transformer.embed.weight"]) * math.sqrt(d) + positions(u, d, enc.device)[None]
    causal = torch.tril(torch.ones(u, u, dtype=torch.bool, device=enc.device))[None, None]
    self_mask = causal & (tokens != pad)[:, None, None, :]
    cross_mask = length_mask(lens, enc.shape[1])[:, None, None, :]
    i = 0
    while f"transformer.decoder_layers.{i}.ln1.weight" in P:
        n = f"transformer.decoder_layers.{i}"
        x = layer_norm(P, f"{n}.ln1", x + attention(p, "asr", P, f"{n}.self_attn", x, x, self_mask, nhead))
        x = layer_norm(P, f"{n}.ln2", x + attention(p, "asr", P, f"{n}.cross_attn", x, enc, cross_mask, nhead))
        x = layer_norm(P, f"{n}.ln3", x + feed_forward(p, "asr", P, f"{n}.ff", x))
        i += 1
    return x


def seq_logits(P, dec, p: Precision = EXACT):
    return _lin(p, "asr", P, "heads.seq_lin", dec)


def lm_logits(L, tokens, nhead: int, p: Precision = EXACT, pad: int = 0):
    """Causal LM: (B, U) tokens -> (B, U, vocab) logits."""
    u = tokens.shape[1]
    d = L["embed.weight"].shape[1]
    x = F.embedding(tokens, L["embed.weight"]) * math.sqrt(d) + positions(u, d, tokens.device)[None]
    causal = torch.tril(torch.ones(u, u, dtype=torch.bool, device=tokens.device))[None, None]
    mask = causal & (tokens != pad)[:, None, None, :]
    i = 0
    while f"layers.{i}.ln1.weight" in L:
        x = encoder_layer(p, "lm", L, f"layers.{i}", x, mask, nhead)
        i += 1
    return _lin(p, "lm", L, "out", x)
