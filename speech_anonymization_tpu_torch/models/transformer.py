"""Transformer ASR stack and its KV-cached beam-decode step.

Counterpart of ``speech_anonymization_tpu/models/transformer.py`` (the ASR
path and its physical and paged decode caches): ``ConvolutionFrontEnd`` (3
conv2d blocks, 4x time subsampling) and ``SBConvFrontEnd`` (SpeechBrain's
layout, for ported reference checkpoints), post-norm encoder/decoder layers
(8 heads, GELU feed-forward), ``TransformerASR`` with ``encode``,
``decode``, ``cross_kv`` and ``decode_step`` (``sb_compat``: exact GELU and
final encoder and decoder LayerNorms), the cache helpers
``use_paged_cache``, ``make_kv_cache``, ``beam_reorder_cache`` and
``make_attends``, and the shallow-fusion ``TransformerLM`` (``forward``,
both heads, ``decode_step`` per layer or through K7).

Layouts follow the JAX package at the public functions: heads flat as
(N, U, H*D) in the cache, (B, T, H, D) for the cross-attention K/V. Module
names mirror the flax tree, so ``utils/convert.py`` maps it one to one.
Numerics follow flax: LayerNorm eps 1e-6, tanh-approximate GELU, SAME
(asymmetric) convolution padding, masked scores set to -1e9.

Train-mode dropout (``dropout`` > 0 and ``train=True``, the JAX package's
sites: the attention weights after the softmax and the feed-forward's hidden
activation) takes its keep masks from a :class:`DropoutRng` passed down the
call, as flax's apply takes ``rngs={"dropout": key}``. ``train=False`` or
``dropout`` 0 runs the plain forward; the decode steps never drop.

The decode step runs the kernels: with paged caches (the default on the
card) self-attention through K5/K6 (``ops/attention_step_paged.py``) and a
beam reorder that gathers an int table; with physical caches
self-attention through K3/K4 (``ops/attention_step.py``) and the beam
reorder through K2 (``ops/beam_gather.py``). The LM's step on a fused paged
cache on the card, given its stacked weights, is one K7 launch for every
layer (``ops/lm_megastep.py``). Unlike the JAX arrays, the
cache is updated in place (the fresh k/v or merged page, the token buffer)
to avoid copying it every step.

int8 caches (``decode_cache_dtype: int8``, the JAX package's quantized
serving mode) hold int8 codes and (L, N, U) f32 ``k_scale``/``v_scale``, by
the contract of ``ops/attention_step.py``, at any U: K3/K5 up to
``max_u_whole_row(M, 2)``, K4/K6 (and K7 for the LM) above it, their twins on
the CPU.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention_step import cached_attention_step, max_u_whole_row, quantize_rows
from ..ops.attention_step_paged import (
    PAGE,
    PAGE_LONG,
    cached_attention_step_paged,
    max_u_for_kernel,
)
from ..ops.beam_gather import beam_gather
from ..ops.lm_megastep import lm_megastep, prepare_lm_megastep
from .init import flax_init_

NEG_INF = -1e9
LN_EPS = 1e-6  # flax nn.LayerNorm default


class DropoutRng:
    """Train-mode dropout's keep masks, as flax's ``nn.Dropout`` makes them:
    keep with probability 1 - rate, kept values divided by 1 - rate (an IEEE
    f32 division), dropped ones 0. The masks are drawn from ``generator`` (on
    its own device; a CUDA generator draws on the card), or taken from
    ``masks`` in call order (a test feeds the masks flax drew). With
    ``record=True`` every mask used is kept in ``used``, in call order."""

    def __init__(self, generator: torch.Generator | None = None,
                 masks: Sequence[torch.Tensor] | None = None, record: bool = False):
        if (generator is None) == (masks is None):
            raise ValueError("DropoutRng takes a generator or given masks")
        self.generator = generator
        self.masks = list(masks) if masks is not None else None
        self.used: list[torch.Tensor] | None = [] if record else None

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        keep_prob = 1.0 - rate
        if self.masks is not None:
            keep = self.masks.pop(0).to(device=x.device, dtype=torch.bool)
            if keep.shape != x.shape:
                raise ValueError(f"given dropout mask {tuple(keep.shape)} for {tuple(x.shape)}")
        else:
            g = self.generator
            keep = (torch.rand(x.shape, generator=g, device=g.device) < keep_prob).to(x.device)
        if self.used is not None:
            self.used.append(keep)
        # a 0-d tensor on x's device: CUDA turns a division by a host scalar
        # into a product by its reciprocal, flax divides
        kp = torch.tensor(keep_prob, dtype=x.dtype, device=x.device)
        return torch.where(keep, x / kp, torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x: torch.Tensor, rate: float, train: bool, rng: DropoutRng | None) -> torch.Tensor:
    """``x`` through train-mode dropout at ``rate``; ``x`` itself unless
    ``train`` and ``rate`` > 0."""
    if rate > 0 and train:
        if rng is None:
            raise ValueError("train-mode dropout needs a DropoutRng")
        return rng(x, rate)
    return x


def lengths_to_padding_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) relative lengths -> (B, max_len) True = valid mask."""
    n = torch.round(lengths * max_len)
    return torch.arange(max_len, device=lengths.device)[None, :] < n[:, None]


def sinusoidal_positions(max_len: int, d_model: int) -> torch.Tensor:
    """(max_len, d_model) table: sin in even columns, cos in odd ones (f32)."""
    pos = torch.arange(max_len, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32) * (-math.log(10000.0) / d_model))
    pe = torch.zeros(max_len, d_model)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def _same_padding(size: int, k: int, s: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial axis: (low, high), low = total // 2."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class ConvolutionFrontEnd(nn.Module):
    """(B, T, F) -> (B, T/4, F/4 * channels[-1]): conv2d (SAME padding) ->
    LayerNorm over channels -> SiLU, three times."""

    def __init__(self, out_channels: Sequence[int] = (128, 256, 512),
                 kernel_sizes: Sequence[int] = (3, 3, 1), strides: Sequence[int] = (2, 2, 1)):
        super().__init__()
        chans = [1, *out_channels]
        self.kernel_sizes, self.strides = tuple(kernel_sizes), tuple(strides)
        self.convs = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], k, stride=s)
            for i, (k, s) in enumerate(zip(kernel_sizes, strides))
        )
        self.norms = nn.ModuleList(nn.LayerNorm(c, eps=LN_EPS) for c in out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[:, None]  # (B, 1, T, F)
        for conv, norm, k, s in zip(self.convs, self.norms, self.kernel_sizes, self.strides):
            t_lo, t_hi = _same_padding(h.shape[2], k, s)
            f_lo, f_hi = _same_padding(h.shape[3], k, s)
            h = conv(F.pad(h, (f_lo, f_hi, t_lo, t_hi)))
            h = F.silu(norm(h.permute(0, 2, 3, 1))).permute(0, 3, 1, 2)
        b, c, t, f = h.shape
        return h.permute(0, 2, 3, 1).reshape(b, t, f * c)


class SBConvFrontEnd(nn.Module):
    """SpeechBrain's ConvolutionFrontEnd, the layout the reference's published
    ASR was trained under: per block a Conv2d with a symmetric ``k // 2`` pad
    (not XLA's SAME, whose (0, 1) pad at an even length shifts the windows),
    a LayerNorm over the trailing (freq, channel) axes (eps 1e-5, weight
    (F', C)), then LeakyReLU (slope 0.01). (B, T, F) -> (B, T/4, F/4 *
    channels[-1]); ``convs[i]`` / ``norms[i]`` hold flax's ``conv_i`` / ``norm_i``."""

    def __init__(self, input_feats: int = 80, out_channels: Sequence[int] = (128, 256, 512),
                 kernel_sizes: Sequence[int] = (3, 3, 1), strides: Sequence[int] = (2, 2, 1)):
        super().__init__()
        chans, freqs = [1, *out_channels], [input_feats]
        for k, s in zip(kernel_sizes, strides):
            freqs.append((freqs[-1] + 2 * (k // 2) - k) // s + 1)
        self.convs = nn.ModuleList(
            nn.Conv2d(chans[i], chans[i + 1], k, stride=s, padding=k // 2)
            for i, (k, s) in enumerate(zip(kernel_sizes, strides))
        )
        self.norms = nn.ModuleList(nn.LayerNorm((f, c), eps=1e-5)
                                   for f, c in zip(freqs[1:], out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[:, None]  # (B, 1, T, F)
        for conv, norm in zip(self.convs, self.norms):
            h = F.leaky_relu(norm(conv(h).permute(0, 2, 3, 1)), 0.01).permute(0, 3, 1, 2)
        b, c, t, f = h.shape
        return h.permute(0, 2, 3, 1).reshape(b, t, f * c)


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, nhead: int, dropout: float = 0.0):
        super().__init__()
        self.d_model, self.nhead, self.d_head = d_model, nhead, d_model // nhead
        self.dropout = dropout
        self.q = nn.Linear(d_model, d_model)
        self.k = nn.Linear(d_model, d_model)
        self.v = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def heads(self, proj: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """(..., D) -> (..., H, Dh) projected heads."""
        return proj(x).unflatten(-1, (self.nhead, self.d_head))

    def kv(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Key/value heads (B, T, H, Dh) of ``x`` (cross-attention memory caching)."""
        return self.heads(self.k, x), self.heads(self.v, x)

    def _context(self, qh, kh, vh, mask, train: bool = False, rng: DropoutRng | None = None):
        scores = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(self.d_head)
        if mask is not None:
            scores = scores.masked_fill(~mask, NEG_INF)
        weights = dropout(torch.softmax(scores, dim=-1), self.dropout, train, rng)
        return torch.einsum("bhqk,bkhd->bqhd", weights, vh)

    def attend_kv(self, q, kh, vh, mask=None):
        """Attention with precomputed key/value heads."""
        return self.out(self._context(self.heads(self.q, q), kh, vh, mask).flatten(-2))

    def attend_kv_grouped(self, q, kh, vh, mask=None):
        """Cross-attention with the memory K/V shared across beam groups.

        q: (N, 1, D) with N = B * K beams; kh/vh: (B, T, H, Dh), not repeated
        per beam; mask: (B, 1, 1, T).
        """
        b = kh.shape[0]
        qg = self.heads(self.q, q).reshape(b, -1, self.nhead, self.d_head)  # (B, K, H, Dh)
        out = self._context(qg, kh, vh, mask)
        return self.out(out.reshape(q.shape[0], 1, self.d_model))

    def attend_cached(self, qh, kh, vh, k_buf, v_buf, mask, step: int, k_scale=None,
                      v_scale=None):
        """Plain cached attention context, the JAX package's reference math.

        qh/kh/vh: (N, 1, H, Dh) current-token heads; k_buf/v_buf: (N, U, M)
        cache holding positions < step (position ``step`` and later may hold
        stale bytes: the fresh kh/vh take position ``step``); mask: optional
        (N, 1, 1, U) key mask; int8 caches: k_scale/v_scale (N, U) f32, the
        buffers dequantized first. Returns the context (N, 1, H, Dh), f32.
        """
        if k_scale is not None:
            k_buf = k_buf.float() * k_scale[:, :, None]
            v_buf = v_buf.float() * v_scale[:, :, None]
        n, u, _ = k_buf.shape
        kb = k_buf.reshape(n, u, self.nhead, self.d_head).float()
        vb = v_buf.reshape(n, u, self.nhead, self.d_head)
        # positions >= step are undefined: zero them before the value product
        pos_v = torch.arange(u, device=k_buf.device).view(1, u, 1, 1)
        vb = torch.where(pos_v < step, vb, torch.zeros((), dtype=vb.dtype, device=vb.device))
        qc = qh.to(k_buf.dtype).float()
        scores = torch.einsum("bqhd,bkhd->bhqk", qc, kb) / math.sqrt(self.d_head)
        s_new = torch.einsum("bqhd,bqhd->bhq", qh, kh)[..., None] / math.sqrt(self.d_head)
        pos = torch.arange(u, device=k_buf.device).view(1, 1, 1, u)
        scores = torch.where(pos == step, s_new, scores)
        scores = torch.where(pos <= step, scores, NEG_INF)
        if mask is not None:
            scores = torch.where(mask, scores, NEG_INF)
        weights = torch.softmax(scores, dim=-1)  # (N, H, 1, U)
        out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v_buf.dtype).float(), vb.float())
        w_step = weights[..., step:step + 1]  # (N, H, 1, 1)
        return out + w_step.permute(0, 2, 1, 3) * vh

    def forward(self, q, kv, mask=None, train: bool = False, rng: DropoutRng | None = None):
        """Full (non-incremental) attention."""
        ctx = self._context(self.heads(self.q, q), self.heads(self.k, kv), self.heads(self.v, kv), mask,
                            train, rng)
        return self.out(ctx.flatten(-2))


class FeedForward(nn.Module):
    """Dense -> GELU -> [dropout] -> Dense; erf GELU with ``exact_gelu``
    (``sb_compat``), else tanh."""

    def __init__(self, d_model: int, d_ffn: int, exact_gelu: bool = False, dropout: float = 0.0):
        super().__init__()
        self.dense0 = nn.Linear(d_model, d_ffn)
        self.dense1 = nn.Linear(d_ffn, d_model)
        self.approximate = "none" if exact_gelu else "tanh"
        self.dropout = dropout

    def forward(self, x, train: bool = False, rng: DropoutRng | None = None):
        h = F.gelu(self.dense0(x), approximate=self.approximate)
        return self.dense1(dropout(h, self.dropout, train, rng))


class EncoderLayer(nn.Module):
    """Post-norm encoder layer."""

    def __init__(self, d_model: int, nhead: int, d_ffn: int, exact_gelu: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.attn = MultiHeadAttention(d_model, nhead, dropout)
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.ff = FeedForward(d_model, d_ffn, exact_gelu, dropout)
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, mask=None, train: bool = False, rng: DropoutRng | None = None):
        x = self.ln1(x + self.attn(x, x, mask, train, rng))
        return self.ln2(x + self.ff(x, train, rng))

    def decode_step(self, x, attend):
        """Cached single-token step. ``attend(qh, kh, vh) -> (N, 1, H, Dh)``
        computes the attention context against the caller's cache. Returns
        (out, kh, vh flat (N, 1, M)) for the caller's cache write."""
        a = self.attn
        kh = a.heads(a.k, x)
        vh = a.heads(a.v, x)
        x = self.ln1(x + a.out(attend(a.heads(a.q, x), kh, vh).flatten(-2)))
        return self.ln2(x + self.ff(x)), kh.flatten(-2), vh.flatten(-2)


class DecoderLayer(nn.Module):
    """Post-norm decoder layer (erf GELU with ``exact_gelu``)."""

    def __init__(self, d_model: int, nhead: int, d_ffn: int, dropout: float = 0.0,
                 exact_gelu: bool = False):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead, dropout)
        self.cross_attn = MultiHeadAttention(d_model, nhead, dropout)
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.ln2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.ln3 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.ff = FeedForward(d_model, d_ffn, exact_gelu, dropout)

    def cross_kv(self, memory):
        """Cross-attention K/V heads of the encoder memory, once per decode."""
        return self.cross_attn.kv(memory)

    def forward(self, x, memory, self_mask=None, cross_mask=None, train: bool = False,
                rng: DropoutRng | None = None):
        x = self.ln1(x + self.self_attn(x, x, self_mask, train, rng))
        x = self.ln2(x + self.cross_attn(x, memory, cross_mask, train, rng))
        return self.ln3(x + self.ff(x, train, rng))

    def decode_step(self, x, attend, cross_kv, cross_mask):
        """Cached single-token step with beam-grouped cross-attention.

        ``attend(qh, kh, vh) -> (N, 1, H, Dh)`` computes the self-attention
        context against the caller's cache; cross_kv: the memory's (B, T, H, Dh)
        heads. Returns (out, kh, vh flat (N, 1, M)) for the caller's cache write.
        """
        sa = self.self_attn
        kh = sa.heads(sa.k, x)
        vh = sa.heads(sa.v, x)
        x = self.ln1(x + sa.out(attend(sa.heads(sa.q, x), kh, vh).flatten(-2)))
        x = self.ln2(x + self.cross_attn.attend_kv_grouped(x, cross_kv[0], cross_kv[1], cross_mask))
        return self.ln3(x + self.ff(x)), kh.flatten(-2), vh.flatten(-2)


def use_paged_cache(batch: int, u_max: int, d_model: int, dtype: torch.dtype,
                    device: str | torch.device) -> bool:
    """The JAX rule for the paged (lazy-beam-reorder) decode cache, with "TPU
    backend" read as "the cache lives on the card": a CUDA device,
    ``d_model % 128 == 0``, ``batch % 8 == 0`` and a U some paged kernel
    serves. The shape conditions are kept so that the same inputs take the
    same layout on both sides."""
    return (
        torch.device(device).type == "cuda"
        and d_model % 128 == 0
        and batch % 8 == 0
        and u_max <= max_u_for_kernel(d_model, max(dtype.itemsize, 2))
    )


def make_kv_cache(batch: int, u_max: int, num_layers: int, nhead: int, d_head: int,
                  dtype: torch.dtype = torch.float32, pad_index: int = 0,
                  device: str | torch.device = "cuda", paged: bool = False,
                  fused: bool = True) -> dict:
    """Stacked KV + token buffers for incremental decoding.

    U is ``u_max`` rounded up to a multiple of 8, to a multiple of 64 above
    ``max_u_whole_row`` (the JAX rounding, so both sides pick the same
    attention kernel), and, paged, to a multiple of the page: 32 for the
    whole-row kernel, 64 (``PAGE_LONG``) above it. ``tokens``: (N, U) filled
    with the pad index so unwritten positions are masked like the full path.

    Physical layout: ``k``/``v`` (L, N, U, H*D), zeros, and ``k_spare``/
    ``v_spare``, the second pair of buffers the beam reorder gathers into (it
    cannot write in place), from ``torch.empty`` (contents undefined).

    Paged layout (the lazy beam reorder, ``ops/attention_step_paged.py``):
    no spare pair; ``table`` (N, U / page) int32, each row owning its own
    pages, and ``act_src`` (N,) int32, the row holding each row's active
    page. Split: ``k``/``v`` (L, N, U, M) and ``k_act``/``v_act``
    (L, N, 2, page, M) parity slots. At page 64 the layout is fused unless
    ``fused=False`` (the JAX package's ``SATPU_FUSED_KV=0``): ``kv``
    (L, N, 2U, M), each logical page stored as [K-page, V-page], and
    ``kv_act`` (L, N, 2, 2 * page, M). All zeros.

    int8 (either layout): the buffers hold codes, and ``k_scale``/``v_scale``
    (L, N, U) f32 zeros the scales, by each row's own logical position. The
    rounding and layout rules are bf16's (itemsize floored at 2, as in JAX):
    up to ``max_u_whole_row(M, 2)`` (426 at M 768) K3/K5 take them, above it
    U rounds to 64 and pages by 64, fused (K4/K6/K7).
    """
    if dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise NotImplementedError(f"{dtype} caches are not ported (float32, bfloat16 and int8 are)")
    m = nhead * d_head
    u = -(-u_max // 8) * 8
    page = PAGE
    if u > max_u_whole_row(m, max(dtype.itemsize, 2)):
        u = -(-u // 64) * 64
        page = PAGE_LONG
    if paged:
        u = -(-u // page) * page
    tokens = torch.full((batch, u), pad_index, dtype=torch.long, device=device)
    scales = {}
    if dtype == torch.int8:
        scales = {key: torch.zeros(num_layers, batch, u, dtype=torch.float32, device=device)
                  for key in ("k_scale", "v_scale")}
    if not paged:
        shape = (num_layers, batch, u, m)
        return {
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "k_spare": torch.empty(shape, dtype=dtype, device=device),
            "v_spare": torch.empty(shape, dtype=dtype, device=device),
            "tokens": tokens,
            **scales,
        }
    rows = torch.arange(batch, dtype=torch.int32, device=device)
    cache = {
        "tokens": tokens,
        **scales,
        # materialized: an expanded view would give the table a zero row stride
        "table": rows[:, None].repeat(1, u // page),
        "act_src": rows,
    }
    if fused and page == PAGE_LONG:
        cache["kv"] = torch.zeros(num_layers, batch, 2 * u, m, dtype=dtype, device=device)
        cache["kv_act"] = torch.zeros(num_layers, batch, 2, 2 * page, m, dtype=dtype, device=device)
    else:
        for key in ("k", "v"):
            cache[key] = torch.zeros(num_layers, batch, u, m, dtype=dtype, device=device)
            cache[f"{key}_act"] = torch.zeros(num_layers, batch, 2, page, m, dtype=dtype,
                                              device=device)
    return cache


def beam_reorder_cache(cache: dict, parent: torch.Tensor, step: int | None = None) -> dict:
    """Reorder the cache to new beam parents, (B, K) ``parent`` within each item.

    Physical: k/v rows move with the K2 gather into the spare buffers, which
    become the live ones (the old ones become the spares): only positions
    <= ``step`` move, later positions are undefined (decode steps mask them
    and overwrite position step + 1 before reading it). ``step=None`` moves
    whole rows.

    Paged: k/v and the active-page slots never move. The ownership table is
    gathered by the parents' rows and ``act_src`` becomes those rows (the
    next attention step reads the parent's parity slot); when ``step``
    completed a page (the kernel wrote it to the main cache at its own row),
    that page's table column becomes the parents' rows. ``step`` is required.

    int8, both layouts: ``k_scale``/``v_scale`` (L, N, U) are gathered along
    N by the parents' rows, whole U, as the JAX package does. They are
    indexed by each row's own position, so in the paged layout they must
    move although the codes do not.
    """
    b, k = parent.shape
    src = (torch.arange(b, device=parent.device)[:, None] * k + parent).reshape(-1).to(torch.int32)
    tokens = cache["tokens"]
    n, u = tokens.shape
    toks = torch.gather(tokens.view(b, k, u), 1, parent[:, :, None].expand(b, k, u)).view(n, u)
    scales = {key: cache[key].index_select(1, src) for key in ("k_scale", "v_scale")
              if key in cache}
    if "table" in cache:
        if step is None:
            raise ValueError("the paged cache reorder needs the decode step")
        table = cache["table"].index_select(0, src)
        page = u // table.shape[1]
        if step % page == page - 1:
            table[:, step // page] = src
        moved = {"table": table, "act_src": src, "tokens": toks, **scales}
        return {**cache, **moved}
    return {
        "k": beam_gather(cache["k"], src, step, cache["k_spare"]),
        "v": beam_gather(cache["v"], src, step, cache["v_spare"]),
        "k_spare": cache["k"],
        "v_spare": cache["v"],
        "tokens": toks,
        **scales,
    }


def _use_kernel(cache: dict) -> bool:
    """The kernel branch runs on the card, as the JAX one runs on the TPU."""
    return (cache["kv"] if "kv" in cache else cache["k"]).device.type == "cuda"


def make_attends(attns: Sequence[MultiHeadAttention], cache: dict, mask_nu: torch.Tensor,
                 step: int, nhead: int):
    """Per-layer ``attend(qh, kh, vh) -> (N, 1, H, Dh)`` closures for a cached
    decode step, plus ``finalize(khs, vhs) -> cache`` entries.

    Paged caches: each layer's attention is one K5/K6 call
    (``ops.attention_step_paged.cached_attention_step_paged``), which writes
    the merged active page in place, so ``finalize`` only returns the
    buffers; on the CPU the same call runs the kernels' plain twins.
    Physical caches on the card: one K3/K4 launch
    (``ops.attention_step.cached_attention_step``), which writes the fresh
    k/v in place. Physical caches elsewhere:
    ``MultiHeadAttention.attend_cached`` on per-layer slices and one stacked
    write at ``step`` in ``finalize``. int8: every path reads and writes the
    scales beside the codes (the kernels in place; ``finalize`` quantizes the
    stacked fresh rows as ``finalize_jnp`` does).
    """
    n, _ = mask_nu.shape
    paged = "table" in cache
    m = (cache["kv"] if "kv" in cache else cache["k"]).shape[-1]
    d = m // nhead
    buffers = {key: cache[key] for key in cache if key != "tokens"}
    if paged or _use_kernel(cache):
        def make(i):
            def attend(qh, kh, vh):
                args = (qh.reshape(n, m), kh.reshape(n, m), vh.reshape(n, m), mask_nu)
                if paged:
                    out = cached_attention_step_paged(*args, cache, step, i, nhead)
                else:
                    out = cached_attention_step(*args, cache["k"], cache["v"], step, i, nhead,
                                                cache.get("k_scale"), cache.get("v_scale"))
                return out.view(n, 1, nhead, d)

            return attend

        return [make(i) for i in range(len(attns))], lambda khs, vhs: buffers

    self_mask = mask_nu[:, None, None, :]

    quant = "k_scale" in cache

    def make_plain(i, attn):
        def attend(qh, kh, vh):
            scales = (cache["k_scale"][i], cache["v_scale"][i]) if quant else ()
            return attn.attend_cached(qh, kh, vh, cache["k"][i], cache["v"][i], self_mask, step,
                                      *scales)

        return attend

    def finalize_plain(khs, vhs):
        for key, fresh in (("k", khs), ("v", vhs)):
            rows = torch.stack(fresh)[:, :, 0]  # (L, N, M) f32
            if quant:
                cache[key][:, :, step], cache[f"{key}_scale"][:, :, step] = quantize_rows(rows)
            else:
                cache[key][:, :, step] = rows.to(cache[key].dtype)
        return buffers

    return [make_plain(i, a) for i, a in enumerate(attns)], finalize_plain


class TransformerASR(nn.Module):
    """Encoder-decoder ASR transformer (post-norm, sinusoidal positions).

    ``sb_compat`` (checkpoints ported from SpeechBrain's layout): exact erf
    GELU in every layer, and a final LayerNorm after the encoder stack
    (``enc_norm``) and after the decoder stack (``dec_norm``, in ``decode``
    and ``decode_step``), both at flax's default eps, as the JAX package's."""

    def __init__(self, input_size: int = 10240, tgt_vocab: int = 5000, d_model: int = 768,
                 nhead: int = 8, num_encoder_layers: int = 12, num_decoder_layers: int = 6,
                 d_ffn: int = 3072, max_len: int = 5000, pad_index: int = 0, dropout: float = 0.0,
                 sb_compat: bool = False):
        super().__init__()
        self.d_model, self.nhead, self.pad_index = d_model, nhead, pad_index
        self.num_decoder_layers, self.sb_compat = num_decoder_layers, sb_compat
        self.input_proj = nn.Linear(input_size, d_model)
        self.register_buffer("pe", sinusoidal_positions(max_len, d_model), persistent=False)
        self.embed = nn.Embedding(tgt_vocab, d_model)
        self.encoder_layers = nn.ModuleList(
            EncoderLayer(d_model, nhead, d_ffn, exact_gelu=sb_compat, dropout=dropout)
            for _ in range(num_encoder_layers))
        self.decoder_layers = nn.ModuleList(
            DecoderLayer(d_model, nhead, d_ffn, dropout, exact_gelu=sb_compat)
            for _ in range(num_decoder_layers))
        if sb_compat:
            self.enc_norm = nn.LayerNorm(d_model, eps=LN_EPS)
            self.dec_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def encode(self, src, src_lengths=None, train: bool = False, rng: DropoutRng | None = None):
        t = src.shape[1]
        x = self.input_proj(src) + self.pe[None, :t]
        mask = None
        if src_lengths is not None:
            mask = lengths_to_padding_mask(src_lengths, t)[:, None, None, :]
        for layer in self.encoder_layers:
            x = layer(x, mask, train, rng)
        return self.enc_norm(x) if self.sb_compat else x

    def decode(self, tgt_tokens, memory, src_lengths=None, train: bool = False,
               rng: DropoutRng | None = None):
        u = tgt_tokens.shape[1]
        x = self.embed(tgt_tokens) * math.sqrt(self.d_model) + self.pe[None, :u]
        causal = torch.tril(torch.ones(u, u, dtype=torch.bool, device=x.device))[None, None]
        self_mask = causal & (tgt_tokens != self.pad_index)[:, None, None, :]
        cross_mask = None
        if src_lengths is not None:
            cross_mask = lengths_to_padding_mask(src_lengths, memory.shape[1])[:, None, None, :]
        for layer in self.decoder_layers:
            x = layer(x, memory, self_mask, cross_mask, train, rng)
        return self.dec_norm(x) if self.sb_compat else x

    def cross_kv(self, memory):
        """Per-layer cross-attention K/V of the encoder memory."""
        return [layer.cross_kv(memory) for layer in self.decoder_layers]

    def decode_step(self, token, memory, cache, step: int, src_lengths=None, cross_kv=None):
        """One decoder step with the stacked KV cache.

        token: (N,) at position ``step``, N = B * beams; memory: (B, T, D), not
        repeated per beam; cache: from :func:`make_kv_cache` (its token buffer
        and k/v are updated in place). Returns (hidden (N, D), cache). Key
        masking matches the full path: causal and pad keys excluded (the pad
        index is also the CTC blank, so a committed blank is masked too, as in
        the JAX package).
        """
        x = self.embed(token[:, None]) * math.sqrt(self.d_model) + self.pe[step][None, None]
        tok_buf = cache["tokens"]
        tok_buf[:, step] = token
        cross_mask = None
        if src_lengths is not None:
            cross_mask = lengths_to_padding_mask(src_lengths, memory.shape[1])[:, None, None, :]
        mask_nu = tok_buf != self.pad_index
        attends, finalize = make_attends([l.self_attn for l in self.decoder_layers], cache, mask_nu,
                                         step, self.nhead)
        khs, vhs = [], []
        for i, layer in enumerate(self.decoder_layers):
            ckv = cross_kv[i] if cross_kv is not None else layer.cross_kv(memory)
            x, kh, vh = layer.decode_step(x, attends[i], ckv, cross_mask)
            khs.append(kh)
            vhs.append(vh)
        if self.sb_compat:
            x = self.dec_norm(x)
        return x[:, 0], {**finalize(khs, vhs), "tokens": tok_buf}


class TransformerLM(nn.Module):
    """Causal LM: token embedding * sqrt(d_model) + sinusoidal positions ->
    post-norm encoder layers under causal and pad-key masks -> vocabulary head.

    Default head: one Linear ``out``. ``sb_compat`` (ported SpeechBrain
    checkpoints): exact erf GELU in the layers, a final LayerNorm ``norm`` and
    the head ``out_a`` (d_model -> d_model / 2) -> ``out_ln`` (eps 1e-5) ->
    ``out_b``. The defaults are the reference LM's published widths (92.7 M
    parameters). With ``generator``, a fresh model takes flax's initialisers
    drawn from it (``models/init.py``); without, torch's (the weights are
    then loaded from a checkpoint).
    """

    def __init__(self, vocab: int = 5000, d_model: int = 768, nhead: int = 12,
                 num_layers: int = 12, d_ffn: int = 3072, max_len: int = 5000,
                 pad_index: int = 0, sb_compat: bool = False, dropout: float = 0.0,
                 generator: torch.Generator | None = None, device: str | torch.device = "cuda"):
        super().__init__()
        self.d_model, self.nhead, self.num_layers, self.d_ffn = d_model, nhead, num_layers, d_ffn
        self.pad_index, self.sb_compat = pad_index, sb_compat
        self.embed = nn.Embedding(vocab, d_model)
        self.register_buffer("pe", sinusoidal_positions(max_len, d_model), persistent=False)
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, nhead, d_ffn, exact_gelu=sb_compat, dropout=dropout)
            for _ in range(num_layers))
        if sb_compat:
            self.norm = nn.LayerNorm(d_model, eps=LN_EPS)
            self.out_a = nn.Linear(d_model, d_model // 2)
            self.out_ln = nn.LayerNorm(d_model // 2, eps=1e-5)
            self.out_b = nn.Linear(d_model // 2, vocab)
        else:
            self.out = nn.Linear(d_model, vocab)
        if generator is not None:
            flax_init_(self, generator)
        self.to(device)

    def _head(self, x):
        if self.sb_compat:
            return self.out_b(self.out_ln(self.out_a(self.norm(x))))
        return self.out(x)

    def forward(self, tokens, train: bool = False, rng: DropoutRng | None = None):
        """(B, U) tokens -> (B, U, vocab) logits."""
        u = tokens.shape[1]
        x = self.embed(tokens) * math.sqrt(self.d_model) + self.pe[None, :u]
        causal = torch.tril(torch.ones(u, u, dtype=torch.bool, device=x.device))[None, None]
        mask = causal & (tokens != self.pad_index)[:, None, None, :]
        for layer in self.layers:
            x = layer(x, mask, train, rng)
        return self._head(x)

    def init_cache(self, batch: int, u_max: int, dtype: torch.dtype = torch.float32,
                   paged: bool = False) -> dict:
        """A decode cache (:func:`make_kv_cache`) on the model's device."""
        return make_kv_cache(batch, u_max, self.num_layers, self.nhead, self.d_model // self.nhead,
                             dtype, self.pad_index, device=self.embed.weight.device, paged=paged)

    def prepare_megastep(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The layer weights stacked for K7 (:func:`ops.lm_megastep.prepare_lm_megastep`).
        Call once per model; pass the result as ``mega=`` to :meth:`decode_step`."""
        mats, rows = [], []
        for layer in self.layers:
            attn, ff = layer.attn, layer.ff
            linears = (attn.q, attn.k, attn.v, attn.out, ff.dense0, ff.dense1)
            mats.append([lin.weight.t() for lin in linears])  # torch's (out, in) -> (in, out)
            rows.append([lin.bias for lin in linears]
                        + [layer.ln1.weight, layer.ln1.bias, layer.ln2.weight, layer.ln2.bias])
        return prepare_lm_megastep(mats, rows)

    def step_layers(self, x, cache: dict, mask_nu, step: int, mega=None):
        """Every layer of one cached step: (N, M) input -> ((N, M) hidden, the
        cache's buffers). With ``mega``, a fused paged cache (``kv``) and the
        cache on the card, one K7 launch (the JAX gate, "TPU" read as "on
        cuda"); otherwise per layer through ``make_attends`` (K5/K6 paged, K3/K4
        physical on the card, their plain twins on the CPU)."""
        if mega is not None and "kv" in cache and _use_kernel(cache):
            out, _, _ = lm_megastep(x, mask_nu, cache["kv"], cache["kv_act"], cache["table"],
                                    cache["act_src"], step, mega[0], mega[1], self.nhead,
                                    exact_gelu=self.sb_compat, k_scale=cache.get("k_scale"),
                                    v_scale=cache.get("v_scale"))
            return out, {key: cache[key] for key in cache if key != "tokens"}
        attends, finalize = make_attends([layer.attn for layer in self.layers], cache, mask_nu,
                                         step, self.nhead)
        h, khs, vhs = x[:, None], [], []
        for layer, attend in zip(self.layers, attends):
            h, kh, vh = layer.decode_step(h, attend)
            khs.append(kh)
            vhs.append(vh)
        return h[:, 0], finalize(khs, vhs)

    def decode_step(self, token, cache: dict, step: int, mega=None):
        """(N,) token at position ``step`` -> ((N, vocab) logits, cache). The
        token buffer and the k/v are updated in place; the key mask is the
        buffer's non-pad positions (pad 0 is also the CTC blank, as in JAX)."""
        x = self.embed(token) * math.sqrt(self.d_model) + self.pe[step]
        tok_buf = cache["tokens"]
        tok_buf[:, step] = token
        x, buffers = self.step_layers(x, cache, tok_buf != self.pad_index, step, mega)
        return self._head(x), {**buffers, "tokens": tok_buf}
