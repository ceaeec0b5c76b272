"""Fixed-shape batched transformer beam search with joint CTC scoring.

Counterpart of ``speech_anonymization_tpu/decoding/beam_search.py`` with the
KV-cached decoder interface. The JAX ``lax.scan`` becomes a Python loop over
``max_steps``: the step index is a host integer and nothing in the loop reads
a device value back, so the host only enqueues work.

  * alive beams: (B, K) hypotheses in a (B, K, U_max) token buffer; only
    beam 0 is alive at step 0;
  * candidate scores = (1 - ctc_w) * attn (+ lm_w * lm), accumulated,
    + ctc_w * psi_ctc (full prefix, ``decoding/ctc_prefix.py``);
  * eos candidates update a per-item finished pool (top-1, score normalized
    by step + 1 with length normalization); eos is masked out of the alive
    expansion;
  * after the loop, the best finished hypothesis is returned, or the best
    alive one (its full total, normalized by max_steps + 1) if none finished.

Spans (``utils/profiler.py``) mark each step and its five parts:
``decode.decoder``, ``decode.lm``, ``decode.ctc`` (with device events: the
scoring, and inside ``decode.reorder`` the advance of the chosen prefixes'
state), ``decode.topk`` and ``decode.reorder``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ctc_prefix import (
    CTCPrefixState,
    ctc_advance_state_prepared,
    ctc_init_state,
    ctc_prepare,
    ctc_score_candidates_prepared,
    mask_ctc_log_probs,
    pad_ctc_frames,
)
from ..utils.profiler import reserve, span
from .topk import fast_top_k_counted

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class BeamSearchConfig:
    beam_size: int = 10
    bos_index: int = 1
    eos_index: int = 2
    blank_index: int = 0
    ctc_weight: float = 0.4
    lm_weight: float = 0.0
    temperature: float = 1.0
    temperature_lm: float = 1.0
    length_normalization: bool = False
    max_decode_ratio: float = 1.0
    min_decode_steps: int = 0


def beam_search(att_cached: tuple, enc_out: torch.Tensor, enc_lens: torch.Tensor,
                ctc_log_probs: torch.Tensor | None, cfg: BeamSearchConfig,
                max_steps: int | None = None, lm_cached: tuple | None = None,
                return_stats: bool = False):
    """Decode. Returns (tokens (B, max_steps), lengths (B,), scores (B,)); with
    ``return_stats`` a 4th element ``{'topk_fallbacks': 0-d int32, 'steps': int}``.

    ``att_cached = (init_fn, step_fn, reorder_fn)``: ``init_fn(n, u_max) ->
    state``, ``step_fn(state, prev_token (N,), step) -> (logits (N, V), state)``,
    ``reorder_fn(state, parent (B, K), step) -> state``. ``lm_cached`` follows
    the same contract and is fused at ``cfg.lm_weight``. ``ctc_log_probs``:
    (B, T, V) from the CTC head, or None to disable joint scoring.
    Temperatures are applied here.
    """
    b, t_enc, _ = enc_out.shape
    k = cfg.beam_size
    dev = enc_out.device
    if max_steps is None:
        max_steps = max(int(cfg.max_decode_ratio * t_enc), 1)
    u_max = max_steps + 1  # bos + emitted tokens

    use_ctc = ctc_log_probs is not None and cfg.ctc_weight > 0
    prep = ctc_state = None
    if use_ctc:
        x_ctc = mask_ctc_log_probs(ctc_log_probs, enc_lens, cfg.blank_index)
        t_real = x_ctc.shape[1]
        x_ctc = pad_ctc_frames(x_ctc)
        prep = ctc_prepare(x_ctc, cfg.blank_index, k=k, t_real=t_real)
        ctc_state = ctc_init_state(x_ctc, cfg.blank_index, k=k)
    use_lm = lm_cached is not None and cfg.lm_weight > 0

    tokens = torch.full((b, k, u_max), cfg.blank_index, dtype=torch.long, device=dev)
    tokens[:, :, 0] = cfg.bos_index
    beams = torch.arange(k, device=dev)
    acc = torch.where(beams[None, :] == 0, 0.0, NEG_INF) * torch.ones((b, 1), device=dev)
    fin_score = torch.full((b,), NEG_INF, device=dev)
    fin_tokens = torch.zeros((b, u_max), dtype=torch.long, device=dev)
    fin_len = torch.zeros((b,), dtype=torch.long, device=dev)
    best_total = torch.full((b,), NEG_INF, device=dev)
    n_fallback = torch.zeros((), dtype=torch.int32, device=dev)
    items = torch.arange(b, device=dev)
    att_w = 1.0 - cfg.ctc_weight if use_ctc else 1.0
    att_state = att_cached[0](b * k, u_max)
    lm_state = lm_cached[0](b * k, u_max) if use_lm else None
    if use_ctc:
        reserve(2 * max_steps)  # the CTC spans' events, made ready outside the steps

    for step in range(max_steps):
        with span("decode.step"):
            prev_token = tokens.view(b * k, u_max)[:, step]  # last committed
            with span("decode.decoder"):
                att_logits, att_state = att_cached[1](att_state, prev_token, step)
                scores_step = att_w * torch.log_softmax(att_logits / cfg.temperature, dim=-1)
            if use_lm:
                with span("decode.lm"):
                    lm_logits, lm_state = lm_cached[1](lm_state, prev_token, step)
                    scores_step = scores_step + cfg.lm_weight * torch.log_softmax(
                        lm_logits / cfg.temperature_lm, dim=-1)
            v = scores_step.shape[-1]
            additive = scores_step.view(b, k, v)
            total = acc[:, :, None] + additive
            if use_ctc:
                with span("decode.ctc", device=True):
                    psi = ctc_score_candidates_prepared(prep, ctc_state, cfg.eos_index, cfg.blank_index)
                    total = total + cfg.ctc_weight * psi.view(b, k, v)

            with span("decode.topk"):
                # finished pool from the eos column; the reference normalizes by
                # the token count including the eos step, step + 1
                norm = float(step + 1) if cfg.length_normalization else 1.0
                eos_scores = total[:, :, cfg.eos_index] / norm
                if step < cfg.min_decode_steps:
                    eos_scores = torch.full_like(eos_scores, NEG_INF)
                best_eos = torch.argmax(eos_scores, dim=1)
                best_eos_score = eos_scores[items, best_eos]
                improved = best_eos_score > fin_score
                fin_tokens = torch.where(improved[:, None], tokens[items, best_eos], fin_tokens)
                fin_len = torch.where(improved, step, fin_len)
                fin_score = torch.where(improved, best_eos_score, fin_score)

                # alive expansion: eos masked, exact top-k over K*V
                alive = total.clone()
                alive[:, :, cfg.eos_index] = NEG_INF
                top_val, top_idx, fell_back = fast_top_k_counted(alive.view(b, k * v), k)
                n_fallback = n_fallback + fell_back
                parent = torch.div(top_idx, v, rounding_mode="floor")
                token = top_idx % v
                best_total = top_val[:, 0]  # full score of the best alive beam, for the fallback

            with span("decode.reorder"):
                tokens = torch.gather(tokens, 1, parent[:, :, None].expand(b, k, u_max))
                tokens[:, :, step + 1] = token
                acc = torch.gather(acc, 1, parent) + torch.gather(additive.reshape(b, k * v), 1, top_idx)
                if use_ctc:
                    flat_parent = (parent + items[:, None] * k).view(-1)
                    gathered = CTCPrefixState(*(s[flat_parent] for s in ctc_state))
                    with span("decode.ctc", device=True):
                        ctc_state = ctc_advance_state_prepared(prep, gathered, token.view(-1), cfg.blank_index)
                att_state = att_cached[2](att_state, parent, step)
                if use_lm:
                    lm_state = lm_cached[2](lm_state, parent, step)

    norm = float(max_steps + 1) if cfg.length_normalization else 1.0
    none_finished = fin_score <= NEG_INF / 2
    out_tokens = torch.where(none_finished[:, None], tokens[:, 0], fin_tokens)
    out_len = torch.where(none_finished, max_steps, fin_len)
    out_score = torch.where(none_finished, best_total / norm, fin_score)
    # strip bos: emitted tokens start at column 1
    if return_stats:
        return out_tokens[:, 1:], out_len, out_score, {"topk_fallbacks": n_fallback,
                                                       "steps": max_steps}
    return out_tokens[:, 1:], out_len, out_score


def hyps_to_lists(tokens, lengths) -> list[list[int]]:
    """Decode outputs -> python token id lists (host side)."""
    toks = np.asarray(torch.as_tensor(tokens).cpu())
    lens = np.asarray(torch.as_tensor(lengths).cpu())
    return [list(map(int, toks[i, : int(lens[i])])) for i in range(toks.shape[0])]
