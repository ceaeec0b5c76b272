"""Batched CTC prefix scoring for joint CTC/attention beam decoding.

Counterpart of ``speech_anonymization_tpu/decoding/ctc_prefix.py``. For a
hypothesis prefix g and every candidate extension c, the prefix probability

    psi(g.c) = logsumexp_t( phi(t-1) + x[t, c] )
    phi(t)   = logaddexp(r_nb(g,t), r_b(g,t)),  or r_b(g,t) when c == last(g)

with the blank/non-blank forward variables r_b, r_nb. Both per-step
computations are parallel over frames:

  * scoring all V candidates: since x are log-probs (exp(x) <= 1),
    psi = log(exp(phi_shift - max) @ exp(x)) + max, one batched matmul
    against a cached exp(x) (B, T, V); the c == last(g) column and the eos
    column are patched separately;
  * advancing the forward variables for the chosen tokens: the coupled
    recursions compose as 3x3 matrices in the log semiring, solved by a
    Hillis-Steele scan in ceil(log2 T) stages (7 or 8 at T = 128 or 256),
    not a per-frame loop. Its association order differs from
    ``jax.lax.associative_scan``'s, so the two agree to rounding, not bits.

Per-item length padding gets blank log-prob 0 and -inf elsewhere
(:func:`mask_ctc_log_probs`); padding of the frame axis to a multiple of 128
uses all -inf rows plus the last real frame index (:func:`pad_ctc_frames`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e30


class CTCPrefixState(NamedTuple):
    r_nb: torch.Tensor          # (N, T) log prob that the prefix ends non-blank at frame t
    r_b: torch.Tensor           # (N, T) log prob that the prefix ends blank at frame t
    last_token: torch.Tensor    # (N,) last real token of the prefix (-1 if empty)
    prefix_empty: torch.Tensor  # (N,) bool


class PreparedCTC(NamedTuple):
    x: torch.Tensor         # (B, T, V) masked log-probs (shared by all beams)
    exp_x: torch.Tensor     # (B, T, V) = exp(x)
    blank_lp: torch.Tensor  # (B, T)
    k: int = 1              # beams per batch item; states have N = B*k rows
    t_real: int = -1        # frame count before the frame padding; -1 = x's own T


def mask_ctc_log_probs(x: torch.Tensor, enc_lens: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """Neutralize padding frames: blank -> 0 logp, others -> -inf."""
    _, t, v = x.shape
    valid = torch.arange(t, device=x.device)[None, :] < torch.round(enc_lens * t)[:, None]
    pad_row = torch.full((v,), NEG_INF, dtype=x.dtype, device=x.device)
    pad_row[blank] = 0.0
    return torch.where(valid[:, :, None], x, pad_row)


def pad_ctc_frames(x: torch.Tensor, multiple: int = 128) -> torch.Tensor:
    """Pad the frame axis of (B, T, V) log-probs to a multiple with all -inf
    rows (-inf in the blank column too: a blank-neutral row would hand a
    prefix ending in a committed blank spurious mass). Callers pass the
    pre-pad frame count to :func:`ctc_prepare` as ``t_real``."""
    b, t, v = x.shape
    rem = (-t) % multiple
    if rem == 0:
        return x
    return torch.cat([x, torch.full((b, rem, v), NEG_INF, dtype=x.dtype, device=x.device)], dim=1)


def ctc_prepare(x: torch.Tensor, blank: int = 0, k: int = 1, t_real: int | None = None) -> PreparedCTC:
    """Cache exp(x) once per decode; ``k`` beams share each item's x."""
    return PreparedCTC(x=x, exp_x=torch.exp(x), blank_lp=x[:, :, blank], k=k,
                       t_real=x.shape[1] if t_real is None else t_real)


def ctc_init_state(x: torch.Tensor, blank: int = 0, k: int = 1) -> CTCPrefixState:
    """State of the empty prefix: r_b = cumulative blank, r_nb = -inf; rows
    beam-major per item (row n = item n // k)."""
    b, t, _ = x.shape
    n = b * k
    return CTCPrefixState(
        r_nb=torch.full((n, t), NEG_INF, dtype=x.dtype, device=x.device),
        r_b=torch.repeat_interleave(torch.cumsum(x[:, :, blank], dim=1), k, dim=0),
        last_token=torch.full((n,), -1, dtype=torch.long, device=x.device),
        prefix_empty=torch.ones((n,), dtype=torch.bool, device=x.device),
    )


def _phi_shift(values: torch.Tensor, init: torch.Tensor) -> torch.Tensor:
    """[init, values[0], ..., values[T-2]] along the frame axis."""
    return torch.cat([init[:, None], values[:, :-1]], dim=1)


def _gather_x_per_beam(x: torch.Tensor, tokens: torch.Tensor, k: int) -> torch.Tensor:
    """x (B, T, V), tokens (N = B*k,) -> (N, T) columns of x per beam."""
    b, t, _ = x.shape
    cols = torch.gather(x, 2, tokens.view(b, 1, k).expand(b, t, k))  # (B, T, K)
    return cols.permute(0, 2, 1).reshape(b * k, t)


def ctc_score_candidates_prepared(prep: PreparedCTC, state: CTCPrefixState, eos_index: int,
                                  blank: int = 0) -> torch.Tensor:
    """psi (N, V) via one batched matmul and column patches (module doc)."""
    b, t, v = prep.x.shape
    k = prep.k
    n = b * k
    neg = torch.full((n,), NEG_INF, dtype=prep.x.dtype, device=prep.x.device)
    init_prev = torch.where(state.prefix_empty, 0.0, neg)  # phi(-1)
    a = _phi_shift(torch.logaddexp(state.r_nb, state.r_b), init_prev)  # (N, T)
    # empty prefixes have a[0] = 0, so max >= 0 there; fully -inf rows stay guarded
    amax_safe = torch.clamp_min(a.max(dim=1, keepdim=True).values, NEG_INF / 2)
    exp_a = torch.where(a > NEG_INF / 2, torch.exp(a - amax_safe), 0.0)
    dots = torch.bmm(exp_a.view(b, k, t), prep.exp_x).view(n, v)
    psi = torch.where(dots > 0, torch.log(torch.clamp_min(dots, 1e-38)) + amax_safe, NEG_INF)

    # c == last(g): phi uses r_b instead
    last = state.last_token
    a_last = _phi_shift(state.r_b, neg)
    x_last = _gather_x_per_beam(prep.x, torch.clamp_min(last, 0), k)
    psi_last = torch.logsumexp(a_last + x_last, dim=1)
    is_last = (torch.arange(v, device=psi.device)[None, :] == last[:, None]) & (last >= 0)[:, None]
    psi = torch.where(is_last, psi_last[:, None], psi)

    # eos: the full-sequence score at the last REAL frame
    tr = prep.t_real if prep.t_real > 0 else t
    psi[:, eos_index] = torch.logaddexp(state.r_nb[:, tr - 1], state.r_b[:, tr - 1])
    # block blank for joint scoring, as the reference scorer does
    if blank != eos_index:
        psi[:, blank] = NEG_INF
    return psi


def ctc_score_candidates(x: torch.Tensor, state: CTCPrefixState, eos_index: int,
                         blank: int = 0) -> torch.Tensor:
    """Convenience wrapper computing exp(x) on the fly (tests / one-shot)."""
    return ctc_score_candidates_prepared(ctc_prepare(x, blank), state, eos_index, blank)


def _logmatmul3(m2: torch.Tensor, m1: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) log-semiring product: out_ij = LSE_k(m2_ik + m1_kj)."""
    return torch.logsumexp(m2[..., :, :, None] + m1[..., None, :, :], dim=-2)


def _prefix_products(m: torch.Tensor) -> torch.Tensor:
    """P[t] = M[t] o ... o M[0] along axis 1 (newest on the left), by a
    Hillis-Steele scan: ceil(log2 T) stages of one batched product each."""
    t = m.shape[1]
    d = 1
    while d < t:
        m = torch.cat([m[:, :d], _logmatmul3(m[:, d:], m[:, :-d])], dim=1)
        d *= 2
    return m


def ctc_advance_state_prepared(prep: PreparedCTC, state: CTCPrefixState, chosen: torch.Tensor,
                               blank: int = 0) -> CTCPrefixState:
    """Child forward variables for the chosen tokens, (N,).

    Per frame, with w[t] = x[t, c], bl[t] = x[t, blank], q[t] = phi_col(parent):
        l_nb[t] = w[t]  + LSE(l_nb[t-1], q[t-1])
        l_b[t]  = bl[t] + LSE(l_nb[t-1], l_b[t-1])
    As 3x3 log-matrices over s = [l_nb, l_b, 0]:
        M[t] = [[w, -inf, w + q[t-1]], [bl, bl, -inf], [-inf, -inf, 0]]
    and s[t] = P[t][:, 2] for the prefix products P.
    """
    b, t, _ = prep.x.shape
    k = prep.k
    n = b * k
    x_sel = _gather_x_per_beam(prep.x, chosen, k)
    blank_lp = torch.repeat_interleave(prep.blank_lp, k, dim=0)
    phi = torch.logaddexp(state.r_nb, state.r_b)
    phi = torch.where((chosen == state.last_token)[:, None], state.r_b, phi)
    neg = torch.full((n, t), NEG_INF, dtype=x_sel.dtype, device=x_sel.device)
    init_prev = torch.where(state.prefix_empty, 0.0, neg[:, 0])
    q_shift = _phi_shift(phi, init_prev)
    m = torch.stack([
        torch.stack([x_sel, neg, x_sel + q_shift], dim=-1),
        torch.stack([blank_lp, blank_lp, neg], dim=-1),
        torch.stack([neg, neg, torch.zeros_like(neg)], dim=-1),
    ], dim=-2)  # (N, T, 3, 3)
    prefix = _prefix_products(m)
    return CTCPrefixState(
        r_nb=prefix[:, :, 0, 2],
        r_b=prefix[:, :, 1, 2],
        last_token=chosen.long(),
        prefix_empty=torch.zeros((n,), dtype=torch.bool, device=chosen.device),
    )


def ctc_advance_state(x: torch.Tensor, state: CTCPrefixState, chosen: torch.Tensor,
                      blank: int = 0) -> CTCPrefixState:
    """Convenience wrapper (tests / one-shot)."""
    return ctc_advance_state_prepared(ctc_prepare(x, blank), state, chosen, blank)
