"""The score a joint CTC/attention beam search gives a hypothesis, recomputed.

The decode under test returns, for each utterance, its best hypothesis and
that hypothesis's score. The score of a token sequence y is fixed by the
models alone:

    sum_i [(1 - c) log p_att(y_i | y_<i) + l log p_lm(y_i | y_<i)] + c psi(y)

with ``c`` the CTC weight, ``l`` the LM weight, each log-probability a
log-softmax of the logits over a temperature, and psi the CTC prefix
log-probability of y (the probability that the frames begin with y, summed
over every frame where y's last token is first emitted). A hypothesis that
ended with eos takes eos's attention and LM terms too and the CTC
probability of the whole sequence in place of psi; with length
normalization the sum is divided by the tokens scored, eos included, or by
the step count plus one for a hypothesis still alive at the end. Here it is
computed teacher-forced, all positions at once, and the CTC terms by the
forward recursion over frames in float64.
"""

from __future__ import annotations

import torch

from . import models
from .numerics import EXACT, Precision


def ctc_prefix_and_full(lp: torch.Tensor, y: torch.Tensor, blank: int = 0):
    """lp (T, V) CTC log-probs of one utterance, y (L,) tokens, no blank ->
    (psi(y), log P(y) over all T frames), float64."""
    lp = lp.double()
    t_len, n = lp.shape[0], y.shape[0]
    if n == 0:
        return torch.tensor(0.0, dtype=torch.float64, device=lp.device), lp[:, blank].sum()
    neg = torch.tensor(-float("inf"), dtype=torch.float64, device=lp.device)
    x = lp[:, y]  # (T, L)
    bl = lp[:, blank]
    # prefixes of length 0..L: r_nb, r_b at the previous frame
    r_nb = torch.full((n + 1,), -float("inf"), dtype=torch.float64, device=lp.device)
    r_b = r_nb.clone()
    same = torch.zeros(n + 1, dtype=torch.bool, device=lp.device)
    same[2:] = y[1:] == y[:-1]
    psi_terms = []
    for t in range(t_len):
        # phi of each prefix's parent at t - 1 (prefix l's parent is l - 1)
        phi_parent = torch.logaddexp(r_nb[:-1], r_b[:-1])
        phi_parent = torch.where(same[1:], r_b[:-1], phi_parent)
        if t == 0:
            phi_parent = torch.full_like(phi_parent, -float("inf"))
            phi_parent[0] = 0.0  # the empty prefix before the first frame
        # psi(y): y's last token first emitted at t, after its parent
        psi_terms.append(phi_parent[n - 1] + x[t, n - 1])
        new_nb = torch.cat([neg[None], x[t] + torch.logaddexp(r_nb[1:], phi_parent)])
        prev_b0 = torch.tensor(0.0, dtype=torch.float64, device=lp.device) if t == 0 else r_b[0]
        new_b = bl[t] + torch.cat([prev_b0[None], torch.logaddexp(r_nb[1:], r_b[1:])])
        r_nb, r_b = new_nb, new_b
    psi = torch.logsumexp(torch.stack(psi_terms), 0)
    return psi, torch.logaddexp(r_nb[n], r_b[n])


def rescore(asr, lm, enc, lens, tokens, lengths, cfg: dict, steps: int, nhead: int, lm_nhead: int,
            p: Precision = EXACT) -> torch.Tensor:
    """Scores of the given hypotheses (B, steps) with their lengths, as the
    beam search defines them (module doc); ``enc`` the encoder states of the
    same utterances. -> (B,) float64."""
    b = tokens.shape[0]
    bos, eos, blank = cfg["bos_index"], cfg["eos_index"], cfg["blank_index"]
    c, lw = cfg["ctc_weight_decode"], cfg["lm_weight"]
    ctc = models.ctc_log_probs(asr, enc, p)
    t_real = torch.round(lens * enc.shape[1]).long()
    out = []
    for i in range(b):
        n = int(lengths[i])
        finished = n < steps
        y = tokens[i, :n].long()
        scored = torch.cat([y, y.new_full((1,), eos)]) if finished else y
        inp = torch.cat([y.new_full((1,), bos), y])[: scored.shape[0]][None]
        dec = models.asr_decode(asr, inp, enc[i:i + 1], lens[i:i + 1], nhead, p)
        att = torch.log_softmax(models.seq_logits(asr, dec, p)[0].double() / cfg["temperature"], -1)
        total = (1.0 - c) * att.gather(1, scored[:, None]).sum()
        if lw > 0:
            lm_lp = torch.log_softmax(models.lm_logits(lm, inp, lm_nhead, p)[0].double() / cfg["temperature_lm"], -1)
            total = total + lw * lm_lp.gather(1, scored[:, None]).sum()
        psi, full = ctc_prefix_and_full(ctc[i, : int(t_real[i])], y, blank)
        total = total + c * (full if finished else psi)
        norm = float(n + 1) if finished else float(steps + 1)
        out.append(total / norm)
    return torch.stack(out)
