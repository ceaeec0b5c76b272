"""A joint CTC/attention beam search with the LM, in plain PyTorch.

The search the decode under test is held to, written from its definition:
``K`` beams a batch item, only beam 0 alive at step 0; at each of ``steps``
steps every alive beam's candidates c take

    total(g.c) = acc(g) + (1 - w) log p_att(c | g) + l log p_lm(c | g) + w psi(g.c)

with ``acc`` the beam's summed attention and LM terms, each log-probability a
log-softmax of the logits over a temperature, ``w`` the CTC weight, ``l`` the
LM weight and psi the CTC prefix log-probability (the frames begin with g.c);
psi of eos is the probability of the whole of g, and blank is never a
candidate. The eos candidates offer their total over ``step + 1`` to a
finished pool that keeps an item's best; the other candidates' ``K`` best
over all beams are the next step's beams. At the end the pool's best is the
item's hypothesis and score, or, where none finished, the best alive beam's
total over ``steps + 1``.

The decoder and the LM run incrementally, each layer keeping the keys and
values of its inputs so far (the teacher-forced forward of ``models.py``, a
position at a time); the CTC forward variables of each beam run frame by
frame in float64.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import models
from .numerics import EXACT, Precision

NEG = -float("inf")


class _Cached:
    """A post-norm transformer stack run a position at a time over ``n`` rows."""

    def __init__(self, p: Precision, part: str, W: dict, prefix: str, nhead: int, n: int, u: int, device):
        self.p, self.part, self.W, self.nhead = p, part, W, nhead
        self.layers = []
        i = 0
        while f"{prefix}{i}.ln1.weight" in W:
            self.layers.append(f"{prefix}{i}")
            i += 1
        d = W[f"{self.layers[0]}.ln1.weight"].shape[0]
        self.k = torch.zeros(len(self.layers), n, u, d, device=device)
        self.v = torch.zeros_like(self.k)

    def lin(self, name, x):
        return self.p.linear(self.part, x, self.W[f"{name}.weight"], self.W[f"{name}.bias"])

    def attend(self, q, k, v):
        """q (n, h, dh), k and v (n, t, h, dh) -> (n, h * dh)."""
        s = self.p.einsum(self.part, "nhd,nthd->nht", q, k) / math.sqrt(q.shape[-1])
        return self.p.einsum(self.part, "nht,nthd->nhd", torch.softmax(s, -1), v).reshape(q.shape[0], -1)

    def self_attention(self, li: int, name: str, x, t: int):
        n, d = x.shape
        h = self.nhead
        self.k[li, :, t] = self.lin(f"{name}.k", x)
        self.v[li, :, t] = self.lin(f"{name}.v", x)
        q = self.lin(f"{name}.q", x).view(n, h, d // h)
        ctx = self.attend(q, self.k[li, :, : t + 1].view(n, t + 1, h, d // h),
                          self.v[li, :, : t + 1].view(n, t + 1, h, d // h))
        return self.lin(f"{name}.out", ctx)

    def feed_forward(self, name, x):
        return self.lin(f"{name}.dense1", F.gelu(self.lin(f"{name}.dense0", x), approximate="tanh"))

    def reorder(self, rows: torch.Tensor, t: int) -> None:
        self.k[:, :, : t + 1] = self.k[:, rows, : t + 1]
        self.v[:, :, : t + 1] = self.v[:, rows, : t + 1]


class _Decoder(_Cached):
    def __init__(self, p, P, enc, lens, nhead, k_beams, u):
        b, t_enc, d = enc.shape
        super().__init__(p, "asr", P, "transformer.decoder_layers.", nhead, b * k_beams, u, enc.device)
        self.b, self.beams = b, k_beams
        h = nhead
        self.cross = [(self.lin(f"{n}.cross_attn.k", enc).view(b, t_enc, h, d // h),
                       self.lin(f"{n}.cross_attn.v", enc).view(b, t_enc, h, d // h)) for n in self.layers]
        self.cross_mask = models.length_mask(lens, t_enc)[:, None, None, :]
        self.pos = models.positions(u, d, enc.device)

    def cross_attention(self, name: str, x, ck, cv):
        """Each beam's query over its item's encoder states."""
        n, d = x.shape
        q = self.lin(f"{name}.q", x).view(self.b, self.beams, self.nhead, d // self.nhead)
        s = self.p.einsum(self.part, "bkhd,bthd->bkht", q, ck) / math.sqrt(d // self.nhead)
        s = s.masked_fill(~self.cross_mask, models.NEG)
        ctx = self.p.einsum(self.part, "bkht,bthd->bkhd", torch.softmax(s, -1), cv)
        return self.lin(f"{name}.out", ctx.reshape(n, d))

    def step(self, prev, t: int):
        """prev (n,) tokens at position t -> (n, vocab) logits."""
        d = self.pos.shape[1]
        x = F.embedding(prev, self.W["transformer.embed.weight"]) * math.sqrt(d) + self.pos[t]
        for li, (name, (ck, cv)) in enumerate(zip(self.layers, self.cross)):
            x = models.layer_norm(self.W, f"{name}.ln1", x + self.self_attention(li, f"{name}.self_attn", x, t))
            x = models.layer_norm(self.W, f"{name}.ln2", x + self.cross_attention(f"{name}.cross_attn", x, ck, cv))
            x = models.layer_norm(self.W, f"{name}.ln3", x + self.feed_forward(f"{name}.ff", x))
        return self.lin("heads.seq_lin", x)


class _LM(_Cached):
    def __init__(self, p, L, nhead, n, u, device):
        super().__init__(p, "lm", L, "layers.", nhead, n, u, device)
        self.pos = models.positions(u, L["embed.weight"].shape[1], device)

    def step(self, prev, t: int):
        d = self.pos.shape[1]
        x = F.embedding(prev, self.W["embed.weight"]) * math.sqrt(d) + self.pos[t]
        for li, name in enumerate(self.layers):
            x = models.layer_norm(self.W, f"{name}.ln1", x + self.self_attention(li, f"{name}.attn", x, t))
            x = models.layer_norm(self.W, f"{name}.ln2", x + self.feed_forward(f"{name}.ff", x))
        return self.lin("out", x)


def _ctc_frames(lp: torch.Tensor, lens: torch.Tensor, blank: int) -> torch.Tensor:
    """(B, T, V) CTC log-probs -> float64, frames past an item's length
    blank with certainty (so that a prefix's probability carries over them)."""
    b, t, v = lp.shape
    valid = models.length_mask(lens, t)
    pad = torch.full((v,), NEG, dtype=torch.float64, device=lp.device)
    pad[blank] = 0.0
    return torch.where(valid[:, :, None], lp.double(), pad)


def _psi_all(x, k: int, phi, r_b, last, empty, eos: int, blank: int, chunk: int = 1024):
    """psi of every candidate of every beam: x (B, T, V), the beams' states
    (B * k, T) -> (B * k, V) float64."""
    b, t, v = x.shape
    n, dev = b * k, x.device
    first = torch.full((n, 1), NEG, dtype=torch.float64, device=dev)
    first[empty] = 0.0  # the empty prefix before the first frame
    a = torch.cat([first, phi[:, :-1]], 1).view(b, k, t, 1)  # phi at t - 1
    psi = torch.empty(b, k, v, dtype=torch.float64, device=dev)
    for c0 in range(0, v, chunk):
        psi[:, :, c0:c0 + chunk] = torch.logsumexp(a + x[:, None, :, c0:c0 + chunk], 2)
    psi = psi.view(n, v)
    # the candidate that repeats the last token starts after a blank
    a_last = torch.cat([torch.full((n, 1), NEG, dtype=torch.float64, device=dev), r_b[:, :-1]], 1)
    item = torch.arange(b, device=dev).repeat_interleave(k)
    x_last = x[item[:, None], torch.arange(t, device=dev)[None, :], last.clamp_min(0)[:, None]]
    rows = torch.nonzero(last >= 0)[:, 0]
    psi[rows, last[rows]] = torch.logsumexp(a_last + x_last, 1)[rows]
    psi[:, eos] = phi[:, -1]  # the whole prefix, over every frame
    psi[:, blank] = NEG
    return psi


def _advance(x, item, r_nb, r_b, last, empty, chosen, blank):
    """The chosen children's forward variables, frame by frame."""
    n, t = r_b.shape
    phi = torch.where((chosen == last)[:, None], r_b, torch.logaddexp(r_nb, r_b))
    x_c = x[item[:, None], torch.arange(t, device=x.device)[None, :], chosen[:, None]]
    x_b = x[item, :, blank]
    nb, b_ = torch.empty_like(r_nb), torch.empty_like(r_b)
    nb_prev = torch.full((n,), NEG, dtype=torch.float64, device=x.device)
    b_prev = nb_prev.clone()
    phi_prev = torch.full((n,), NEG, dtype=torch.float64, device=x.device)
    phi_prev[empty] = 0.0  # the parent's phi before the first frame
    for f in range(t):
        nb[:, f] = x_c[:, f] + torch.logaddexp(nb_prev, phi_prev)
        b_[:, f] = x_b[:, f] + torch.logaddexp(nb_prev, b_prev)
        nb_prev, b_prev, phi_prev = nb[:, f], b_[:, f], phi[:, f]
    return nb, b_


@torch.no_grad()
def beam_search(P, L, enc, lens, cfg: dict, beam: int, steps: int, nhead: int, lm_nhead: int,
                p: Precision = EXACT):
    """Decode encoder states ``enc`` (B, T, d) -> (tokens (B, steps), lengths
    (B,), scores (B,) float64), as the module doc defines the search."""
    b, _, _ = enc.shape
    k, dev = beam, enc.device
    bos, eos, blank = cfg["bos_index"], cfg["eos_index"], cfg["blank_index"]
    w, lw = cfg["ctc_weight_decode"], cfg["lm_weight"]
    n = b * k
    u = steps + 1
    dec = _Decoder(p, P, enc, lens, nhead, k, u)
    lm = _LM(p, L, lm_nhead, n, u, dev) if lw > 0 else None
    x = _ctc_frames(models.ctc_log_probs(P, enc, p), lens, blank)
    item = torch.arange(b, device=dev).repeat_interleave(k)
    r_nb = torch.full((n, x.shape[1]), NEG, dtype=torch.float64, device=dev)
    r_b = torch.cumsum(x[:, :, blank], 1)[item]
    last = torch.full((n,), -1, dtype=torch.long, device=dev)
    empty = torch.ones(n, dtype=torch.bool, device=dev)
    tokens = torch.full((b, k, u), blank, dtype=torch.long, device=dev)
    tokens[:, :, 0] = bos
    acc = torch.full((b, k), NEG, dtype=torch.float64, device=dev)
    acc[:, 0] = 0.0
    fin_score = torch.full((b,), NEG, dtype=torch.float64, device=dev)
    fin_tokens = tokens[:, 0].clone()
    fin_len = torch.zeros(b, dtype=torch.long, device=dev)
    items = torch.arange(b, device=dev)
    best_alive = torch.full((b,), NEG, dtype=torch.float64, device=dev)
    for t in range(steps):
        prev = tokens[:, :, t].reshape(n)
        add = (1.0 - w) * torch.log_softmax(dec.step(prev, t).double() / cfg["temperature"], -1)
        if lm is not None:
            add = add + lw * torch.log_softmax(lm.step(prev, t).double() / cfg["temperature_lm"], -1)
        phi = torch.logaddexp(r_nb, r_b)
        psi = _psi_all(x, k, phi, r_b, last, empty, eos, blank)
        v = add.shape[1]
        total = acc[:, :, None] + (add + w * psi).view(b, k, v)
        eos_total = total[:, :, eos] / (t + 1)
        best = eos_total.argmax(1)
        better = eos_total[items, best] > fin_score
        fin_score = torch.where(better, eos_total[items, best], fin_score)
        fin_tokens = torch.where(better[:, None], tokens[items, best], fin_tokens)
        fin_len = torch.where(better, t, fin_len)
        total[:, :, eos] = NEG
        top, idx = total.view(b, k * v).topk(k, dim=1)
        best_alive = top[:, 0]
        parent, token = idx // v, idx % v
        rows = (parent + items[:, None] * k).view(n)
        tokens = tokens[items[:, None], parent]
        tokens[:, :, t + 1] = token
        acc = acc.gather(1, parent) + add.view(b, k * v).gather(1, idx)
        r_nb, r_b = _advance(x, item, r_nb[rows], r_b[rows], last[rows], empty[rows], token.view(n), blank)
        last, empty = token.view(n), torch.zeros_like(empty)
        dec.reorder(rows, t)
        if lm is not None:
            lm.reorder(rows, t)
    none = fin_score == NEG
    out_tokens = torch.where(none[:, None], tokens[:, 0], fin_tokens)[:, 1:]
    out_len = torch.where(none, steps, fin_len)
    out_score = torch.where(none, best_alive / (steps + 1), fin_score)
    return out_tokens, out_len, out_score
