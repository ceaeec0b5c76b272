"""The adversarial anonymizer's first updates, in plain PyTorch.

Updates of the reference recipe at accumulation ``k`` (convae.yaml: 3): for
each of ``k`` micro-batches, the log-mel features, the normalizer's
statistics folded in, the features padded to a multiple of 36, SpecAugment
on the given draws, the ConvAutoencoder in training (its TDNN sex head on
batch statistics behind the gradient reversal), the losses weighted by the
phase (the generator phase: sex 0.8, utility 0.2, where utility is the MSE
between the frozen ASR decoder's states on the clean and on the
reconstructed features, teacher-forced on the utterances' tokens; the
classifier phase: sex 0.5), and the gradients by autograd, averaged over the
``k``; then the phase's mask (the generator phase leaves the sex head out,
the classifier phase everything else), the clip to global norm 5, Noam's
learning rate at the update's count and the phase's own Adam (b1 0.9, b2
0.98, eps 1e-9) on every parameter.
"""

from __future__ import annotations

import torch

from . import frontend, models
from .numerics import EXACT, Precision

LN_HALF = -0.6931  # the confusion loss's target, as the recipe rounds ln(1/2)


def micro_batch_loss(P, asr, batch, draws, norm: frontend.Normalizer, weights, asr_nhead: int,
                     p: Precision = EXACT):
    """-> the weighted loss of one micro-batch; folds its statistics into ``norm``."""
    wavs, lens, labels, tokens_bos = batch
    feats = frontend.fbank(wavs, p)
    norm.update(feats, lens)
    clean = frontend.pad_time(norm(feats))
    aug = frontend.spec_augment(clean, *draws)
    recon, sex_lp = models.autoencoder(P, aug, train=True, p=p)
    b = clean.shape[0]
    recon_loss = torch.mean((recon.reshape(b, -1) - clean.reshape(b, -1)) ** 2)
    sex_loss = -sex_lp.gather(1, labels.long()[:, None]).mean()
    confusion = torch.mean((sex_lp - LN_HALF) ** 2)
    w_recon, w_sex, w_util, w_conf = weights
    utility = torch.zeros((), device=clean.device)
    if w_util:
        with torch.no_grad():
            dec_o = models.asr_decode(asr, tokens_bos, models.asr_encode(asr, clean, lens, asr_nhead, p), lens,
                                      asr_nhead, p)
        dec_r = models.asr_decode(asr, tokens_bos, models.asr_encode(asr, recon, lens, asr_nhead, p), lens,
                                  asr_nhead, p)
        utility = torch.mean((dec_r - dec_o) ** 2)
    return w_recon * recon_loss + w_sex * sex_loss + w_util * utility + w_conf * confusion


def noam_lr(step: int, lr_initial: float, warmup: int, model_size: int) -> float:
    return lr_initial * model_size ** -0.5 * min(step ** -0.5, step * warmup ** -1.5)


def updates(P0: dict, trainable: list, asr, batches, draws, phases, cfg: dict, p: Precision = EXACT):
    """The updates of the reference recipe from weights ``P0`` (not changed),
    ``gradient_accumulation`` micro-batches each; ``phases`` gives each
    update's (loss weights, the leaves its mask leaves out, its optimizer's
    name). -> (every micro-batch's loss, {optimizer: the gradient it took at
    its first update, by leaf}, [the parameters after each update])."""
    k = cfg["gradient_accumulation"]
    P = {n: (v.detach().clone().requires_grad_(True) if n in trainable else v) for n, v in P0.items()}
    norm = frontend.Normalizer(device=next(iter(P.values())).device)
    b1, b2, eps = 0.9, 0.98, 1e-9
    adam: dict = {}
    losses, first, after = [], {}, []
    for step, (weights, masked, opt) in enumerate(phases, start=1):
        acc = {n: torch.zeros_like(P[n]) for n in trainable}
        for i in range((step - 1) * k, step * k):
            loss = micro_batch_loss(P, asr, batches[i], draws[i], norm, weights, cfg["nhead"], p)
            grads = torch.autograd.grad(loss, [P[n] for n in trainable], allow_unused=True)
            for n, g in zip(trainable, grads):
                if g is not None:
                    acc[n] += g / k
            losses.append(float(loss.detach()))
        g = {n: acc[n] * (0.0 if n in masked else 1.0) for n in trainable}
        gnorm = torch.sqrt(sum((x.double() ** 2).sum() for x in g.values()))
        scale = min(1.0, cfg["gradient_clipping"] / max(float(gnorm), 1e-12))
        g = {n: x * scale for n, x in g.items()}
        lr = noam_lr(step, cfg["lr_initial"], cfg["n_warmup_steps"], cfg["noam_model_size"])
        count, mu, nu = adam.get(opt, (0, {n: 0.0 for n in g}, {n: 0.0 for n in g}))
        count += 1
        mu = {n: b1 * mu[n] + (1 - b1) * x for n, x in g.items()}
        nu = {n: b2 * nu[n] + (1 - b2) * x * x for n, x in g.items()}
        adam[opt] = (count, mu, nu)
        first.setdefault(opt, g)
        with torch.no_grad():
            for n in g:
                upd = (mu[n] / (1 - b1 ** count)) / (torch.sqrt(nu[n] / (1 - b2 ** count)) + eps)
                P[n] -= lr * upd
        after.append({n: P[n].detach().clone() for n in trainable})
    return losses, first, after
