"""The ASR and LM recipes' losses (``losses/basic.py``) against the JAX
package's on seeded inputs (CPU, JAX jitted):

  * ``kldiv_loss`` at label smoothing 0 and 0.1 under the three reductions,
    with relative lengths; the (B, T, C) ``nll_loss`` with lengths; ``l1_loss``;
  * ``ctc_loss`` on rows an alignment fits: the value and the gradient with
    respect to the pre-softmax logits (through the model's log-softmax, where
    torch's CTC gradient convention and optax's agree), and the three
    reductions;
  * ``ctc_loss`` on a row no alignment fits (repeated labels over too few
    frames): optax's finite ~1e5 value (``F.ctc_loss`` would give inf) and its
    gradient, and ``ctc_feasible`` deciding which rows are which;
  * relative lengths whose ``len * T`` lands on .5: both round half to even.

Tolerances: values rtol 1e-5 (measured <= ~2e-7); the feasible rows'
gradients atol 1e-5 (~2e-7). The infeasible row's gradient is f32-limited in
both packages: its loss is ~1e5, so log-space sums cancel at an f32 ulp of
~8e-3 and the posteriors carry ~1e-3 of error; JAX's f32 gradient lies
~9e-4 from a float64 run there and the port's ~3e-4
(``test_infeasible_row_gradient_is_f32_limited``), so the two are held to
INFEASIBLE_GRAD_ATOL = 2e-3 of each other and of float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_anonymization_tpu.losses import basic as J
from speech_anonymization_tpu_torch.losses import basic as P
from tests.torch_port_helpers import t

RTOL = 1e-5
GRAD_ATOL = 1e-5
INFEASIBLE_GRAD_ATOL = 2e-3
B, T, C, U = 4, 12, 7, 5


def _inputs(seed: int, per_frame: bool = False):
    """-> (B, T, C) logits, targets ((B, T) per frame, else (B, U) labels), relative lengths."""
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((B, T, C))).astype(np.float32)
    targets = rng.integers(0 if per_frame else 1, C, (B, T if per_frame else U)).astype(np.int32)
    lens = np.array([1.0, 0.75, 0.5, 0.9], np.float32)
    return logits, targets, lens


@pytest.mark.parametrize("reduction", ["batchmean", "mean", "sum"])
@pytest.mark.parametrize("ls", [0.0, 0.1])
def test_kldiv_matches_jax(ls, reduction):
    logits, targets, lens = _inputs(1, per_frame=True)
    lp = np.asarray(jax.nn.log_softmax(logits, -1))
    want = jax.jit(lambda a, b, c: J.kldiv_loss(a, b, c, ls, reduction))(lp, targets, lens)
    got = P.kldiv_loss(t(lp), t(targets), t(lens), ls, reduction)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    no_len = jax.jit(lambda a, b: J.kldiv_loss(a, b, None, ls, reduction))(lp, targets)
    np.testing.assert_allclose(float(P.kldiv_loss(t(lp), t(targets), None, ls, reduction)), float(no_len), rtol=RTOL)


def test_sequence_nll_and_l1_match_jax():
    logits, targets, lens = _inputs(2, per_frame=True)
    lp = np.asarray(jax.nn.log_softmax(logits, -1))
    want = jax.jit(J.nll_loss)(lp, targets, lens)
    np.testing.assert_allclose(float(P.nll_loss(t(lp), t(targets), t(lens))), float(want), rtol=RTOL)
    np.testing.assert_allclose(float(P.nll_loss(t(lp), t(targets))), float(jax.jit(J.nll_loss)(lp, targets)),
                               rtol=RTOL)
    b = np.random.default_rng(3).standard_normal(logits.shape).astype(np.float32)
    np.testing.assert_allclose(float(P.l1_loss(t(logits), t(b))), float(jax.jit(J.l1_loss)(logits, b)), rtol=RTOL)


def _ctc_both(logits, targets, in_lens, tg_lens, reduction="batchmean"):
    """-> ((port loss, port grad), (JAX loss, JAX grad)) w.r.t. the logits before the log-softmax."""
    f = jax.jit(jax.value_and_grad(lambda z: J.ctc_loss(jax.nn.log_softmax(z, -1), targets, in_lens, tg_lens,
                                                        reduction=reduction)))
    jl, jg = f(jnp.asarray(logits))
    x = t(logits).requires_grad_(True)
    pl = P.ctc_loss(torch.log_softmax(x, -1), t(targets), t(in_lens), t(tg_lens), reduction=reduction)
    (pg,) = torch.autograd.grad(pl, x)
    return (float(pl.detach()), pg.numpy()), (float(jl), np.asarray(jg))


@pytest.mark.parametrize("reduction", ["batchmean", "mean", "sum"])
def test_ctc_feasible_rows_match_optax(reduction):
    logits, targets, lens = _inputs(4)
    tg_lens = np.array([1.0, 0.6, 0.4, 0.8], np.float32)
    assert P.ctc_feasible(targets, lens, T, tg_lens).all()
    (pl, pg), (jl, jg) = _ctc_both(logits, targets, lens, tg_lens, reduction)
    np.testing.assert_allclose(pl, jl, rtol=RTOL)
    np.testing.assert_allclose(pg, jg, atol=GRAD_ATOL)
    assert np.abs(pg[1, round(0.75 * T):]).max() == 0.0  # frames past a row's length take no gradient


def _infeasible():
    logits, targets, lens = _inputs(5)
    targets[3] = 3  # five repeated labels need 9 frames
    lens[3] = 0.25  # 3 frames
    tg_lens = np.array([1.0, 0.6, 0.4, 1.0], np.float32)
    return logits, targets, lens, tg_lens


def test_ctc_infeasible_row_matches_optax():
    logits, targets, lens, tg_lens = _infeasible()
    assert P.ctc_feasible(targets, lens, T, tg_lens).tolist() == [True, True, True, False]
    (pl, pg), (jl, jg) = _ctc_both(logits, targets, lens, tg_lens, "sum")
    assert pl > 1e5  # finite: optax's log-epsilon, where F.ctc_loss gives inf
    np.testing.assert_allclose(pl, jl, rtol=RTOL)
    np.testing.assert_allclose(pg[:3], jg[:3], atol=GRAD_ATOL)
    np.testing.assert_allclose(pg[3], jg[3], atol=INFEASIBLE_GRAD_ATOL)
    # the plain recursion is optax's on every row, the feasible ones too
    pads = (np.arange(T)[None] >= np.round(lens * T)[:, None]).astype(np.float32)
    lpads = (np.arange(U)[None] >= np.round(tg_lens * U)[:, None]).astype(np.float32)
    import optax

    want = jax.jit(optax.ctc_loss)(logits, pads, targets, lpads)
    got = P.ctc_loss_plain(t(logits), t(pads), t(targets), t(lpads))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    # ctc_loss reads its counts back itself when the caller gives none, or takes the host's
    given = P.ctc_loss(torch.log_softmax(t(logits), -1), t(targets), t(lens), t(tg_lens), reduction="sum",
                       host=(targets, lens, tg_lens))
    assert float(given) == pl


def test_infeasible_row_gradient_is_f32_limited():
    """Why the infeasible row's gradient takes INFEASIBLE_GRAD_ATOL: JAX's own
    f32 gradient lies ~1e-3 from its float64 run, the port's within the same."""
    logits, targets, lens, tg_lens = _infeasible()
    (_, pg), (_, jg) = _ctc_both(logits, targets, lens, tg_lens, "sum")
    jax.config.update("jax_enable_x64", True)
    try:
        f64 = np.asarray(jax.grad(lambda z: J.ctc_loss(jax.nn.log_softmax(z, -1), targets, lens, tg_lens,
                                                       reduction="sum"))(jnp.asarray(logits, jnp.float64)))
    finally:
        jax.config.update("jax_enable_x64", False)
    jax_gap, port_gap = np.abs(jg[3] - f64[3]).max(), np.abs(pg[3] - f64[3]).max()
    assert 1e-4 < jax_gap < INFEASIBLE_GRAD_ATOL, jax_gap
    assert port_gap < INFEASIBLE_GRAD_ATOL, port_gap


def test_relative_lengths_round_half_to_even():
    """len * T on .5 (0.625 * 4 = 2.5 -> 2, 0.875 * 4 = 3.5 -> 4), in the masks and CTC's counts."""
    lens = np.array([0.625, 0.875], np.float32)
    np.testing.assert_array_equal(P.length_mask((2, 4), t(lens)).numpy(),
                                  np.asarray(J._length_mask((2, 4), jnp.asarray(lens))))
    assert P.length_mask((2, 4), t(lens)).sum(1).tolist() == [2.0, 4.0]
    in_n, tg_n = P.ctc_counts(lens, 4, lens, 4)
    assert in_n.tolist() == tg_n.tolist() == [2, 4]
    rng = np.random.default_rng(6)
    lp = np.asarray(jax.nn.log_softmax(rng.standard_normal((2, 4, 5)).astype(np.float32), -1))
    tg = np.array([[1, 2, 3, 4], [2, 3, 4, 1]], np.int32)
    np.testing.assert_allclose(float(P.kldiv_loss(t(lp), t(tg), t(lens))),
                               float(jax.jit(J.kldiv_loss)(lp, tg, lens)), rtol=RTOL)
    np.testing.assert_allclose(float(P.ctc_loss(t(lp), t(tg), t(lens), t(lens * 0.5))),
                               float(jax.jit(J.ctc_loss)(lp, tg, lens, lens * 0.5)), rtol=RTOL)
