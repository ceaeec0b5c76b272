"""The port's CTC prefix scorer against the JAX package's (CPU): candidate
scores and the advance of the forward variables over three decode steps, with
per-item length masking, the all -inf frame padding, a repeated token and a
committed blank.

The advance's log-depth scan associates in another order than
``jax.lax.associative_scan``, so values agree to rounding: atol 1e-4 in log
space on entries above -1e29 (measured: at most 2.3e-5 on log-probabilities
of magnitude up to 142, i.e. 3 ulp, 2e-7 relative); entries below are the
-1e30 "impossible" floor on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_anonymization_tpu.decoding import ctc_prefix as jax_ctc
from speech_anonymization_tpu_torch.decoding import ctc_prefix as port_ctc
from tests.torch_port_helpers import t

B, K, T, V, BLANK, EOS = 2, 3, 37, 12, 0, 2
FLOOR = -1e29


def _close(got: torch.Tensor, want, name: str) -> None:
    got, want = got.numpy(), np.asarray(want)
    live = want > FLOOR
    assert np.array_equal(got > FLOOR, live), name
    np.testing.assert_allclose(got[live], want[live], atol=1e-4, rtol=0, err_msg=name)


def _log_probs(seed: int) -> np.ndarray:
    logits = 2.0 * np.random.default_rng(seed).standard_normal((B, T, V))
    return (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_scoring_and_advance_match_jax(seed):
    x, lens = _log_probs(seed), np.array([1.0, 0.7], np.float32)
    jx = jax_ctc.mask_ctc_log_probs(jnp.asarray(x), jnp.asarray(lens), BLANK)
    px = port_ctc.mask_ctc_log_probs(t(x), t(lens), BLANK)
    np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
    jx, px = jax_ctc.pad_ctc_frames(jx), port_ctc.pad_ctc_frames(px)
    assert px.shape == jx.shape == (B, 128, V)
    jprep = jax_ctc.ctc_prepare(jx, BLANK, k=K, t_real=T)
    pprep = port_ctc.ctc_prepare(px, BLANK, k=K, t_real=T)
    jstate = jax_ctc.ctc_init_state(jx, BLANK, k=K)
    pstate = port_ctc.ctc_init_state(px, BLANK, k=K)
    # step 1 starts new prefixes; step 2 repeats row 0's token and commits a blank on row 1
    chosen = [np.array([3, 5, 3, 4, 4, 7]), np.array([3, 0, 6, 4, 9, 2]), np.array([1, 1, 1, 1, 1, 1])]
    jax_score = jax.jit(lambda st: jax_ctc.ctc_score_candidates_prepared(jprep, st, EOS, BLANK))
    jax_advance = jax.jit(lambda st, c: jax_ctc.ctc_advance_state_prepared(jprep, st, c, BLANK))
    for step, c in enumerate(chosen):
        want = jax_score(jstate)
        got = port_ctc.ctc_score_candidates_prepared(pprep, pstate, EOS, BLANK)
        _close(got, want, f"psi {step}")
        jstate = jax_advance(jstate, jnp.asarray(c, jnp.int32))
        pstate = port_ctc.ctc_advance_state_prepared(pprep, pstate, t(c).long(), BLANK)
        _close(pstate.r_nb, jstate.r_nb, f"r_nb {step}")
        _close(pstate.r_b, jstate.r_b, f"r_b {step}")
        np.testing.assert_array_equal(pstate.last_token.numpy(), np.asarray(jstate.last_token))
        assert not pstate.prefix_empty.any()


def test_one_shot_wrappers_match_jax():
    """ctc_score_candidates / ctc_advance_state (exp(x) on the fly, one beam)."""
    x, lens = _log_probs(2), np.array([1.0, 0.7], np.float32)
    jx = jax_ctc.mask_ctc_log_probs(jnp.asarray(x), jnp.asarray(lens), BLANK)
    px = port_ctc.mask_ctc_log_probs(t(x), t(lens), BLANK)
    jstate, pstate = jax_ctc.ctc_init_state(jx, BLANK), port_ctc.ctc_init_state(px, BLANK)
    _close(port_ctc.ctc_score_candidates(px, pstate, EOS, BLANK),
           jax.jit(lambda st: jax_ctc.ctc_score_candidates(jx, st, EOS, BLANK))(jstate), "psi")
    chosen = np.array([4, 9])
    jstate = jax.jit(lambda st, c: jax_ctc.ctc_advance_state(jx, st, c, BLANK))(
        jstate, jnp.asarray(chosen, jnp.int32))
    pstate = port_ctc.ctc_advance_state(px, pstate, t(chosen).long(), BLANK)
    _close(pstate.r_nb, jstate.r_nb, "r_nb")
    _close(pstate.r_b, jstate.r_b, "r_b")


@pytest.mark.parametrize("frames", [1, 2, 5, 128, 256])
def test_log_depth_scan_equals_the_sequential_recursion(frames):
    """The Hillis-Steele prefix products against a per-frame loop."""
    rng = np.random.default_rng(frames)
    m = torch.from_numpy(rng.standard_normal((4, frames, 3, 3)).astype(np.float32))
    want, acc = [], m[:, 0]
    for i in range(frames):
        acc = m[:, 0] if i == 0 else port_ctc._logmatmul3(m[:, i], acc)
        want.append(acc)
    torch.testing.assert_close(port_ctc._prefix_products(m), torch.stack(want, 1),
                               atol=1e-5, rtol=1e-5)
