"""The port's beam search against the independent slow decoder (CPU).

``tests/test_beam_search_reference.py``'s ``slow_beam_decode`` re-implements
SpeechBrain 0.5's S2STransformerBeamSearch as the reference configures it
(joint CTC/attention scoring with textbook float64 CTC forward variables,
shallow LM fusion, temperatures, length normalization by step + 1, blank kept
out of the joint scores) with explicit lists. Here the port's
``decoding.beam_search`` decodes the same random toy models: attention and
LM logits are tables keyed by (last token, step), served through the cached
``(init, step, reorder)`` contract (the state is the table itself: a step
reads the row of the token it is given, a reorder keeps it). Over that file's
``CASES`` grid (beams 2 to 16, with and without the LM, vocabularies 8 and
32, batches 1 to 3, a ``min_decode_steps`` case): identical hypotheses, and
scores within 1e-3 of the float64 decoder's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_anonymization_tpu.decoding.ctc_prefix import mask_ctc_log_probs
from speech_anonymization_tpu_torch.decoding import BeamSearchConfig, beam_search, hyps_to_lists
from tests.test_beam_search_reference import BLANK, BOS, CASES, EOS, slow_beam_decode
from tests.torch_port_helpers import t

SCORE_ATOL = 1e-3
T_ENC, MAX_STEPS = 5, 6


def _table_cached(table: torch.Tensor) -> tuple:
    """A (V_prev, S, V) logit table as a cached decoder: ``step(state, prev,
    step)`` -> the rows ``table[prev, step]``."""
    return (lambda n, u_max: table,
            lambda state, prev, step: (state[prev, step], state),
            lambda state, parent, step: state)


@pytest.mark.parametrize("k,lm_w,ln,v,batch,min_steps,seeds", CASES)
def test_port_beam_matches_slow_reference(k, lm_w, ln, v, batch, min_steps, seeds):
    cfg = BeamSearchConfig(beam_size=k, bos_index=BOS, eos_index=EOS, blank_index=BLANK, ctc_weight=0.4,
                           lm_weight=lm_w, temperature=1.15, temperature_lm=1.15,
                           length_normalization=ln, min_decode_steps=min_steps)
    mismatches = []
    for seed in range(seeds):
        rng = np.random.default_rng(seed)
        att = rng.standard_normal((v, MAX_STEPS, v)).astype(np.float32) * 2.0
        lm = rng.standard_normal((v, MAX_STEPS, v)).astype(np.float32) * 2.0
        ctc_raw = np.log(rng.dirichlet(np.ones(v), size=(batch, T_ENC))).astype(np.float32)
        lens = rng.choice([0.6, 1.0], size=batch).astype(np.float32)
        x_masked = np.asarray(mask_ctc_log_probs(jnp.asarray(ctc_raw), jnp.asarray(lens), BLANK))

        toks, lengths, scores = beam_search(
            _table_cached(t(att)), torch.zeros((batch, T_ENC, 4)), t(lens), t(ctc_raw), cfg,
            max_steps=MAX_STEPS, lm_cached=_table_cached(t(lm)) if lm_w > 0 else None)
        hyps = hyps_to_lists(toks, lengths)
        for b in range(batch):
            slow_hyp, slow_score = slow_beam_decode(att.astype(np.float64),
                                                    lm.astype(np.float64) if lm_w > 0 else None,
                                                    x_masked[b].astype(np.float64), cfg, MAX_STEPS)
            if hyps[b] != slow_hyp or abs(float(scores[b]) - slow_score) > SCORE_ATOL:
                mismatches.append((seed, b, hyps[b], slow_hyp, float(scores[b]), slow_score))
    assert not mismatches, f"the port's beam search != the slow reference decoder: {mismatches}"
