"""The LM-fused beam decode against the JAX package (CPU).

``ASRBundle(..., lm=)`` against JAX's ``ASRBundle(..., lm=, lm_variables=)``:
beam 4 over 2 utterances (N = 8), CTC 0.4, temperature 1.15, length
normalization, ``lm_weight`` 0.6, ``temperature_lm`` 1.15, f32 caches, the
ASR and the LM at small widths with converted weights:

* physical caches (the CPU default), d_model 64, 20 steps;
* paged, page 32 (split): d_model 128, 40 steps (a page completes at 31);
* paged, page 64 (fused, the layout K7 takes on the card): d_model 768 for
  the ASR and the LM (U 256 > ``max_u_whole_row`` 213), one layer each, 220
  steps. On the CPU the LM runs per layer, on both sides.

Both bundles page on the CPU by monkeypatching ``use_paged_cache`` with the
card's answer, as ``test_torch_paged_decode.py`` does. Identical tokens and
lengths, scores within 1e-4; and (physical) the LM changes at least one
hypothesis against the same decode at ``lm_weight`` 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import speech_anonymization_tpu.models.transformer as jax_transformer
from speech_anonymization_tpu.models.asr import ASRModel as JaxASRModel
from speech_anonymization_tpu.models.transformer import TransformerLM as JaxLM
from speech_anonymization_tpu.recipes.asr_bundle import ASRBundle as JaxASRBundle
from speech_anonymization_tpu_torch.decoding import hyps_to_lists
from speech_anonymization_tpu_torch.models import TransformerLM
from speech_anonymization_tpu_torch.models.asr import ASRModel
from speech_anonymization_tpu_torch.models.transformer import use_paged_cache
from speech_anonymization_tpu_torch.recipes import asr_bundle as port_bundle
from speech_anonymization_tpu_torch.utils.convert import (
    asr_state_dict,
    lm_state_dict,
    load_numpy_state,
)
from tests.torch_port_helpers import perturbed, t

VOCAB = 24
HPARAMS = {"test_beam_size": 4, "ctc_weight_decode": 0.4, "temperature": 1.15,
           "lm_weight": 0.6, "temperature_lm": 1.15}
# name: (ASR widths, LM widths, feature frames, steps, LM cache keys (None: physical))
REGIMES = {
    "physical": (dict(d_model=64, nhead=4, num_encoder_layers=1, num_decoder_layers=2, d_ffn=64),
                 dict(d_model=64, nhead=4, num_layers=2, d_ffn=128), 80, 20, None),
    "page32": (dict(d_model=128, nhead=4, num_encoder_layers=1, num_decoder_layers=1, d_ffn=64),
               dict(d_model=128, nhead=4, num_layers=2, d_ffn=256), 176, 40, ("k", "k_act")),
    "page64_fused": (dict(d_model=768, nhead=8, num_encoder_layers=1, num_decoder_layers=1,
                          d_ffn=64),
                     dict(d_model=768, nhead=12, num_layers=1, d_ffn=768), 900, 220,
                     ("kv", "kv_act")),
}


class _Tok:
    def decode_ids(self, ids):
        return " ".join(str(i) for i in ids)


def _card_rule(n, u_max, d_model, dtype, device="cuda"):
    return use_paged_cache(n, u_max, d_model, dtype, "cuda")


@pytest.mark.parametrize("name", list(REGIMES))
def test_lm_fused_decode_matches_jax(name, monkeypatch):
    asr_w, lm_w, frames, steps, layout = REGIMES[name]
    jm = JaxASRModel(**asr_w, output_neurons=VOCAB)
    v = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 80)),
                                   jnp.zeros((1, 3), jnp.int32), jnp.ones((1,))), 0)
    jl = JaxLM(vocab=VOCAB, **lm_w)
    lv = perturbed(jax.jit(jl.init)(jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32)), 1)
    pm = load_numpy_state(ASRModel(**asr_w, output_neurons=VOCAB, device="cpu"), asr_state_dict(v))
    pl = load_numpy_state(TransformerLM(vocab=VOCAB, **lm_w, device="cpu"), lm_state_dict(lv))
    feats = np.random.default_rng(frames).standard_normal((2, frames, 80)).astype(np.float32)
    lens = np.array([1.0, 0.9], np.float32)
    hp = {**HPARAMS, "max_decode_steps": steps}
    if layout is not None:
        monkeypatch.setattr(jax_transformer, "use_paged_cache", lambda *a: True)
        monkeypatch.setattr(port_bundle, "use_paged_cache", _card_rule)

    want = JaxASRBundle(jm, v, _Tok(), hp, lm=jl, lm_variables=lv)._decode_test(
        jnp.asarray(feats), jnp.asarray(lens))
    bundle = port_bundle.ASRBundle(pm, _Tok(), hp, lm=pl)
    assert bundle.cfg.lm_weight == 0.6 and bundle.cfg.temperature_lm == 1.15
    lm_cache = bundle.make_lm_cache(8, steps + 1, "cpu")
    assert all(key in lm_cache for key in layout) if layout else "table" not in lm_cache
    got = bundle._decode_test(t(feats), t(lens))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-4, rtol=0)

    if layout is None:  # once: the same decode without the LM differs
        no_lm = port_bundle.ASRBundle(pm, _Tok(), {**hp, "lm_weight": 0.0}, lm=pl)
        assert no_lm.lm_mega is None
        base = no_lm._decode_test(t(feats), t(lens))
        assert hyps_to_lists(base[0], base[1]) != hyps_to_lists(got[0], got[1])
