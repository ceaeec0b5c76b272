"""The paged decode end to end against the JAX package (CPU).

``ASRBundle._decode_test`` pages its caches on the card only; here both
bundles are made to page on the CPU by giving them the paging rule with the
card's answer (``use_paged_cache`` evaluated for a CUDA device, its shape
conditions kept), so the port's decode runs K5/K6's plain twins and JAX's
its ``_make_attends_paged_jnp``. Beam 4 over 2 utterances (N = 8), CTC 0.4,
temperature 1.15, length normalization, f32 caches:

* page 32: d_model 128, 40 steps (a page completes at step 31);
* page 64, fused layout: d_model 768 (U 256 > ``max_u_whole_row`` 213), one
  encoder and one decoder layer, 220 steps.

Identical tokens and lengths, scores within 1e-4; and the port's paged
decode gives the same hypotheses as its physical one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import speech_anonymization_tpu.models.transformer as jax_transformer
from speech_anonymization_tpu.models.asr import ASRModel as JaxASRModel
from speech_anonymization_tpu.recipes.asr_bundle import ASRBundle as JaxASRBundle
from speech_anonymization_tpu_torch.decoding import hyps_to_lists
from speech_anonymization_tpu_torch.models.asr import ASRModel
from speech_anonymization_tpu_torch.models.transformer import use_paged_cache
from speech_anonymization_tpu_torch.recipes import asr_bundle as port_bundle
from speech_anonymization_tpu_torch.utils.convert import asr_state_dict, load_numpy_state
from tests.torch_port_helpers import perturbed, t

HPARAMS = {"test_beam_size": 4, "ctc_weight_decode": 0.4, "temperature": 1.15}
# name: (model widths, feature frames, decode steps, layout keys of the paged cache)
REGIMES = {
    "page32": (dict(d_model=128, nhead=4, num_encoder_layers=1, num_decoder_layers=2, d_ffn=64,
                    output_neurons=24), 176, 40, ("k", "k_act")),
    "page64_fused": (dict(d_model=768, nhead=8, num_encoder_layers=1, num_decoder_layers=1,
                          d_ffn=64, output_neurons=24), 900, 220, ("kv", "kv_act")),
}


class _Tok:
    def decode_ids(self, ids):
        return " ".join(str(i) for i in ids)


def _card_rule(n, u_max, d_model, dtype, device="cuda"):
    return use_paged_cache(n, u_max, d_model, dtype, "cuda")


@pytest.mark.parametrize("name", list(REGIMES))
def test_paged_decode_matches_jax(name, monkeypatch):
    widths, frames, steps, layout = REGIMES[name]
    jm = JaxASRModel(**widths)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 80)), jnp.zeros((1, 3), jnp.int32),
                         jnp.ones((1,)))
    v = perturbed(v, 0)
    pm = load_numpy_state(ASRModel(**widths, device="cpu"), asr_state_dict(v))
    feats = np.random.default_rng(frames).standard_normal((2, frames, 80)).astype(np.float32)
    lens = np.array([1.0, 0.9], np.float32)
    hp = {**HPARAMS, "max_decode_steps": steps}

    monkeypatch.setattr(jax_transformer, "use_paged_cache", lambda *a: True)
    want = JaxASRBundle(jm, v, _Tok(), hp)._decode_test(jnp.asarray(feats), jnp.asarray(lens))
    monkeypatch.setattr(port_bundle, "use_paged_cache", _card_rule)
    bundle = port_bundle.ASRBundle(pm, _Tok(), hp)
    cache = bundle.make_cache(8, steps + 1, "cpu")
    assert all(key in cache for key in layout)
    got = bundle._decode_test(t(feats), t(lens))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-4, rtol=0)
    assert len({tuple(h) for h in hyps_to_lists(got[0], got[1])}) == 2  # input-dependent logits

    physical = port_bundle.ASRBundle(pm, _Tok(), {**hp, "decode_paged_kv": False})
    assert "table" not in physical.make_cache(8, steps + 1, "cpu")
    phys = physical._decode_test(t(feats), t(lens))
    assert np.array_equal(phys[0].numpy(), got[0].numpy())
    assert np.array_equal(phys[1].numpy(), got[1].numpy())
    np.testing.assert_allclose(phys[2].numpy(), got[2].numpy(), atol=1e-4, rtol=0)
