"""The bf16-cache decode (``decode_cache_dtype: bfloat16``, the serving
decode) end to end against the JAX package's (CPU).

Both bundles decode the same features with the same weights and bf16 k/v
caches: physical caches (``decode_paged_kv: false``), and paged by 32, both
bundles made to page on the CPU as ``tests/test_torch_paged_decode.py`` does
(the paging rule given the card's answer, its shape conditions kept). The
port's decode runs its attention kernels' plain twins (K3 physical, K5
paged), JAX its reference math. Beam 4 over 2 utterances (N = 8), CTC 0.4,
temperature 1.15, length normalization, d_model 128, 40 steps (page 32
completes at step 31).

Identical tokens and lengths; scores within the layout's tolerance, both
far inside JAX's own bf16-vs-f32 bound of 5e-2 (``tests/test_cached_decode.py``):

* physical, 1e-4 (the f32 decodes' tolerance): both sides run the reference
  math (``attend_cached``: q rounded to bf16 against the cached keys, the
  weights rounded to bf16 against the cached values, the fresh token in
  f32) and differ by f32 sums in other orders (measured 4.3e-6);
* page 32, 1e-3: the port's paged attention follows the kernels' bf16
  contract (K5's twin: q, kh and vh rounded to bf16, f32 weights), as the
  JAX package's kernel does on its accelerator, while JAX's paged path off
  the accelerator materializes the logical buffer and runs the reference
  math; the rounding points differ, the tokens do not (measured 1.6e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import speech_anonymization_tpu.models.transformer as jax_transformer
from speech_anonymization_tpu.models.asr import ASRModel as JaxASRModel
from speech_anonymization_tpu.recipes.asr_bundle import ASRBundle as JaxASRBundle
from speech_anonymization_tpu_torch.decoding import hyps_to_lists
from speech_anonymization_tpu_torch.models.asr import ASRModel
from speech_anonymization_tpu_torch.models.transformer import use_paged_cache
from speech_anonymization_tpu_torch.recipes import asr_bundle as port_bundle
from speech_anonymization_tpu_torch.utils.convert import asr_state_dict, load_numpy_state
from tests.torch_port_helpers import perturbed, t

WIDTHS = dict(d_model=128, nhead=4, num_encoder_layers=1, num_decoder_layers=2, d_ffn=64,
              output_neurons=24)
FRAMES, STEPS = 176, 40
HPARAMS = {"test_beam_size": 4, "ctc_weight_decode": 0.4, "temperature": 1.15,
           "max_decode_steps": STEPS, "decode_cache_dtype": "bfloat16"}
# name: (paged, the cache keys that layout holds, score tolerance)
LAYOUTS = {"physical": (False, ("k", "v"), 1e-4), "page32": (True, ("k", "k_act", "table"), 1e-3)}


class _Tok:
    def decode_ids(self, ids):
        return " ".join(str(i) for i in ids)


def _card_rule(n, u_max, d_model, dtype, device="cuda"):
    return use_paged_cache(n, u_max, d_model, dtype, "cuda")


@pytest.fixture(scope="module")
def weights():
    jm = JaxASRModel(**WIDTHS)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 80)), jnp.zeros((1, 3), jnp.int32),
                         jnp.ones((1,)))
    v = perturbed(v, 0)
    return jm, v, load_numpy_state(ASRModel(**WIDTHS, device="cpu"), asr_state_dict(v))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_bf16_decode_matches_jax(layout, weights, monkeypatch):
    jm, v, pm = weights
    paged, keys, atol = LAYOUTS[layout]
    feats = np.random.default_rng(FRAMES).standard_normal((2, FRAMES, 80)).astype(np.float32)
    lens = np.array([1.0, 0.9], np.float32)
    hp = {**HPARAMS, "decode_paged_kv": paged}

    if paged:
        monkeypatch.setattr(jax_transformer, "use_paged_cache", lambda *a: True)
        monkeypatch.setattr(port_bundle, "use_paged_cache", _card_rule)
    want = JaxASRBundle(jm, v, _Tok(), hp)._decode_test(jnp.asarray(feats), jnp.asarray(lens))
    bundle = port_bundle.ASRBundle(pm, _Tok(), hp)
    cache = bundle.make_cache(8, STEPS + 1, "cpu")
    assert all(key in cache for key in keys) and ("table" in cache) == paged
    assert all(cache[key].dtype == torch.bfloat16 for key in keys if key != "table")
    got = bundle._decode_test(t(feats), t(lens))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2], np.float32), atol=atol, rtol=0)
    assert len({tuple(h) for h in hyps_to_lists(got[0], got[1])}) == 2  # input-dependent logits
