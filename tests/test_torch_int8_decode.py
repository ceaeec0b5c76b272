"""The int8-cache decode (``decode_cache_dtype: int8``, the JAX package's
quantized serving mode) end to end against the JAX package's (CPU).

Both bundles decode the same features with the same weights and int8 k/v
caches (codes with an f32 scale per layer, row and position): physical caches
(``decode_paged_kv: false``), paged by 32 (both bundles made to page on the
CPU as ``tests/test_torch_paged_decode.py`` does), and paged with a
shallow-fusion LM whose int8 cache pages alike. The port runs its kernels'
plain twins (K3 physical, K5 paged), JAX its reference math (``attend_cached``
and ``finalize_jnp``, or ``_make_attends_paged_jnp``). Beam 4 over 2
utterances (N = 8), CTC 0.4, temperature 1.15, length normalization, d_model
128, 40 steps (page 32 completes at step 31).

Identical tokens and lengths; scores within 1e-4. Both sides quantize and
dequantize by the same formulas, but JAX's decode is jitted, and there XLA
turns finalize's ``amax / 127`` into ``amax * (1 / 127)``: a scale can differ
in its last bit, and the f32 sums run in other orders, so a code could flip
where ``x * 127 / amax`` sits on a rounding boundary. Measured: 2.4e-7
physical, 2.4e-7 page 32, 4.8e-7 with the LM; 1e-4 is the f32 decodes'
tolerance and leaves room for a flipped code at these widths.
Against the port's own f32 decode: identical hypotheses, scores within
0.15, the JAX package's int8-vs-f32 bound (``tests/test_cached_decode.py``).

The chunked layouts (U above the int8 whole-row bound, the 30 s decode's):
both packages' whole-row bound is shrunk to 40 positions at d_model 128 (each
side's ``_VMEM_BUDGET``, which ``max_u_whole_row`` reads at call time), so a
70-step decode (U 71 -> 128, page 64 completing at step 63) takes them on
both sides: physical through K4's twin (and K2's), and paged by 64 with the
fused layout and the LM (K6's twin for both stacks; the LM per layer on both
sides, as off the accelerator). Same tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import speech_anonymization_tpu.models.transformer as jax_transformer
import speech_anonymization_tpu.ops.pallas.attention_step as jax_attention_step
from speech_anonymization_tpu.models.asr import ASRModel as JaxASRModel
from speech_anonymization_tpu.models.transformer import TransformerLM as JaxLM
from speech_anonymization_tpu.recipes.asr_bundle import ASRBundle as JaxASRBundle
from speech_anonymization_tpu_torch.decoding import hyps_to_lists
from speech_anonymization_tpu_torch.models import TransformerLM
from speech_anonymization_tpu_torch.models.asr import ASRModel
from speech_anonymization_tpu_torch.models import transformer as port_transformer
from speech_anonymization_tpu_torch.models.transformer import use_paged_cache
from speech_anonymization_tpu_torch.ops import attention_step as port_attention_step
from speech_anonymization_tpu_torch.ops import attention_step_paged as port_paged
from speech_anonymization_tpu_torch.recipes import asr_bundle as port_bundle
from speech_anonymization_tpu_torch.utils.convert import (
    asr_state_dict,
    lm_state_dict,
    load_numpy_state,
)
from tests.torch_port_helpers import perturbed, t

VOCAB = 24
WIDTHS = dict(d_model=128, nhead=4, num_encoder_layers=1, num_decoder_layers=2, d_ffn=64,
              output_neurons=VOCAB)
LM_WIDTHS = dict(d_model=128, nhead=4, num_layers=2, d_ffn=256)
FRAMES, STEPS = 176, 40
HPARAMS = {"test_beam_size": 4, "ctc_weight_decode": 0.4, "temperature": 1.15,
           "max_decode_steps": STEPS, "decode_cache_dtype": "int8"}
# name: (paged, with the LM, the cache keys that layout holds)
RUNS = {"physical": (False, False, ("k", "k_spare", "k_scale", "v_scale")),
        "page32": (True, False, ("k", "k_act", "table", "k_scale", "v_scale")),
        "page32_lm": (True, True, ("k", "k_act", "table", "k_scale", "v_scale"))}


class _Tok:
    def decode_ids(self, ids):
        return " ".join(str(i) for i in ids)


def _card_rule(n, u_max, d_model, dtype, device="cuda"):
    return use_paged_cache(n, u_max, d_model, dtype, "cuda")


@pytest.fixture(scope="module")
def weights():
    jm = JaxASRModel(**WIDTHS)
    v = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 80)),
                                   jnp.zeros((1, 3), jnp.int32), jnp.ones((1,))), 0)
    jl = JaxLM(vocab=VOCAB, **LM_WIDTHS)
    lv = perturbed(jax.jit(jl.init)(jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32)), 1)
    pm = load_numpy_state(ASRModel(**WIDTHS, device="cpu"), asr_state_dict(v))
    pl = load_numpy_state(TransformerLM(vocab=VOCAB, **LM_WIDTHS, device="cpu"), lm_state_dict(lv))
    return jm, v, jl, lv, pm, pl


def _feats():
    feats = np.random.default_rng(FRAMES).standard_normal((2, FRAMES, 80)).astype(np.float32)
    return feats, np.array([1.0, 0.9], np.float32)


@pytest.mark.parametrize("name", list(RUNS))
def test_int8_decode_matches_jax(name, weights, monkeypatch):
    jm, v, jl, lv, pm, pl = weights
    paged, with_lm, keys = RUNS[name]
    feats, lens = _feats()
    hp = {**HPARAMS, "decode_paged_kv": paged}
    if paged:
        monkeypatch.setattr(jax_transformer, "use_paged_cache", lambda *a: True)
        monkeypatch.setattr(port_bundle, "use_paged_cache", _card_rule)
    lm_args = dict(lm=jl, lm_variables=lv) if with_lm else {}
    want = JaxASRBundle(jm, v, _Tok(), hp, **lm_args)._decode_test(jnp.asarray(feats),
                                                                   jnp.asarray(lens))
    bundle = port_bundle.ASRBundle(pm, _Tok(), hp, lm=pl if with_lm else None)
    caches = [bundle.make_cache(8, STEPS + 1, "cpu")]
    if with_lm:
        caches.append(bundle.make_lm_cache(8, STEPS + 1, "cpu"))
    for cache in caches:
        assert all(key in cache for key in keys) and ("table" in cache) == paged
        assert cache["k"].dtype == torch.int8 and cache["k_scale"].dtype == torch.float32
    got = bundle._decode_test(t(feats), t(lens))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2], np.float32), atol=1e-4, rtol=0)
    assert len({tuple(h) for h in hyps_to_lists(got[0], got[1])}) == 2  # input-dependent logits


def test_int8_decode_matches_port_f32(weights):
    """The port's int8 decode against its own f32 one (physical, the CPU's
    layout): the same hypotheses, scores within 0.15, over 20 steps (the JAX
    package's own check runs 5 on its toy model). Over the 40 steps above, a
    near tie flips the first utterance's hypothesis between the int8 and the
    f32 decode, in the JAX package's decodes exactly as in the port's
    (measured; scores 1.1e-3 apart): quantization moves near ties, and the
    tests above hold the port's int8 decode to JAX's at 40 steps."""
    *_, pm, _ = weights
    feats, lens = _feats()
    hp = {**HPARAMS, "max_decode_steps": 20}
    runs = {dtype: port_bundle.ASRBundle(pm, _Tok(), {**hp, "decode_cache_dtype": dtype})
            ._decode_test(t(feats), t(lens)) for dtype in ("float32", "int8")}
    assert hyps_to_lists(*runs["int8"][:2]) == hyps_to_lists(*runs["float32"][:2])
    np.testing.assert_allclose(runs["int8"][2].numpy(), runs["float32"][2].numpy(), atol=0.15,
                               rtol=0)


# max_u_whole_row(128, 2) == 40 on both sides; name: (paged, with the LM, the
# cache keys that layout holds)
CHUNKED_BUDGET = 40 * 2 * 8 * 128 * 2
CHUNKED_STEPS = 70
CHUNKED_RUNS = {"physical": (False, False, ("k", "k_spare", "k_scale", "v_scale")),
                "page64_fused_lm": (True, True, ("kv", "kv_act", "table", "k_scale", "v_scale"))}


@pytest.mark.parametrize("name", list(CHUNKED_RUNS))
def test_int8_chunked_decode_matches_jax(name, weights, monkeypatch):
    jm, v, jl, lv, pm, pl = weights
    paged, with_lm, keys = CHUNKED_RUNS[name]
    monkeypatch.setattr(jax_attention_step, "_VMEM_BUDGET", CHUNKED_BUDGET)
    monkeypatch.setattr(port_attention_step, "_VMEM_BUDGET", CHUNKED_BUDGET)
    assert port_attention_step.max_u_whole_row(128, 2) == 40
    # count the chunked kernels' calls (their twins run: the tensors are on the CPU)
    calls = []
    kernel_module, kernel_name = ((port_paged, "attention_step_paged_chunked") if paged
                                  else (port_attention_step, "attention_step_chunked"))
    kernel = getattr(kernel_module, kernel_name)
    monkeypatch.setattr(kernel_module, kernel_name,
                        lambda *a, **k: calls.append(1) or kernel(*a, **k))
    if paged:
        monkeypatch.setattr(jax_transformer, "use_paged_cache", lambda *a: True)
        monkeypatch.setattr(port_bundle, "use_paged_cache", _card_rule)
    else:  # the physical kernel branch (K4, K2), as on the card
        monkeypatch.setattr(port_transformer, "_use_kernel", lambda cache: True)
    feats, lens = _feats()
    hp = {**HPARAMS, "max_decode_steps": CHUNKED_STEPS, "decode_paged_kv": paged}
    lm_args = dict(lm=jl, lm_variables=lv) if with_lm else {}
    want = JaxASRBundle(jm, v, _Tok(), hp, **lm_args)._decode_test(jnp.asarray(feats),
                                                                   jnp.asarray(lens))
    bundle = port_bundle.ASRBundle(pm, _Tok(), hp, lm=pl if with_lm else None)
    caches = [bundle.make_cache(8, CHUNKED_STEPS + 1, "cpu")]
    if with_lm:
        caches.append(bundle.make_lm_cache(8, CHUNKED_STEPS + 1, "cpu"))
    for cache in caches:
        assert all(key in cache for key in keys) and ("table" in cache) == paged
        assert cache["tokens"].shape[1] == 128 and cache["k_scale"].shape[2] == 128
        assert (cache["kv"] if paged else cache["k"]).dtype == torch.int8
        assert not paged or cache["table"].shape[1] == 2  # page 64
    got = bundle._decode_test(t(feats), t(lens))
    layers = WIDTHS["num_decoder_layers"] + (LM_WIDTHS["num_layers"] if with_lm else 0)
    assert len(calls) == layers * CHUNKED_STEPS
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2], np.float32), atol=1e-4, rtol=0)
    assert len({tuple(h) for h in hyps_to_lists(got[0], got[1])}) == 2  # input-dependent logits
