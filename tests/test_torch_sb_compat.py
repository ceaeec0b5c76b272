"""The port's ``sb_compat`` ASR against the JAX package's (CPU).

``ASRModel(sb_compat=True)`` is the model the reference's published
SpeechBrain ASR loads into: ``SBConvFrontEnd`` (symmetric ``k // 2`` conv
padding, LayerNorm over (freq, channel), LeakyReLU), exact GELU, and final
encoder and decoder LayerNorms. JAX's variables (traced shapes filled from a
seed, norm parameters perturbed) are carried across by ``asr_state_dict``.
Tolerances: the front end 1e-5 (at an even and an odd T: XLA's SAME would
pad an even T (0, 1), the symmetric pad does not); the model's outputs 1e-4;
the cached decode against the full-prefix ``decode_one_step`` 2e-4 (the JAX
package's own cached-vs-full bound); the beam decode with the ``sb_compat``
LM fused: tokens identical, scores 1e-4; the weight bridge bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_anonymization_tpu.models.asr import ASRModel as JaxASRModel
from speech_anonymization_tpu.models.transformer import TransformerLM as JaxLM
from speech_anonymization_tpu.recipes.asr_bundle import ASRBundle as JaxASRBundle
from speech_anonymization_tpu_torch.models import transformer as port_transformer
from speech_anonymization_tpu_torch.models.asr import ASRModel
from speech_anonymization_tpu_torch.models.transformer import SBConvFrontEnd, TransformerLM, make_kv_cache
from speech_anonymization_tpu_torch.recipes.asr_bundle import ASRBundle
from speech_anonymization_tpu_torch.utils.convert import (
    asr_state_dict,
    asr_variables,
    lm_state_dict,
    load_numpy_state,
)
from tests.torch_port_helpers import random_variables, t

SMALL = dict(d_model=32, nhead=4, num_encoder_layers=1, num_decoder_layers=2, d_ffn=64,
             output_neurons=24)
LM = dict(vocab=24, d_model=32, nhead=4, num_layers=2, d_ffn=64)
FRONT_ATOL = 1e-5
MODEL_ATOL = 1e-4
CACHED_ATOL = 2e-4
SCORE_ATOL = 1e-4
TOKENS = np.array([[1, 5, 6, 9, 2, 0], [1, 7, 3, 0, 8, 2]], np.int32)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its variables, the port model with them)."""
    jm = JaxASRModel(**SMALL, sb_compat=True)
    v = random_variables(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 80)),
                         jnp.zeros((1, 3), jnp.int32), jnp.ones((1,)), seed=0)
    pm = load_numpy_state(ASRModel(**SMALL, sb_compat=True, device="cpu"), asr_state_dict(v))
    return jm, v, pm.eval()


def _feats(frames: int, seed: int = 0):
    feats = np.random.default_rng(seed).standard_normal((2, frames, 80)).astype(np.float32)
    return feats, np.array([1.0, 0.75], np.float32)


@pytest.mark.parametrize("frames", [24, 25])
def test_sb_front_end_matches_jax(pair, frames):
    jm, v, pm = pair
    feats, _ = _feats(frames)
    want = jax.jit(functools.partial(jm.apply, method=lambda m, x: m.cnn(x)))(v, jnp.asarray(feats))
    assert isinstance(pm.cnn, SBConvFrontEnd)
    assert [tuple(n.weight.shape) for n in pm.cnn.norms] == [(40, 128), (20, 256), (20, 512)]
    with torch.no_grad():
        got = pm.cnn(t(feats))
    assert got.shape == want.shape == (2, (frames + 3) // 4, 20 * 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FRONT_ATOL, rtol=0)


def test_forward_matches_jax(pair):
    """``__call__``: encoder and decoder states, CTC and seq log-probs; and ``encode``."""
    jm, v, pm = pair
    feats, lens = _feats(37, 1)
    want = jax.jit(jm.apply)(v, jnp.asarray(feats), jnp.asarray(TOKENS), jnp.asarray(lens))
    want_enc = jax.jit(functools.partial(jm.apply, method=JaxASRModel.encode))(
        v, jnp.asarray(feats), jnp.asarray(lens))
    with torch.no_grad():
        got = pm(t(feats), t(TOKENS).long(), t(lens))
        got_enc = pm.encode(t(feats), t(lens))
    for name, g, w in zip(("enc", "dec", "p_ctc", "p_seq"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=MODEL_ATOL, rtol=0, err_msg=name)
    np.testing.assert_allclose(got_enc.numpy(), np.asarray(want_enc), atol=MODEL_ATOL, rtol=0)


def test_decode_one_step_matches_jax_at_every_step(pair):
    jm, v, pm = pair
    feats, lens = _feats(28, 2)
    enc_j = jax.jit(functools.partial(jm.apply, method=JaxASRModel.encode))(
        v, jnp.asarray(feats), jnp.asarray(lens))
    one_step = jax.jit(functools.partial(jm.apply, method=JaxASRModel.decode_one_step))
    enc = t(np.asarray(enc_j))
    for step in [*range(TOKENS.shape[1]), None]:
        want = one_step(v, jnp.asarray(TOKENS), enc_j, jnp.asarray(lens), step)
        with torch.no_grad():
            got = pm.decode_one_step(t(TOKENS).long(), enc, t(lens), step)
        assert got.shape == (2, SMALL["output_neurons"])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_ATOL, rtol=0,
                                   err_msg=str(step))


@pytest.mark.parametrize("layout", ["plain", "kernel", "paged"])
def test_cached_decode_matches_decode_one_step(pair, layout, monkeypatch):
    """``decode_step_cached`` (physical caches through the plain math or the
    kernels' twins, or a paged cache) against the full-prefix step: the final
    ``dec_norm`` sits in both."""
    _, _, pm = pair
    if layout == "kernel":
        monkeypatch.setattr(port_transformer, "_use_kernel", lambda cache: True)
    feats, lens = _feats(24, 3)
    d_head = SMALL["d_model"] // SMALL["nhead"]
    u = TOKENS.shape[1]
    cache = make_kv_cache(2, u, SMALL["num_decoder_layers"], SMALL["nhead"], d_head, device="cpu",
                          paged=layout == "paged")
    toks, lens_t = t(TOKENS).long(), t(lens)
    with torch.no_grad():
        enc = pm.encode(t(feats), lens_t)
        cross = pm.cross_kv(enc)
        for step in range(u):
            full = pm.decode_one_step(toks, enc, lens_t, step)
            cached, cache = pm.decode_step_cached(toks[:, step], enc, cache, step, lens_t, cross)
            np.testing.assert_allclose(cached.numpy(), full.numpy(), atol=CACHED_ATOL, rtol=0,
                                       err_msg=str(step))


class _Tok:
    def decode_ids(self, ids):
        return " ".join(str(i) for i in ids)


def test_lm_fused_beam_decode_matches_jax(pair):
    """The sb_compat ASR with the sb_compat LM fused at 0.6 (beam 4, CTC 0.4,
    temperatures 1.15, length normalization), physical caches, 12 steps."""
    jm, v, pm = pair
    jl = JaxLM(**LM, sb_compat=True)
    lv = random_variables(jl.init, jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32), seed=1)
    pl = load_numpy_state(TransformerLM(**LM, sb_compat=True, device="cpu"), lm_state_dict(lv)).eval()
    feats, lens = _feats(48, 4)
    hp = {"test_beam_size": 4, "ctc_weight_decode": 0.4, "temperature": 1.15, "lm_weight": 0.6,
          "temperature_lm": 1.15, "max_decode_steps": 12}
    want = JaxASRBundle(jm, v, _Tok(), hp, lm=jl, lm_variables=lv)._decode_test(
        jnp.asarray(feats), jnp.asarray(lens))
    got = ASRBundle(pm, _Tok(), hp, lm=pl)._decode_test(t(feats), t(lens))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=SCORE_ATOL, rtol=0)


def test_asr_variables_round_trip(pair):
    """JAX's sb_compat variables -> the port -> ``asr_variables``: the same
    tree (names ``conv_i``, ``norm_i``, ``enc_norm``, ``dec_norm``) bit for bit,
    and ``asr_state_dict`` of it gives the port's state_dict back exactly."""
    _, v, pm = pair
    back = jax.tree_util.tree_map(lambda x: x.numpy(), asr_variables(pm))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(v)
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(v), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(got, want, err_msg=jax.tree_util.keystr(path))
    sd = asr_state_dict(back)
    own = pm.state_dict()
    assert sd.keys() == own.keys()
    for k, x in own.items():
        np.testing.assert_array_equal(sd[k], x.numpy(), err_msg=k)


def test_fresh_sb_compat_model_takes_flax_init():
    """A fresh ``ASRModel(sb_compat=True, generator=)`` draws flax's
    initialisers (``models/init.py``), the (F', C) front-end norms included:
    scale 1, bias 0; one seed gives one model; ``seeded_init_`` fills the
    2-D norms too."""
    from speech_anonymization_tpu_torch.utils.seeded_init import seeded_init_

    a, b = (ASRModel(**SMALL, sb_compat=True, generator=torch.Generator().manual_seed(5), device="cpu")
            for _ in range(2))
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    for norm in (*a.cnn.norms, a.transformer.enc_norm, a.transformer.dec_norm):
        assert torch.equal(norm.weight, torch.ones_like(norm.weight)) and not norm.bias.any()
    w = a.transformer.input_proj.weight
    assert abs(float(w.std()) - (1.0 / w.shape[1]) ** 0.5) < 0.05 * (1.0 / w.shape[1]) ** 0.5
    seeded_init_(a, 0)
    assert a.cnn.norms[0].weight.shape == (40, 128) and float(a.cnn.norms[0].weight.std()) > 0.05
