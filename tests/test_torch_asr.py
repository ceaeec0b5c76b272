"""The port's ASR model against the JAX package's at a small config (CPU): the
encoder (odd and even T, for the asymmetric SAME padding), the full decoder,
and the KV-cached decode step over several steps, with weights carried over by
``asr_state_dict``; and the weight bridge's round trip."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_anonymization_tpu.models.asr import ASRModel as JaxASRModel
from speech_anonymization_tpu.models.transformer import make_kv_cache as jax_make_kv_cache
from speech_anonymization_tpu.utils.port_weights import (
    conv2d_from_torch,
    embedding_from_torch,
    linear_from_torch,
)
from speech_anonymization_tpu_torch.models import transformer as port_transformer
from speech_anonymization_tpu_torch.models.asr import ASRModel
from speech_anonymization_tpu_torch.models.transformer import make_kv_cache, sinusoidal_positions
from speech_anonymization_tpu_torch.utils.convert import asr_state_dict, load_numpy_state
from speech_anonymization_tpu_torch.utils.seeded_init import seeded_init_
from tests.torch_port_helpers import perturbed, t

SMALL = dict(d_model=32, nhead=4, num_encoder_layers=1, num_decoder_layers=2, d_ffn=64,
             output_neurons=24)
ATOL = 2e-4  # the JAX package's cached-vs-full decode bound (tests/test_cached_decode.py:42)


def _init(seed: int):
    """Flax variables with every norm parameter perturbed (the model's
    parameters do not depend on T)."""
    v = jax.jit(JaxASRModel(**SMALL).init)(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 80)),
                                           jnp.zeros((1, 3), jnp.int32), jnp.ones((1,)))
    return perturbed(v, seed)


@pytest.fixture(scope="module")
def variables():
    return _init(0)


def _models(variables, t_frames: int, seed: int = 0):
    feats = np.random.default_rng(seed).standard_normal((2, t_frames, 80)).astype(np.float32)
    lens = np.array([1.0, 0.75], np.float32)
    pm = load_numpy_state(ASRModel(**SMALL, device="cpu"), asr_state_dict(variables))
    return JaxASRModel(**SMALL), variables, pm, feats, lens


@pytest.mark.parametrize("t_frames", [24, 25, 37])
def test_encode_and_decode_match_jax(variables, t_frames):
    """ASRModel's full forward: encoder states, decoder states, CTC and seq log-probs."""
    jm, v, pm, feats, lens = _models(variables, t_frames)
    toks = np.array([[1, 5, 6, 0], [1, 7, 3, 4]])
    want = jax.jit(jm.apply)(v, jnp.asarray(feats), jnp.asarray(toks), jnp.asarray(lens))
    with torch.no_grad():
        got = pm(t(feats), t(toks), t(lens))
    assert got[0].shape == want[0].shape == (2, (t_frames + 3) // 4, 32)  # two stride-2 convs
    for name, g, w in zip(("enc", "dec", "p_ctc", "p_seq"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("branch", ["plain", "kernel"])
def test_decode_step_cached_matches_jax(variables, branch, monkeypatch):
    """Six cached steps with blanks (pad keys) committed mid-sequence; the
    kernel branch runs here through the wrappers' plain twins."""
    if branch == "kernel":
        monkeypatch.setattr(port_transformer, "_use_kernel", lambda cache: True)
    jm, v, pm, feats, lens = _models(variables, 24, seed=1)
    enc_j = jax.jit(functools.partial(jm.apply, method=JaxASRModel.encode))(
        v, jnp.asarray(feats), jnp.asarray(lens))
    enc = t(np.asarray(enc_j))
    tokens = np.array([[1, 5, 0, 9, 2, 7], [1, 7, 3, 0, 8, 2]], np.int32)
    d_head = SMALL["d_model"] // SMALL["nhead"]
    cache_j = jax_make_kv_cache(2, 6, SMALL["num_decoder_layers"], SMALL["nhead"], d_head)
    cache = make_kv_cache(2, 6, SMALL["num_decoder_layers"], SMALL["nhead"], d_head, device="cpu")
    cross_j = jax.jit(functools.partial(jm.apply, method=JaxASRModel.cross_kv))(v, enc_j)
    with torch.no_grad():
        cross = pm.cross_kv(enc)
    jax_step = jax.jit(functools.partial(jm.apply, method=JaxASRModel.decode_step_cached))
    for step in range(6):
        want, cache_j = jax_step(v, jnp.asarray(tokens[:, step]), enc_j, cache_j, step,
                                 jnp.asarray(lens), cross_j)
        with torch.no_grad():
            got, cache = pm.decode_step_cached(t(tokens[:, step]).long(), enc, cache, step, t(lens),
                                               cross)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, err_msg=str(step))
        np.testing.assert_allclose(cache["k"][:, :, :step + 1].numpy(),
                                   np.asarray(cache_j["k"])[:, :, :step + 1], atol=ATOL)
        np.testing.assert_array_equal(cache["tokens"].numpy(), np.asarray(cache_j["tokens"]))


def test_attend_kv_matches_jax(variables):
    """Attention with precomputed K/V heads (first decoder layer's cross-attention)."""
    from speech_anonymization_tpu.models.transformer import MultiHeadAttention as JaxMHA

    rng = np.random.default_rng(2)
    q, mem = (rng.standard_normal((2, n, 32)).astype(np.float32) for n in (3, 7))
    mask = np.ones((2, 1, 1, 7), bool)
    mask[1, ..., 5:] = False
    params = {"params": variables["params"]["transformer"]["dec_0"]["cross_attn"]}
    jm = JaxMHA(32, 4)
    kh_j, vh_j = jm.apply(params, jnp.asarray(mem), method=JaxMHA.kv)
    want = jm.apply(params, jnp.asarray(q), kh_j, vh_j, jnp.asarray(mask), method=JaxMHA.attend_kv)
    attn = load_numpy_state(ASRModel(**SMALL, device="cpu"), asr_state_dict(variables)) \
        .transformer.decoder_layers[0].cross_attn
    with torch.no_grad():
        kh, vh = attn.kv(t(mem))
        got = attn.attend_kv(t(q), kh, vh, t(mask))
    np.testing.assert_allclose(kh.numpy(), np.asarray(kh_j), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_sinusoidal_positions_match_jax():
    from speech_anonymization_tpu.models.transformer import sinusoidal_positions as jax_pe

    np.testing.assert_allclose(sinusoidal_positions(300, 32).numpy(), np.asarray(jax_pe(300, 32)),
                               atol=1e-5)


def _to_flax(model: ASRModel) -> dict:
    """The port's state_dict -> an ASRModel flax params tree, built with the
    JAX package's torch->flax helpers (DenseGeneral heads reshaped here)."""
    sd = model.state_dict()
    h, dh = model.nhead, model.d_model // model.nhead

    def lin(prefix):
        return linear_from_torch(sd[f"{prefix}.weight"], sd[f"{prefix}.bias"])

    def ln(prefix):
        return {"scale": sd[f"{prefix}.weight"].numpy(), "bias": sd[f"{prefix}.bias"].numpy()}

    def mha(prefix):
        out = {}
        for name in ("q", "k", "v"):
            p = lin(f"{prefix}.{name}")
            out[name] = {"kernel": p["kernel"].reshape(-1, h, dh), "bias": p["bias"].reshape(h, dh)}
        p = lin(f"{prefix}.out")
        out["out"] = {"kernel": p["kernel"].reshape(h, dh, -1), "bias": p["bias"]}
        return out

    def ff(prefix):
        return {"Dense_0": lin(f"{prefix}.dense0"), "Dense_1": lin(f"{prefix}.dense1")}

    cnn = {}
    for i in range(3):
        cnn[f"Conv_{i}"] = conv2d_from_torch(sd[f"cnn.convs.{i}.weight"], sd[f"cnn.convs.{i}.bias"])
        cnn[f"LayerNorm_{i}"] = ln(f"cnn.norms.{i}")
    tr = {"input_proj": lin("transformer.input_proj"),
          "embed": embedding_from_torch(sd["transformer.embed.weight"])}
    for i in range(SMALL["num_encoder_layers"]):
        p = f"transformer.encoder_layers.{i}"
        tr[f"enc_{i}"] = {"attn": mha(f"{p}.attn"), "LayerNorm_0": ln(f"{p}.ln1"),
                          "FeedForward_0": ff(f"{p}.ff"), "LayerNorm_1": ln(f"{p}.ln2")}
    for i in range(SMALL["num_decoder_layers"]):
        p = f"transformer.decoder_layers.{i}"
        tr[f"dec_{i}"] = {"self_attn": mha(f"{p}.self_attn"), "cross_attn": mha(f"{p}.cross_attn"),
                          "ln1": ln(f"{p}.ln1"), "ln2": ln(f"{p}.ln2"), "ln3": ln(f"{p}.ln3"),
                          "ff": ff(f"{p}.ff")}
    return {"params": {"cnn": cnn, "transformer": tr,
                       "heads": {"ctc_lin": lin("heads.ctc_lin"), "seq_lin": lin("heads.seq_lin")}}}


def test_asr_state_dict_round_trip():
    """port -> flax (the JAX helpers) has the flax model's own tree and shapes,
    and asr_state_dict brings every tensor back bit for bit."""
    model = seeded_init_(ASRModel(**SMALL, device="cpu"), 3)
    flax_vars = _to_flax(model)
    init = jax.eval_shape(lambda: JaxASRModel(**SMALL).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 80)), jnp.zeros((1, 3), jnp.int32), jnp.ones((1,))))
    assert jax.tree_util.tree_map(np.shape, flax_vars) == jax.tree_util.tree_map(
        lambda x: x.shape, dict(init))
    back = asr_state_dict(flax_vars)
    want = model.state_dict()
    assert back.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)
