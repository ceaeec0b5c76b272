"""The decode slice end to end against the JAX package (CPU), small config:

* the port's ``ASRBundle._decode_test`` against JAX's (beam 4, CTC 0.4,
  temperature 1.15, length normalization, f32 caches): identical tokens and
  lengths, scores within 1e-4;
* the whole chain, waveform -> fbank -> normalizer -> ConvAutoencoder ->
  ASR encoder similarity -> beam decode of reconstructed and clean features
  -> WER, through the port's ``evaluate_batch`` and through the same
  composition of the JAX package's functions.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from speech_anonymization_tpu.eval.metrics import SimilarityMetricsStats
from speech_anonymization_tpu.models import ConvAutoencoder as JaxConvAE
from speech_anonymization_tpu.models.asr import ASRModel as JaxASRModel
from speech_anonymization_tpu.ops.fbank import Fbank as JaxFbank
from speech_anonymization_tpu.ops.normalization import InputNormalizer as JaxNormalizer
from speech_anonymization_tpu.recipes.anonymizer import _pad_time_to_multiple
from speech_anonymization_tpu.recipes.asr_bundle import ASRBundle as JaxASRBundle
from speech_anonymization_tpu.train.brain import Stage
from speech_anonymization_tpu_torch.decoding import hyps_to_lists
from speech_anonymization_tpu_torch.models import ConvAutoencoder
from speech_anonymization_tpu_torch.models.asr import ASRModel
from speech_anonymization_tpu_torch.ops.fbank import Fbank
from speech_anonymization_tpu_torch.ops.normalization import InputNormalizer, NormalizerState
from speech_anonymization_tpu_torch.recipes import anonymizer as recipe
from speech_anonymization_tpu_torch.recipes.asr_bundle import ASRBundle
from speech_anonymization_tpu_torch.utils.convert import (
    asr_state_dict,
    convae_state_dict,
    load_numpy_state,
)
from tests.torch_port_helpers import perturbed, rand_wav, t

SMALL = dict(d_model=32, nhead=4, num_encoder_layers=1, num_decoder_layers=2, d_ffn=64,
             output_neurons=24)
HPARAMS = {"test_beam_size": 4, "ctc_weight_decode": 0.4, "temperature": 1.15}


class _Tok:
    def decode_ids(self, ids):
        return " ".join(str(i) for i in ids)


@pytest.fixture(scope="module")
def asr():
    jm = JaxASRModel(**SMALL)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 80)), jnp.zeros((1, 3), jnp.int32),
                         jnp.ones((1,)))
    v = perturbed(v, 0)
    pm = load_numpy_state(ASRModel(**SMALL, device="cpu"), asr_state_dict(v))
    return jm, v, pm


@pytest.mark.parametrize("t_frames,max_steps", [(40, None), (37, 6)])
def test_decode_matches_jax(asr, t_frames, max_steps):
    jm, v, pm = asr
    feats = np.random.default_rng(t_frames).standard_normal((3, t_frames, 80)).astype(np.float32)
    lens = np.array([1.0, 0.75, 0.9], np.float32)
    hp = {**HPARAMS, "max_decode_steps": max_steps, "decode_return_stats": True}
    want = JaxASRBundle(jm, v, _Tok(), hp)._decode_test(jnp.asarray(feats), jnp.asarray(lens))
    got = ASRBundle(pm, _Tok(), hp)._decode_test(t(feats), t(lens))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-4, rtol=0)
    assert int(got[3]["topk_fallbacks"]) == 0 and got[3]["steps"] == want[3]["steps"]
    hyps = hyps_to_lists(got[0], got[1])
    assert len({tuple(h) for h in hyps}) >= 2  # the logits depend on the input


@pytest.mark.parametrize("kind", ["mse", "cosine"])
def test_utility_loss_matches_jax(asr, kind):
    jm, v, pm = asr
    rng = np.random.default_rng(7)
    clean, recon = (rng.standard_normal((2, 36, 80)).astype(np.float32) for _ in range(2))
    lens = np.array([1.0, 0.8], np.float32)
    tokens_bos = np.array([[1, 5, 9, 0], [1, 7, 3, 4]])
    jbundle = JaxASRBundle(jm, v, _Tok(), HPARAMS, utility_kind=kind)
    want = jax.jit(lambda c, r, ln, tb: jbundle.utility_loss(c, r, ln, (None, None, None, tb)))(
        jnp.asarray(clean), jnp.asarray(recon), jnp.asarray(lens), jnp.asarray(tokens_bos))
    got = ASRBundle(pm, _Tok(), HPARAMS, utility_kind=kind).utility_loss(
        t(clean), t(recon), t(lens), t(tokens_bos))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)


def test_slice_chain_matches_jax(asr):
    """evaluate_batch with the ASR bundle: utility similarity, hypotheses and WER."""
    jm, v, pm = asr
    wavs, lens = rand_wav(2, 16000, seed=5), np.array([1.0, 0.8], np.float32)
    labels = np.array([1, 0], np.int32)
    ids, words = ["a", "b"], ["3 7 9 11", "5 5 8"]

    jfb, jn = JaxFbank(use_pallas=False), JaxNormalizer(dim=80)
    _, jstate = jn(jn.init_state(), jfb(jnp.asarray(rand_wav(3, 12000, seed=6))), None, 0,
                   training=True)
    jstate = jax.tree_util.tree_map(np.asarray, jstate)
    jae = JaxConvAE()
    av = perturbed(jax.jit(lambda key: jae.init(key, jnp.zeros((1, 36, 80)), train=False))(
        jax.random.PRNGKey(1)), 1)

    # the JAX recipe's composition (anonymizer.py eval step + asr_bundle.eval_batch)
    feats, _ = jn(jstate, jfb(jnp.asarray(wavs)), jnp.asarray(lens), 0, training=False)
    clean = _pad_time_to_multiple(feats, 36)
    recon, _ = jax.jit(lambda p, x: jae.apply(p, x, train=False))(av, clean)
    jbundle = JaxASRBundle(jm, v, _Tok(), HPARAMS)
    brain = types.SimpleNamespace(utility_similarity_aggregator=SimilarityMetricsStats())
    jbundle.start_test(brain)
    batch = types.SimpleNamespace(id=ids, wrd=words)
    jbundle.eval_batch(brain, batch, Stage.TEST, recon, clean, (None, jnp.asarray(lens)))

    bundle = ASRBundle(pm, _Tok(), HPARAMS)
    metrics = recipe.EvalMetrics()
    bundle.start_test(metrics)
    ae = load_numpy_state(ConvAutoencoder(device="cpu"), convae_state_dict(av))
    recipe.evaluate_batch(ae, Fbank(device="cpu"), InputNormalizer(80),
                          NormalizerState(*(t(x) for x in jstate)), t(wavs), t(lens), t(labels),
                          metrics, asr_bundle=bundle, ids=ids, words=words, stage="test")

    np.testing.assert_allclose(metrics.utility_similarity.scores,
                               brain.utility_similarity_aggregator.scores, atol=1e-5)
    for port_agg, jax_agg in ((metrics.wer_metric, brain.wer_metric),
                              (metrics.wer_metric2, brain.wer_metric2)):
        assert [u["hyp"] for u in port_agg.utts] == [u["hyp"] for u in jax_agg.utts]
        assert port_agg.summarize() == jax_agg.summarize()
    assert bundle.finish_test(metrics) == jbundle.finish_test(
        types.SimpleNamespace(wer_metric=brain.wer_metric, hparams={}))
