"""The port's anonymizer epoch loop (``SexAnonymizationBrain``) against the JAX
recipe's (CPU), on in-memory batches of the recipe's ``PaddedBatch`` duck type:

  * evaluation for every ``model_type``: the trainer's ``eval_batch`` against
    JAX's ``_eval_step`` on the same weights, normalizer state and batch (fcae
    pads T to 1, endtoend subtracts its external classifier's terms): loss
    and recon within 1e-5 (recon relative to its largest element), sex
    log-probs within ``SEX_RTOL``;
  * the stage hooks without an ASR bundle (the cosine-proxy utility): the
    valid and test stats, ACC and ACC_external exactly, the rest within 1e-5,
    MI_bits included; the MI estimators on well-separated features; the
    logger's lines byte-equal on the same stats, and the experiment
    directory's files; the epoch's train loss of a
    two-micro-batch ``fit`` within ``LOSS_RTOL``;
  * port only: with an ``ASRBundle`` the test stage logs the WER and WER_orig
    that the module-level ``evaluate_batch`` (held to JAX by
    ``test_torch_slice.py`` and ``test_torch_decode.py``) gives on the same batches.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_anonymization_tpu.eval.evaluator import FeatureClassifier as JaxFeatureClassifier
from speech_anonymization_tpu.losses.mi import ClusterMI as JaxClusterMI
from speech_anonymization_tpu.losses.mi import GroupSamplingMI as JaxGroupSamplingMI
from speech_anonymization_tpu.losses.mi import MILoss as JaxMILoss
from speech_anonymization_tpu.losses.mi import cosine_distance_matrix as jax_cosine_distances
from speech_anonymization_tpu.models import Xvector as JaxXvector
from speech_anonymization_tpu.models import XvectorClassifier as JaxXvectorClassifier
from speech_anonymization_tpu.ops.normalization import InputNormalizer as JaxNormalizer
from speech_anonymization_tpu.ops.normalization import NormalizerState as JaxNormalizerState
from speech_anonymization_tpu.recipes.anonymizer import SexAnonymizationBrain as JaxBrain
from speech_anonymization_tpu.train.brain import Stage as JaxStage
from speech_anonymization_tpu.train.epoch_loop import EpochCounter as JaxEpochCounter
from speech_anonymization_tpu.train.experiment import create_experiment_directory as jax_create_experiment_directory
from speech_anonymization_tpu.train.logger import FileTrainLogger as JaxLogger
from speech_anonymization_tpu_torch.eval.evaluator import FeatureClassifier
from speech_anonymization_tpu_torch.losses.mi import GroupSamplingMI, MILoss, cosine_distance_matrix
from speech_anonymization_tpu_torch.models import ASRModel
from speech_anonymization_tpu_torch.ops.normalization import InputNormalizer
from speech_anonymization_tpu_torch.recipes import anonymizer as recipe
from speech_anonymization_tpu_torch.recipes.asr_bundle import ASRBundle
from speech_anonymization_tpu_torch.tools.train_parity import LOSS_RTOL, SEX_RTOL, speechlike
from speech_anonymization_tpu_torch.train.brain import Stage
from speech_anonymization_tpu_torch.train.epoch_loop import EpochCounter
from speech_anonymization_tpu_torch.train.experiment import create_experiment_directory
from speech_anonymization_tpu_torch.train.logger import FileTrainLogger
from speech_anonymization_tpu_torch.utils.seeded_init import seeded_init_
from tests.torch_port_helpers import perturbed, random_variables, t
from tests.torch_train_helpers import hparams

RTOL = 1e-5
EVAL_WEIGHTS = {"recon_loss_weight": 1.0, "sex_loss_weight": 0.5, "utility_loss_weight": 0.0,
                "confusion_loss_weight": 0.2}
RECON_ONLY = [{"weights": {"recon": 1.0}, "train": "all"}]  # the fit's phase: no sex term


def _batch(b: int, t_frames: int, seed: int):
    """The recipe's PaddedBatch duck type: speech-like utterances, alternating sexes."""
    ns = types.SimpleNamespace(sig=(speechlike(b, (t_frames - 1) * 160, seed), np.ones(b, np.float32)),
                               gender=np.arange(b) % 2, id=[f"u{seed}-{i}" for i in range(b)])
    rng = np.random.default_rng(seed)
    ns.wrd = [" ".join(map(str, rng.integers(3, 24, 5))) for _ in range(b)]
    return ns


VALID = [_batch(4, 36, 70), _batch(4, 36, 71)]
TEST = [_batch(4, 36, 72), _batch(4, 36, 73)]


@functools.lru_cache(maxsize=None)
def _evaluators():
    """The external x-vector classifier in both packages, one pair for the
    module (the JAX one compiles its classify once)."""
    emb, clf = JaxXvector(lin_neurons=16), JaxXvectorClassifier(lin_neurons=16)
    ev = random_variables(emb.init, jax.random.PRNGKey(5), jnp.zeros((1, 8, 80)), train=False, seed=5)
    cv = random_variables(clf.init, jax.random.PRNGKey(6), jnp.zeros((1, 16)), train=False, seed=6)
    jax_fc = JaxFeatureClassifier(
        emb, clf, {"embedding_model": ev["params"], "classifier": cv["params"]},
        {"embedding_model": {"batch_stats": ev["batch_stats"]},
         "classifier": {"batch_stats": cv["batch_stats"]}}, JaxNormalizer(dim=80).init_state())
    port_fc = FeatureClassifier.from_flax(ev, cv, InputNormalizer(80).init_state("cpu"), emb_dim=16,
                                          device="cpu")
    return jax_fc, port_fc


def _norm_tree() -> dict:
    rng = np.random.default_rng(9)
    return {"count": np.asarray(8.0, np.float32), "glob_mean": rng.normal(-20, 3, 80).astype(np.float32),
            "glob_std": rng.uniform(8.0, 14.0, 80).astype(np.float32)}


def _brains(model_type: str, log_dir, **extra):
    """The JAX recipe and the port's brain on the same perturbed weights and
    normalizer state, each with its own train log; the external x-vector
    classifier attached to both."""
    jax_fc, port_fc = _evaluators()
    common = {**EVAL_WEIGHTS, "adversarial_schedule": RECON_ONLY, "gradient_accumulation": 2, **extra}
    jb = JaxBrain({**hparams(model_type, None, 2, False, False), **common,
                   "train_logger": JaxLogger(str(log_dir / "jax_log.txt")),
                   "epoch_counter": JaxEpochCounter(1)}, external_classifier=jax_fc)
    init = jb.model.init
    object.__setattr__(jb.model, "init", lambda *a, **k: random_variables(init, *a, seed=1, **k))
    b = VALID[0]
    jb.init_state((jnp.asarray(b.sig[0]), jnp.asarray(b.sig[1]), jnp.asarray(b.gender, jnp.int32)))
    v = perturbed({"params": jb.state.params, **jb.state.model_state}, 3)
    model_state = {k: w for k, w in v.items() if k != "params"}
    jb._set(params=v["params"], model_state=model_state, norm_state=JaxNormalizerState(**_norm_tree()))
    pb = recipe.SexAnonymizationBrain(
        {**hparams(model_type, None, 2, False, True), **common,
         "train_logger": FileTrainLogger(str(log_dir / "port_log.txt")), "epoch_counter": EpochCounter(1)},
        external_classifier=port_fc, device="cpu")
    pb._set_params(v["params"])
    pb._set_model_state(model_state)
    pb._set_normalizer(_norm_tree())
    return jb, pb


@pytest.fixture
def jitted_jax_mi(monkeypatch):
    """JAX's per-draw MI jitted: the package vmaps it eagerly, which compiles
    op by op; the arithmetic is the same."""
    orig, cache = JaxClusterMI._mutual_information, {}

    def mi(self, x, y):
        key = (self.k, self.n_classes)
        if key not in cache:
            est = types.SimpleNamespace(k=self.k, n_classes=self.n_classes)
            cache[key] = jax.jit(lambda x, y: orig(est, x, y))
        return cache[key](x, y)

    monkeypatch.setattr(JaxClusterMI, "_mutual_information", mi)


def _db(batch):
    return tuple(jnp.asarray(x) for x in (*batch.sig, np.asarray(batch.gender, np.int32)))


# -- (e) evaluation for every model_type ---------------------------------------------

@pytest.mark.parametrize("model_type", ["convae", "fcae", "endtoend", "cyclegan"])
def test_eval_batch_matches_jax(model_type, tmp_path):
    jb, pb = _brains(model_type, tmp_path)
    batch = _batch(4, 50, 75)  # T 50: fcae keeps it, the others pad to 72
    weights = [EVAL_WEIGHTS[k] for k in ("recon_loss_weight", "sex_loss_weight", "utility_loss_weight",
                                         "confusion_loss_weight")]
    s = jb.state
    loss, sex_lp, recon, clean = jb._eval_step(s.params, s.model_state, s.norm_state, _db(batch), 0,
                                               jnp.asarray(weights, jnp.float32))
    got = pb.trainer.eval_batch(tuple(t(x) for x in (*batch.sig, batch.gender)), 0, weights)
    assert got[2].shape == (4, 50 if model_type == "fcae" else 72, 80)
    recon = np.asarray(recon)
    np.testing.assert_allclose(float(got[0]), float(loss), rtol=RTOL)
    np.testing.assert_allclose(got[2].numpy(), recon, rtol=RTOL, atol=RTOL * np.abs(recon).max())
    np.testing.assert_allclose(got[3].numpy(), np.asarray(clean), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(sex_lp), rtol=SEX_RTOL, atol=1e-7)


# -- (f) the hooks, without an ASR bundle ---------------------------------------------

@pytest.fixture(scope="module")
def convae(tmp_path_factory):
    return _brains("convae", tmp_path_factory.mktemp("logs"), measure_mi=True, mi_iterations=6)


def _assert_stats(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k, v in want.items():
        if k.startswith("ACC"):
            assert got[k] == v, k
        else:
            np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=1e-7, err_msg=k)


def test_valid_and_test_stats_match_jax(convae, jitted_jax_mi):
    jb, pb = convae
    for brain, stage, name in ((jb, JaxStage.VALID, "jax"), (pb, Stage.VALID, "port")):
        brain.on_stage_start(stage, 1)
        losses = [float(brain.evaluate_batch(b, stage)) for b in VALID]
        brain.on_stage_end(stage, sum(losses) / len(losses), 1)
    want = {"ACC": jb.sex_classification_acc.summarize(),
            "ACC_external": jb.sex_classification_acc_extern.summarize(),
            "ACC_external_orig": jb.sex_classification_acc_extern_orig.summarize(),
            "Utility_Retention": jb.utility_similarity_aggregator.summarize()}
    m = pb.metrics
    _assert_stats({"ACC": m.sex_acc.summarize(), "ACC_external": m.sex_acc_extern.summarize(),
                   "ACC_external_orig": m.sex_acc_extern_orig.summarize(),
                   "Utility_Retention": m.utility_similarity.summarize()}, want)
    assert m.sex_acc.total == 8

    got_loss, want_loss = pb.evaluate(TEST), jb.evaluate(TEST)
    np.testing.assert_allclose(got_loss, want_loss, rtol=RTOL)
    assert "MI_bits" in jb.test_stats and np.isfinite(jb.test_stats["MI_bits"])
    _assert_stats(pb.test_stats, jb.test_stats)


def _clusters(n_per: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Two classes of 16-dim features around their own well-separated
    directions: no two pairwise distances near a tie."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((2, 16)) * 3.0
    y = np.repeat([0, 1], n_per)
    x = centers[y] + rng.standard_normal((2 * n_per, 16))
    return x.astype(np.float32), y


def test_mi_estimators_match_jax(jitted_jax_mi):
    x, y = _clusters(12, 3)
    np.testing.assert_allclose(cosine_distance_matrix(t(x)).numpy(),
                               np.asarray(jax.jit(jax_cosine_distances)(jnp.asarray(x))), atol=1e-6)
    want = JaxGroupSamplingMI(n_samples=6, n_iterations=10)(jnp.asarray(x), y, y, seed=4)
    got = GroupSamplingMI(n_samples=6, n_iterations=10)(t(x), y, y, seed=4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=1e-6)
    mi = MILoss()(t(x.reshape(24, 4, 4)), y, y, batch_size=8, seed=1)
    np.testing.assert_allclose(float(mi), float(JaxMILoss()(jnp.asarray(x.reshape(24, 4, 4)), y, y,
                                                          batch_size=8, seed=1)), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("stats", [
    ({"epoch": 3, "lr": 3.9e-4, "steps": 124920, "optimizer": "Adam"}, {"loss": 0.963},
     {"loss": 1.02, "ACC": 0.5, "ACC_external": 0.75, "Utility_Retention": 0.00123}),
    ({"Epoch loaded": 7}, None, {"loss": 2.5e5, "WER": 101.3, "MI_bits": -0.0421, "n": 12}),
], ids=["valid", "test"])
def test_logger_lines_match_jax(stats, tmp_path):
    meta, train, valid = stats
    JaxLogger(str(tmp_path / "jax.txt")).log_stats(meta, train_stats=train, valid_stats=valid)
    FileTrainLogger(str(tmp_path / "port.txt")).log_stats(meta, train_stats=train, valid_stats=valid)
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


@pytest.mark.parametrize("overrides", [{"seed": 1234, "lr": 1e-4}, "--seed 1234"], ids=["dict", "str"])
def test_experiment_directory_matches_jax(overrides, tmp_path):
    """The hyperparameter snapshot (overrides appended) and env.log byte-equal."""
    src = tmp_path / "hparams.yaml"
    src.write_text("seed: 8886\nbatch_size: 3\n")
    jax_create_experiment_directory(str(tmp_path / "jax"), str(src), overrides)
    create_experiment_directory(str(tmp_path / "port"), str(src), overrides)
    for name in ("hyperparams.yaml", "env.log"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_fit_train_loss_matches_jax(tmp_path):
    """Two micro-batches (accumulation 2: one update, after both losses),
    recon only, the normalizer updating."""
    jb, pb = _brains("convae", tmp_path)
    train = [VALID[0], TEST[0]]
    jb.fit(JaxEpochCounter(1), train)
    pb.fit(EpochCounter(1), train)
    assert pb.step == jb.step == 2
    np.testing.assert_allclose(pb.train_stats["loss"], jb.train_stats["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(pb.trainer.state.norm_state.count), float(jb.state.norm_state.count))


# -- (g) port only: the test stage with an ASR bundle --------------------------------

class _Tokenizer:
    def decode_ids(self, ids):
        return " ".join(map(str, ids))


def test_test_stage_wer_equals_evaluate_batch(tmp_path):
    asr = seeded_init_(ASRModel(d_model=32, nhead=4, num_encoder_layers=1, num_decoder_layers=2,
                                d_ffn=64, output_neurons=24, device="cpu"), 4)
    bundle = ASRBundle(asr, _Tokenizer(), {"test_beam_size": 4, "max_decode_steps": 6})
    pb = recipe.SexAnonymizationBrain(
        {**hparams("convae", None, 1, False, True), "train_logger": FileTrainLogger(str(tmp_path / "log.txt")),
         "epoch_counter": EpochCounter(1), "wer_file": str(tmp_path / "wer.txt")},
        asr_bundle=bundle, device="cpu")
    seeded_init_(pb.model, 2)
    pb.evaluate(TEST)
    metrics = recipe.EvalMetrics()
    bundle.start_test(metrics)
    tr = pb.trainer
    for b in TEST:
        recipe.evaluate_batch(pb.model, tr.fbank, tr.normalizer, tr.state.norm_state, t(b.sig[0]),
                              t(b.sig[1]), torch.from_numpy(b.gender), metrics, asr_bundle=bundle,
                              ids=b.id, words=b.wrd, stage="test")
    assert pb.test_stats["WER"] == metrics.wer_metric.summarize("error_rate")
    assert pb.test_stats["WER_orig"] == metrics.wer_metric2.summarize("error_rate")
    assert pb.test_stats["Utility_Retention"] == metrics.utility_similarity.summarize()
    assert (tmp_path / "wer.txt").read_text()
    assert "test WER" in (tmp_path / "log.txt").read_text()
