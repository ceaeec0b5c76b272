"""The port's gender recipes through their entry points on the CPU
(``--device cpu``), on the synthetic fixture corpus (``make_fake_librispeech``:
two male and two female speakers whose pitch differs), on the port alone:

  * ``recipes/gender_classifier.py`` ``main()``, ``tests/test_recipe_gender.py``'s
    run (configs/gender_classifier.yaml at full TDNN width, embeddings 32,
    batch 8, 6 epochs): it learns the sex (test error <= 0.25) and leaves the
    train log, ``label_encoder.txt``, the experiment files and one ``CKPT*``
    kept by the least error; that checkpoint, loaded as the anonymizer's
    external evaluator (``FeatureClassifier.from_checkpoint``), gives the
    log-probs a brain recovered from it gives (atol 1e-5);
  * the recon variant (configs/gender_classifier_recon.yaml, 1 epoch) on a
    ConvAutoencoder checkpoint written by the port's Checkpointer with
    frontier metas: the ``valid_frontier`` pick is loaded, and stays frozen;
  * ``recipes/gender_classifier_pitch_norm.py`` ``main()`` (2 epochs): the
    native vocoder serves each utterance once, the WAV cache every later read.
"""

import os

import numpy as np
import pytest
import torch

from speech_anonymization_tpu_torch.data import pitch
from speech_anonymization_tpu_torch.eval.evaluator import FeatureClassifier
from speech_anonymization_tpu_torch.models import ConvAutoencoder
from speech_anonymization_tpu_torch.recipes import gender_classifier as recipe
from speech_anonymization_tpu_torch.recipes import gender_classifier_pitch_norm as pitch_recipe
from speech_anonymization_tpu_torch.recipes.anonymizer import model_state_tree, set_model_params, set_model_state
from speech_anonymization_tpu_torch.train.checkpoint import Checkpointer, PytreeRecoverable
from speech_anonymization_tpu_torch.utils.convert import anonymizer_variables
from tests.fixtures import make_fake_librispeech

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def _argv(config: str, root: str, out: str, **overrides) -> list:
    csv = os.path.join(root, "train-clean.csv")
    args = {"data_folder": root, "train_splits": '["train-clean"]', "dev_splits": '["train-clean"]',
            "test_splits": '["train-clean"]', "train_csv": csv, "valid_csv": csv, "test_csv": csv,
            "output_folder": out, "save_folder": os.path.join(out, "save"),
            "train_log": os.path.join(out, "train_log.txt"), **{k: str(v) for k, v in overrides.items()}}
    argv = [os.path.join(CONFIGS, config)]
    for k, v in args.items():
        argv += [f"--{k}", v]
    return argv + ["--device", "cpu"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ls"))
    make_fake_librispeech(root, utts_per_speaker=6, duration_s=0.8)
    return root


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("gender"))
    brain = recipe.main(_argv("gender_classifier.yaml", corpus, out, batch_size=8, number_of_epochs=6,
                              emb_dim=32))
    return brain, out


def test_recipe_learns_gender(trained):
    brain, _ = trained
    assert brain.test_stats["error"] <= 0.25, brain.test_stats
    assert brain.device == torch.device("cpu") and brain.fbank.dft.device.type == "cpu"


def test_recipe_artifacts(trained):
    _, out = trained
    lines = open(os.path.join(out, "train_log.txt")).read().strip().splitlines()
    assert any(line.startswith("Epoch: 1") for line in lines)
    assert any("Epoch loaded" in line for line in lines)
    assert "=>" in open(os.path.join(out, "save", "label_encoder.txt")).read()
    ckpts = Checkpointer(os.path.join(out, "save", "ckpts")).list_checkpoints()
    assert len(ckpts) == 1 and {"loss", "error", "epoch"} <= set(ckpts[0].meta)
    names = set(os.listdir(ckpts[0].path))
    assert {f"{n}.ckpt" for n in ("embedding_model", "classifier", "normalizer", "model_state", "counter",
                                  "lr_annealing")} <= names
    for name in ("hyperparams.yaml", "env.log"):
        assert os.path.exists(os.path.join(out, name)), name


def test_evaluator_loads_the_kept_checkpoint(corpus, trained, tmp_path):
    """The anonymizer's external evaluator, from this run's checkpoint
    directory, scores one batch as a brain recovered from that checkpoint."""
    brain, out = trained
    ckpt_dir = os.path.join(out, "save", "ckpts")
    config, _, overrides = recipe.parse_arguments(_argv("gender_classifier.yaml", corpus, str(tmp_path),
                                                        emb_dim=32))
    hp = recipe.load_config(config, overrides, device="cpu")
    fresh = recipe.GenderBrain(hp, Checkpointer(ckpt_dir), device="cpu")
    fresh.init_state()
    assert fresh.checkpointer.recover_if_possible(min_key="error") is not None
    wavs = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 12800)).astype(np.float32) * 0.1)
    lens = torch.tensor([1.0, 0.8, 0.9])
    _, _, want = fresh.eval_step((wavs, lens, torch.tensor([0, 1, 0])), 0)
    ext = FeatureClassifier.from_checkpoint(ckpt_dir, emb_dim=32, device="cpu")
    feats, _ = fresh.normalizer(fresh.state.norm_state, fresh.fbank(wavs), lens, training=False)
    got, _, _ = ext.classify_feats(feats, lens)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_main_needs_a_device(corpus, tmp_path):
    argv = _argv("gender_classifier.yaml", corpus, str(tmp_path))[:-2]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            recipe.main(argv)
    with pytest.raises(SystemExit, match="unknown --device"):
        recipe.main(argv + ["--device", "tpu"])


def _write_anonymizer(ckpt_dir: str) -> dict:
    """Three ConvAutoencoder checkpoints in the JAX package's format, the
    port's Checkpointer writing them, with frontier metas; -> the pick's
    (epoch 2) parameters."""
    model = ConvAutoencoder(generator=torch.Generator().manual_seed(5), device="cpu")
    ckptr = Checkpointer(ckpt_dir, {
        "model": PytreeRecoverable(lambda: anonymizer_variables(model)["params"],
                                   lambda p: set_model_params(model, p)),
        "model_state": PytreeRecoverable(lambda: model_state_tree(model), lambda s: set_model_state(model, s))})
    picked = None
    for epoch, acc, util in ((1, 0.9, 0.99), (2, 0.55, 0.9), (3, 0.5, 0.4)):
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.01)
        ckptr.save_checkpoint({"epoch": epoch, "ACC_external": acc, "Utility_Retention": util})
        if epoch == 2:
            picked = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return picked


def test_recon_main_attacks_the_frontier_pick(corpus, tmp_path):
    ckpt_dir = str(tmp_path / "anonymizer" / "ckpts")
    picked = _write_anonymizer(ckpt_dir)
    brain = recipe.main(_argv("gender_classifier_recon.yaml", corpus, str(tmp_path / "out"), batch_size=8,
                              number_of_epochs=1, emb_dim=32, trained_recon_model_dir=ckpt_dir,
                              recon_model_type="convae", recon_ckpt_select="valid_frontier"))
    assert isinstance(brain.recon_model, ConvAutoencoder)
    assert all(torch.equal(v, picked[k]) for k, v in brain.recon_model.state_dict().items())
    assert np.isfinite(brain.test_stats["loss"]) and 0.0 <= brain.test_stats["error"] <= 1.0


def test_pitch_norm_main(tmp_path):
    root = str(tmp_path / "ls")
    make_fake_librispeech(root, utts_per_speaker=2, duration_s=0.8)
    out = str(tmp_path / "out")
    served = dict(pitch.SERVED)
    brain = pitch_recipe.main(_argv("gender_classifier_pitch_norm.yaml", root, out, batch_size=4,
                                    number_of_epochs=2, emb_dim=16))
    cache = os.listdir(os.path.join(out, "save", "pitch_cache"))
    assert len(cache) == 8 and all(name.endswith(".wav") for name in cache)
    assert pitch.SERVED["native"] - served["native"] == 8 and pitch.SERVED["numpy"] == served["numpy"]
    assert np.isfinite(brain.test_stats["loss"])
