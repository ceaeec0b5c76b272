"""The port's anonymizer recipe through its entry point, ``main()``, on the CPU
(``--device cpu``), on the synthetic fixture corpus (``make_fake_librispeech``):

  * the five tests of ``tests/test_recipe_anonymizer.py`` on the port alone:
    fcae recon-only, convae's two-phase schedule with the checkpoints' meta
    keys, endtoend's warning, endtoend refused without an evaluator, and
    ``--eval_only``; and a resume check: ``main()`` then ``main(--eval_only)``
    in one folder give equal ``test_stats``;
  * one parity run against the JAX package's ``main()``: convae, one epoch,
    ``--augmentation null``; both runs first recover one checkpoint written
    into their ``save/ckpts`` by the JAX package's ``Checkpointer`` from
    seeded variables, so they start from the same state. The train and valid
    losses within ``LOSS_RTOL``, ``test_stats`` ACC exactly and the rest within
    ``RTOL``, the kept checkpoints' ``model`` trees within ``RTOL`` of each
    tensor's largest element and their metas with the same keys;
  * the initialisation repair: a fresh model of every family has flax's
    initialiser statistics (kernel stds within 5% of ``lecun_normal``'s,
    sqrt(1/fan_in) with fan_in counted by flax on the same shapes, for kernels
    of 1,000 elements or more, that rule itself held to ``lecun_normal``'s
    draws; biases, norm shifts and BatchNorm means 0, norm scales and BatchNorm
    variances 1), and the same seed gives the same weights.

The JAX ``main()``'s own flax init is replaced by a traced one (zeros of its
shapes): its state is overwritten by the recovered checkpoint, and flax's
eager init would take most of the test's time.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from jax._src.nn.initializers import _compute_fans

from speech_anonymization_tpu.models import ConvAutoencoder as JaxConvAE
from speech_anonymization_tpu.models import ConvReconstruction as JaxConvReconstruction
from speech_anonymization_tpu.models import CycleGANGenerator as JaxCycleGAN
from speech_anonymization_tpu.models import FullyConnectedAutoencoder as JaxFCAE
from speech_anonymization_tpu.ops.normalization import InputNormalizer as JaxNormalizer
from speech_anonymization_tpu.recipes import anonymizer as jax_recipe
from speech_anonymization_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from speech_anonymization_tpu.train.checkpoint import PytreeRecoverable as JaxPytreeRecoverable
from speech_anonymization_tpu.train.epoch_loop import EpochCounter as JaxEpochCounter
from speech_anonymization_tpu.train.schedulers import NoamScheduler as JaxNoamScheduler
from speech_anonymization_tpu_torch.recipes import anonymizer as recipe
from speech_anonymization_tpu_torch.train.checkpoint import Checkpointer, read_tree
from speech_anonymization_tpu_torch.utils.convert import anonymizer_variables
from tests.fixtures import make_fake_librispeech
from tests.torch_port_helpers import random_variables, shape_init

CFG = os.path.join(os.path.dirname(__file__), "..", "configs", "convae.yaml")
RTOL = 1e-5
LOSS_RTOL = 1e-5
INIT_STD_RTOL = 0.05
_NUMBER = re.compile(r"(train|valid) loss: ([-0-9.e+]+)")


def _argv(root, out, device="cpu", **overrides):
    """The JAX recipe test's command line, on the port's device flag."""
    base = {
        "data_folder": root,
        "train_splits": '["train-clean"]',
        "dev_splits": '["train-clean"]',
        "test_splits": '["train-clean"]',
        "train_csv": os.path.join(root, "train-clean.csv"),
        "valid_csv": os.path.join(root, "train-clean.csv"),
        "test_csv": f'["{os.path.join(root, "train-clean.csv")}"]',
        "output_folder": out,
        "save_folder": os.path.join(out, "save"),
        "train_log": os.path.join(out, "train_log.txt"),
        "batch_size": "4",
        "gradient_accumulation": "1",
        "number_of_epochs": "2",
    }
    base.update({k: str(v) for k, v in overrides.items()})
    argv = [CFG]
    for k, v in base.items():
        argv += [f"--{k}", v]
    return argv + (["--device", device] if device else [])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ls"))
    make_fake_librispeech(root, utts_per_speaker=3, duration_s=0.7)
    return root


# -- the JAX recipe's tests, on the port ---------------------------------------------


def test_fcae_recon_only_learns(corpus, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("out_fcae"))
    brain = recipe.main(_argv(corpus, out, model_type="fcae", number_of_epochs=3,
                              adversarial_schedule="null", recon_loss_weight=1.0) + ["--lr_adam", "0.05"])
    assert os.path.exists(os.path.join(out, "train_log.txt"))
    assert "Utility_Retention" in brain.test_stats
    assert np.isfinite(brain.test_stats["loss"])
    assert brain.device == torch.device("cpu") and brain.trainer.fbank.dft.device.type == "cpu"


@pytest.fixture(scope="module")
def convae_run(corpus, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("out_convae"))
    return out, recipe.main(_argv(corpus, out, model_type="convae", number_of_epochs=2))


def test_convae_adversarial_schedule_runs(convae_run):
    out, brain = convae_run
    assert 0.0 <= brain.test_stats["ACC"] <= 1.0
    ckpts = os.listdir(os.path.join(out, "save", "ckpts"))
    assert any(c.startswith("CKPT") for c in ckpts)
    meta = open(os.path.join(out, "save", "ckpts", sorted(ckpts)[0], "CKPT.yaml")).read()
    assert "ACC_external" in meta and "Utility_Retention" in meta
    for name in ("train_log.txt", "hyperparams.yaml", "env.log"):
        assert os.path.exists(os.path.join(out, name)), name


def test_eval_only_resumes_to_the_same_stats(corpus, convae_run):
    """``main()`` then ``main(--eval_only)`` in one folder: the second run
    recovers and averages the first's checkpoints and scores the same."""
    out, brain = convae_run
    again = recipe.main(_argv(corpus, out, model_type="convae", number_of_epochs=2) + ["--eval_only"])
    assert again.test_stats == brain.test_stats
    assert again.epoch_counter.current == 2


def test_endtoend_model_runs(corpus, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("out_e2e"))
    with pytest.warns(UserWarning, match="chance-level CONSTANT"):
        brain = recipe.main(_argv(corpus, out, model_type="endtoend", number_of_epochs=1)
                            + ["--allow_endtoend_without_evaluator", "true"])
    assert np.isfinite(brain.test_stats["loss"])


def test_endtoend_without_evaluator_refused(corpus, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("out_e2e_refuse"))
    with pytest.raises(ValueError, match="external classifier"):
        recipe.main(_argv(corpus, out, model_type="endtoend", number_of_epochs=1))


def test_eval_only_mode(corpus, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("out_evalonly"))
    brain = recipe.main(_argv(corpus, out, model_type="fcae", number_of_epochs=1) + ["--eval_only"])
    assert "ACC" in brain.test_stats
    assert not os.listdir(os.path.join(out, "save", "ckpts"))


def test_cuda_is_the_default_and_never_falls_back(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    with pytest.raises(SystemExit, match="--device cpu"):
        recipe.main(_argv(corpus, str(tmp_path), device=None, number_of_epochs=1))


# -- parity with the JAX package's main() -------------------------------------------


def _seed_checkpoint(save_folder: str, variables: dict) -> None:
    """One checkpoint in the JAX package's format, written by its own
    Checkpointer: the recipe's five recoverables at a fresh run's counters."""
    ckpt = JaxCheckpointer(os.path.join(save_folder, "ckpts"))
    norm = JaxNormalizer(dim=80).init_state()
    trees = {"model": variables["params"], "model_state": {"batch_stats": variables["batch_stats"]},
             "normalizer": norm}
    for name, tree in trees.items():
        ckpt.add_recoverable(name, JaxPytreeRecoverable(lambda tree=tree: tree, lambda _: None))
    ckpt.add_recoverable("counter", JaxEpochCounter(1))
    ckpt.add_recoverable("noam_scheduler", JaxNoamScheduler())
    ckpt.save_checkpoint({"epoch": 0})


def _losses(out: str) -> list[float]:
    with open(os.path.join(out, "train_log.txt")) as f:
        return [float(v) for _, v in _NUMBER.findall(f.read())]


def _kept(out: str) -> list:
    return sorted(Checkpointer(os.path.join(out, "save", "ckpts")).list_checkpoints(),
                  key=lambda c: c.meta["epoch"])


@pytest.fixture(scope="module")
def parity_runs(corpus, tmp_path_factory):
    key = jax.random.PRNGKey(0)
    variables = random_variables(JaxConvAE().init, {"params": key, "dummy": key},
                                 np.zeros((2, 36, 80), np.float32), train=False, seed=3)
    outs = {}
    for name in ("jax", "port"):
        outs[name] = str(tmp_path_factory.mktemp(f"parity_{name}"))
        _seed_checkpoint(os.path.join(outs[name], "save"), variables)
    overrides = dict(model_type="convae", number_of_epochs=1, augmentation="null")
    saved = jax_recipe.MODEL_TYPES["convae"]
    jax_recipe.MODEL_TYPES["convae"] = shape_init(JaxConvAE)
    try:
        jax_brain = jax_recipe.main(_argv(corpus, outs["jax"], device=None, **overrides))
    finally:
        jax_recipe.MODEL_TYPES["convae"] = saved
    port_brain = recipe.main(_argv(corpus, outs["port"], **overrides))
    return outs, jax_brain, port_brain


def test_main_matches_jax_main(parity_runs):
    outs, jb, pb = parity_runs
    # the losses: the epoch's train loss, and the train and valid losses as logged
    np.testing.assert_allclose(pb.train_stats["loss"], jb.train_stats["loss"], rtol=LOSS_RTOL)
    got, want = _losses(outs["port"]), _losses(outs["jax"])
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    # the test stage's stats
    assert set(pb.test_stats) == set(jb.test_stats)
    assert pb.test_stats["ACC"] == jb.test_stats["ACC"]
    for k, v in jb.test_stats.items():
        np.testing.assert_allclose(pb.test_stats[k], v, rtol=RTOL, atol=RTOL, err_msg=k)
    # the kept checkpoints: the same metas' keys, the model trees within RTOL of each tensor's max
    kept = {name: _kept(out) for name, out in outs.items()}
    assert len(kept["port"]) == len(kept["jax"]) == 1
    for pc, jc in zip(kept["port"], kept["jax"]):
        assert set(pc.meta) == set(jc.meta) and pc.meta["epoch"] == jc.meta["epoch"] == 1
        pt = jax.tree_util.tree_leaves_with_path(read_tree(os.path.join(pc.path, "model.ckpt")))
        jt = dict(jax.tree_util.tree_leaves_with_path(read_tree(os.path.join(jc.path, "model.ckpt"))))
        assert len(pt) == len(jt) > 0
        for path, leaf in pt:
            want_leaf = np.asarray(jt[path])
            scale = max(float(np.abs(want_leaf).max()), 1e-30)
            assert np.abs(np.asarray(leaf) - want_leaf).max() <= RTOL * scale, path


# -- the initialisation repair ----------------------------------------------------------

FAMILIES = {
    "convae": (JaxConvAE, (2, 36, 80)),
    "fcae": (JaxFCAE, (2, 36, 80)),
    "endtoend": (JaxConvReconstruction, (2, 36, 80)),
    "cyclegan": (JaxCycleGAN, (2, 36, 80)),
}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _flax_std(shape) -> float:
    """The standard deviation of flax's ``lecun_normal`` on a kernel of ``shape``
    (flax's layout): sqrt(1 / fan_in), fan_in counted by flax's own rule."""
    fan_in, _ = _compute_fans(shape)
    return float(np.sqrt(1.0 / fan_in))


def test_flax_std_rule_matches_lecun_normal_draws():
    """:func:`_flax_std` against ``lecun_normal``'s own draws on the
    ConvAutoencoder's dense, conv and transposed-conv kernel shapes."""
    init = jax.nn.initializers.lecun_normal()
    for i, shape in enumerate([(256, 128), (5, 64, 64), (5, 128, 64)]):
        draw = np.asarray(init(jax.random.PRNGKey(i), shape))
        np.testing.assert_allclose(draw.std(), _flax_std(shape), rtol=INIT_STD_RTOL, err_msg=str(shape))


@pytest.mark.parametrize("model_type", FAMILIES)
def test_fresh_model_has_flax_init_statistics(model_type):
    jax_cls, shape = FAMILIES[model_type]
    key = jax.random.PRNGKey(0)
    flax_shapes = jax.eval_shape(lambda: jax_cls().init({"params": key, "dummy": key},
                                                        np.zeros(shape, np.float32), train=False))
    model = recipe.MODEL_TYPES[model_type](generator=torch.Generator().manual_seed(5), device="cpu")
    port = {k: v.detach().numpy() for k, v in _flat(anonymizer_variables(model)).items()}
    want_shapes = {k: tuple(v.shape) for k, v in _flat(flax_shapes).items()}
    assert {k: v.shape for k, v in port.items()} == want_shapes
    kernels = sorted(k for k in port if k.endswith("kernel") and port[k].size >= 1000)
    assert kernels
    for name in kernels:
        np.testing.assert_allclose(port[name].std(), _flax_std(want_shapes[name]), rtol=INIT_STD_RTOL,
                                   err_msg=name)
    for name, value in port.items():
        leaf = name.rsplit("/", 1)[-1]
        if leaf in ("bias", "mean"):
            assert not value.any(), name
        elif leaf in ("scale", "var"):
            assert (value == 1.0).all(), name


@pytest.mark.parametrize("model_type", ["convae", "fcae"])
def test_same_seed_same_weights(model_type):
    def fresh(seed):
        return recipe.AnonymizerTrainer({"model_type": model_type, "seed": seed}, device="cpu").model

    a, b, c = fresh(8886), fresh(8886), fresh(8887)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)


def test_main_builds_on_the_requested_device(parity_runs):
    """Under ``--device cpu`` the config's objects and the brain live on the CPU."""
    _, _, pb = parity_runs
    assert pb.trainer.fbank.dft.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in pb.model.parameters())
    assert pb.hparams["compute_features"] is pb.trainer.fbank
