"""The port's ASR recipe (``recipes/asr_train.py``) against the JAX package's,
on the CPU, at a small width (d_model 32, 4 heads, 2 encoder and 1 decoder
layers, ffn 64, vocab 64), 3 white-noise utterances of 0.5 s, the same
weights on both sides (the port's fresh flax-initialised model, converted):

  * ``ASRBrain.fit_batch`` against the JAX brain's on the same batches, at
    accumulation 1 and 2, with SpecAugment fed the JAX draws, after the switch
    to SGD (``check_and_reset_optimizer``), and with a non-finite loss (the
    parameters kept, the optimizer state advanced, as the JAX update does);
    its eval loss against ``_eval_loss``; its valid and test decodes against
    ``_decode_valid`` / ``_decode_test`` (beam 2 and 3, the CPU's physical
    caches);
  * the five recoverables (``model``, ``normalizer``, ``counter``,
    ``noam_scheduler``, ``optimizer_name``) JAX -> port -> JAX, bit for bit
    and the files byte-equal; ``on_evaluate_start``'s average against JAX's
    on one directory;
  * the port-only ``main()`` (the analog of ``tests/test_recipe_asr.py``,
    without the JAX recipe): the train loss falls, the WER file and the
    tokenizer are written, an ``--eval_only`` rerun with int8 caches gives
    the same WER.

Tolerances: losses rtol 1e-5; the normalizer rtol 1e-5, atol 1e-6; eval
encoder states and CTC log-probs atol 1e-5; accumulated gradients 1e-4 and
Adam moments 2e-4 of each tensor's largest element above the noise floor
(``tools/train_parity.py`` GRAD_RTOL, MOMENT_RTOL; measured <= ~8e-6), SGD's
trace and step 1e-4; the parameters as ``step_gaps`` holds them (the moments'
gaps carried into the step; elements whose first Adam step is +-lr by a
rounding-decided sign counted); decodes: hypotheses identical, scores atol
1e-4. JAX's train steps are its recipe's own jitted functions.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_anonymization_tpu.ops.fbank import Fbank as JaxFbank
from speech_anonymization_tpu.ops.normalization import InputNormalizer as JaxNormalizer
from speech_anonymization_tpu.ops.specaugment import SpecAugment as JaxSpecAugment
from speech_anonymization_tpu.recipes import asr_train as jax_recipe
from speech_anonymization_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from speech_anonymization_tpu.train.epoch_loop import EpochCounter as JaxEpochCounter
from speech_anonymization_tpu.train.logger import FileTrainLogger as JaxFileTrainLogger
from speech_anonymization_tpu_torch.decoding import hyps_to_lists
from speech_anonymization_tpu_torch.ops.fbank import Fbank
from speech_anonymization_tpu_torch.ops.normalization import InputNormalizer
from speech_anonymization_tpu_torch.ops.specaugment import SpecAugment
from speech_anonymization_tpu_torch.recipes import asr_train as recipe
from speech_anonymization_tpu_torch.tools.train_parity import (
    GRAD_RTOL,
    MOMENT_RTOL,
    noise_floor,
    step_gaps,
    tensor_gaps,
)
from speech_anonymization_tpu_torch.train.brain import Stage
from speech_anonymization_tpu_torch.train.checkpoint import Checkpointer
from speech_anonymization_tpu_torch.train.epoch_loop import EpochCounter
from speech_anonymization_tpu_torch.train.logger import FileTrainLogger
from speech_anonymization_tpu_torch.utils.convert import asr_state_dict, asr_variables
from tests.fixtures import make_fake_librispeech
from tests.torch_port_helpers import to_numpy
from tests.torch_train_helpers import jax_draws

WIDTHS = dict(d_model=32, nhead=4, num_encoder_layers=2, num_decoder_layers=1, d_ffn=64,
              output_neurons=64)
B, SAMPLES = 3, 8000
LOSS_RTOL = 1e-5
FEAT_ATOL = 1e-5
SCORE_ATOL = 1e-4
SGD_RTOL = 1e-4
CFG = os.path.join(os.path.dirname(__file__), "..", "configs", "transformer.yaml")


def _batch(seed: int, nan: bool = False):
    """The loader's PaddedBatch duck type: waveforms, tokens with bos/eos, words."""
    rng = np.random.default_rng(seed)
    wavs = (0.1 * rng.standard_normal((B, SAMPLES))).astype(np.float32)
    if nan:
        wavs[1, 100] = np.nan
    lens = np.array([1.0, 0.9, 0.8], np.float32)
    ids = rng.integers(3, WIDTHS["output_neurons"], (B, 4))
    n_ids = np.array([4, 3, 2])
    tokens = np.where(np.arange(4)[None] < n_ids[:, None], ids, 0).astype(np.int64)
    bos = np.zeros((B, 5), np.int64)
    eos = np.zeros((B, 5), np.int64)
    for i, n in enumerate(n_ids):
        bos[i, : n + 1] = [1, *ids[i, :n]]
        eos[i, : n + 1] = [*ids[i, :n], 2]
    return types.SimpleNamespace(
        sig=(wavs, lens), tokens_bos=(bos, (n_ids + 1) / 5.0), tokens_eos=(eos, ((n_ids + 1) / 5.0).astype(np.float32)),
        tokens=(tokens, (n_ids / 4.0).astype(np.float32)), id=[f"u{seed}-{i}" for i in range(B)],
        wrd=[" ".join(f"w{int(x)}" for x in ids[i, :n]) for i, n in enumerate(n_ids)])


class _Tokenizer:
    def decode_ids(self, ids):
        return " ".join(f"w{int(i)}" for i in ids)


def _hparams(jax_side: bool, tmp, accum: int, **extra) -> dict:
    side = (JaxFbank, JaxNormalizer, JaxFileTrainLogger, JaxEpochCounter) if jax_side else (
        lambda: Fbank(device="cpu"), InputNormalizer, FileTrainLogger, EpochCounter)
    fbank, normalizer, logger, counter = side
    return {**WIDTHS, "seed": 3, "gradient_accumulation": accum, "gradient_clipping": 5.0,
            "stage_one_epochs": 1, "lr_sgd": 1e-3, "valid_beam_size": 2, "test_beam_size": 3,
            "valid_search_interval": 1, "noam_annealing": None, "lr_adam": 1.0, "n_warmup_steps": 10,
            "compute_features": fbank(), "normalize": normalizer(dim=80, update_until_epoch=4),
            "train_logger": logger(str(tmp / ("jax" if jax_side else "port") / "log.txt")),
            "epoch_counter": counter(3), **extra}


# JAX's jitted train step by (accumulation, hparams): every Pair of one
# configuration reuses the first one's (its constants are the same), so each
# configuration compiles once
_JAX_STEPS: dict = {}


class Pair:
    """A port brain and a JAX brain on the same (the port's fresh) weights."""

    def __init__(self, tmp, accum: int = 1, checkpoints: bool = False, **extra):
        ck = (lambda side: Checkpointer(str(tmp / side / "ckpts"))) if checkpoints else (lambda side: None)
        jck = (lambda side: JaxCheckpointer(str(tmp / side / "ckpts"))) if checkpoints else (lambda side: None)
        self.port = recipe.ASRBrain(_hparams(False, tmp, accum, **extra), _Tokenizer(), ck("port"), device="cpu")
        self.port.init_state()
        self.jax = jax_recipe.ASRBrain(_hparams(True, tmp, accum, **extra), _Tokenizer(), jck("jax"))
        # copies: the port updates its tensors in place, and JAX may alias numpy memory
        params = jax.tree_util.tree_map(lambda x: np.array(x, np.float32),
                                        asr_variables(self.port.model)["params"])
        object.__setattr__(self.jax.model, "init", lambda *a, **k: {"params": params})
        self.jax.init_state(self.jax._device_batch(_batch(0)), 3)
        self.jax._train_step = _JAX_STEPS.setdefault((accum, repr(sorted(extra.items()))),
                                                      self.jax._train_step)

    def jax_params(self) -> dict:
        return asr_state_dict({"params": to_numpy(self.jax.state.params)})

    def port_params(self) -> dict:
        return {k: p.detach().clone().numpy() for k, p in self.port.model.named_parameters()}

    def opt(self):
        """-> ((port count, mu, nu), (JAX count, mu, nu)), in the port's names."""
        adam = self.jax.state.opt_state.inner_state[0]
        p = self.port.state.opt_state["opt"]
        return ((p.count, {k: v.numpy() for k, v in p.mu.items()}, {k: v.numpy() for k, v in p.nu.items()}),
                (int(adam.count), asr_state_dict({"params": to_numpy(adam.mu)}),
                 asr_state_dict({"params": to_numpy(adam.nu)})))

    def check_norm(self):
        got, want = self.port.state.norm_state, self.jax.state.norm_state
        for k in got._fields:
            np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def _fit_both(pair: Pair, batch, epoch: int, augment: bool = False) -> tuple[float, float]:
    draws = None
    if augment:
        _, key = jax.random.split(pair.jax._rng)
        t = pair.port.fbank(torch.from_numpy(batch.sig[0])).shape[1]
        draws = jax_draws(key, (B, t, 80), pair.jax.augmentation)
    got = float(pair.port.fit_batch(batch, epoch, draws))
    want = float(pair.jax.fit_batch(batch, epoch))
    return got, want


def _check_adam_step(pair: Pair, start: dict, lr: float, count: int) -> int:
    (pc, pmu, pnu), (jc, jmu, jnu) = pair.opt()
    assert pc == jc == count
    failures = []
    floor = noise_floor(jmu)
    tensor_gaps(pmu, jmu, MOMENT_RTOL, "mu", failures)
    tensor_gaps(pnu, jnu, MOMENT_RTOL, "nu", failures)
    got, want = pair.port_params(), pair.jax_params()
    sign_only = 0
    for k in want:
        n, _ = step_gaps(k, got[k], want[k], start[k], (pmu[k], jmu[k]), (pnu[k], jnu[k]), count, lr, floor,
                         failures)
        sign_only += n
    assert not failures, failures
    return sign_only


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum, tmp_path):
    pair = Pair(tmp_path, accum)
    start = pair.port_params()
    for i in range(accum):
        got, want = _fit_both(pair, _batch(10 + i), 1)
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
        pair.check_norm()
        if i < accum - 1:  # the buffer before the update
            failures = []
            jacc = asr_state_dict({"params": to_numpy(pair.jax.state.accum_grads)})
            tensor_gaps({k: v.numpy() for k, v in pair.port.state.accum_grads.items()}, jacc, GRAD_RTOL,
                        "accum", failures)
            assert not failures, failures
    assert pair.port.noam.state_dict() == pair.jax.noam.state_dict()
    _check_adam_step(pair, start, pair.port.noam.current_lr, 1)


def test_specaugment_step_matches_jax(tmp_path):
    pair = Pair(tmp_path, 1, augmentation=None)
    pair.port.augmentation, pair.jax.augmentation = SpecAugment(), JaxSpecAugment()
    start = pair.port_params()
    got, want = _fit_both(pair, _batch(20), 1, augment=True)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    _check_adam_step(pair, start, pair.port.noam.current_lr, 1)


def test_sgd_stage_matches_jax(tmp_path):
    """Epoch 1 on Adam, then epoch 2 switches both to SGD with a fresh state:
    the SGD trace and step, and Noam advancing in the SGD stage."""
    pair = Pair(tmp_path, 1)
    _fit_both(pair, _batch(30), 1)
    # each side's own start: a first Adam step's sign can differ by rounding
    start, jstart = pair.port_params(), pair.jax_params()
    got, want = _fit_both(pair, _batch(31), 2)
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert pair.port._optimizer_name == pair.jax._optimizer_name == "SGD"
    assert pair.port.noam.state_dict() == pair.jax.noam.state_dict() and pair.port.noam.n_steps == 2
    failures = []
    trace = asr_state_dict({"params": to_numpy(pair.jax.state.opt_state.inner_state[0].trace)})
    tensor_gaps({k: v.numpy() for k, v in pair.port.state.opt_state["opt"].trace.items()}, trace, SGD_RTOL,
                "trace", failures)
    got_p, want_p = pair.port_params(), pair.jax_params()
    tensor_gaps({k: got_p[k] - start[k] for k in start}, {k: want_p[k] - jstart[k] for k in start}, SGD_RTOL,
                "step", failures)
    assert not failures, failures


def test_non_finite_loss_keeps_params_and_advances_the_state(tmp_path):
    """A NaN sample makes the loss and the norm non-finite: both packages keep
    the parameters, and both optimizers' states advance (to NaN moments)."""
    pair = Pair(tmp_path, 1)
    start = pair.port_params()
    got, want = _fit_both(pair, _batch(40, nan=True), 1)
    assert np.isnan(got) and np.isnan(want)
    for k, v in pair.port_params().items():
        np.testing.assert_array_equal(v, start[k], err_msg=k)
        np.testing.assert_array_equal(pair.jax_params()[k], start[k], err_msg=k)
    (pc, pmu, _), (jc, jmu, _) = pair.opt()
    assert pc == jc == 1
    for k in jmu:
        np.testing.assert_array_equal(np.isnan(pmu[k]), np.isnan(jmu[k]), err_msg=k)
    # the normalizer's statistics took the NaN in both (they update on every micro-batch)
    for k in pair.port.state.norm_state._fields:
        np.testing.assert_array_equal(np.isnan(getattr(pair.port.state.norm_state, k).numpy()),
                                      np.isnan(np.asarray(getattr(pair.jax.state.norm_state, k))), err_msg=k)


def test_eval_loss_and_decodes_match_jax(tmp_path):
    pair = Pair(tmp_path, 1)
    batch = _batch(50)
    db = pair.port._device_batch(batch)
    jdb = pair.jax._device_batch(batch)
    s = pair.jax.state
    loss, enc, p_ctc = pair.port._eval_loss(db, 1)
    jloss, jenc, jp = pair.jax._eval_loss(s.params, s.model_state, s.norm_state, jdb, jnp.asarray(1))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), atol=FEAT_ATOL)
    np.testing.assert_allclose(p_ctc.numpy(), np.asarray(jp), atol=FEAT_ATOL)
    for port_fn, jax_fn in ((pair.port._decode_valid, pair.jax._decode_valid),
                            (pair.port._decode_test, pair.jax._decode_test)):
        toks, lengths, scores = port_fn(db.wavs, db.lens, 1)
        jt, jl, js = jax_fn(s.params, s.model_state, s.norm_state, jdb[0], jdb[1], jnp.asarray(1))
        assert hyps_to_lists(toks, lengths) == [list(map(int, np.asarray(jt)[i, : int(n)]))
                                                for i, n in enumerate(np.asarray(jl))]
        np.testing.assert_allclose(scores.numpy(), np.asarray(js), atol=SCORE_ATOL)
    # evaluate_batch: a valid stage decodes every valid_search_interval epochs
    pair.port.epoch_counter.current = 1
    pair.port.on_stage_start(Stage.VALID, 1)
    pair.port.evaluate_batch(batch, Stage.VALID)
    assert len(pair.port.wer_metric.utts) == B


def _port_ckpt_state(brain) -> dict:
    ns = brain.state.norm_state
    return {"model": {k: v.detach().numpy() for k, v in brain.model.named_parameters()},
            "normalizer": {k: getattr(ns, k).numpy() for k in ns._fields},
            "counter": brain.epoch_counter.state_dict(), "noam": brain.noam.state_dict(),
            "optimizer": brain._optimizer_name}


def _jax_ckpt_state(brain) -> dict:
    s = brain.state
    return {"model": asr_state_dict({"params": to_numpy(s.params)}),
            "normalizer": {k: np.asarray(getattr(s.norm_state, k)) for k in s.norm_state._fields},
            "counter": brain.epoch_counter.state_dict(), "noam": brain.noam.state_dict(),
            "optimizer": brain._optimizer_name}


def _assert_same(got: dict, want: dict) -> None:
    assert (got["counter"], got["noam"], got["optimizer"]) == (want["counter"], want["noam"], want["optimizer"])
    for part in ("model", "normalizer"):
        assert set(got[part]) == set(want[part])
        for k, v in want[part].items():
            assert got[part][k].dtype == v.dtype and np.array_equal(got[part][k], v), (part, k)


RECOVERABLES = ("model", "normalizer", "counter", "noam_scheduler", "optimizer_name")


def test_checkpoints_interchange_with_jax(tmp_path):
    pair = Pair(tmp_path, 1, checkpoints=True)
    jb, pb = pair.jax, pair.port
    for brain in (jb, pb):
        brain.check_and_reset_optimizer(2)  # registers optimizer_name
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(lambda x: (x + 0.01 * rng.standard_normal(x.shape)).astype(np.float32),
                                    to_numpy(jb.state.params))
    jb._set(params=params, norm_state=jb.state.norm_state._replace(
        count=jnp.asarray(4.0), glob_mean=jnp.asarray(rng.standard_normal(80), jnp.float32)))
    jb.epoch_counter.current = 2
    jb.noam.load_state_dict({"n_steps": 9, "current_lr": 3.5e-4})
    jax_ckpt = jb.checkpointer.save_checkpoint({"ACC": -3.0, "epoch": 2})
    pb.checkpointer.checkpoints_dir = jb.checkpointer.checkpoints_dir
    assert pb.checkpointer.recover_if_possible().path == jax_ckpt.path
    _assert_same(_port_ckpt_state(pb), _jax_ckpt_state(jb))
    port_dir = str(tmp_path / "port_out")
    os.makedirs(port_dir)
    pb.checkpointer.checkpoints_dir = port_dir
    port_ckpt = pb.checkpointer.save_checkpoint({"ACC": -3.0, "epoch": 2})
    for name in RECOVERABLES:
        with open(os.path.join(jax_ckpt.path, f"{name}.ckpt"), "rb") as a, \
                open(os.path.join(port_ckpt.path, f"{name}.ckpt"), "rb") as b:
            assert a.read() == b.read(), name
    # port -> JAX: other values
    with torch.no_grad():
        for i, p in enumerate(pb.model.parameters()):
            p.add_(0.01 * (i + 1))
    pb.epoch_counter.current = 3
    pb.noam()
    ckpt = pb.checkpointer.save_checkpoint({"ACC": -2.0, "epoch": 3})
    jb.checkpointer.checkpoints_dir = port_dir
    assert jb.checkpointer.recover_if_possible().path == ckpt.path
    _assert_same(_port_ckpt_state(pb), _jax_ckpt_state(jb))


def test_checkpoint_average_matches_jax(tmp_path):
    """Six checkpoints with ACC metas in one directory: each package's
    ``on_evaluate_start`` averages the top 5 by ACC, to the same parameters."""
    pair = Pair(tmp_path, 1, checkpoints=True)
    jb, pb = pair.jax, pair.port
    base = to_numpy(jb.state.params)
    for i, acc in enumerate((-5.0, -1.0, -3.0, -4.0, -2.0, -6.0)):
        rng = np.random.default_rng(60 + i)
        jb._set(params=jax.tree_util.tree_map(
            lambda x: (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32), base))
        jb.checkpointer.save_checkpoint({"ACC": acc, "epoch": i + 1})
    pb.checkpointer.checkpoints_dir = jb.checkpointer.checkpoints_dir
    jb.on_evaluate_start(max_key="ACC")
    pb.on_evaluate_start(max_key="ACC")
    want = pair.jax_params()
    for k, v in pair.port_params().items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


# -- the port's main() alone -------------------------------------------------------


def _main_argv(root, out, **extra):
    csv = os.path.join(root, "train-clean.csv")
    args = {"data_folder": root, "train_splits": '["train-clean"]', "dev_splits": '["train-clean"]',
            "test_splits": '["train-clean"]', "train_csv": csv, "valid_csv": csv, "test_csv": f'["{csv}"]',
            "output_folder": out, "save_folder": os.path.join(out, "save"),
            "train_log": os.path.join(out, "train_log.txt"), "batch_size": "6", "gradient_accumulation": "1",
            "number_of_epochs": "3", "stage_one_epochs": "2", "d_model": "32", "nhead": "4",
            "num_encoder_layers": "2", "num_decoder_layers": "1", "d_ffn": "64", "output_neurons": "64",
            "valid_beam_size": "2", "test_beam_size": "2", "valid_search_interval": "100",
            "noam_annealing": "null", "lr_adam": "0.005", "device": "cpu", **extra}
    argv = [CFG]
    for k, v in args.items():
        argv += [f"--{k}", v]
    return argv


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ls"))
    make_fake_librispeech(root, utts_per_speaker=3, duration_s=0.5, seed=3)
    out = str(tmp_path_factory.mktemp("asr_out"))
    return recipe.main(_main_argv(root, out)), root, out


def test_main_trains_and_switches_to_sgd(trained):
    brain, _, out = trained
    lines = [ln for ln in open(os.path.join(out, "train_log.txt")).read().splitlines() if "train loss" in ln]
    losses = [float(ln.split("train loss: ")[1].split(" ")[0].rstrip(",")) for ln in lines]
    assert len(losses) == 3 and losses[-1] < losses[0], losses
    assert "optimizer: Adam" in lines[1] and "optimizer: SGD" in lines[2]
    assert brain._optimizer_name == "SGD"
    ckpts = Checkpointer(os.path.join(out, "save", "ckpts")).list_checkpoints()
    assert len(ckpts) == 3 and all("ACC" in c.meta for c in ckpts)
    assert os.path.exists(os.path.join(ckpts[-1].path, "optimizer_name.ckpt"))


def test_main_wer_file_and_tokenizer(trained):
    brain, _, out = trained
    assert 0.0 <= brain.test_stats["WER"] <= 200.0
    with open(os.path.join(out, "wer_train-clean.txt")) as f:
        assert f.readline().startswith("%WER")
    assert os.path.exists(os.path.join(out, "save", "tokenizer.json"))
    ids = brain.tokenizer.encode_as_ids("HELLO WORLD")
    assert brain.tokenizer.decode_ids(ids) == "HELLO WORLD"


def test_main_eval_only_int8_gives_the_same_wer(trained):
    brain, root, out = trained
    rerun = recipe.main(_main_argv(root, out, decode_cache_dtype="int8", eval_only="true"))
    assert rerun.test_stats["WER"] == brain.test_stats["WER"]
    assert rerun.test_stats["loss"] == brain.test_stats["loss"]
