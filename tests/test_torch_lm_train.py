"""The port's LM recipe (``recipes/lm_train.py``) against the JAX package's,
on the CPU, at a small width (d_model 32, 4 heads, 2 layers, ffn 64, vocab
64), the same weights on both sides (the port's fresh flax-initialised LM):

  * ``TextBatchLoader``: the same batches as JAX's over two shuffled epochs
    (``default_rng(seed + epoch)``) and unshuffled;
  * ``LMBrain.fit_batch`` against the JAX brain's at ``lm_dropout`` 0, and at
    0.1 on the masks flax drew (the JAX attention's dropout declared in
    ``setup`` by a test-side subclass: the package's own refuses a train-mode
    call, ``tests/test_torch_dropout_init.py``); the eval loss against
    ``_eval_step``;
  * the three recoverables (``model``, ``counter``, ``noam_scheduler``) JAX ->
    port -> JAX, bit for bit and the files byte-equal; ``on_evaluate_start``'s
    average against JAX's on one directory;
  * the port-only ``main()`` (the analog of ``tests/test_recipe_lm.py``): the
    LM trains and keeps checkpoints; ``load_lm`` and one cached decode step on
    its directory.

Tolerances: losses rtol 1e-5 (measured ~2e-7); Adam moments 2e-4 of each
tensor's largest element above the noise floor (``tools/train_parity.py``
MOMENT_RTOL; measured <= ~2e-6) and the parameters as ``step_gaps`` holds
them.
"""

import functools
import os

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from speech_anonymization_tpu.data.tokenizer import UnigramTokenizer as JaxTokenizer
from speech_anonymization_tpu.models import transformer as jax_tr
from speech_anonymization_tpu.recipes import lm_train as jax_recipe
from speech_anonymization_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from speech_anonymization_tpu.train.epoch_loop import EpochCounter as JaxEpochCounter
from speech_anonymization_tpu.train.logger import FileTrainLogger as JaxFileTrainLogger
from speech_anonymization_tpu_torch.data.tokenizer import UnigramTokenizer
from speech_anonymization_tpu_torch.models.transformer import DropoutRng
from speech_anonymization_tpu_torch.recipes import lm_train as recipe
from speech_anonymization_tpu_torch.recipes.asr_bundle import load_lm
from speech_anonymization_tpu_torch.tools.train_parity import MOMENT_RTOL, noise_floor, step_gaps, tensor_gaps
from speech_anonymization_tpu_torch.train.checkpoint import Checkpointer
from speech_anonymization_tpu_torch.train.epoch_loop import EpochCounter
from speech_anonymization_tpu_torch.train.logger import FileTrainLogger
from speech_anonymization_tpu_torch.utils.convert import lm_state_dict, lm_variables
from tests.fixtures import make_fake_librispeech
from tests.test_torch_dropout_init import _SetupDropoutMHA
from tests.torch_port_helpers import t, to_numpy

WIDTHS = {"output_neurons": 64, "lm_d_model": 32, "lm_nhead": 4, "lm_num_layers": 2, "lm_d_ffn": 64}
LOSS_RTOL = 1e-5
BUCKETS = [8, 16, 32]
_WORDS = ["ALPHA", "BRAVO", "CHARLIE", "DELTA", "ECHO", "FOXTROT", "GOLF", "HOTEL", "INDIA", "JULIET"]


def _sentences(n: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(_WORDS, size=int(rng.integers(1, 14)))) for _ in range(n)]


@pytest.fixture(scope="module")
def tokenizers():
    sents = _sentences(60, 0)
    return (UnigramTokenizer().train(sents, vocab_size=WIDTHS["output_neurons"]),
            JaxTokenizer().train(sents, vocab_size=WIDTHS["output_neurons"]))


def test_text_batch_loader_matches_jax(tokenizers):
    port_tok, jax_tok = tokenizers
    sents = _sentences(37, 1)
    for shuffle in (True, False):
        got = recipe.TextBatchLoader(sents, port_tok, 8, BUCKETS, shuffle=shuffle, seed=5)
        want = jax_recipe.TextBatchLoader(sents, jax_tok, 8, BUCKETS, shuffle=shuffle, seed=5)
        assert len(got) == len(want) == 5
        for epoch in (1, 2):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            pairs = list(zip(got, want, strict=True))
            for g, w in pairs:
                for a, b in zip(g, w, strict=True):
                    assert a.dtype == b.dtype and np.array_equal(a, b)
            assert {p[0][0].shape[1] for p in pairs} <= set(BUCKETS)


def _hparams(jax_side: bool, tmp, dropout: float = 0.0) -> dict:
    logger, counter = (JaxFileTrainLogger, JaxEpochCounter) if jax_side else (FileTrainLogger, EpochCounter)
    return {**WIDTHS, "seed": 4, "lm_dropout": dropout, "lm_label_smoothing": 0.1, "gradient_clipping": 5.0,
            "noam_annealing": None, "lr_adam": 1.0, "lm_warmup_steps": 10,
            "train_logger": logger(str(tmp / ("jax" if jax_side else "port") / "log.txt")),
            "epoch_counter": counter(3)}


class Pair:
    """A port LM brain and a JAX one on the same (the port's fresh) weights."""

    def __init__(self, tmp, tokenizers, dropout: float = 0.0, checkpoints: bool = False):
        ck = (lambda cls, side: cls(str(tmp / side / "ckpts"))) if checkpoints else (lambda cls, side: None)
        self.port = recipe.LMBrain(_hparams(False, tmp, dropout), tokenizers[0], ck(Checkpointer, "port"),
                                   device="cpu")
        self.port.init_state()
        self.jax = jax_recipe.LMBrain(_hparams(True, tmp, dropout), tokenizers[1], ck(JaxCheckpointer, "jax"))
        # copies: the port updates its tensors in place, and JAX may alias numpy memory
        params = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), lm_variables(self.port.model)["params"])
        object.__setattr__(self.jax.model, "init", lambda *a, **k: {"params": params})
        self.jax.init_state(self.batch(0))

    def batch(self, seed: int):
        loader = recipe.TextBatchLoader(_sentences(6, 10 + seed), self.port.tokenizer, 6, BUCKETS)
        return next(iter(loader))

    def params(self) -> tuple[dict, dict]:
        return ({k: p.detach().clone().numpy() for k, p in self.port.model.named_parameters()},
                lm_state_dict({"params": to_numpy(self.jax.params)}))

    def check_adam_step(self, start: dict, count: int) -> None:
        adam = self.jax.opt_state.inner_state[0]
        pmu = {k: v.numpy() for k, v in self.port.opt_state.mu.items()}
        pnu = {k: v.numpy() for k, v in self.port.opt_state.nu.items()}
        jmu, jnu = (lm_state_dict({"params": to_numpy(x)}) for x in (adam.mu, adam.nu))
        assert self.port.opt_state.count == int(adam.count) == count
        failures = []
        tensor_gaps(pmu, jmu, MOMENT_RTOL, "mu", failures)
        tensor_gaps(pnu, jnu, MOMENT_RTOL, "nu", failures)
        got, want = self.params()
        floor = noise_floor(jmu)
        for k in want:
            step_gaps(k, got[k], want[k], start[k], (pmu[k], jmu[k]), (pnu[k], jnu[k]), count,
                      self.port.noam.current_lr, floor, failures)
        assert not failures, failures


def test_train_step_and_eval_loss_match_jax(tmp_path, tokenizers):
    pair = Pair(tmp_path, tokenizers)
    start, _ = pair.params()
    batch = pair.batch(1)
    got, want = float(pair.port.fit_batch(batch, 1)), float(pair.jax.fit_batch(batch, 1))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert pair.port.noam.state_dict() == pair.jax.noam.state_dict()
    pair.check_adam_step(start, 1)
    valid = pair.batch(2)
    np.testing.assert_allclose(float(pair.port.evaluate_batch(valid, None)),
                               float(pair.jax.evaluate_batch(valid, None)), rtol=LOSS_RTOL)


def test_dropout_step_on_flax_masks_matches_jax(tmp_path, tokenizers, monkeypatch):
    """At lm_dropout 0.1 the JAX brain's own jitted step, its attention's
    dropout declared in setup, records each mask as flax draws it (by a host
    callback, in call order); the port's step takes them."""
    monkeypatch.setattr(jax_tr, "MultiHeadAttention", _SetupDropoutMHA)
    pair = Pair(tmp_path, tokenizers, dropout=0.1)
    masks: dict = {}
    traced: list = []  # the call order, counted as the step is traced

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, nn.Dropout) and context.method_name == "__call__" and not kwargs.get(
                "deterministic", mod.deterministic):
            rng = mod.make_rng(mod.rng_collection)
            keep = jax.random.bernoulli(rng, 1.0 - mod.rate, args[0].shape)
            traced.append(len(traced))
            jax.debug.callback(functools.partial(masks.__setitem__, traced[-1]), keep)
            return next_fun(*args, **{**kwargs, "rng": rng})
        return next_fun(*args, **kwargs)

    start, _ = pair.params()
    batch = pair.batch(3)
    with nn.intercept_methods(interceptor):
        want = float(pair.jax.fit_batch(batch, 1))
    assert len(masks) == 2 * WIDTHS["lm_num_layers"]
    pair.port.dropout_rng = DropoutRng(masks=[t(np.asarray(masks[i])) for i in range(len(masks))])
    got = float(pair.port.fit_batch(batch, 1))
    assert not pair.port.dropout_rng.masks
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    pair.check_adam_step(start, 1)


def _state(brain, port: bool) -> dict:
    params = ({k: v.detach().numpy() for k, v in brain.model.named_parameters()} if port
              else lm_state_dict({"params": to_numpy(brain.params)}))
    return {"model": params, "counter": brain.epoch_counter.state_dict(), "noam": brain.noam.state_dict()}


def _assert_same(got: dict, want: dict) -> None:
    assert (got["counter"], got["noam"]) == (want["counter"], want["noam"])
    assert set(got["model"]) == set(want["model"])
    for k, v in want["model"].items():
        assert got["model"][k].dtype == v.dtype and np.array_equal(got["model"][k], v), k


def test_checkpoints_and_average_interchange_with_jax(tmp_path, tokenizers):
    pair = Pair(tmp_path, tokenizers, checkpoints=True)
    jb, pb = pair.jax, pair.port
    base = to_numpy(jb.params)
    for i, loss in enumerate((5.0, 2.0, 4.0, 1.0, 3.0, 6.0)):
        rng = np.random.default_rng(70 + i)
        jb._set_params(jax.tree_util.tree_map(lambda x: (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32),
                                              base))
        jb.epoch_counter.current = i + 1
        jb.noam()
        last = jb.checkpointer.save_checkpoint({"loss": loss, "epoch": i + 1})
    pb.checkpointer.checkpoints_dir = jb.checkpointer.checkpoints_dir
    assert pb.checkpointer.recover_if_possible().path == last.path
    _assert_same(_state(pb, True), _state(jb, False))
    port_dir = str(tmp_path / "port_out")
    os.makedirs(port_dir)
    pb.checkpointer.checkpoints_dir = port_dir
    mine = pb.checkpointer.save_checkpoint({"loss": 6.0, "epoch": 6})
    for name in ("model", "counter", "noam_scheduler"):
        with open(os.path.join(last.path, f"{name}.ckpt"), "rb") as a, \
                open(os.path.join(mine.path, f"{name}.ckpt"), "rb") as b:
            assert a.read() == b.read(), name
    # the top-5 least-loss average, each package on the JAX directory
    pb.checkpointer.checkpoints_dir = jb.checkpointer.checkpoints_dir
    jb.on_evaluate_start(min_key="loss")
    pb.on_evaluate_start(min_key="loss")
    _assert_same(_state(pb, True), _state(jb, False))
    # port -> JAX
    with torch.no_grad():
        for i, p in enumerate(pb.model.parameters()):
            p.add_(0.01 * (i + 1))
    pb.checkpointer.checkpoints_dir = port_dir
    ckpt = pb.checkpointer.save_checkpoint({"loss": 0.5, "epoch": 7})
    jb.checkpointer.checkpoints_dir = port_dir
    assert jb.checkpointer.recover_if_possible().path == ckpt.path
    _assert_same(_state(pb, True), _state(jb, False))


# -- the port's main() alone -------------------------------------------------------


@pytest.fixture(scope="module")
def lm_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ls_lm"))
    make_fake_librispeech(root, utts_per_speaker=4, duration_s=0.5, seed=11)
    csv = os.path.join(root, "train-clean.csv")
    out = str(tmp_path_factory.mktemp("lm_out"))
    args = {"data_folder": root, "train_splits": '["train-clean"]', "dev_splits": '["train-clean"]',
            "test_splits": '["train-clean"]', "train_csv": csv, "valid_csv": csv, "test_csv": f'["{csv}"]',
            "output_folder": out, "save_folder": os.path.join(out, "save"),
            "train_log": os.path.join(out, "train_log.txt"), "number_of_epochs": "8", "batch_size": "8",
            "output_neurons": "64", "lm_d_model": "32", "lm_nhead": "4", "lm_num_layers": "2", "lm_d_ffn": "64",
            "lm_token_buckets": "[16, 32]", "noam_annealing": "null", "lm_warmup_steps": "6", "lr_adam": "1.0",
            "lm_dropout": "0.1", "device": "cpu"}
    argv = [os.path.join(os.path.dirname(__file__), "..", "configs", "lm.yaml")]
    for k, v in args.items():
        argv += [f"--{k}", v]
    return recipe.main(argv), out, csv


def test_main_trains_and_keeps_checkpoints(lm_run):
    brain, out, _ = lm_run
    with open(os.path.join(out, "train_log.txt")) as f:
        losses = [float(ln.split("valid loss:")[1].split(",")[0]) for ln in f if "valid loss:" in ln]
    assert len(losses) == 8
    assert losses[-1] < losses[0] - 1.0 and losses[-1] < 10.0, losses
    ckpts = Checkpointer(os.path.join(out, "save", "ckpts")).list_checkpoints()
    assert len(ckpts) == 5 and all("loss" in c.meta for c in ckpts)
    assert np.isfinite(brain.test_stats["loss"])


def test_load_lm_and_cached_decode_step(lm_run):
    brain, out, csv = lm_run
    hparams = {"lm_checkpoint_dir": os.path.join(out, "save", "ckpts"), "output_neurons": 64,
               "lm_d_model": 32, "lm_nhead": 4, "lm_num_layers": 2, "lm_d_ffn": 64}
    lm = load_lm(hparams, device="cpu")
    with torch.no_grad():
        cache = lm.init_cache(2, 8)
        logits, cache = lm.decode_step(torch.tensor([1, 1]), cache, 0)
    assert logits.shape == (2, 64) and torch.isfinite(logits).all()
    # trained: an in-domain sentence's NLL beats a uniform guess over 64 tokens
    ids = brain.tokenizer.encode_as_ids(recipe._read_transcripts(csv)[0])[:8]
    tb = torch.tensor([[1, *ids]])
    te = torch.tensor([[*ids, 2]])
    with torch.no_grad():
        lp = torch.log_softmax(lm(tb), -1).gather(2, te[:, :, None])
    assert float(-lp.mean()) < np.log(64)
