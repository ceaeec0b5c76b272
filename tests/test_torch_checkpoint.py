"""The port's checkpoints against the JAX package's (CPU): one format, both ways.

  * the msgpack codec (``utils/msgpack.py``): bytes equal to
    ``flax.serialization.to_bytes`` and every decoded leaf's dtype, shape and
    value exact;
  * interchange for each ``model_type``: the JAX recipe's ``init_state`` and a
    JAX ``Checkpointer`` save recovered by the port's brain (parameters,
    BatchNorm statistics, normalizer, counter and Noam bit for bit), the
    port's files byte-equal to JAX's on the same state, and a port save
    recovered by the JAX recipe, its trees equal;
  * retention: the same metas through both checkpointers (the port's sync and
    async): the same kept metas, ``find_checkpoints`` orders, ``valid_frontier``
    pick and ``average_checkpoints`` bit for bit;
  * the loaders (``FeatureClassifier.from_checkpoint``, ``load_lm``,
    ``load_asr_bundle``) on directories the JAX package wrote, at small widths:
    their outputs within 1e-5 of JAX's.

Flax's init compiles its whole graph, so weights come from traced shapes
filled from a seed (``random_variables``), and the JAX loaders build their
templates the same way (``shape_init``: every value is then read from the
checkpoint). No JAX train step runs here.
"""

import gc
import os
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from speech_anonymization_tpu.eval import evaluator as jax_evaluator
from speech_anonymization_tpu.eval.evaluator import FeatureClassifier as JaxFeatureClassifier
from speech_anonymization_tpu.models import Xvector as JaxXvector
from speech_anonymization_tpu.models import XvectorClassifier as JaxXvectorClassifier
from speech_anonymization_tpu.models.asr import ASRModel as JaxASRModel
from speech_anonymization_tpu.models.transformer import TransformerLM as JaxTransformerLM
from speech_anonymization_tpu.ops.normalization import NormalizerState as JaxNormalizerState
from speech_anonymization_tpu.recipes import asr_bundle as jax_asr_bundle
from speech_anonymization_tpu.recipes.anonymizer import SexAnonymizationBrain as JaxBrain
from speech_anonymization_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from speech_anonymization_tpu.train.checkpoint import PytreeRecoverable as JaxRecoverable
from speech_anonymization_tpu.train.checkpoint import average_checkpoints as jax_average
from speech_anonymization_tpu.train.epoch_loop import EpochCounter as JaxEpochCounter
from speech_anonymization_tpu_torch.eval.evaluator import FeatureClassifier
from speech_anonymization_tpu_torch.recipes import asr_bundle
from speech_anonymization_tpu_torch.recipes.anonymizer import SexAnonymizationBrain
from speech_anonymization_tpu_torch.train.checkpoint import Checkpointer, PytreeRecoverable, average_checkpoints
from speech_anonymization_tpu_torch.train.epoch_loop import EpochCounter
from speech_anonymization_tpu_torch.utils import msgpack
from speech_anonymization_tpu_torch.utils.convert import anonymizer_state_dict, anonymizer_variables
from tests.torch_port_helpers import perturbed, rand_wav, random_variables, shape_init, t, to_numpy
from tests.torch_train_helpers import hparams

LOADER_ATOL = 1e-5
MODEL_TYPES = ("convae", "fcae", "endtoend", "cyclegan")
RECOVERABLES = ("model", "model_state", "normalizer", "counter", "noam_scheduler")


# -- (a) the codec ----------------------------------------------------------------

def _codec_tree(case: str, rng) -> dict:
    if case == "f32":
        return {"w": rng.standard_normal((3, 5)).astype(np.float32), "b": np.zeros(0, np.float32)}
    if case == "int32":
        return {"i": rng.integers(-2**31, 2**31 - 1, (4, 3)).astype(np.int32)}
    if case == "int64":
        return {"i": rng.integers(-2**62, 2**62, (7,)), "z": np.asarray(3, np.int64)}
    if case == "bool":
        return {"m": rng.integers(0, 2, (2, 9)).astype(bool)}
    if case == "bfloat16":
        return {"h": jnp.asarray(rng.standard_normal((6, 4)), jnp.bfloat16)}
    if case == "scalars":  # 0-d numpy scalars: flax's extension type 3
        return {"f": np.float32(rng.standard_normal()), "i": np.int64(-7), "d": np.float64(2.5),
                "b": np.bool_(True), "a": np.asarray(1.25, np.float32)}
    # nested and empty maps, keys in insertion order, 300 leaves (map16 headers)
    return {"z": {}, "a": {"y": {"x": rng.standard_normal(2).astype(np.float32), "e": {}}},
            "many": {f"k{i}": np.float32(i) for i in range(300)},
            "batch_stats": {"BatchNorm_1": {"var": np.ones(3, np.float32)},
                            "BatchNorm_0": {"mean": np.zeros(3, np.float32)}}}


def _as_port(tree):
    """bfloat16 leaves as torch tensors (numpy has no bfloat16)."""
    if isinstance(tree, dict):
        return {k: _as_port(v) for k, v in tree.items()}
    if isinstance(tree, jax.Array) and tree.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(tree).view(np.int16).copy()).view(torch.bfloat16)
    return tree


def _assert_same_leaves(got, want, path="") -> None:
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_same_leaves(got[k], want[k], f"{path}/{k}")
        return
    if torch.is_tensor(got):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16, path
        assert got.shape == want.shape, path
        assert np.array_equal(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16)), path
        return
    assert type(got) is type(want), (path, type(got), type(want))
    assert got.dtype == want.dtype and np.shape(got) == np.shape(want), path
    assert np.array_equal(got, want), path


@pytest.mark.parametrize("case", ["f32", "int32", "int64", "bool", "bfloat16", "scalars", "nested"])
def test_codec_matches_flax(case):
    tree = _codec_tree(case, np.random.default_rng(len(case)))
    want = serialization.to_bytes(tree)
    assert msgpack.to_bytes(_as_port(tree)) == want
    _assert_same_leaves(msgpack.from_bytes(bytearray(want)), serialization.msgpack_restore(want))


def test_codec_refuses_chunked_arrays():
    data = serialization.to_bytes({"x": {"__msgpack_chunked_array__": True, "shape": {}}})
    with pytest.raises(ValueError, match="chunked"):
        msgpack.from_bytes(data)


# -- (b) interchange, each model_type ---------------------------------------------

BATCH = (rand_wav(2, 71 * 160, 7), np.ones(2, np.float32), np.array([0, 1], np.int32))


def _norm_tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"count": np.asarray(5.0, np.float32),
            "glob_mean": rng.standard_normal(80).astype(np.float32),
            "glob_std": rng.uniform(0.5, 2.0, 80).astype(np.float32)}


def _jax_brain(model_type: str, ckpt_dir: str) -> JaxBrain:
    brain = JaxBrain(hparams(model_type, None, 1, False, False, epoch_counter=JaxEpochCounter(9),
                             allow_endtoend_without_evaluator=True), JaxCheckpointer(ckpt_dir))
    init = brain.model.init
    object.__setattr__(brain.model, "init", lambda *a, **k: random_variables(init, *a, seed=1, **k))
    brain.init_state(tuple(jnp.asarray(x) for x in BATCH))
    return brain


def _port_brain(model_type: str, ckpt_dir: str) -> SexAnonymizationBrain:
    brain = SexAnonymizationBrain(
        hparams(model_type, None, 1, False, True, epoch_counter=EpochCounter(9), train_logger=None,
                allow_endtoend_without_evaluator=True), Checkpointer(ckpt_dir), device="cpu")
    brain.init_state()
    return brain


def _port_state(brain: SexAnonymizationBrain) -> dict:
    ns = brain.trainer.state.norm_state
    return {"model": {k: v.numpy() for k, v in brain.model.state_dict().items()
                      if not k.endswith("num_batches_tracked")},
            "normalizer": {k: getattr(ns, k).numpy() for k in ns._fields},
            "counter": brain.epoch_counter.state_dict(), "noam": brain.noam.state_dict()}


def _jax_state(brain: JaxBrain) -> dict:
    s = brain.state
    sd = anonymizer_state_dict({"params": to_numpy(s.params), **to_numpy(s.model_state)})
    return {"model": {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")},
            "normalizer": {k: np.asarray(getattr(s.norm_state, k)) for k in s.norm_state._fields},
            "counter": brain.epoch_counter.state_dict(), "noam": brain.noam.state_dict()}


def _assert_states_equal(got: dict, want: dict) -> None:
    assert got["counter"] == want["counter"] and got["noam"] == want["noam"]
    for part in ("model", "normalizer"):
        assert set(got[part]) == set(want[part]), part
        for k, v in want[part].items():
            assert got[part][k].dtype == v.dtype and np.array_equal(got[part][k], v), (part, k)


@pytest.mark.filterwarnings("ignore:model_type=endtoend")
@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_checkpoints_interchange_with_jax(model_type, tmp_path):
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jb = _jax_brain(model_type, jax_dir)
    v = perturbed({"params": jb.state.params, **jb.state.model_state}, 11)
    jb._set(params=v["params"], model_state={k: w for k, w in v.items() if k != "params"},
            norm_state=JaxNormalizerState(**_norm_tree(12)))
    jb.epoch_counter.current = 3
    jb.noam.load_state_dict({"n_steps": 7, "current_lr": 1.25e-4})
    jax_ckpt = jb.checkpointer.save_checkpoint({"epoch": 3})

    # JAX -> port: recovered bit for bit, and written back byte for byte
    pb = _port_brain(model_type, jax_dir)
    assert pb.checkpointer.recover_if_possible().path == jax_ckpt.path
    _assert_states_equal(_port_state(pb), _jax_state(jb))
    pb.checkpointer.checkpoints_dir = port_dir
    os.makedirs(port_dir)
    port_ckpt = pb.checkpointer.save_checkpoint({"epoch": 3})
    for name in RECOVERABLES:
        with open(os.path.join(jax_ckpt.path, f"{name}.ckpt"), "rb") as a, \
                open(os.path.join(port_ckpt.path, f"{name}.ckpt"), "rb") as b:
            assert a.read() == b.read(), name

    # port -> JAX: other values, recovered by the JAX recipe
    with torch.no_grad():
        for i, p in enumerate(pb.model.parameters()):
            p.add_(0.01 * (i + 1))
        for name, buf in pb.model.named_buffers():
            if name.endswith("running_var"):
                buf.mul_(1.5)
    pb._set_normalizer(_norm_tree(13))
    pb.epoch_counter.current = 4
    pb.noam()
    ckpt = pb.checkpointer.save_checkpoint({"epoch": 4})
    jb.checkpointer.checkpoints_dir = port_dir
    assert jb.checkpointer.recover_if_possible().path == ckpt.path
    _assert_states_equal(_port_state(pb), _jax_state(jb))
    port_vars = anonymizer_variables(pb.model)
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, b),
                           port_vars, {"params": to_numpy(jb.state.params), **to_numpy(jb.state.model_state)})


# -- (c) retention, find, frontier, average ----------------------------------------

METAS = [  # (ACC_external, Utility_Retention): epochs oscillating around chance
    (0.71, 0.91), (0.52, 0.80), (0.44, 0.95), (0.60, 0.88), (0.49, 0.86), (0.55, 0.97), (0.38, 0.84)]


def _meta(i: int) -> dict:
    acc, util = METAS[i]
    return {"ACC_external": acc, "ACC_dist": abs(acc - 0.5), "Utility_Retention": util,
            "epoch": i + 1, "unixtime": 1000.0 + i}


def _params(i: int) -> dict:
    rng = np.random.default_rng(100 + i)
    return {"Dense_0": {"kernel": rng.standard_normal((4, 3)).astype(np.float32),
                        "bias": rng.standard_normal(3).astype(np.float32)}}


def _run_retention(make, root: str):
    holder = {"p": _params(0)}
    ckptr = make(root, holder)
    for i in range(len(METAS)):
        holder["p"] = _params(i)
        ckptr.save_and_keep_only(_meta(i), max_keys=["Utility_Retention"],
                                 min_keys=["ACC_external", "ACC_dist"], num_to_keep=2)
    return ckptr


def _epochs(ckpts) -> list:
    return [c.meta["epoch"] for c in ckpts]


def _frontier(brain_cls, ckptr, template):
    """The recipe's ``on_evaluate_start`` under ``valid_frontier`` on a stub brain."""
    stub = types.SimpleNamespace(
        checkpointer=ckptr, hparams={"eval_ckpt_select": "valid_frontier"}, picked=[],
        state=types.SimpleNamespace(params=template), _params_tree=lambda: template)
    stub._set = lambda params: stub.picked.append(params)
    stub._set_params = stub.picked.append
    brain_cls.on_evaluate_start(stub)
    return stub.selected_ckpt_meta, stub.picked[0]


@pytest.mark.parametrize("async_writes", [False, True], ids=["sync", "async"])
def test_retention_and_selection_match_jax(async_writes, tmp_path):
    jax_ckptr = _run_retention(lambda d, h: JaxCheckpointer(
        d, {"model": JaxRecoverable(lambda: h["p"], lambda p: h.__setitem__("p", p))},
        async_writes=async_writes), str(tmp_path / "j"))
    port_ckptr = _run_retention(lambda d, h: Checkpointer(
        d, {"model": PytreeRecoverable(lambda: h["p"], lambda p: h.__setitem__("p", p))},
        async_writes=async_writes), str(tmp_path / "p"))
    # (directory names, and so the listing's order, depend on when a deletion
    # frees a name: compare the kept set; the rankings below are by key)
    kept = sorted(_epochs(jax_ckptr.list_checkpoints()))
    assert sorted(_epochs(port_ckptr.list_checkpoints())) == kept and 2 < len(kept) < len(METAS)
    for key in ({"max_key": "Utility_Retention"}, {"min_key": "ACC_external"},
                {"min_key": "ACC_dist"}, {}):
        assert _epochs(port_ckptr.find_checkpoints(**key)) == _epochs(jax_ckptr.find_checkpoints(**key))

    ranked = port_ckptr.find_checkpoints(max_key="Utility_Retention")
    got = average_checkpoints(ranked, "model", _params(0))
    want = jax_average(jax_ckptr.find_checkpoints(max_key="Utility_Retention"), "model", _params(0))
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)), got, want)
    # the mean as the recipe takes it: summed in rank order, divided by the count
    by_epoch = {i + 1: _params(i) for i in range(len(METAS))}
    total = by_epoch[ranked[0].meta["epoch"]]["Dense_0"]["kernel"].copy()
    for c in ranked[1:]:
        total = total + by_epoch[c.meta["epoch"]]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(got["Dense_0"]["kernel"], total / np.float32(len(ranked)))

    jax_meta, jax_pick = _frontier(JaxBrain, jax_ckptr, _params(0))
    port_meta, port_pick = _frontier(SexAnonymizationBrain, port_ckptr, _params(0))
    assert port_meta == jax_meta and port_meta["kept_n"] == len(kept)
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
                           port_pick, jax_pick)


def test_dropped_async_checkpointer_is_freed(tmp_path):
    """Neither the writer thread nor the exit hook keeps an asynchronous
    checkpointer, and so the state its recoverables reach, alive once its
    owner drops it."""
    class Owner:  # stands for the brain whose bound methods the recoverables hold
        def get(self):
            return _params(0)

        def set(self, tree):
            pass

    owner = Owner()
    ckptr = Checkpointer(str(tmp_path), {"model": PytreeRecoverable(owner.get, owner.set)}, async_writes=True)
    ckptr.save_and_keep_only({"epoch": 1}, max_keys=["epoch"])
    ckptr.wait()
    refs = weakref.ref(owner), weakref.ref(ckptr)
    del owner, ckptr
    gc.collect()
    assert all(r() is None for r in refs)


# -- (d) the loaders on JAX-written directories, small widths ----------------------

EMB_DIM = 16
ASR_HP = dict(n_mels=80, d_model=32, nhead=4, num_encoder_layers=1, num_decoder_layers=2, d_ffn=64,
              output_neurons=24, lm_d_model=32, lm_nhead=4, lm_num_layers=2, lm_d_ffn=64)


def _save_trees(ckpt_dir: str, trees: dict, meta: dict) -> None:
    holder = dict(trees)
    JaxCheckpointer(ckpt_dir, {k: JaxRecoverable(lambda k=k: holder[k], lambda v, k=k: None)
                               for k in trees}).save_checkpoint(meta)


def test_feature_classifier_from_checkpoint_matches_jax(tmp_path, monkeypatch):
    emb, clf = JaxXvector(lin_neurons=EMB_DIM), JaxXvectorClassifier(lin_neurons=EMB_DIM)
    monkeypatch.setattr(jax_evaluator, "Xvector", shape_init(JaxXvector))
    monkeypatch.setattr(jax_evaluator, "XvectorClassifier", shape_init(JaxXvectorClassifier))
    for i, error in enumerate((0.4, 0.2, 0.3)):  # the least error is loaded
        ev = random_variables(emb.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 80)), train=False,
                              seed=20 + i)
        cv = random_variables(clf.init, jax.random.PRNGKey(0), jnp.zeros((1, EMB_DIM)), train=False,
                              seed=30 + i)
        _save_trees(str(tmp_path), {
            "embedding_model": ev["params"], "classifier": cv["params"],
            "normalizer": JaxNormalizerState(**_norm_tree(40 + i)),
            "model_state": {"embedding_model": {"batch_stats": ev["batch_stats"]},
                            "classifier": {"batch_stats": cv["batch_stats"]}}}, {"error": error})
    want = JaxFeatureClassifier.from_checkpoint(str(tmp_path), emb_dim=EMB_DIM)
    got = FeatureClassifier.from_checkpoint(str(tmp_path), emb_dim=EMB_DIM, device="cpu")
    np.testing.assert_array_equal(got.norm_state.glob_mean.numpy(), want.norm_state.glob_mean)
    feats = np.random.default_rng(5).standard_normal((3, 40, 80)).astype(np.float32)
    lp_want = np.asarray(want.classify_feats(jnp.asarray(feats))[0])
    np.testing.assert_allclose(got.classify_feats(t(feats))[0].numpy(), lp_want, rtol=0, atol=LOADER_ATOL)


class _Tokenizer:
    def decode_ids(self, ids):
        return " ".join(map(str, ids))


def test_load_asr_bundle_and_lm_match_jax(tmp_path, monkeypatch):
    hp = {**ASR_HP, "asr_checkpoint_dir": str(tmp_path / "asr"), "lm_checkpoint_dir": str(tmp_path / "lm")}
    jm = JaxASRModel(input_feats=80, d_model=32, nhead=4, num_encoder_layers=1, num_decoder_layers=2,
                     d_ffn=64, output_neurons=24)
    jl = JaxTransformerLM(vocab=24, d_model=32, nhead=4, num_layers=2, d_ffn=64)
    monkeypatch.setattr(jax_asr_bundle, "ASRModel", shape_init(JaxASRModel))
    monkeypatch.setattr(jax_asr_bundle, "TransformerLM", shape_init(JaxTransformerLM))
    key = jax.random.PRNGKey(0)
    for i, (acc, loss) in enumerate(((0.3, 2.0), (0.6, 1.5), (0.5, 1.0))):  # ACC max / loss min
        v = random_variables(jm.init, key, jnp.zeros((1, 8, 80)), jnp.zeros((1, 3), jnp.int32),
                             jnp.ones((1,)), seed=50 + i)
        _save_trees(hp["asr_checkpoint_dir"], {"model": v["params"]}, {"ACC": acc})
        lv = random_variables(jl.init, key, jnp.zeros((1, 4), jnp.int32), seed=60 + i)
        _save_trees(hp["lm_checkpoint_dir"], {"model": lv["params"]}, {"loss": loss})
    want = jax_asr_bundle.load_asr_bundle(hp, _Tokenizer())
    got = asr_bundle.load_asr_bundle(hp, _Tokenizer(), device="cpu")
    assert got.lm is not None and got.lm_weight == pytest.approx(0.6)
    feats = np.random.default_rng(6).standard_normal((2, 40, 80)).astype(np.float32)
    lens = np.ones(2, np.float32)
    np.testing.assert_allclose(got._encode(t(feats), t(lens)).numpy(),
                               np.asarray(want._encode(jnp.asarray(feats), jnp.asarray(lens))),
                               rtol=0, atol=LOADER_ATOL)
    toks = np.random.default_rng(7).integers(3, 24, (2, 9)).astype(np.int32)
    lm_want = jax.jit(want.lm.apply)(want.lm_variables, jnp.asarray(toks))
    with torch.no_grad():
        lm_got = got.lm(t(toks).long())
    np.testing.assert_allclose(lm_got.numpy(), np.asarray(lm_want), rtol=0, atol=LOADER_ATOL)
    assert asr_bundle.load_lm({}) is None and asr_bundle.load_asr_bundle({}, _Tokenizer()) is None
