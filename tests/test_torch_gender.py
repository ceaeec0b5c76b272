"""The port's gender recipe (``recipes/gender_classifier.py``) against the JAX
package's, on the CPU, at a small x-vector width (TDNN channels (16, 16, 16,
16, 48), embeddings 16), on speech-like waveforms (batch 4, 1 s), the same
seeded weights on both sides (``tests/torch_gender_helpers.py``):

  * the x-vector repair: ``Xvector`` and ``XvectorClassifier`` in train mode
    against flax's ``apply(..., mutable=["batch_stats"])``: outputs and every
    updated running mean and variance (torch's ``BatchNorm1d`` moved the
    variance toward the unbiased batch variance: 1/(n-1) too far);
  * ``GenderBrain``'s train step against the JAX brain's ``_train_step`` fed
    the same key (its draws reproduced for the port): plain, with
    ``EnvCorrupt`` + ``TimeDomainSpecAugment`` at accumulation 2, with a
    frozen convae and fcae anonymizer; and a forced non-finite loss, which
    skips the whole update; its eval step against ``_eval_step``;
  * the six recoverables, port -> JAX -> port, bit for bit and the files
    byte-equal; ``load_recon_model``'s pick; ``data/pitch.py``.

Tolerances: the loss within rtol 1e-5 (measured ~5e-7), the error exactly,
eval log-probs within 1e-5 (~6e-8); BatchNorm running statistics within 1e-5
of each tensor's largest element (~8e-7); the normalizer within rtol 1e-5,
atol 1e-6; accumulated gradients 1e-4 and Adam moments 2e-4 of each tensor's
largest element (``tools/train_parity.py`` GRAD_RTOL, MOMENT_RTOL), above the
noise floor (1e-4 of the largest gradient): each package's f32 gradients lie
up to ~1.5e-5 of a tensor's scale from a float64 run
(``test_head_gradients_are_f32_limited``), so their mutual gap can reach
~3e-5; the parameters as ``step_gaps`` holds them (the moments' gaps carried
into the step, elements whose first step is +-lr by a rounding-decided sign
counted). At the recipe's full width the TDNN gradients are f32-limited far
more (~7e-3 of a tensor's scale from float64 on the CPU,
``test_full_width_gradients_are_f32_limited``): the card test's reason for
its moment tolerance.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_anonymization_tpu.data import pitch as jax_pitch
from speech_anonymization_tpu.models import Xvector as JaxXvector
from speech_anonymization_tpu.models import XvectorClassifier as JaxXvectorClassifier
from speech_anonymization_tpu.recipes import gender_classifier as jax_recipe
from speech_anonymization_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
from speech_anonymization_tpu_torch.data import pitch
from speech_anonymization_tpu_torch.models import Xvector, XvectorClassifier
from speech_anonymization_tpu_torch.recipes import gender_classifier as recipe
from speech_anonymization_tpu_torch.tools.train_parity import (
    GRAD_RTOL,
    MOMENT_RTOL,
    SEX_MOMENT_RTOL,
    gender_hparams,
    noise_floor,
    step_gaps,
    tensor_gaps,
    train_batch,
)
from speech_anonymization_tpu_torch.train.checkpoint import Checkpointer
from speech_anonymization_tpu_torch.utils.convert import anonymizer_variables, indexed_state_dict, load_numpy_state
from tests.torch_gender_helpers import (
    EMB,
    LR,
    SMALL,
    GenderPair,
    hparams,
    port_batch,
    recon_pair,
    speech_batch,
)
from tests.torch_port_helpers import jax_gender_draws, random_variables, shape_init, t, to_numpy

B, N = 4, 16000
LOSS_RTOL = 1e-5
LP_ATOL = 1e-5
STATS_RTOL = 1e-5
NORM_RTOL, NORM_ATOL = 1e-5, 1e-6
LENS = [1.0, 0.9, 0.8, 0.7]


# -- the x-vector repair ------------------------------------------------------------


@pytest.mark.parametrize("which", ["xvector", "classifier"])
def test_xvector_train_mode_matches_flax(which):
    """Train mode at batch 4: the output and every running statistic after one
    call. The gap the repair closes: 0.1 var / (n - 1) = 3.3e-2 var at n 4
    for the classifier's BatchNorms (n rows), 1/(B T - 1) of it for the TDNN's."""
    rng = np.random.default_rng(5)
    if which == "xvector":
        jm, x = JaxXvector(**SMALL), rng.standard_normal((B, 40, 80)).astype(np.float32)
        args = (jnp.asarray(x), jnp.asarray(np.array(LENS, np.float32)))
        pm = Xvector(**SMALL, device="cpu")
    else:
        jm, x = JaxXvectorClassifier(lin_neurons=EMB), rng.standard_normal((B, EMB)).astype(np.float32)
        args = (jnp.asarray(x),)
        pm = XvectorClassifier(lin_neurons=EMB, device="cpu")
    v = random_variables(jm.init, jax.random.PRNGKey(0), *args, train=False, seed=11)
    out, mut = jax.jit(lambda v, *a: jm.apply(v, *a, train=True, mutable=["batch_stats"]))(v, *args)
    load_numpy_state(pm, indexed_state_dict(v))
    got = pm.train()(*(t(np.asarray(a)) for a in args))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=1e-5, atol=1e-5)
    want = indexed_state_dict({"params": v["params"], **to_numpy(mut)})
    for k, buf in pm.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_head_gradients_are_f32_limited():
    """Why the gradient tolerance exceeds 1e-5: the recipe's loss gradients in
    f32, the port's and the JAX package's, each against a float64 run of the
    port on the same features and weights, per tensor relative to its largest
    element. Both are some 1e-6..2e-5 from float64, so a 1e-4 bound on
    their mutual gap is what f32 leaves, and a tighter one is not."""
    pair = GenderPair()
    wavs, lens, labels = port_batch(speech_batch(B, N, 10, LENS))
    feats, _ = pair.pb.normalizer(pair.pb.state.norm_state, pair.pb.fbank(wavs), lens, 0, training=True)

    def port_grads(dtype):
        emb = copy.deepcopy(pair.pb.embedding_model).to(dtype).train()
        clf = copy.deepcopy(pair.pb.classifier).to(dtype).train()
        loss = torch.nn.functional.nll_loss(clf(emb(feats.to(dtype), lens.to(dtype))), labels)
        named = [(f"embedding_model.{k}", p) for k, p in emb.named_parameters()] + \
                [(f"classifier.{k}", p) for k, p in clf.named_parameters()]
        grads = torch.autograd.grad(loss, [p for _, p in named])
        return {k: g.double() for (k, _), g in zip(named, grads)}

    jb, s = pair.jb, pair.jstate

    def jax_loss(params, f, ln, y):
        emb, _ = jb.embedding_model.apply({"params": params["embedding_model"], **s.model_state["embedding_model"]},
                                          f, ln, train=True, mutable=["batch_stats"])
        lp, _ = jb.classifier.apply({"params": params["classifier"], **s.model_state["classifier"]}, emb,
                                    train=True, mutable=["batch_stats"])
        return -jnp.mean(jnp.take_along_axis(lp, y[:, None], axis=1))

    jg = jax.jit(jax.grad(jax_loss))(s.params, jnp.asarray(feats.numpy()), jnp.asarray(lens.numpy()),
                                     jnp.asarray(labels.numpy()))
    g64, g32, gj = port_grads(torch.float64), port_grads(torch.float32), pair.jax_tree(jg)

    def worst(got):
        return max(float((got[k].double() - g64[k]).abs().max() / g64[k].abs().max()) for k in g64)

    port_gap, jax_gap = worst(g32), worst({k: torch.from_numpy(np.array(v)) for k, v in gj.items()})
    assert 1e-7 < max(port_gap, jax_gap) < 5e-5, (port_gap, jax_gap)
    mutual = max(float(np.abs(g32[k].numpy() - gj[k]).max() / g64[k].abs().max()) for k in g64)
    assert mutual <= port_gap + jax_gap + 1e-7 and mutual < GRAD_RTOL


def test_full_width_gradients_are_f32_limited():
    """Why the card test of a full-width step (``tests/test_torch_cuda.py``
    ``test_gender_step_on_card_matches_cpu``, ``tools/train_parity.py``
    ``compare_gender_step``) holds Adam's moments to SEX_MOMENT_RTOL: on its
    batch (8 x 2 s) and weights, the port's f32 gradients on the CPU lie up
    to ~7e-3 of a TDNN tensor's largest element from a float64 run (the
    pooled standard deviations of 1,500 channels amplify rounding), while
    the head's stay within ~1e-5."""
    brain = recipe.GenderBrain(gender_hparams("cpu", augment=False), device="cpu")
    wavs, lens, labels = train_batch(8, 32_000, 21)[:3]
    feats, _ = brain.normalizer(brain.state.norm_state, brain.fbank(wavs), lens, 0, training=True)

    def grads(dtype):
        emb = copy.deepcopy(brain.embedding_model).to(dtype).train()
        clf = copy.deepcopy(brain.classifier).to(dtype).train()
        loss = torch.nn.functional.nll_loss(clf(emb(feats.to(dtype), lens.to(dtype))), labels)
        named = [(f"embedding_model.{k}", p) for k, p in emb.named_parameters()] + \
                [(f"classifier.{k}", p) for k, p in clf.named_parameters()]
        return {k: g.double() for (k, _), g in zip(named, torch.autograd.grad(loss, [p for _, p in named]))}

    g64, g32 = grads(torch.float64), grads(torch.float32)
    gap = {k: float((g32[k] - g64[k]).abs().max() / g64[k].abs().max()) for k in g64}
    tdnn = max(v for k, v in gap.items() if k.startswith(("embedding_model.convs", "embedding_model.norms")))
    head = max(v for k, v in gap.items() if k.startswith(("classifier.", "embedding_model.dense")))
    assert 1e-3 < tdnn < SEX_MOMENT_RTOL and head < 1e-4, gap


# -- the train and eval steps -----------------------------------------------------------


def _check_step(pair: GenderPair, jm: dict, loss: torch.Tensor, failures: list, stepped: bool, i: int):
    g, w = float(loss), float(jm["loss"])
    if not abs(g - w) <= LOSS_RTOL * abs(w):
        failures.append(f"micro-batch {i}: loss {g} vs {w}")
    if float(pair.pb.metrics["error"]) != float(jm["error"]):
        failures.append(f"micro-batch {i}: error {float(pair.pb.metrics['error'])} vs {float(jm['error'])}")
    tensor_gaps(pair.port_stats(), pair.jax_stats(), STATS_RTOL, "BatchNorm statistics", failures)
    for name, a, b in zip(("count", "glob_mean", "glob_std"), pair.pb.state.norm_state, pair.jstate.norm_state):
        if not np.allclose(a.numpy(), np.asarray(b), rtol=NORM_RTOL, atol=NORM_ATOL):
            failures.append(f"micro-batch {i}: normalizer {name}")
    if not stepped:
        tensor_gaps(pair.pb.state.accum_grads, pair.jax_tree(pair.jstate.accum_grads), GRAD_RTOL,
                    "accumulated gradients", failures)
        return
    count, mu, nu = pair.adam()
    adam = pair.pb.state.opt_state["adam"]
    if adam.count != count:
        failures.append(f"Adam count {adam.count} vs {count}")
    tensor_gaps(adam.mu, mu, MOMENT_RTOL, "Adam mu", failures)
    tensor_gaps(adam.nu, nu, MOMENT_RTOL, "Adam nu", failures)
    want, start, floor = pair.jax_tree(pair.jstate.params), pair.jax_tree(pair.start), noise_floor(mu)
    for k, p in pair.pb.params.items():
        step_gaps(k, p.detach(), want[k], start[k], (adam.mu[k], mu[k]), (adam.nu[k], nu[k]), count, LR,
                  floor, failures)


def _check_eval(pair: GenderPair, seed: int, failures: list):
    batch = speech_batch(B, N, seed, [1.0, 0.6, 0.9, 0.75])
    jl, je, jlp = pair.jax_eval(batch)
    pl, pe, plp = pair.pb.eval_step(port_batch(batch), 0)
    if abs(float(pl) - jl) > LOSS_RTOL * abs(jl) or float(pe) != je:
        failures.append(f"eval loss/error {float(pl)}/{float(pe)} vs {jl}/{je}")
    if np.abs(plp.numpy() - jlp).max() > LP_ATOL:
        failures.append(f"eval log-probs differ by {np.abs(plp.numpy() - jlp).max()}")


CASES = {"plain": dict(), "augmented_accum2": dict(env=True, aug=True, accum=2),
         "recon_convae": dict(recon="convae"), "recon_fcae": dict(recon="fcae")}


@pytest.mark.parametrize("case", list(CASES))
def test_train_and_eval_steps_match_jax(case):
    """Eval on the starting weights, one accumulation cycle, then for the
    plain case a non-finite loss (a NaN sample): the JAX step keeps the
    parameters and Adam's state, and so must the port."""
    kw = CASES[case]
    pair = GenderPair(**kw)
    failures: list = []
    _check_eval(pair, 50, failures)
    accum = kw.get("accum", 1)
    env, aug = kw.get("env", False), kw.get("aug", False)
    for i in range(accum):
        batch = speech_batch(B, N, 10 + i, LENS)
        key = jax.random.PRNGKey(100 + i)
        jm = pair.jax_step(batch, key)
        loss = pair.pb.fit_batch(port_batch(batch), 0, draws=jax_gender_draws(key, B, N, env, aug))
        _check_step(pair, jm, loss, failures, stepped=i == accum - 1, i=i)
    assert pair.pb.state.accum_count == 0
    assert not failures, failures
    if case != "plain":
        return
    wavs, lens, labels = speech_batch(B, N, 12, LENS)
    wavs[1, 100] = np.nan
    before = {k: p.detach().clone() for k, p in pair.pb.params.items()}
    mu_before = {k: m.clone() for k, m in pair.pb.state.opt_state["adam"].mu.items()}
    jparams, jcount = to_numpy(pair.jstate.params), pair.adam()[0]
    jm = pair.jax_step((wavs, lens, labels), jax.random.PRNGKey(7))
    loss = pair.pb.fit_batch(port_batch((wavs, lens, labels)), 0, draws=None)
    assert not np.isfinite(jm["loss"]) and not torch.isfinite(loss)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, jparams, to_numpy(pair.jstate.params)))
    assert pair.adam()[0] == jcount == pair.pb.state.opt_state["adam"].count
    assert all(torch.equal(before[k], p) for k, p in pair.pb.params.items())
    assert all(torch.equal(mu_before[k], m) for k, m in pair.pb.state.opt_state["adam"].mu.items())
    assert pair.pb.state.accum_count == 0 and not any(a.any() for a in pair.pb.state.accum_grads.values())


# -- checkpoints ---------------------------------------------------------------------------


def _port_trees(brain) -> dict:
    return {name: to_numpy(rec._get()) for name, rec in brain.checkpointer.recoverables.items()
            if hasattr(rec, "_get")}


def test_checkpoints_interchange_bit_for_bit(tmp_path):
    """The port's six recoverables after a train step: saved by the port,
    recovered by the JAX ``GenderBrain`` (``init_state`` on traced shapes),
    saved again by JAX (every file byte-equal to the port's) and recovered by
    a fresh port brain, equal to the first bit for bit."""
    pair = GenderPair()
    pb = pair.pb
    pb.fit_batch(port_batch(speech_batch(B, N, 10, LENS)), 0)
    pb.lr_annealing(1, 0.5)
    pb.epoch_counter.current = 1
    pb.checkpointer = Checkpointer(str(tmp_path / "port"))
    pb.init_state()
    saved = pb.checkpointer.save_checkpoint({"error": 0.25, "epoch": 1})

    jhp = hparams(False)
    jhp["embedding_model"] = shape_init(JaxXvector)(**SMALL)
    jhp["classifier"] = shape_init(JaxXvectorClassifier)(lin_neurons=EMB)
    jb = jax_recipe.GenderBrain(jhp, checkpointer=JaxCheckpointer(str(tmp_path / "port")))
    wavs, lens, labels = speech_batch(B, N, 10, LENS)
    jb.init_state((jnp.asarray(wavs), jnp.asarray(lens), jnp.asarray(labels)))
    assert jb.checkpointer.recover_if_possible() is not None
    want = _port_trees(pb)
    got = {"embedding_model": jb.state.params["embedding_model"], "classifier": jb.state.params["classifier"],
           "normalizer": jb.state.norm_state._asdict(), "model_state": jb.state.model_state}
    for name, tree in got.items():
        same = jax.tree_util.tree_map(np.array_equal, to_numpy(tree), want[name])
        assert jax.tree_util.tree_all(same), name
    assert jb.epoch_counter.current == 1 and jb.lr_annealing.state_dict() == pb.lr_annealing.state_dict()

    jsave = JaxCheckpointer(str(tmp_path / "jax"), dict(jb.checkpointer.recoverables)).save_checkpoint(
        {"error": 0.25, "epoch": 1})
    for f in sorted(os.listdir(saved.path)):
        if f.endswith(".ckpt"):
            assert (open(os.path.join(saved.path, f), "rb").read()
                    == open(os.path.join(jsave.path, f), "rb").read()), f

    fresh = recipe.GenderBrain(hparams(True), Checkpointer(str(tmp_path / "jax")), device="cpu")
    fresh.init_state()
    assert fresh.checkpointer.recover_if_possible() is not None
    for a, b in ((fresh.embedding_model, pb.embedding_model), (fresh.classifier, pb.classifier)):
        assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert all(torch.equal(x, y) for x, y in zip(fresh.state.norm_state, pb.state.norm_state))
    assert fresh.epoch_counter.current == 1
    assert fresh.lr_annealing.state_dict() == pb.lr_annealing.state_dict()


# -- the recon model's checkpoint pick --------------------------------------------------------


METAS = [{"epoch": 1, "ACC_external": 0.9, "Utility_Retention": 0.99},
         {"epoch": 2, "ACC_external": 0.55, "Utility_Retention": 0.90},
         {"epoch": 3, "ACC_external": 0.50, "Utility_Retention": 0.40}]


@pytest.mark.parametrize("model_type,select,epoch", [("fcae", "valid_frontier", 2), ("fcae", "max_utility", 1),
                                                     ("convae", "valid_frontier", 2)])
def test_load_recon_model_picks_as_jax(tmp_path, model_type, select, epoch, monkeypatch):
    """``tests/test_valid_frontier.py``'s metas, one anonymizer checkpoint
    each (its weights shifted by the epoch), written by the JAX package's
    Checkpointer: the port loads the checkpoint the JAX package loads."""
    (module, variables), _ = recon_pair(model_type, 31)
    ckptr = JaxCheckpointer(str(tmp_path / "ckpts"))
    for meta in METAS:
        ckptr.recoverables["model"] = jax.tree_util.tree_map(lambda a, e=meta["epoch"]: a + e, variables["params"])
        ckptr.recoverables["model_state"] = {k: v for k, v in variables.items() if k != "params"}
        ckptr.save_checkpoint(meta, name=f"CKPT+e{meta['epoch']}")
    # the JAX loader's own init is overwritten by the checkpoint: trace it
    from speech_anonymization_tpu.recipes import anonymizer as jax_anonymizer

    monkeypatch.setitem(jax_anonymizer.MODEL_TYPES, model_type, shape_init(jax_anonymizer.MODEL_TYPES[model_type]))
    _, jv = jax_recipe.load_recon_model(str(tmp_path / "ckpts"), model_type, ckpt_select=select)
    model = recipe.load_recon_model(str(tmp_path / "ckpts"), model_type, ckpt_select=select, device="cpu")
    got = to_numpy(anonymizer_variables(model))
    want = to_numpy(jv)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, got["params"], want["params"]))
    shifted = jax.tree_util.tree_map(lambda a: a + np.float32(epoch), to_numpy(variables["params"]))
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, got["params"], shifted))
    assert not model.training and not any(p.requires_grad for p in model.parameters())


def test_reference_torch_checkpoint_is_refused(tmp_path):
    """A torch archive in the last ``CKPT+*`` goes to the reference loader for
    fcae (``utils/reference_ckpts.py``; a valid one is ported, see
    ``test_torch_reference_ckpts.py``), which refuses a broken one; other
    model types never read it."""
    (tmp_path / "CKPT+x").mkdir()
    (tmp_path / "CKPT+x" / "model.ckpt").write_bytes(b"PK\x03\x04rest")
    with pytest.raises(RuntimeError, match="zip archive"):
        recipe.load_recon_model(str(tmp_path), "fcae", device="cpu")
    with pytest.raises(FileNotFoundError):
        recipe.load_recon_model(str(tmp_path), "convae", device="cpu")


# -- pitch normalization -------------------------------------------------------------------------


def _voiced(seconds: float = 1.5, f0: float = 140.0, sr: int = 16000) -> np.ndarray:
    tt = np.arange(int(seconds * sr)) / sr
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3 * tt)
    wav = sum(np.sin(2 * np.pi * f0 * (1 + 0.05 * np.sin(2 * np.pi * 2 * tt)) * h * tt) / h for h in range(1, 8))
    rng = np.random.default_rng(0)
    return (0.2 * env * wav + 0.003 * rng.standard_normal(len(tt))).astype(np.float32)


@pytest.mark.parametrize("native", [True, False])
def test_pitch_matches_jax(native, monkeypatch):
    """``pitch_normalize`` (both methods) and ``track_f0``: the native vocoder
    through both bindings, and the numpy tracker and PSOLA (the library
    hidden from both modules), equal to the JAX package's; ``SERVED`` counts
    the path."""
    if native:
        assert pitch._native_lib(), "native/libsatpu_audio.so must load"
    else:
        monkeypatch.setattr(pitch, "_native_lib", lambda: False)
        monkeypatch.setattr(jax_pitch, "_native_lib", lambda: False)
    wav = _voiced()
    served = dict(pitch.SERVED)
    f0, hop = pitch.track_f0(wav)
    jf0, jhop = jax_pitch.track_f0(wav)
    assert hop == jhop and np.array_equal(f0, jf0)
    voiced = f0[f0 > 0]
    assert voiced.size > len(f0) // 2 and abs(np.median(voiced) - 140.0) < 15.0
    methods = ("world", "psola") if native else ("world",)
    for method in methods:
        out = pitch.pitch_normalize(wav, 16000, 500.0, method=method)
        assert np.array_equal(out, jax_pitch.pitch_normalize(wav, 16000, 500.0, method=method)), method
        assert out.dtype == np.float32 and np.isfinite(out).all() and abs(len(out) - len(wav)) < 200
    path = "native" if native else "numpy"
    assert pitch.SERVED[path] - served[path] == 1 + len(methods)
