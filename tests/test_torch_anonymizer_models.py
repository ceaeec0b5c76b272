"""Every anonymizer family and sex head of the port against the JAX package
(CPU): the train-mode forward (BatchNorm on batch statistics), the gradients
of every parameter and of the input, and the BatchNorm running statistics
after the forward; the ConvAutoencoder's inference path without autograd
(K8's plain twin on each block, ``anonymize``, which path runs when, at any
length); the GRL's reversed gradient at the bottleneck; flax's BatchNorm;
and one update of each family through the recipe (fcae with pad multiple 1,
cyclegan, endtoend with and without the external evaluator).

Inputs: per-utterance scaled and shifted features, so the heads' batch
statistics of pooled features are well conditioned. Tolerances: outputs
atol 1e-5 (heads' log-probs 1e-3 on top, their f32 limit: see
``test_head_log_probs_are_f32_limited``), gradients per tensor within 1e-3
of the tensor's largest element (3e-2 where the loss reads a sex head),
BatchNorm statistics within 1e-4 of it.
"""

import copy
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_anonymization_tpu.eval.evaluator import FeatureClassifier as JaxFeatureClassifier
from speech_anonymization_tpu.models import ConvAutoencoder as JaxConvAE
from speech_anonymization_tpu.models import ConvReconstruction as JaxConvReconstruction
from speech_anonymization_tpu.models import CycleGANGenerator as JaxCycleGAN
from speech_anonymization_tpu.models import DummyFullyConnectedAutoencoder as JaxDummyFCAE
from speech_anonymization_tpu.models import DummyFullyConnSexClassifier as JaxDummyHead
from speech_anonymization_tpu.models import FullyConnectedAutoencoder as JaxFCAE
from speech_anonymization_tpu.models import FullyConnSexClassifier as JaxFCHead
from speech_anonymization_tpu.models import SexClassifier1D as JaxSexClassifier1D
from speech_anonymization_tpu.models import TDNNSexClassifier as JaxTDNN
from speech_anonymization_tpu.models import ResidualLayer as JaxResidualLayer
from speech_anonymization_tpu.models import Xvector as JaxXvector
from speech_anonymization_tpu.models import XvectorClassifier as JaxXvectorClassifier
from speech_anonymization_tpu.models.components import PixelShuffle1D as JaxPixelShuffle1D
from speech_anonymization_tpu.models.components import pixel_shuffle_2d
from speech_anonymization_tpu.ops.normalization import InputNormalizer as JaxNormalizer
from speech_anonymization_tpu_torch.eval.evaluator import FeatureClassifier
from speech_anonymization_tpu_torch.models import (
    ConvAutoencoder,
    ConvReconstruction,
    CycleGANGenerator,
    DummyFullyConnectedAutoencoder,
    DummyFullyConnSexClassifier,
    FullyConnectedAutoencoder,
    FullyConnSexClassifier,
    ResidualLayer,
    SexClassifier1D,
    TDNNSexClassifier,
)
from speech_anonymization_tpu_torch.models.components import BatchNorm, PixelShuffle1D, glu
from speech_anonymization_tpu_torch.ops import norm_silu as k8
from speech_anonymization_tpu_torch.ops.normalization import InputNormalizer
from speech_anonymization_tpu_torch.recipes.anonymizer import AnonymizerTrainer
from speech_anonymization_tpu_torch.tools.train_parity import SEX_GRAD_RTOL, STATS_RTOL, speechlike
from speech_anonymization_tpu_torch.utils.convert import (
    anonymizer_state_dict,
    indexed_state_dict,
    load_numpy_state,
)
from tests.torch_port_helpers import perturbed, t, to_numpy
from tests.torch_train_helpers import (
    LR,
    Pair,
    assert_tensors,
    bn_stats,
    check_micro_batch,
    check_update,
)

OUT_ATOL = 1e-5
HEAD_ATOL = 1e-3
GRAD_RTOL = 1e-3


def _inputs(shape, seed):
    """Standard normal, each utterance scaled and shifted by its own amount."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    scale = rng.uniform(0.5, 2.0, (shape[0],) + (1,) * (len(shape) - 1))
    shift = rng.uniform(-1.0, 1.0, (shape[0],) + (1,) * (len(shape) - 1))
    return (x * scale + shift).astype(np.float32)


def _weights(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _run_jax(jm, v, x, probes, rngs=None, train_kw=True):
    """Train-mode forward; -> (outputs, grads of sum(out * probe) by params and
    input, new batch_stats)."""
    kw = {"train": True} if train_kw else {}

    def loss(params, x):
        out, mut = jm.apply({**v, "params": params}, x, mutable=["batch_stats"], rngs=rngs, **kw)
        outs = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o * p) for o, p in zip(outs, probes)), (outs, mut)

    (_, (outs, mut)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        v["params"], jnp.asarray(x))
    return [np.asarray(o) for o in outs], to_numpy(gp), np.asarray(gx), to_numpy(mut)


def _run_port(pm, x, probes, to_port=lambda a: a, from_port=lambda a: a, **kw):
    pm.train()
    xt = t(to_port(x)).requires_grad_(True)
    out = pm(xt, **kw)
    outs = out if isinstance(out, tuple) else (out,)
    loss = sum((o * t(p)).sum() for o, p in zip(outs, probes))
    names = [k for k, _ in pm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in pm.named_parameters()] + [xt], allow_unused=True)
    gp = {k: (torch.zeros_like(p) if g is None else g) for (k, p), g in zip(pm.named_parameters(), grads)}
    assert len(gp) == len(names)
    return [o.detach().numpy() for o in outs], gp, from_port(grads[-1].numpy())


def _compare(jm, pm, x, out_shapes, to_dict, seed, to_port=lambda a: a, from_port=lambda a: a,
             rngs=None, head_outputs=(), train_kw=True, variables=None, **kw):
    """``variables``: a family's (perturbed) weights from its update test's
    Pair, which saves a second init; else ``jm``'s init at ``seed``, perturbed."""
    if variables is None:
        init_kw = {"train": False} if train_kw else {}
        variables = perturbed(jax.jit(lambda x: jm.init(jax.random.PRNGKey(seed), x, **init_kw))(
            jnp.asarray(x)), seed)
    v = variables
    load_numpy_state(pm, to_dict(v))
    probes = _weights(out_shapes, seed + 1)
    j_out, j_gp, j_gx, j_mut = _run_jax(jm, v, x, probes, rngs, train_kw)
    p_out, p_gp, p_gx = _run_port(pm, x, probes, to_port, from_port, **kw)
    for i, (g, w) in enumerate(zip(p_out, j_out)):
        atol = OUT_ATOL + (HEAD_ATOL if i in head_outputs else 0.0)
        np.testing.assert_allclose(g, w, atol=atol, rtol=1e-5, err_msg=f"output {i}")
    want = to_dict({"params": j_gp})
    # a loss through a sex head's log-probs carries its f32 limit
    rtol = SEX_GRAD_RTOL if head_outputs else GRAD_RTOL
    assert_tensors(p_gp, want, rtol, "grads")
    np.testing.assert_array_less(np.abs(p_gx - j_gx), rtol * np.abs(j_gx).max() + 1e-30)
    stats = bn_stats(pm)
    if stats:
        want_stats = to_dict({"params": v["params"], **j_mut})
        assert_tensors(stats, {k: want_stats[k] for k in stats}, STATS_RTOL, "BatchNorm stats")
        start = to_dict(v)
        assert all(not np.array_equal(stats[k].numpy(), start[k]) for k in stats)  # they moved
    return v, p_gx, j_gx


NCW = (lambda a: a.transpose(0, 2, 1), lambda a: a.transpose(0, 2, 1))


def test_tdnn_head_train_mode_matches_jax():
    # no (utterance, channel) row of the pooled features is constant here (see
    # test_constant_pooled_row_gives_nan_gradients_in_both)
    x = _inputs((4, 80, 128), 2)
    _compare(JaxTDNN(), TDNNSexClassifier(device="cpu"), x, [(4, 2)], indexed_state_dict, 1,
             *NCW, head_outputs=(0,))


def test_sex_classifier_1d_train_mode_matches_jax():
    x = _inputs((4, 9, 128), 2)
    _compare(JaxSexClassifier1D(), SexClassifier1D(device="cpu"), x, [(4, 2)], indexed_state_dict, 3,
             head_outputs=(0,))


def test_fully_conn_head_train_mode_matches_jax():
    x = _inputs((4, 30, 20), 4)
    _compare(JaxFCHead(), FullyConnSexClassifier(device="cpu"), x, [(4, 2)], indexed_state_dict, 5,
             head_outputs=(0,))


def test_dummy_head_matches_jax():
    x = _inputs((4, 1024), 6)
    _compare(JaxDummyHead(), DummyFullyConnSexClassifier(device="cpu"), x, [(4, 2)],
             indexed_state_dict, 7)


def test_fcae_train_mode_matches_jax(fcae):
    x = _inputs((4, 50, 80), 8)
    assert fcae.brain.model == JaxFCAE()
    _compare(fcae.brain.model, FullyConnectedAutoencoder(device="cpu"), x, [(4, 50, 80), (4, 2)],
             anonymizer_state_dict, 9, head_outputs=(1,), variables=fcae.variables)


def test_dummy_fcae_with_jax_draws_matches_jax():
    """The "log-probs" are JAX's uniform draws, fed to the port as they are."""
    x = _inputs((4, 50, 80), 10)
    key = jax.random.PRNGKey(11)
    jm = JaxDummyFCAE()
    v = perturbed(jax.jit(jm.init)({"params": key, "dummy": key}, jnp.asarray(x)), 11)
    _, lp = jm.apply(v, jnp.asarray(x), rngs={"dummy": key})
    pm = DummyFullyConnectedAutoencoder(device="cpu")
    _compare(jm, pm, x, [(4, 50, 80)], anonymizer_state_dict, 11, rngs={"dummy": key},
             sex_draws=t(np.asarray(lp)))
    got = pm(t(x), sex_draws=t(np.asarray(lp)))[1]
    np.testing.assert_array_equal(got.numpy(), np.asarray(lp))
    a = DummyFullyConnectedAutoencoder(generator=torch.Generator().manual_seed(0), device="cpu")(t(x))[1]
    b = DummyFullyConnectedAutoencoder(generator=torch.Generator().manual_seed(0), device="cpu")(t(x))[1]
    assert torch.equal(a, b) and bool(((a >= 0) & (a < 1)).all())


def test_cyclegan_train_mode_matches_jax(cyclegan):
    x = _inputs((2, 36, 80), 12)
    assert cyclegan.brain.model == JaxCycleGAN()
    _compare(cyclegan.brain.model, CycleGANGenerator(device="cpu"), x, [(2, 36, 80), (2, 2)],
             anonymizer_state_dict, 13, head_outputs=(1,), variables=cyclegan.variables)


class _ChannelsLast(torch.nn.Module):
    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, x):
        return self.inner(x.transpose(1, 2)).transpose(1, 2)


def test_residual_layer_matches_jax():
    """Not in the CycleGAN's live forward at reference HEAD; kept for parity."""
    x = _inputs((2, 12, 6), 25)
    _compare(JaxResidualLayer(6, 10), _ChannelsLast(ResidualLayer(6, 10)), x, [(2, 12, 6)],
             lambda v: {f"inner.{k}": a for k, a in indexed_state_dict(v).items()}, 26,
             train_kw=False)


def test_endtoend_model_matches_jax(endtoend_alone):
    x = _inputs((2, 36, 80), 14)
    assert endtoend_alone.brain.model == JaxConvReconstruction()
    _compare(endtoend_alone.brain.model, ConvReconstruction(device="cpu"), x, [(2, 36, 80)],
             anonymizer_state_dict, 15, variables=endtoend_alone.variables)


def test_convae_train_mode_matches_jax():
    x = _inputs((4, 36, 80), 16)
    _compare(JaxConvAE(), ConvAutoencoder(device="cpu"), x, [(4, 36, 80), (4, 2)],
             anonymizer_state_dict, 17, head_outputs=(1,))


@pytest.fixture(scope="module")
def convae_perturbed():
    """A ConvAutoencoder with flax's init perturbed (every bias, norm scale and
    shift nonzero) -> (flax variables, the port model with the same weights)."""
    jm = JaxConvAE()
    v = perturbed(jax.jit(lambda x: jm.init(jax.random.PRNGKey(19), x, train=False))(
        jnp.zeros((1, 36, 80))), 19)
    return v, load_numpy_state(ConvAutoencoder(device="cpu"), anonymizer_state_dict(v))


# the seven blocks K8 takes: (conv, norm or None); the lengths the conv gives
# from inputs of 9, 10 and 16 samples: odd, not a multiple of 4, a multiple
_K8_BLOCKS = [("enc_conv0", None), ("enc_conv1", "enc_in1"), ("enc_conv2", "enc_in2"), ("enc_conv3", "enc_in3"),
              ("enc_conv4", "enc_in4"), ("dec_up1", "dec_in1"), ("dec_up2", "dec_in2")]


@pytest.mark.parametrize("conv,norm", _K8_BLOCKS)
@pytest.mark.parametrize("length", [9, 10, 16])
def test_norm_silu_plain_matches_the_block(convae_perturbed, conv, norm, length):
    """``norm_silu_plain`` on the bias-free convolution is ``glu(norm(conv(x)))``
    (``glu(conv(x))`` for enc_conv0), and ``norm_silu`` takes it on the CPU."""
    from speech_anonymization_tpu_torch.models.autoencoders import _without_bias

    model = convae_perturbed[1]
    c, n = getattr(model, conv), None if norm is None else getattr(model, norm)
    x = t(_inputs((3, c.in_channels, length), 20 + length))
    with torch.no_grad():
        want = glu(c(x) if n is None else n(c(x)))
        y = _without_bias(c, x)
        args = (y, c.bias) if n is None else (y, c.bias, n.weight, n.bias, n.eps)
        got = k8.norm_silu_plain(*args)
        launches = k8.norm_silu.launches
        torch.testing.assert_close(k8.norm_silu(*args), got, rtol=0, atol=0)
    assert k8.norm_silu.launches == launches  # CPU tensors launch nothing
    assert c.bias.abs().min() > 0 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=OUT_ATOL)


def test_convae_anonymize_without_grad_matches_jax(convae_perturbed):
    """The inference path (bias-free convolutions, the blocks' epilogue in
    ``norm_silu``) against the JAX package's ``anonymize``."""
    v, model = convae_perturbed
    x = _inputs((3, 36, 80), 21)
    want = np.asarray(JaxConvAE().apply(v, jnp.asarray(x), method=JaxConvAE.anonymize))
    with torch.no_grad():
        got = model.eval().anonymize(t(x))
    np.testing.assert_allclose(got.numpy(), want, atol=OUT_ATOL, rtol=1e-5)


def _count_norm_silu(monkeypatch):
    calls = []
    real = k8.norm_silu
    monkeypatch.setattr(k8, "norm_silu", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    return calls


@pytest.mark.parametrize("grad", [False, True])
def test_k8_path_only_without_autograd(convae_perturbed, monkeypatch, grad):
    """Without autograd each ``anonymize`` calls ``norm_silu`` once a block
    (7); with autograd never, and every norm's weight gets its gradient."""
    model = copy.deepcopy(convae_perturbed[1]).train()
    real = k8.norm_silu
    launches = real.launches
    calls = _count_norm_silu(monkeypatch)
    x = t(_inputs((2, 36, 80), 22))
    with torch.set_grad_enabled(grad):
        recon, sex_lp = model(x)
    assert real.launches == launches
    if not grad:
        assert len(calls) == 7 and not recon.requires_grad
        return
    assert calls == []
    (recon.square().sum() + sex_lp.sum()).backward()
    for name in ("enc_in1", "enc_in2", "enc_in3", "enc_in4", "dec_in1", "dec_in2"):
        g = getattr(model, name).weight.grad
        assert g is not None and g.abs().max() > 0, name
    assert all(getattr(model, c).bias.grad is not None for c, _ in _K8_BLOCKS)


def test_k8_path_at_any_length(convae_perturbed, monkeypatch):
    """Without autograd every block calls ``norm_silu`` whatever the length:
    dec_in2's rows of T * 80 floats past ``MAX_LENGTH`` too (on the card,
    K8's streaming launches; the model makes no choice by length)."""
    frames = k8.MAX_LENGTH // 80 + 1
    calls = _count_norm_silu(monkeypatch)
    with torch.no_grad():
        recon = convae_perturbed[1].eval().anonymize(t(_inputs((1, frames, 80), 23)))
    assert len(calls) == 7 and recon.shape == (1, frames, 80) and bool(torch.isfinite(recon).all())


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_grl_reverses_the_gradient_at_the_bottleneck(scale):
    """d(head)/d(bottleneck) with the GRL at ``scale`` is -scale times the
    gradient without reversal (scale -1: the identity's sign)."""
    torch.manual_seed(0)
    model = ConvAutoencoder(grl_scale=scale, device="cpu").train()
    x = t(_inputs((4, 36, 80), 18))
    grads = []
    for s in (scale, -1.0):
        model.sex_classifier.grl_scale = s
        bottleneck = model._encode(x).detach().requires_grad_(True)
        lp = model.sex_classifier(bottleneck)
        grads.append(torch.autograd.grad(lp[:, 0].sum(), bottleneck)[0])
    torch.testing.assert_close(grads[0], -scale * grads[1], rtol=0, atol=0)
    assert grads[0].abs().max() > 0


@pytest.mark.parametrize("shape", [(6, 5), (6, 5, 7)])
def test_batchnorm_matches_flax(shape):
    """Train: flax's statistics and its running update (biased variance,
    momentum 0.9); eval: torch's BatchNorm1d, bit for bit."""
    import flax.linen as nn

    x = _inputs(shape, 19)
    channels_last = np.moveaxis(x, 1, -1)
    fm = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = perturbed(fm.init(jax.random.PRNGKey(0), jnp.asarray(channels_last)), 20)
    want, mut = fm.apply(v, jnp.asarray(channels_last), mutable=["batch_stats"])
    bn = BatchNorm(shape[1])
    sd = {"weight": v["params"]["scale"], "bias": v["params"]["bias"],
          "running_mean": v["batch_stats"]["mean"], "running_var": v["batch_stats"]["var"],
          "num_batches_tracked": np.zeros((), np.int64)}
    load_numpy_state(bn, sd)
    ref = torch.nn.BatchNorm1d(shape[1])
    load_numpy_state(ref, sd)
    assert torch.equal(bn.eval()(t(x)), ref.eval()(t(x)))
    got = bn.train()(t(x))
    np.testing.assert_allclose(np.moveaxis(got.detach().numpy(), 1, -1), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]), rtol=1e-5)
    # torch's own update takes the unbiased variance: it would not match
    ref.train()(t(x))
    assert not np.allclose(ref.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]), rtol=1e-5)


def test_pixel_shuffles_match_jax():
    x = _inputs((2, 5, 8), 21)
    want = np.asarray(JaxPixelShuffle1D(2).apply({}, jnp.asarray(x)))
    got = PixelShuffle1D(2)(t(x.transpose(0, 2, 1))).numpy().transpose(0, 2, 1)
    np.testing.assert_array_equal(got, want)
    x2 = _inputs((2, 3, 4, 8), 22)
    want2 = np.asarray(pixel_shuffle_2d(jnp.asarray(x2), 2))
    got2 = torch.nn.PixelShuffle(2)(t(x2.transpose(0, 3, 1, 2))).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(got2, want2)


def test_head_log_probs_are_f32_limited():
    """The sex head's pooled BatchNorm is ill-conditioned on features that
    InstanceNorm has made alike across utterances: both packages' f32
    log-probs lie far from a float64 run of the same weights, farther than
    from each other. This is why the recipe tests hold the sex loss at 2e-3."""
    x = np.random.default_rng(23).standard_normal((4, 36, 80)).astype(np.float32)
    jm = JaxConvAE()
    v = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(x)), 3)
    (_, lp), _ = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    sd = anonymizer_state_dict(v)
    pm = load_numpy_state(ConvAutoencoder(device="cpu"), sd).train()
    pm64 = load_numpy_state(ConvAutoencoder(device="cpu").double(),
                            {k: a.astype(np.float64) if a.dtype == np.float32 else a
                             for k, a in sd.items()}).train()
    with torch.no_grad():
        lp32 = pm(t(x))[1].numpy()
        lp64 = pm64(t(x).double())[1].numpy()
    jax_err, port_err = np.abs(np.asarray(lp) - lp64).max(), np.abs(lp32 - lp64).max()
    assert 1e-5 < max(jax_err, port_err) < 2e-3, (jax_err, port_err)
    assert np.abs(lp32 - np.asarray(lp)).max() < 2 * max(jax_err, port_err)


def test_constant_pooled_row_gives_nan_gradients_in_both():
    """A row of the TDNN head's pooled features that is constant over time has
    variance 0, where the pooled std's derivative is infinite: both packages'
    gradients are NaN (the recipe's guard then skips the update). Whether a
    near-constant row rounds to variance exactly 0 depends on the summation
    order, so on such rows the two packages can disagree (ROADMAP Queue 3)."""
    from speech_anonymization_tpu.ops.pooling import statistics_pooling as jax_pooling
    from speech_anonymization_tpu_torch.ops.pooling import statistics_pooling

    x = _inputs((2, 9, 3), 24)
    x[1, :, 2] = 0.25
    want = np.asarray(jax.grad(lambda a: jax_pooling(a).sum())(jnp.asarray(x)))
    xt = t(x).requires_grad_(True)
    statistics_pooling(xt).sum().backward()
    got = xt.grad.numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want[1, :, 2]).all() and not np.isnan(want[0]).any()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)


# -- one update of each family through the recipe ---------------------------------------

ALL = [{"weights": {"recon": 1.0, "sex": 0.5, "utility": 0.0, "confusion": 0.2}, "train": "all"}]


def _family_batch(b, t_frames, seed):
    return (speechlike(b, (t_frames - 1) * 160, seed), np.ones(b, np.float32),
            np.array([0, 1, 1, 0][:b], np.int32))


def _one_update(pair, batch):
    tr = pair.trainer
    start = {k: p.detach().clone().numpy() for k, p in tr.model.named_parameters()}
    want, got = pair.fit(batch, 0)
    assert got["stepped"]
    check_micro_batch(pair, want, got, check_accum=False)
    sign_only, total = check_update(pair, "gen", start, LR)
    assert sign_only <= 0.05 * total, (sign_only, total)
    return tr


FCAE_BATCH = _family_batch(4, 50, 30)
CYCLEGAN_BATCH = _family_batch(2, 36, 31)
ENDTOEND_BATCH = _family_batch(4, 36, 33)


# one Pair (one JAX brain) per family, shared by its forward and update tests
@pytest.fixture(scope="module")
def fcae():
    return Pair("fcae", ALL, 1, FCAE_BATCH)


@pytest.fixture(scope="module")
def cyclegan():
    return Pair("cyclegan", ALL, 1, CYCLEGAN_BATCH)


@pytest.fixture(scope="module")
def endtoend_alone():
    """endtoend without the external evaluator: allowed, with a warning."""
    with pytest.warns(UserWarning, match="chance-level CONSTANT"):
        return Pair("endtoend", ALL, 1, ENDTOEND_BATCH, allow_endtoend_without_evaluator=True)


def test_fcae_update_matches_jax(fcae):
    """fcae keeps T as it is (pad multiple 1): 50 frames stay 50."""
    tr = _one_update(fcae, FCAE_BATCH)
    assert tr.pad_multiple == fcae.brain.pad_multiple == 1


def test_cyclegan_update_matches_jax(cyclegan):
    _one_update(cyclegan, CYCLEGAN_BATCH)


def _evaluators():
    emb, clf = JaxXvector(), JaxXvectorClassifier()
    ev = perturbed(emb.init(jax.random.PRNGKey(5), jnp.zeros((1, 8, 80)), train=False), 5)
    cv = perturbed(clf.init(jax.random.PRNGKey(6), jnp.zeros((1, 128)), train=False), 6)
    jax_fc = JaxFeatureClassifier(
        emb, clf, {"embedding_model": ev["params"], "classifier": cv["params"]},
        {"embedding_model": {"batch_stats": ev["batch_stats"]},
         "classifier": {"batch_stats": cv["batch_stats"]}},
        JaxNormalizer(dim=80).init_state())
    return jax_fc, FeatureClassifier.from_flax(ev, cv, InputNormalizer(80).init_state("cpu"), device="cpu")


def test_endtoend_update_with_the_evaluator_matches_jax():
    """The external x-vector's log-probs on the reconstruction, differentiable;
    the sex and confusion terms subtracted; the evaluator stays frozen."""
    batch = _family_batch(4, 36, 32)
    jax_fc, port_fc = _evaluators()
    pair = Pair("endtoend", ALL, 1, batch, jax_kw={"external_classifier": jax_fc},
                port_kw={"external_classifier": port_fc})
    _one_update(pair, batch)
    assert not any(p.requires_grad for p in port_fc.embedding_model.parameters())


def test_endtoend_update_without_the_evaluator_matches_jax(endtoend_alone):
    """Allowed with a warning: the sex loss is the chance-level constant."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _one_update(endtoend_alone, ENDTOEND_BATCH)
    np.testing.assert_allclose(float(endtoend_alone.trainer.metrics["sex_loss"]), np.log(2.0),
                               rtol=1e-6)


def test_endtoend_without_the_evaluator_is_refused():
    with pytest.raises(ValueError, match="external classifier"):
        AnonymizerTrainer({"model_type": "endtoend"}, device="cpu")
