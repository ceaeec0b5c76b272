"""The port's anonymizer training step against the JAX recipe (CPU).

``SexAnonymizationBrain.fit_batch`` and the port's ``AnonymizerTrainer.
fit_batch`` on the same converted weights (norm and BatchNorm parameters
perturbed), the same batches and JAX's SpecAugment draws, convae at T 72,
batch 4, accumulation 3, clip 5, Noam at lr 1e-3, with the utility term
through the small ASR of ``test_torch_decode.py``: after every micro-batch
the loss terms, the accumulated gradients, the BatchNorm running statistics
and the normalizer state; after the update the Adam moments and count and
the parameters. In each train mode, the utility term alone with the
reconstruction, a "generator" phase after an "all" one (trap a) and the
non-finite guard (trap b). One JAX brain (one compile) serves every test:
the phases' weights are arguments of its step.

Tolerances: ``speech_anonymization_tpu_torch/tools/train_parity.py`` states
each, and the card parity holds the card to the CPU at the same ones. Loss
terms: recon and utility rtol 1e-5 (LOSS_RTOL); sex, confusion and the total
2e-3 (SEX_RTOL: the head's pooled BatchNorm is f32-limited in both
packages). Accumulated gradients and Adam moments per tensor, relative to the
tensor's largest element, above a noise floor of 1e-4 of the largest
anywhere (NOISE): 3e-2 with the sex term in the loss (SEX_GRAD_RTOL,
SEX_MOMENT_RTOL), 1e-4 and 2e-4 without (GRAD_RTOL, MOMENT_RTOL). BatchNorm
running statistics 1e-4 (STATS_RTOL). Updated parameters (``step_gaps``):
where the first moment is resolved, within what the moments' measured gaps
carry into Adam's step plus 1e-6 (STEP_ATOL); elsewhere Adam's first step is
+-lr by a sign that rounding decides (eps 1e-9, trap e), so those elements,
counted and bounded in each test, are held only to |step| <= lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_anonymization_tpu.models.asr import ASRModel as JaxASRModel
from speech_anonymization_tpu.recipes.asr_bundle import ASRBundle as JaxASRBundle
from speech_anonymization_tpu_torch.models.asr import ASRModel
from speech_anonymization_tpu_torch.recipes.asr_bundle import ASRBundle
from speech_anonymization_tpu_torch.tools.train_parity import GRAD_RTOL, MOMENT_RTOL, speechlike
from speech_anonymization_tpu_torch.utils.convert import asr_state_dict, load_numpy_state
from tests.torch_port_helpers import perturbed
from tests.torch_train_helpers import (
    LR,
    Pair,
    adam_state,
    assert_losses,
    check_micro_batch,
    check_update,
    jax_params,
)

B, T = 4, 72
N_SAMPLES = (T - 1) * 160
W_GEN = {"recon": 1.0, "sex": 0.8, "utility": 0.2, "confusion": 0.3}
W_CLF = {"recon": 0.0, "sex": 0.5, "utility": 0.0, "confusion": 0.0}
W_ALL = {"recon": 1.0, "sex": 0.4, "utility": 0.0, "confusion": 0.2}
W_UTIL = {"recon": 1.0, "utility": 1.0}  # no sex term: the tight tolerances
# epoch % 4 picks the phase
SCHEDULE = [{"weights": W_GEN, "train": "generator"}, {"weights": W_CLF, "train": "sex_classifier"},
            {"weights": W_ALL, "train": "all"}, {"weights": W_UTIL, "train": "generator"}]
MODES = {"generator": 0, "sex_classifier": 1, "all": 2}
UTILITY_EPOCH, GENERATOR_AGAIN = 3, 4
LENS = np.array([1.0, 0.9, 0.8, 1.0], np.float32)
LABELS = np.array([0, 1, 1, 0], np.int32)
SMALL_ASR = dict(d_model=32, nhead=4, num_encoder_layers=1, num_decoder_layers=2, d_ffn=64,
                 output_neurons=24)
TOKENS = np.random.default_rng(5).integers(3, 24, (B, 6)).astype(np.int32)
TOKENS[:, 0] = 1


def _batch(seed, lens=LENS):
    return (speechlike(B, N_SAMPLES, seed), lens, LABELS, TOKENS)


BATCHES = [_batch(s) for s in (10, 11, 12)]


class _Tok:
    def decode_ids(self, ids):
        return " ".join(str(i) for i in ids)


@pytest.fixture(scope="module")
def asr():
    """The small ASR in both packages, on the same perturbed weights."""
    jm = JaxASRModel(**SMALL_ASR)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 80)), jnp.zeros((1, 3), jnp.int32),
                         jnp.ones((1,)))
    v = perturbed(v, 0)
    return jm, v, load_numpy_state(ASRModel(**SMALL_ASR, device="cpu"), asr_state_dict(v))


@pytest.fixture(scope="module")
def pair(asr):
    jm, v, pm = asr
    return Pair("convae", SCHEDULE, 3, BATCHES[0], augment=True,
                jax_kw={"asr_bundle": JaxASRBundle(jm, v, _Tok(), {})},
                port_kw={"asr_bundle": ASRBundle(pm, _Tok(), {})})


@pytest.mark.parametrize("mode", list(MODES))
def test_accumulation_cycle_matches_jax(pair, mode):
    pair.reset()
    tr = pair.trainer
    start = {k: p.detach().clone().numpy() for k, p in tr.model.named_parameters()}
    epoch = MODES[mode]
    for i, batch in enumerate(BATCHES):
        want, got = pair.fit(batch, epoch)
        check_micro_batch(pair, want, got, check_accum=i < 2)
    opt_key = "clf" if mode == "sex_classifier" else "gen"
    sign_only, total = check_update(pair, opt_key, start, LR)
    assert sign_only <= 0.01 * total, (sign_only, total)
    # the masks: the frozen group did not move, the trained one did
    for k, p in tr.model.named_parameters():
        is_clf = "sex_classifier" in k
        frozen = (mode == "generator" and is_clf) or (mode == "sex_classifier" and not is_clf)
        moved = not np.array_equal(p.detach().numpy(), start[k])
        assert moved != frozen, (mode, k)


def test_generator_after_all_moves_the_head(pair):
    """Trap (a): after an "all" phase the generator optimizer's moments on the
    sex head are non-zero, so a "generator" phase still moves the head."""
    pair.reset()
    tr = pair.trainer
    for batch in BATCHES:
        pair.fit(batch, MODES["all"])
    # start the second phase from JAX's parameters, so that the "all"
    # update's sign-only elements (trap e) do not carry into its losses; the
    # optimizer states stay each package's own
    after_all = jax_params(pair)
    with torch.no_grad():
        for k, p in tr.model.named_parameters():
            p.copy_(torch.from_numpy(np.ascontiguousarray(after_all[k])))
    head_before = {k: p.detach().clone().numpy() for k, p in tr.model.named_parameters()
                   if "sex_classifier" in k}
    start = {k: p.detach().clone().numpy() for k, p in tr.model.named_parameters()}
    for batch in BATCHES:
        want, got = pair.fit(batch, GENERATOR_AGAIN)
        assert_losses(want, got)
    check_update(pair, "gen", start, LR / np.sqrt(2))
    want = jax_params(pair)
    for k, before in head_before.items():
        now = dict(tr.model.named_parameters())[k].detach().numpy()
        assert not np.array_equal(now, before), k
        assert not np.array_equal(want[k], before), k


def test_non_finite_guard_keeps_params_and_advances_the_optimizer(pair):
    """Trap (b): a NaN waveform makes the stepping micro-batch's loss NaN: the
    parameters stay, the optimizer state advances (NaN moments) in both."""
    pair.reset()
    tr = pair.trainer
    bad = (BATCHES[2][0].copy(), *BATCHES[2][1:])
    bad[0][1, 100:200] = np.nan
    for batch in BATCHES[:2]:
        pair.fit(batch, MODES["generator"])
    before = {k: p.detach().clone().numpy() for k, p in tr.model.named_parameters()}
    jax_before = jax_params(pair)
    want, got = pair.fit(bad, MODES["generator"])
    assert np.isnan(want["loss"]) and np.isnan(got["loss"])
    jax_after = jax_params(pair)
    for k, p in tr.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), before[k])
        np.testing.assert_array_equal(jax_after[k], jax_before[k])
    count, mu, _ = adam_state(pair, "gen")
    assert count == tr.state.opt_state["gen"].count == 1
    for k, m in mu.items():
        np.testing.assert_array_equal(np.isnan(tr.state.opt_state["gen"].mu[k].numpy()), np.isnan(m))
    assert any(np.isnan(m).any() for m in mu.values())


def test_utility_term_matches_jax(pair, asr):
    """The generator phase with the frozen ASR's utility term (recon 1,
    utility 1, no sex term: the tight tolerances), one accumulation cycle."""
    pair.reset()
    tr = pair.trainer
    start = {k: p.detach().clone().numpy() for k, p in tr.model.named_parameters()}
    for i, batch in enumerate(BATCHES):
        want, got = pair.fit(batch, UTILITY_EPOCH)
        assert got["utility_loss"] > 0
        check_micro_batch(pair, want, got, check_accum=i < 2, grad_rtol=GRAD_RTOL)
    assert not any(p.requires_grad for p in asr[2].parameters())  # the ASR stays frozen
    check_update(pair, "gen", start, LR, moment_rtol=MOMENT_RTOL)
