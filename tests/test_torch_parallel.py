"""The port's ``parallel/mesh.py`` on ``torch.distributed`` (CPU, gloo ranks on
a file store, no network; the ranks' code is ``tests/torch_parallel_helpers.py``).

  * The process layer without a group, as ``tests/test_parallel.py`` checks
    the JAX package's: ``initialize_distributed`` is False without the
    environment, ``run_on_main`` returns its result, ``global_barrier``
    completes, a mesh without a group has one rank and its collectives are
    the identity; ``use_mesh(None, ...)`` takes a mesh off; loading the ops
    that reduce over a mesh loads neither the models nor the tensor-parallel
    rules.
  * Four ranks, each given its rows of one seeded global batch of 8
    speech-like utterances (T 72; three rows shorter, their tails silent, so
    that the fbank's ``top_db`` floor binds there and differs from rank to
    rank). One convae update cycle (accumulation 3, the utility through a
    small ASR, JAX's SpecAugment draws of the global batch) of each
    adversarial phase, from the same start, equals the one-process cycle on
    the whole batch and the JAX package's brain step over ``make_mesh(4)`` of
    the conftest's virtual CPU devices, at ``tools/train_parity.py``'s
    tolerances (``compare_records``); the four ranks end bit-equal. The
    fbank, the normalizer's update, the head's BatchNorm statistics and the
    loss terms equal the global batch's, where a rank alone on its shard gets
    other values. Under the same spawn the valid stage's statistics, a
    ``GenderBrain`` step (the x-vector's BatchNorms, ``GenderDraws`` of the
    global batch) and an ``ASRBrain`` cycle (CTC + KLdiv, accumulation 2)
    equal one process.
  * Two ranks from the recipes' environment (``SATPU_COORDINATOR`` as a
    ``file://`` store): ``run_on_main`` runs on rank 0 while rank 1 waits;
    the anonymizer recipe's ``main()`` at ``test_torch_recipe_main.py``'s CPU
    size prepares the CSVs once and writes its checkpoints and valid log
    lines from rank 0 alone.
"""

import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_anonymization_tpu.models.asr import ASRModel as JaxASRModel
from speech_anonymization_tpu.parallel import make_mesh as jax_make_mesh
from speech_anonymization_tpu.recipes.asr_bundle import ASRBundle as JaxASRBundle
from speech_anonymization_tpu_torch.parallel import (
    all_gather_concat,
    all_gather_rows,
    data_sharding,
    global_barrier,
    initialize_distributed,
    is_main_process,
    make_mesh,
    pmax,
    psum,
    psum_terms,
    replicated_sharding,
    run_on_main,
    shard_batch,
    use_mesh,
)
from speech_anonymization_tpu_torch.tools.train_parity import (
    LOSS_RTOL,
    NORM_RTOL,
    STATS_RTOL,
    compare_gender_records,
    compare_records,
    cycle_record,
    gender_record,
    speechlike,
    tensor_gaps,
)
from speech_anonymization_tpu_torch.tools.train_parity import GRAD_RTOL, MOMENT_RTOL, noise_floor, step_gaps
from speech_anonymization_tpu_torch.utils.convert import anonymizer_state_dict, asr_state_dict
from tests import torch_parallel_helpers as helpers
from tests.fixtures import make_fake_librispeech
from tests.test_torch_recipe_main import _argv
from tests.torch_port_helpers import random_variables, to_numpy
from tests.torch_train_helpers import Pair, adam_state, jax_draws, jax_params, jax_tree

RANKS = 4
B, T = 8, 72
N_SAMPLES = (T - 1) * 160
LENS = np.array([1.0, 0.9, 1.0, 1.0, 0.8, 1.0, 1.0, 0.85], np.float32)
LABELS = np.array([0, 1, 1, 0, 1, 0, 0, 1], np.int32)
TOKENS = np.random.default_rng(5).integers(3, 24, (B, 6)).astype(np.int32)
TOKENS[:, 0] = 1
W_GEN = {"recon": 1.0, "sex": 0.8, "utility": 0.2, "confusion": 0.3}
W_CLF = {"recon": 0.0, "sex": 0.5, "utility": 0.0, "confusion": 0.0}
SCHEDULE = [{"weights": W_GEN, "train": "generator"}, {"weights": W_CLF, "train": "sex_classifier"}]
JAX_LR_RTOL = 1e-6  # JAX's Noam lr is a float32 (as torch_train_helpers.Pair.fit holds it)
SMALL_ASR = dict(d_model=32, nhead=4, num_encoder_layers=1, num_decoder_layers=2, d_ffn=64, output_neurons=24)


def _batch(seed):
    wavs = speechlike(B, N_SAMPLES, seed)
    for i, frac in enumerate(LENS):
        wavs[i, int(frac * N_SAMPLES):] = 0.0  # silent tails: the floor binds there
    return (wavs, LENS, LABELS, TOKENS)


BATCHES = [_batch(s) for s in (10, 11, 12)]


class _Tok:
    def decode_ids(self, ids):
        return " ".join(str(i) for i in ids)


def _asr_batch(seed: int):
    """An ASR ``PaddedBatch`` duck type of B rows: tokens with bos/eos, words."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, helpers.ASR_WIDTHS["output_neurons"], (B, 4))
    n_ids = np.array([4, 3, 2, 4, 1, 3, 4, 2])
    tokens = np.where(np.arange(4)[None] < n_ids[:, None], ids, 0).astype(np.int64)
    bos, eos = np.zeros((B, 5), np.int64), np.zeros((B, 5), np.int64)
    for i, n in enumerate(n_ids):
        bos[i, :n + 1] = [1, *ids[i, :n]]
        eos[i, :n + 1] = [*ids[i, :n], 2]
    rel = ((n_ids + 1) / 5.0).astype(np.float32)
    return types.SimpleNamespace(sig=(_batch(seed)[0], LENS), tokens_bos=(bos, rel), tokens_eos=(eos, rel),
                                 tokens=(tokens, (n_ids / 4.0).astype(np.float32)),
                                 id=[f"u{seed}-{i}" for i in range(B)],
                                 wrd=[" ".join(str(int(x)) for x in ids[i, :n]) for i, n in enumerate(n_ids)])


def _jax_micro(pair, names, last: bool) -> dict:
    s, want = pair.brain.state, jax_params(pair)
    norm = to_numpy(s.norm_state)
    return {"metrics": {k: float(v) for k, v in pair.captured["metrics"].items() if k != "stepped"},
            "stats": {k: v for k, v in want.items() if k.endswith(("running_mean", "running_var"))},
            "norm": [norm.count, norm.glob_mean, norm.glob_std],
            "accum": None if last else jax_tree(s.accum_grads)}


def _jax_cycle(pair, epoch: int, names) -> tuple[dict, list]:
    """JAX's brain over its mesh: one cycle of BATCHES in ``epoch``'s phase.
    -> (its record, the SpecAugment draws of each micro-batch)."""
    pair.reset()
    micro, draws = [], []
    for i, (wavs, lens, labels, tokens) in enumerate(BATCHES):
        pair.brain.fit_batch(types.SimpleNamespace(sig=(wavs, lens), gender=labels, tokens_bos=(tokens, None)),
                             epoch)
        draws.append(jax_draws(pair.captured["key"], (B, T, 80), pair.brain.augmentation))
        micro.append(_jax_micro(pair, names, i == len(BATCHES) - 1))
    phase = SCHEDULE[epoch]
    opt_key = "clf" if phase["train"] == "sex_classifier" else "gen"
    count, mu, nu = adam_state(pair, opt_key)
    want = jax_params(pair)
    record = {"micro": micro, "opt_key": opt_key, "count": count, "mu": mu, "nu": nu,
              "params": {k: want[k] for k in names}, "lr": pair.captured["lr"],
              "sex_on": any(phase["weights"].get(k, 0.0) for k in ("sex", "confusion"))}
    return record, draws


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The JAX brain over a 4-device mesh, the port in one process, and the
    port's four ranks, on the same start weights, batches and draws."""
    folder = tmp_path_factory.mktemp("dp")
    jm = JaxASRModel(**SMALL_ASR)
    v = random_variables(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 80)), jnp.zeros((1, 3), jnp.int32),
                         jnp.ones((1,)), seed=0)
    pair = Pair("convae", SCHEDULE, 3, BATCHES[0], augment=True,
                jax_kw={"mesh": jax_make_mesh(RANKS), "asr_bundle": JaxASRBundle(jm, v, _Tok(), {})})
    inputs = {"schedule": SCHEDULE, "asr_widths": SMALL_ASR, "asr": asr_state_dict(v),
              "start": anonymizer_state_dict(pair.variables), "batches": BATCHES,
              "valid": _batch(20)[:3]}
    names = list(dict(helpers.convae_trainer(inputs).model.named_parameters()))
    jax_records, inputs["draws"] = zip(*(_jax_cycle(pair, epoch, names) for epoch in range(len(SCHEDULE))))
    tensors = [tuple(torch.from_numpy(x) for x in b) for b in BATCHES]
    one = [cycle_record(helpers.convae_trainer(inputs), tensors, epoch, draws)
           for epoch, draws in enumerate(inputs["draws"])]
    vb = inputs["valid"]
    one_valid = helpers.valid_stats(helpers.anonymizer_brain(inputs, str(folder)), types.SimpleNamespace(
        sig=(torch.from_numpy(vb[0]), torch.from_numpy(vb[1])), gender=torch.from_numpy(vb[2]),
        id=list(range(B)), wrd=[]))
    inputs["gender_batch"] = (speechlike(B, N_SAMPLES, 30), np.ones(B, np.float32), LABELS.astype(np.int64))
    brain = helpers.gender_brain()
    inputs["gender_draws"] = brain.draw(inputs["gender_batch"][0].shape)
    gender_start = {k: p.detach().clone() for k, p in brain.params.items()}
    one_gender = gender_record(brain, tuple(torch.from_numpy(x) for x in inputs["gender_batch"]),
                               inputs["gender_draws"])
    brain = helpers.asr_brain(str(folder))
    inputs["asr_batches"] = [_asr_batch(40), _asr_batch(41)]
    inputs["asr_draws"] = [brain.augmentation.draw((B, 1 + N_SAMPLES // 160, 80), torch.Generator().manual_seed(s))
                           for s in (1, 2)]
    asr_start = {k: p.detach().clone() for k, p in brain.params.items()}
    one_asr = helpers.asr_record(brain, inputs["asr_batches"], inputs["asr_draws"])
    torch.save(inputs, folder / "inputs.pt")
    ranks = helpers.spawn(helpers.data_parallel_ranks, RANKS, folder)
    start = {k: inputs["start"][k] for k in names}
    return types.SimpleNamespace(inputs=inputs, jax=jax_records, one=one, ranks=ranks, start=start,
                                 one_valid=one_valid, one_gender=one_gender, gender_start=gender_start,
                                 one_asr=one_asr, asr_start=asr_start)


# -- without a process group -----------------------------------------------------------


def test_ops_load_the_collectives_without_the_model_code():
    """``ops`` and ``models.components`` reduce through ``parallel.mesh``;
    loading them does not pull in the tensor-parallel rules (which import the
    models), and loading the ops does not pull in the models."""
    code = ("import sys, speech_anonymization_tpu_torch.ops.fbank, speech_anonymization_tpu_torch.ops.normalization\n"
            "assert 'speech_anonymization_tpu_torch.models' not in sys.modules\n"
            "import speech_anonymization_tpu_torch.models.components\n"
            "assert 'speech_anonymization_tpu_torch.parallel.sharding_rules' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=Path(__file__).resolve().parents[1])


def test_initialize_distributed_noop_without_env(monkeypatch):
    for name in ("SATPU_COORDINATOR", "SATPU_NUM_PROCESSES", "SATPU_PROCESS_ID", "SATPU_MULTIHOST"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_distributed() is False
    assert is_main_process()


def test_run_on_main_returns_result_and_barrier_completes():
    assert run_on_main(lambda a, b: a + b, 2, b=3) == 5
    global_barrier()  # no group: nothing to wait for


def test_one_rank_mesh_is_the_identity():
    mesh = make_mesh()
    assert (mesh.size("data"), mesh.index("data"), mesh.group("data")) == (1, 0, None)
    x = torch.arange(6.0).reshape(2, 3)
    assert psum(x, mesh) is x and pmax(x, mesh) is x and all_gather_rows(x, mesh) is x
    rows = [1, 2]
    assert all_gather_concat(rows, mesh) is rows
    terms = psum_terms((x.sum().requires_grad_(),), mesh)
    assert float(terms[0]) == 15.0 and not terms[0].requires_grad
    fb = helpers.Fbank(device="cpu")
    use_mesh(mesh, fb)
    assert fb.mesh is mesh
    use_mesh(None, fb)  # a brain built without a mesh takes a shared object's off
    assert fb.mesh is None
    placed = shard_batch((np.ones((2, 4), np.float32), [x], None), mesh)
    assert torch.equal(placed[0], torch.ones(2, 4)) and placed[1][0] is x and placed[2] is None
    assert data_sharding(mesh).axis == "data" and replicated_sharding(mesh).axis is None
    with pytest.raises(ValueError):
        make_mesh(2)


# -- four ranks ------------------------------------------------------------------------


@pytest.mark.parametrize("epoch", range(len(SCHEDULE)), ids=[p["train"] for p in SCHEDULE])
def test_convae_cycle_over_four_ranks_equals_one_process_and_jax(dp_run, epoch):
    got = dp_run.ranks[0]["cycles"][epoch]
    compare_records(got, dp_run.one[epoch], dp_run.start, "four ranks and one process")
    compare_records(got, dp_run.jax[epoch], dp_run.start, "four ranks and JAX's mesh", lr_rtol=JAX_LR_RTOL)
    compare_records(dp_run.one[epoch], dp_run.jax[epoch], dp_run.start, "one process and JAX's mesh",
                    lr_rtol=JAX_LR_RTOL)
    for r in dp_run.ranks[1:]:  # every rank took the identical update
        other = r["cycles"][epoch]
        for k, p in got["params"].items():
            assert torch.equal(p, other["params"][k]), (r["rank"], k)
        for a, b in zip(got["micro"], other["micro"]):
            assert a["metrics"] == b["metrics"]


def test_batch_global_values_differ_from_a_rank_alone(dp_run):
    """The fbank's floor, the normalizer's update, the head's BatchNorm
    statistics and the loss terms are the global batch's on every rank; on
    its shard alone a rank gets other values, far beyond the tolerances."""
    fbank = helpers.Fbank(device="cpu")(torch.from_numpy(BATCHES[0][0]))
    one = dp_run.one[0]["micro"][0]
    floor_gaps = []
    for r in dp_run.ranks:
        rows = slice(r["rank"] * B // RANKS, (r["rank"] + 1) * B // RANKS)
        np.testing.assert_allclose(r["fbank_global"].numpy(), fbank[rows].numpy(), rtol=1e-5, atol=1e-5)
        floor_gaps.append(float((r["fbank_local"] - fbank[rows]).abs().max()))
        alone = r["alone"]
        assert float(alone["norm"][0]) == 2.0 and float(one["norm"][0]) == B
        assert float((alone["norm"][1] - one["norm"][1]).abs().max()) > 100 * NORM_RTOL
        gap = tensor_gaps(alone["stats"], one["stats"], 1.0, "per-rank statistics", [])
        assert gap > 100 * STATS_RTOL, gap
        assert abs(alone["metrics"]["recon_loss"] - one["metrics"]["recon_loss"]) > 100 * LOSS_RTOL * abs(
            one["metrics"]["recon_loss"])
    # a rank with silent frames and without the batch's loudest one floors them
    # at its own max - 80 dB
    assert max(floor_gaps) > 1.0, floor_gaps


def test_collectives_over_four_ranks(dp_run):
    want = torch.arange(RANKS, dtype=torch.float32).repeat_interleave(2)[:, None].expand(2 * RANKS, 3)
    for r in dp_run.ranks:
        assert torch.equal(r["gather"], want)
        ranks = [i for i in range(RANKS) for _ in range(2)]
        assert r["concat"][0] == ranks and np.array_equal(r["concat"][1], ranks)
        assert r["pmax"] == RANKS - 1 and r["psum"] == RANKS * (RANKS + 1) / 2
        assert r["mesh"] == (RANKS, r["rank"])


def test_valid_stage_statistics_equal_one_process(dp_run):
    want = dp_run.one_valid
    for r in dp_run.ranks:
        assert r["valid"]["ACC"] == want["ACC"]
        for k in ("loss", "Utility_Retention"):
            np.testing.assert_allclose(r["valid"][k], want[k], rtol=LOSS_RTOL, err_msg=k)


def test_gender_step_over_four_ranks_equals_one_process(dp_run):
    for r in dp_run.ranks:
        compare_gender_records(r["gender"], dp_run.one_gender, dp_run.gender_start, f"rank {r['rank']}")


def test_asr_cycle_over_four_ranks_equals_one_process(dp_run):
    want = dp_run.one_asr
    for r in dp_run.ranks:
        got, failures = r["asr"], []
        for g_mb, w_mb in zip(got["micro"], want["micro"]):
            for k, w in w_mb["metrics"].items():
                np.testing.assert_allclose(g_mb["metrics"][k], w, rtol=LOSS_RTOL, err_msg=k)
            for a, b in zip(g_mb["norm"], w_mb["norm"]):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=NORM_RTOL, atol=NORM_RTOL)
            if w_mb["accum"] is not None:
                tensor_gaps(g_mb["accum"], w_mb["accum"], GRAD_RTOL, "accumulated grads", failures)
        assert got["count"] == want["count"] == 1
        tensor_gaps(got["mu"], want["mu"], MOMENT_RTOL, "Adam mu", failures)
        tensor_gaps(got["nu"], want["nu"], MOMENT_RTOL, "Adam nu", failures)
        floor = noise_floor(want["mu"])
        for k in want["params"]:
            step_gaps(k, got["params"][k], want["params"][k], dp_run.asr_start[k], (got["mu"][k], want["mu"][k]),
                      (got["nu"][k], want["nu"][k]), 1, want["lr"], floor, failures)
        assert not failures, failures


# -- two ranks from the recipes' environment ---------------------------------------------


@pytest.fixture(scope="module")
def main_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ls"))
    make_fake_librispeech(root, utts_per_speaker=3, duration_s=0.7)
    folder = tmp_path_factory.mktemp("main")
    out = str(folder / "out")
    torch.save({"argv": _argv(root, out, model_type="convae", number_of_epochs=2)}, folder / "inputs.pt")
    ranks = helpers.spawn(helpers.launch_and_main_ranks, 2, folder)
    return folder, out, ranks


def test_run_on_main_runs_on_rank_zero_while_rank_one_waits(main_run):
    folder, _, ranks = main_run
    marks = (folder / "marks.txt").read_text().splitlines()
    assert marks.count("rank 0 ran") == 1
    assert marks.index("rank 0 ran") < marks.index("rank 1 passed")
    assert marks.index("rank 1 at the barrier") < marks.index("rank 1 passed")
    assert [r["run_on_main"] for r in ranks] == ["rank 0 ran", None]
    assert [r["main"] for r in ranks] == [True, False]


def test_two_process_main_writes_from_rank_zero(main_run):
    folder, out, ranks = main_run
    assert (folder / "prepared.txt").read_text().splitlines() == ["rank 0"]
    ckpts = [c for c in os.listdir(os.path.join(out, "save", "ckpts")) if c.startswith("CKPT")]
    assert len(ckpts) == 2, ckpts  # one a valid stage, from rank 0 alone
    lines = open(os.path.join(out, "train_log.txt")).read().splitlines()
    assert [line.split(",")[0] for line in lines if "valid loss" in line] == ["epoch: 1", "epoch: 2"]
    # the test stage's line is not gated in the JAX recipe: one from each rank
    assert sum("test loss" in line for line in lines) == 2
    for r in ranks:
        assert np.isfinite(r["test_stats"]["loss"])
