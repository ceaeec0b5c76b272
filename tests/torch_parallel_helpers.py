"""The ranks of the port's multi-process CPU tests: gloo processes started by
``torch.multiprocessing`` (spawn) on a file store, with no network. JAX-free,
so that a child imports only torch and the port: each child reads its inputs
from ``inputs.pt`` in the run's folder (written by the test in the parent),
caps torch at one thread, joins the group, runs its checks and writes its
results to ``rank<r>.pt`` there for the parent to compare. A child's
exception fails the spawn, and with it the test."""

from __future__ import annotations

import os
import types
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

from speech_anonymization_tpu_torch.models import ASRModel
from speech_anonymization_tpu_torch.ops.fbank import Fbank
from speech_anonymization_tpu_torch.ops.normalization import InputNormalizer
from speech_anonymization_tpu_torch.ops.specaugment import SpecAugment
from speech_anonymization_tpu_torch.parallel import (
    all_gather_concat,
    all_gather_rows,
    initialize_distributed,
    is_main_process,
    local_rows,
    make_mesh,
    pmax,
    psum,
    run_on_main,
    use_mesh,
)
from speech_anonymization_tpu_torch.parallel.sharding_rules import asr_param_specs, reduce_tp_grads, shard_asr_params
from speech_anonymization_tpu_torch.recipes import anonymizer as recipe
from speech_anonymization_tpu_torch.recipes.asr_bundle import ASRBundle
from speech_anonymization_tpu_torch.recipes.asr_train import ASRBrain
from speech_anonymization_tpu_torch.recipes.gender_classifier import GenderBrain
from speech_anonymization_tpu_torch.tools.train_parity import (
    convae_hparams,
    cycle_record,
    gender_hparams,
    gender_record,
)
from speech_anonymization_tpu_torch.train.epoch_loop import EpochCounter
from speech_anonymization_tpu_torch.train.logger import FileTrainLogger
from speech_anonymization_tpu_torch.train.schedulers import NoamScheduler
from speech_anonymization_tpu_torch.utils.convert import load_numpy_state

LR = 1e-3  # Noam at lr_initial 1e-3, one warmup step, model size 1
GENDER_WIDTHS = dict(tdnn_channels=(16, 16, 16, 16, 48), lin_neurons=16)
ASR_WIDTHS = dict(d_model=32, nhead=4, num_encoder_layers=1, num_decoder_layers=1, d_ffn=64,
                  output_neurons=24)


def spawn(fn, nprocs: int, folder: Path) -> list:
    """Run ``fn(rank, nprocs, folder)`` in ``nprocs`` spawned processes;
    -> each rank's results (``rank<r>.pt``)."""
    mp.start_processes(fn, args=(nprocs, str(folder)), nprocs=nprocs, join=True, start_method="spawn")
    return [torch.load(Path(folder) / f"rank{r}.pt", weights_only=False) for r in range(nprocs)]


def join(rank: int, world: int, folder: str) -> None:
    """One thread, then the gloo group on the folder's file store."""
    torch.set_num_threads(1)
    assert initialize_distributed(f"file://{os.path.join(folder, 'store')}", world, rank, backend="gloo")


def convae_trainer(inputs: dict, mesh=None, **kw):
    """The convae trainer of the tests: convae.yaml's training with the
    tests' schedule, Noam at LR, the utility through the small ASR; the
    start weights ``inputs["start"]``."""
    asr = load_numpy_state(ASRModel(**inputs["asr_widths"], device="cpu"), inputs["asr"])
    hp = convae_hparams("cpu", inputs["schedule"], NoamScheduler(LR, 1, 1))
    trainer = recipe.AnonymizerTrainer(hp, asr_bundle=ASRBundle(asr, None, {}), device="cpu", mesh=mesh, **kw)
    load_numpy_state(trainer.model, inputs["start"])
    return trainer


def anonymizer_brain(inputs: dict, folder: str, mesh=None):
    """A ``SexAnonymizationBrain`` on :func:`convae_trainer`'s model and weights."""
    asr = load_numpy_state(ASRModel(**inputs["asr_widths"], device="cpu"), inputs["asr"])
    hp = {**convae_hparams("cpu", inputs["schedule"], NoamScheduler(LR, 1, 1)),
          "train_logger": FileTrainLogger(os.path.join(folder, "log.txt")), "epoch_counter": EpochCounter(1)}
    brain = recipe.SexAnonymizationBrain(hp, asr_bundle=ASRBundle(asr, None, {}), device="cpu", mesh=mesh)
    load_numpy_state(brain.model, inputs["start"])
    return brain


def valid_stats(brain, batch) -> dict:
    """One valid batch through ``evaluate_batch``, and the stage's statistics."""
    brain.on_stage_start(recipe.Stage.VALID, 0)
    loss = float(brain.evaluate_batch(batch, recipe.Stage.VALID))
    m = brain.metrics
    return {"loss": loss, "ACC": m.sex_acc.summarize(), "Utility_Retention": m.utility_similarity.summarize()}


def gender_brain(mesh=None):
    hp = {**gender_hparams("cpu", True, **GENDER_WIDTHS), "lr_start": LR}
    return GenderBrain(hp, device="cpu", mesh=mesh)


class _Tok:
    def decode_ids(self, ids):
        return " ".join(str(int(i)) for i in ids)


def asr_brain(folder: str, mesh=None):
    """A small ``ASRBrain`` (accumulation 2, SpecAugment, Noam), fresh from seed 3."""
    hp = {**ASR_WIDTHS, "seed": 3, "gradient_accumulation": 2, "gradient_clipping": 5.0,
          "noam_annealing": NoamScheduler(LR, 1, 1), "compute_features": Fbank(device="cpu"),
          "normalize": InputNormalizer(dim=80), "augmentation": SpecAugment(),
          "train_logger": FileTrainLogger(os.path.join(folder, "asr_log.txt")), "epoch_counter": EpochCounter(1)}
    return ASRBrain(hp, _Tok(), device="cpu", mesh=mesh)


def asr_record(brain, batches, draws) -> dict:
    """An ``ASRBrain`` accumulation cycle: the loss terms of each micro-batch,
    the normalizer, the accumulated gradients before the update, and after it
    Adam's count and moments and the parameters."""
    micro = []
    for i, (batch, d) in enumerate(zip(batches, draws)):
        brain.fit_batch(batch, 0, d)
        micro.append({"metrics": {k: float(v) for k, v in brain.metrics.items() if k != "stepped"},
                      "norm": [t.clone() for t in brain.state.norm_state],
                      "accum": {k: v.clone() for k, v in brain.state.accum_grads.items()}
                      if i < len(batches) - 1 else None})
    opt = brain.state.opt_state["opt"]
    return {"micro": micro, "count": opt.count, "mu": dict(opt.mu), "nu": dict(opt.nu),
            "params": {k: p.detach().clone() for k, p in brain.params.items()}, "lr": brain.noam.current_lr}


def asr_rows(batch, mesh):
    """This rank's rows of an ASR ``PaddedBatch`` duck type."""
    take = lambda pair: tuple(np.asarray(local_rows(torch.from_numpy(np.asarray(x)), mesh)) for x in pair)  # noqa: E731
    n, i = mesh.size("data"), mesh.index("data")
    rows = slice(i * len(batch.id) // n, (i + 1) * len(batch.id) // n)
    return types.SimpleNamespace(sig=take(batch.sig), tokens_bos=take(batch.tokens_bos),
                                 tokens_eos=take(batch.tokens_eos), tokens=take(batch.tokens),
                                 id=batch.id[rows], wrd=batch.wrd[rows])


def data_parallel_ranks(rank: int, world: int, folder: str) -> None:
    """Four ranks of one global batch: the convae update cycle of each
    phase, the valid stage's statistics, a GenderBrain step, an ASRBrain
    cycle, and what each rank would compute on its own shard alone."""
    join(rank, world, folder)
    inputs = torch.load(os.path.join(folder, "inputs.pt"), weights_only=False)
    mesh = make_mesh()
    rows = lambda tree: local_rows(tree, mesh)  # noqa: E731
    out: dict = {"rank": rank, "mesh": (mesh.size("data"), mesh.index("data"))}
    batches = [tuple(rows(torch.from_numpy(x)) for x in b) for b in inputs["batches"]]
    out["cycles"] = [cycle_record(convae_trainer(inputs, mesh), batches, epoch, draws)
                     for epoch, draws in enumerate(inputs["draws"])]
    # the fbank with the global floor, and without it
    fb = Fbank(device="cpu")
    use_mesh(mesh, fb)
    out["fbank_global"] = fb(batches[0][0])
    out["fbank_local"] = Fbank(device="cpu")(batches[0][0])
    # this rank's shard alone: no mesh (per-rank statistics and means)
    alone = convae_trainer(inputs)
    alone.fit_batch(batches[0], 0, rows(inputs["draws"][0][0]))
    out["alone"] = {"metrics": {k: float(v) for k, v in alone.metrics.items() if k != "stepped"},
                    "stats": {k: v.clone() for k, v in alone.model.state_dict().items()
                              if k.endswith(("running_mean", "running_var"))},
                    "norm": [t.clone() for t in alone.state.norm_state]}
    vb = inputs["valid"]
    out["valid"] = valid_stats(anonymizer_brain(inputs, folder, mesh), types.SimpleNamespace(
        sig=(rows(torch.from_numpy(vb[0])), rows(torch.from_numpy(vb[1]))), gender=rows(torch.from_numpy(vb[2])),
        id=list(np.asarray(local_rows(torch.arange(len(vb[2])), mesh))), wrd=[]))
    gb = inputs["gender_batch"]
    out["gender"] = gender_record(gender_brain(mesh), tuple(rows(torch.from_numpy(x)) for x in gb),
                                  inputs["gender_draws"])
    out["asr"] = asr_record(asr_brain(folder, mesh), [asr_rows(b, mesh) for b in inputs["asr_batches"]],
                            inputs["asr_draws"])
    out["gather"] = all_gather_rows(torch.full((2, 3), float(rank)), mesh)
    out["concat"] = (all_gather_concat([rank, rank], mesh), all_gather_concat(np.full(2, rank), mesh))
    out["pmax"] = float(pmax(torch.tensor(float(rank)), mesh))
    out["psum"] = float(psum(torch.tensor(float(rank + 1)), mesh))
    torch.save(out, os.path.join(folder, f"rank{rank}.pt"))


def _append_line(path: str, line: str) -> str:
    with open(path, "a") as f:
        f.write(line + "\n")
    return line


def launch_and_main_ranks(rank: int, world: int, folder: str) -> None:
    """Two ranks from the recipes' environment: ``run_on_main`` runs on rank 0
    while rank 1 waits at its barrier; then the anonymizer recipe's
    ``main()`` (``inputs["argv"]``), counting ``prepare_librispeech``'s runs."""
    torch.set_num_threads(1)
    os.environ.update(SATPU_COORDINATOR=f"file://{os.path.join(folder, 'store')}",
                      SATPU_NUM_PROCESSES=str(world), SATPU_PROCESS_ID=str(rank))
    inputs = torch.load(os.path.join(folder, "inputs.pt"), weights_only=False)
    assert recipe.launch("cpu") and is_main_process() == (rank == 0)
    marks = os.path.join(folder, "marks.txt")
    if rank == 1:
        _append_line(marks, "rank 1 at the barrier")
    got = run_on_main(_append_line, marks, "rank 0 ran")
    _append_line(marks, f"rank {rank} passed")  # after rank 0's line, on both ranks
    prepare = recipe.prepare_librispeech

    def counted(**kw):
        _append_line(os.path.join(folder, "prepared.txt"), f"rank {rank}")
        return prepare(**kw)

    recipe.prepare_librispeech = counted
    brain = recipe.main(inputs["argv"])
    torch.save({"run_on_main": got, "test_stats": brain.test_stats, "main": is_main_process()},
               os.path.join(folder, f"rank{rank}.pt"))


def grads_of(loss: torch.Tensor, model: torch.nn.Module) -> dict:
    """{name: d loss / d parameter}, zeros for a parameter the loss does not use."""
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), grads)}


def tensor_parallel_ranks(rank: int, world: int, folder: str) -> None:
    """A (data 2 x model 2) mesh: the small ASR's KLdiv gradients, tensor
    parallel over ``model`` and data parallel over ``data``."""
    from speech_anonymization_tpu_torch.losses.basic import kldiv_loss

    join(rank, world, folder)
    inputs = torch.load(os.path.join(folder, "inputs.pt"), weights_only=False)
    mesh = make_mesh(shape=(2, 2), axis_names=("data", "model"))
    model = load_numpy_state(ASRModel(**inputs["widths"], device="cpu"), inputs["weights"])
    specs = asr_param_specs(model)
    shard_asr_params(model, mesh)
    feats, tokens, lens, targets = (local_rows(torch.from_numpy(x), mesh) for x in inputs["batch"])
    _, _, _, p_seq = model(feats, tokens, lens)
    tp = mesh.size("model")
    loss = kldiv_loss(p_seq, targets, None) / (mesh.size("data") * tp)
    raw = grads_of(loss, model)
    grads = reduce_tp_grads(raw, specs, mesh)
    q_bias = "transformer.encoder_layers.0.attn.q.bias"
    torch.save({"grads": grads, "raw_q_bias": raw[q_bias], "loss": float(psum(loss.detach(), mesh, "data") * tp),
                "coords": (mesh.index("data"), mesh.index("model")),
                "shapes": {k: tuple(p.shape) for k, p in model.named_parameters()}},
               os.path.join(folder, f"rank{rank}.pt"))
