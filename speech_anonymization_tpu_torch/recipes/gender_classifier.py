"""The gender (binary sex) classifier recipe: the privacy evaluator's trainer.

Counterpart of ``speech_anonymization_tpu/recipes/gender_classifier.py`` (the
reference's gender_classifier_train.py and its recon variant,
gender_classifier_train_recon.py):

  * :class:`GenderBrain`: per batch, waveforms -> [``env_corrupt``: the batch
    doubled with noise-corrupted copies, the labels too] -> [``augmentation``:
    speed perturbation, frequency and chunk dropout] -> fbank (K1) -> the
    global normalizer -> [the frozen anonymizer of the recon variant] ->
    ``Xvector`` -> ``XvectorClassifier`` -> NLL. The update is the JAX
    package's ``make_update_fn``: gradients averaged over
    ``gradient_accumulation`` micro-batches, clipped by global norm
    (``gradient_clipping``), Adam (b2 0.98, eps 1e-9) at the lr
    ``ReduceLROnPlateau`` holds, and the whole update (parameters and Adam's
    state) skipped when the norm or the loss is not finite; the BatchNorm
    statistics and the normalizer update on every micro-batch. Valid and test
    stages score the classification error; the valid stage anneals the lr
    and keeps the checkpoint with the least error, in the JAX package's format
    (``embedding_model``, ``classifier``, ``normalizer``, ``model_state``,
    ``counter``, ``lr_annealing``), so ``FeatureClassifier.from_checkpoint``
    loads it as the anonymizer's external evaluator;
  * :func:`dataio_prepare` (``label_encoder.txt`` in the save folder) and
    :func:`make_loaders` (a geometric bucket grid over the train durations);
  * :func:`load_recon_model`: the frozen anonymizer of the recon variant,
    from an anonymizer checkpoint directory in the JAX package's format, by
    the most useful checkpoint or the ``valid_frontier`` pick;
  * :func:`main`, the entry point::

        python -m speech_anonymization_tpu_torch.recipes.gender_classifier configs/gender_classifier.yaml
            [--key value ...] [--device cuda|cpu]

    and the same with ``configs/gender_classifier_recon.yaml``.

As in the JAX package, ``evaluate(test, min_key="error")`` reaches the base
``on_evaluate_start``, which selects nothing: the test stage scores the last
epoch's parameters, not the least-error checkpoint's.
"""

from __future__ import annotations

import os
import sys
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..config import load_config, parse_arguments
from ..data import CategoricalEncoder, DynamicItemDataset, SaveableDataLoader, read_audio
from ..data.dataset import make_buckets
from ..eval.metrics import AccuracyStats
from ..losses.basic import classification_error, nll_loss
from ..models.init import flax_init_
from ..ops.augment import NoiseDraws
from ..ops.normalization import NormalizerState
from ..parallel.mesh import (Mesh, all_gather_concat, data_parallel_grads, is_main_process, local_rows, psum_terms,
                             use_mesh)
from ..train.brain import Brain, Stage
from ..train.checkpoint import Checkpointer, PytreeRecoverable
from ..train.experiment import create_experiment_directory
from ..train.state import TrainState, adam_like_reference, guarded_step
from ..utils.reference_ckpts import find_best_ckpt_dir, load_reference_fcae
from ..utils.convert import (anonymizer_variables, indexed_state_dict, normalizer_state, normalizer_tree,
                             xvector_variables)
from ..models.autoencoders import FullyConnectedAutoencoder
from .anonymizer import (MODEL_TYPES, _flat, copy_into, frontier_pick, launch, model_state_tree,
                         pad_time_to_multiple, prepare_data, resolve_device, set_model_params, set_model_state)


class GenderDraws(NamedTuple):
    """One training micro-batch's random choices: ``env_corrupt``'s (for the
    (B, L) batch) and ``augmentation``'s (for the batch it gets: 2B rows with
    ``env_corrupt``); None where that transform is off."""

    env: NoiseDraws | None
    aug: object | None


class GenderBrain(Brain):
    """The x-vector sex classifier's trainer on ``Brain.fit`` / ``evaluate``.

    ``hparams`` holds the recipe's built objects: ``compute_features`` (an
    ``Fbank``), ``mean_var_norm`` (an ``InputNormalizer``), ``embedding_model``
    (an ``Xvector``), ``classifier`` (an ``XvectorClassifier``),
    ``lr_annealing`` (``ReduceLROnPlateau``), ``train_logger``,
    ``epoch_counter``, optionally ``env_corrupt`` and ``augmentation``; and
    ``lr_start``, ``gradient_accumulation``, ``gradient_clipping``, ``seed``
    (the fresh models' flax initialisers and the augmentations' generator).
    ``recon_model``: a frozen anonymizer applied between the normalizer and
    the x-vector (the recon variant). A batch is a ``PaddedBatch`` (``.sig =
    (wavs, lens)``, ``.gender_encoded``) or a tuple ``(wavs, lens, labels)``.
    Call :meth:`init_state` before a checkpointer saves or recovers.

    ``mesh``: data parallelism over its ``data`` axis, as the JAX brain's
    ``mesh=``, each batch this rank's shard: the fbank's floor, the
    normalizer's update and the x-vector's train-mode BatchNorms over the
    global batch (the mesh set on them here), the NLL and the error as this
    rank's shares of the global means, the gradients summed over the ranks
    before they are accumulated, the draws (:meth:`draw`) made for the global
    batch and each rank taking its rows (of the clean and of the corrupted
    half alike); an evaluation batch's log-probs and labels gathered over the
    ranks before they are scored. The valid stage's checkpoint comes from
    rank 0 alone; its log line, as in the JAX recipe, from every rank.
    """

    def __init__(self, hparams: dict, checkpointer: Checkpointer | None = None,
                 recon_model: torch.nn.Module | None = None, device: str | torch.device = "cuda",
                 mesh: Mesh | None = None):
        super().__init__(hparams, checkpointer, hparams.get("ckpt_interval_minutes"))
        self.device = torch.device(device)
        self.mesh = mesh
        self.dp = mesh.size("data") if mesh is not None else 1
        self.fbank = hparams["compute_features"]
        self.normalizer = hparams["mean_var_norm"]
        self.embedding_model = hparams["embedding_model"]
        self.classifier = hparams["classifier"]
        self.lr_annealing = hparams["lr_annealing"]
        self.train_logger = hparams["train_logger"]
        self.epoch_counter = hparams["epoch_counter"]
        seed = int(hparams.get("seed", 0))
        # a fresh run: flax's initialisers, drawn from the run's seed
        init_gen = torch.Generator().manual_seed(seed)
        flax_init_(self.embedding_model, init_gen)
        flax_init_(self.classifier, init_gen)
        self.recon_model = recon_model
        if recon_model is not None:
            recon_model.eval().requires_grad_(False)
        self.env_corrupt = hparams.get("env_corrupt")
        self.augmentation = hparams.get("augmentation")
        self.generator = torch.Generator().manual_seed(seed)
        self.accum_steps = int(hparams.get("gradient_accumulation", 1))
        self.clip = hparams.get("gradient_clipping")
        self.optimizer = adam_like_reference(lr=hparams.get("lr_start", 1e-3))
        self.params = {**{f"embedding_model.{k}": p for k, p in self.embedding_model.named_parameters()},
                       **{f"classifier.{k}": p for k, p in self.classifier.named_parameters()}}
        self.state = TrainState.create(self.params, {"adam": self.optimizer.init(self.params)},
                                       self.normalizer.init_state(self.device))
        self.metrics: dict = {}  # the last micro-batch's loss and error (device scalars)
        self.error_metrics = AccuracyStats()
        use_mesh(mesh, self.fbank, self.normalizer, self.embedding_model, self.classifier)

    # -- compute -------------------------------------------------------------------

    def draw(self, shape) -> GenderDraws:
        """A micro-batch's draws for (B, L) waveforms from the brain's generator
        (under a mesh, B is the global batch's)."""
        env = self.env_corrupt.draw(shape, self.generator) if self.env_corrupt is not None else None
        rows = 2 * shape[0] if env is not None else shape[0]
        aug = (self.augmentation.draw((rows, shape[1]), self.generator)
               if self.augmentation is not None else None)
        return GenderDraws(env, aug)

    def _forward(self, wavs: torch.Tensor, lens: torch.Tensor, epoch: int, train: bool,
                 draws: GenderDraws | None = None) -> tuple[torch.Tensor, NormalizerState]:
        """-> ((B', 2) log-probs, the new normalizer state); the augmentations
        apply when ``train`` (B' = 2B with ``env_corrupt``)."""
        if train:
            if self.env_corrupt is not None:
                noisy = self.env_corrupt(wavs, lens, draws.env)
                wavs, lens = torch.cat([wavs, noisy]), torch.cat([lens, lens])
            if self.augmentation is not None:
                wavs, lens = self.augmentation(wavs, lens, draws.aug)
        feats, new_norm = self.normalizer(self.state.norm_state, self.fbank(wavs), lens, epoch,
                                          training=train)
        if self.recon_model is not None:
            # the frozen anonymizer, without gradient, on T padded to a multiple
            # of 36 (fcae: none), cut back to T
            t = feats.shape[1]
            multiple = 1 if isinstance(self.recon_model, FullyConnectedAutoencoder) else 36
            with torch.no_grad():
                out = self.recon_model(pad_time_to_multiple(feats, multiple))
            feats = (out[0] if isinstance(out, tuple) else out)[:, :t]
        return self.classifier(self.embedding_model(feats, lens)), new_norm

    def _device_batch(self, batch) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if isinstance(batch, tuple):
            wavs, lens, labels = batch
        else:
            (wavs, lens), labels = batch.sig, np.asarray(batch.gender_encoded)
        return (torch.as_tensor(wavs, dtype=torch.float32, device=self.device),
                torch.as_tensor(lens, dtype=torch.float32, device=self.device),
                torch.as_tensor(labels, dtype=torch.int64, device=self.device))

    def fit_batch(self, batch, epoch: int, draws: GenderDraws | None = None) -> torch.Tensor:
        """One training micro-batch: gradients into the accumulation buffer;
        at the count, :func:`guarded_step` at the plateau's lr. ``draws``
        default to :meth:`draw`'s. -> the loss (a device scalar)."""
        wavs, lens, labels = self._device_batch(batch)
        if draws is None:
            draws = self.draw((wavs.shape[0] * self.dp, *wavs.shape[1:]))
        draws = GenderDraws(local_rows(draws.env, self.mesh),
                            local_rows(draws.aug, self.mesh, blocks=2 if draws.env is not None else 1))
        self.embedding_model.train()
        self.classifier.train()
        log_probs, new_norm = self._forward(wavs, lens, epoch, True, draws)
        if self.env_corrupt is not None:
            labels = torch.cat([labels, labels])
        loss = nll_loss(log_probs, labels) / self.dp
        error = classification_error(log_probs.detach(), labels) / self.dp
        grads, (loss, error) = data_parallel_grads(loss, (loss, error), self.params, self.mesh)
        self.state.norm_state = new_norm
        self.metrics = {"loss": loss, "error": error}
        if self.state.accumulate(grads, self.accum_steps):
            guarded_step(self.params, self.state, self.optimizer, "adam", self.lr_annealing.lr, loss,
                         self.clip)
        return loss

    @torch.no_grad()
    def eval_step(self, batch, epoch: int | None = None):
        """The JAX recipe's ``_eval_step``: eval mode, the frozen normalizer.
        -> (loss, error, log-probs); under a mesh the loss and error are the
        global batch's, the log-probs this rank's rows."""
        wavs, lens, labels = self._device_batch(batch)
        self.embedding_model.eval()
        self.classifier.eval()
        epoch = self.epoch_counter.current if epoch is None else epoch
        log_probs, _ = self._forward(wavs, lens, epoch, False)
        loss, error = psum_terms((nll_loss(log_probs, labels) / self.dp,
                                  classification_error(log_probs, labels) / self.dp), self.mesh)
        return loss, error, log_probs

    def evaluate_batch(self, batch, stage: Stage) -> torch.Tensor:
        batch = self._device_batch(batch)
        loss, _, log_probs = self.eval_step(batch)
        self.error_metrics.append(all_gather_concat(log_probs.cpu().numpy(), self.mesh),
                                  all_gather_concat(batch[2].cpu().numpy(), self.mesh))
        return loss

    # -- state ---------------------------------------------------------------------

    def init_state(self) -> None:
        """Register the recoverables under the JAX recipe's names and trees:
        ``embedding_model`` and ``classifier`` (flax params), ``normalizer``,
        ``model_state`` (``{"embedding_model": {"batch_stats"}, "classifier":
        {"batch_stats"}}``), ``counter`` and ``lr_annealing``. Adam's state is
        not saved: a resumed run starts it afresh, as the JAX package's does."""
        if self.checkpointer is None:
            return
        for name in ("embedding_model", "classifier"):
            self.checkpointer.add_recoverable(name, PytreeRecoverable(
                lambda name=name: xvector_variables(getattr(self, name))["params"],
                lambda tree, name=name: self._set_params(name, tree)))
        self.checkpointer.add_recoverable("normalizer", PytreeRecoverable(
            lambda: normalizer_tree(self.state.norm_state), self._set_normalizer))
        self.checkpointer.add_recoverable("model_state", PytreeRecoverable(
            self._model_state, self._set_model_state))
        self.checkpointer.add_recoverable("counter", self.epoch_counter)
        self.checkpointer.add_recoverable("lr_annealing", self.lr_annealing)

    def _set_params(self, name: str, params: dict) -> None:
        module = getattr(self, name)
        copy_into(dict(module.named_parameters()), indexed_state_dict({"params": params}))

    def _model_state(self) -> dict:
        return {name: {"batch_stats": xvector_variables(getattr(self, name))["batch_stats"]}
                for name in ("embedding_model", "classifier")}

    def _set_model_state(self, tree: dict) -> None:
        for name in ("embedding_model", "classifier"):
            # xvector_variables' statistics are views of the running buffers
            copy_into(_flat(xvector_variables(getattr(self, name))["batch_stats"]),
                      _flat(tree[name]["batch_stats"]))

    def _set_normalizer(self, tree: dict) -> None:
        self.state.norm_state = normalizer_state(tree, self.device)

    # -- hooks ---------------------------------------------------------------------

    def on_stage_start(self, stage: Stage, epoch: int | None = None) -> None:
        if stage != Stage.TRAIN:
            self.error_metrics = AccuracyStats()

    def on_stage_end(self, stage: Stage, stage_loss: float, epoch: int | None = None) -> None:
        if stage == Stage.TRAIN:
            return
        error = 1.0 - self.error_metrics.summarize()
        stats = {"loss": stage_loss, "error": error}
        if stage == Stage.VALID:
            old_lr, _ = self.lr_annealing(epoch, stage_loss)
            self.train_logger.log_stats({"Epoch": epoch, "lr": old_lr}, train_stats=self.train_stats,
                                        valid_stats=stats)
            if self.checkpointer is not None and is_main_process():
                self.checkpointer.save_and_keep_only({"loss": stage_loss, "error": error, "epoch": epoch},
                                                     min_keys=["error"])
        else:
            self.train_logger.log_stats({"Epoch loaded": self.epoch_counter.current}, test_stats=stats)
            self.test_stats = stats


def dataio_prepare(hparams: dict, audio_pipeline=None):
    """The train, valid and test datasets (``train_csv``, ``valid_csv``,
    ``test_csv``) with ``sig`` (``audio_pipeline`` of the path; default
    ``read_audio``) and ``gender_encoded`` (the label encoder's index of
    ``sex``). Train is ordered by ``sorting``, valid and test by duration. The
    encoder is ``hparams["label_encoder"]`` (or a new one), loaded from or
    written to ``<save_folder>/label_encoder.txt`` from the train labels.
    -> (train, valid, test, label encoder)."""
    data_folder = hparams["data_folder"]
    datasets = {split: DynamicItemDataset.from_csv(hparams[key], {"data_root": data_folder})
                for split, key in (("train", "train_csv"), ("valid", "valid_csv"), ("test", "test_csv"))}
    sorting = hparams.get("sorting", "random")
    if sorting == "ascending":
        datasets["train"] = datasets["train"].filtered_sorted(sort_key="duration")
    elif sorting == "descending":
        datasets["train"] = datasets["train"].filtered_sorted(sort_key="duration", reverse=True)
    for split in ("valid", "test"):
        datasets[split] = datasets[split].filtered_sorted(sort_key="duration")

    label_encoder = hparams.get("label_encoder") or CategoricalEncoder()
    audio_pipeline = audio_pipeline or read_audio
    for ds in datasets.values():
        ds.add_dynamic_item(audio_pipeline, takes=["wav"], provides=["sig"])
        ds.add_dynamic_item(lambda sex: np.int64(label_encoder.encode_label(sex)), takes=["sex"],
                            provides=["gender_encoded"])
        ds.set_output_keys(["id", "sig", "gender_encoded"])
    label_encoder.load_or_create(os.path.join(hparams["save_folder"], "label_encoder.txt"),
                                 from_iterables=[datasets["train"].raw_values("sex")])
    return datasets["train"], datasets["valid"], datasets["test"], label_encoder


def make_loaders(hparams: dict, train_data, valid_data, test_data):
    """-> (train, valid, test) loaders of ``batch_size``: waveforms padded to a
    geometric grid (growth 1.3) from the shortest train utterance (at least a
    quarter second) to the longest plus 0.1 s; the train loader shuffles from
    ``seed`` and the epoch and drops a last part batch."""
    batch_size = int(hparams.get("batch_size", 8))
    durations = [float(d) for d in train_data.raw_values("duration")] or [1.0]
    sr = int(hparams.get("sample_rate", 16000))
    buckets = make_buckets(max(int(min(durations) * sr), sr // 4), int(max(durations) * sr) + sr // 10)
    seed = int(hparams.get("seed", 0))

    def mk(ds, shuffle):
        return SaveableDataLoader(ds, batch_size=batch_size, shuffle=shuffle, seed=seed,
                                  bucket_map={"sig": buckets}, drop_last=shuffle)

    return mk(train_data, True), mk(valid_data, False), mk(test_data, False)


def _is_torch_ckpt(path: str) -> bool:
    """The reference's checkpoints are torch zip archives; the JAX package's
    and the port's are flax msgpack."""
    try:
        with open(path, "rb") as f:
            return f.read(4) == b"PK\x03\x04"
    except OSError:
        return False


def _reference_ckpt(ckpt_dir: str) -> str | None:
    """The reference's ``model.ckpt`` the JAX package would load for fcae: in
    ``ckpt_dir`` itself, or in its last ``CKPT+*`` directory; None if neither
    is a torch archive."""
    direct = os.path.join(ckpt_dir, "model.ckpt")
    if _is_torch_ckpt(direct):
        return direct
    try:
        cand = os.path.join(find_best_ckpt_dir(ckpt_dir), "model.ckpt")
    except FileNotFoundError:
        return None
    return cand if _is_torch_ckpt(cand) else None


def load_recon_model(ckpt_dir: str, model_type: str = "fcae", n_mels: int = 80,
                     ckpt_select: str = "max_utility", min_utility: float = 0.85,
                     device: str | torch.device = "cuda") -> torch.nn.Module:
    """The recon variant's frozen anonymizer (``model_type``), in eval mode.

    For fcae, a reference checkpoint (a torch ``model.ckpt`` in ``ckpt_dir``
    or in its last ``CKPT+*`` directory: gender_classifier_recon.yaml's
    ``trained_recon_model_path`` may name the reference's ``save/``) is ported
    by ``utils/reference_ckpts.py`` ``load_reference_fcae``. Otherwise the
    directory holds anonymizer-recipe checkpoints in the JAX package's format:
    its ``model`` and ``model_state`` from the checkpoint with the most
    Utility_Retention (``max_utility``) or the ``valid_frontier`` pick (valid
    ACC_external nearest chance among those with Utility_Retention >=
    ``min_utility``), the checkpoint the anonymizer's own frontier evaluation
    reports. ``n_mels`` is the models' fixed 80."""
    reference = _reference_ckpt(ckpt_dir) if model_type == "fcae" else None
    if reference is not None:
        return load_reference_fcae(reference, device=device)[0].eval().requires_grad_(False)
    model = MODEL_TYPES[model_type](device=device)
    ckptr = Checkpointer(ckpt_dir, {
        "model": PytreeRecoverable(lambda: anonymizer_variables(model)["params"],
                                   lambda p: set_model_params(model, p)),
        "model_state": PytreeRecoverable(lambda: model_state_tree(model),
                                         lambda s: set_model_state(model, s)),
    })
    if ckpt_select == "valid_frontier":
        pick, _, _ = frontier_pick(ckptr.find_checkpoints(), min_utility)
        if pick is None:
            raise FileNotFoundError(f"no frontier-scored anonymizer checkpoint under {ckpt_dir}")
        print(f"[recon ckpt_select=valid_frontier] epoch {pick.meta.get('epoch')}: valid "
              f"ACC_external={pick.meta['ACC_external']:.3f} Utility={pick.meta['Utility_Retention']:.3f}")
        ckptr.load_checkpoint(pick)
    elif ckptr.recover_if_possible(max_key="Utility_Retention") is None:
        raise FileNotFoundError(f"no anonymizer checkpoint under {ckpt_dir}")
    return model.eval().requires_grad_(False)


def main(argv: Sequence[str] | None = None) -> GenderBrain:
    """The gender classifier recipe, end to end: ``<config.yaml> [--key value
    ...] [--device cuda|cpu]``, the JAX recipe's command line.

    Runs on the card (``cuda``, TF32 off for cuBLAS and cuDNN) unless
    ``--device cpu`` is given; without a CUDA device it stops with an error.
    Steps: the config (its objects built on the device), the experiment
    directory, the LibriSpeech CSVs, the datasets and loaders, the frozen
    anonymizer of ``trained_recon_model_dir`` (``recon_model_type``,
    ``recon_ckpt_select``, ``eval_ckpt_min_utility``) when that directory
    exists, the checkpointer (``async_checkpointing``), the brain (fresh
    models from flax's initialisers at ``seed``), the newest checkpoint
    recovered, ``fit``, then ``evaluate(test, min_key="error")``. Returns
    the brain (its ``test_stats``). Under several processes
    (``anonymizer.launch``) rank 0 prepares the CSVs and saves the
    checkpoints; as in the JAX recipe no mesh is given to the brain, so each
    process trains on its own batches."""
    return run(argv, "gender classifier recipe")


def run(argv: Sequence[str] | None, name: str, make_pipeline=None) -> GenderBrain:
    """:func:`main`'s steps; ``make_pipeline(hparams)``, when given, makes the
    datasets' audio pipeline (the pitch-norm recipe's)."""
    config_path, run_opts, overrides = parse_arguments(list(argv) if argv is not None else sys.argv[1:])
    device = resolve_device(name, run_opts.get("device"))
    launch(device)
    hparams = load_config(config_path, overrides, device=device)
    create_experiment_directory(hparams["output_folder"], config_path, overrides)
    prepare_data(hparams)
    audio_pipeline = make_pipeline(hparams) if make_pipeline is not None else None
    train_data, valid_data, test_data, _ = dataio_prepare(hparams, audio_pipeline)
    train_loader, valid_loader, test_loader = make_loaders(hparams, train_data, valid_data, test_data)

    recon_model = None
    recon_dir = hparams.get("trained_recon_model_dir")
    if recon_dir and os.path.isdir(recon_dir):
        recon_model = load_recon_model(
            recon_dir, model_type=hparams.get("recon_model_type", "fcae"),
            n_mels=int(hparams.get("n_mels", 80)),
            ckpt_select=str(hparams.get("recon_ckpt_select", "max_utility")),
            min_utility=float(hparams.get("eval_ckpt_min_utility", 0.85)), device=device)

    checkpointer = Checkpointer(os.path.join(hparams["save_folder"], "ckpts"),
                                async_writes=bool(hparams.get("async_checkpointing", True)))
    brain = GenderBrain(hparams, checkpointer, recon_model=recon_model, device=device)
    brain.init_state()
    checkpointer.recover_if_possible()
    brain.fit(hparams["epoch_counter"], train_loader, valid_loader)
    brain.evaluate(test_loader, min_key="error")
    checkpointer.wait()
    return brain


if __name__ == "__main__":
    main()
