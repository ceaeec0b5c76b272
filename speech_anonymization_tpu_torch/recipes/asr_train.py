"""The transformer-ASR training recipe: the utility evaluator the anonymizer scores with.

Counterpart of ``speech_anonymization_tpu/recipes/asr_train.py``
(``ASRBrain``, ``train_tokenizer_if_needed``, ``main``): fbank (K1) -> the
global normalizer -> [SpecAugment] -> ``ASRModel`` -> the joint loss
``ctc_weight * CTC + (1 - ctc_weight) * KLdiv(label_smoothing)``; gradients
averaged over ``gradient_accumulation`` micro-batches; at the count, clip by
the global norm (``gradient_clipping``) and Adam (b1 0.9, b2 0.98, eps 1e-9)
at Noam's lr, then from epoch ``stage_one_epochs + 1`` on SGD (nesterov
momentum 0.99) at the constant ``lr_sgd`` with a fresh state; the valid
stage's loss and, every ``valid_search_interval`` epochs, its beam decode
(``valid_beam_size``, no length normalization), the checkpoint (top 5 by
``ACC``); before the test stage the average of the kept ``model`` trees; the
test stage's beam decode (``test_beam_size``, length normalization) into WER
and ``wer_file``. The decodes run :func:`recipes.asr_bundle.beam_decode`:
K2 with K3 or K4 on physical caches, K5/K6 where the paging rule pages.

Checkpoints are the JAX package's (recoverables ``model``, ``normalizer``,
``counter``, ``noam_scheduler``, and ``optimizer_name`` from the switch to
SGD on), so either package resumes or averages the other's.

The recipe mirrors the JAX one where it is easy to "fix":
  * the model runs without ``train=True`` (no dropout, whatever
    ``transformer_dropout`` says), and its test decode fuses no LM;
  * the non-finite guard keeps the parameters but lets the optimizer state
    advance; the normalizer's statistics update on every micro-batch;
  * Noam advances on every stepping micro-batch, in the SGD stage too;
  * ``ACC`` is ``-loss``, a ranking key; only ``model`` is averaged;
    ``optimizer_name`` is registered only at the switch.

Entry point::

    python -m speech_anonymization_tpu_torch.recipes.asr_train configs/transformer.yaml
        --data_folder <LibriSpeech> [--eval_only] [--device cuda|cpu]
"""

from __future__ import annotations

import os
import sys
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..config import load_config, parse_arguments
from ..data.tokenizer import UnigramTokenizer
from ..decoding import BeamSearchConfig, hyps_to_lists
from ..eval.wer import ErrorRateStats
from ..losses.basic import ctc_loss, kldiv_loss
from ..models.asr import ASRModel
from ..ops.fbank import Fbank
from ..ops.normalization import InputNormalizer
from ..ops.specaugment import SpecAugmentDraws
from ..parallel.mesh import Mesh, all_gather_concat, data_parallel_grads, is_main_process, local_rows, psum, use_mesh
from ..train.brain import Brain, Stage
from ..train.checkpoint import Checkpointer, PytreeRecoverable, average_checkpoints
from ..train.experiment import create_experiment_directory
from ..train.schedulers import NoamScheduler
from ..train.state import SGD, Adam, TrainState, kept_step
from ..utils.convert import asr_state_dict, asr_variables, normalizer_state, normalizer_tree
from .anonymizer import copy_into, dataio_prepare, launch, make_loaders, prepare_data, resolve_device
from .asr_bundle import CACHE_DTYPES, beam_decode


class ASRBatch(NamedTuple):
    """A batch on the device, and the host's copies of the values CTC reads
    (``host``: tokens, relative wav lengths, relative token lengths as
    numpy), so the loss reads nothing back."""

    wavs: torch.Tensor
    lens: torch.Tensor
    tokens_bos: torch.Tensor
    tokens_eos: torch.Tensor
    tokens: torch.Tensor
    eos_lens: torch.Tensor
    tokens_lens: torch.Tensor
    host: tuple


class ASRBrain(Brain):
    """``hparams``: the recipe's keys (``transformer.yaml``) with its built
    objects ``compute_features``, ``normalize``, ``train_logger``,
    ``epoch_counter``, ``noam_annealing`` (None: one from ``lr_adam``,
    ``n_warmup_steps``, ``d_model``) and optionally ``augmentation`` (a
    ``SpecAugment``, drawn from a generator seeded by ``seed``). The model is
    built here, on ``device``, from flax's initialisers drawn from ``seed``.
    A batch is the loader's ``PaddedBatch``: ``.sig``, ``.tokens_bos``,
    ``.tokens_eos``, ``.tokens`` (each (values, relative lengths)), ``.id``,
    ``.wrd``. Call :meth:`init_state` before a checkpointer saves or recovers.

    ``mesh``: data parallelism over its ``data`` axis, as the JAX brain's
    ``mesh=``, each batch this rank's shard (tokens padded to the global
    batch's lengths too): the fbank's floor and the normalizer's update over
    the global batch, the CTC and KLdiv ``batchmean`` terms as this rank's
    shares of the global ones, the gradients summed over the ranks before they
    are accumulated, the SpecAugment draws the global batch's; a valid or test
    batch's decoded words gathered over the ranks before they are scored. The
    valid stage's log line and checkpoint come from rank 0 alone."""

    def __init__(self, hparams: dict, tokenizer, checkpointer: Checkpointer | None = None,
                 device: str | torch.device = "cuda", mesh: Mesh | None = None):
        super().__init__(hparams, checkpointer, hparams.get("ckpt_interval_minutes"))
        self.device = torch.device(device)
        self.mesh = mesh
        self.dp = mesh.size("data") if mesh is not None else 1
        self.tokenizer = tokenizer
        self.fbank: Fbank = hparams.get("compute_features") or Fbank(device=device)
        self.normalizer: InputNormalizer = hparams.get("normalize") or InputNormalizer(dim=80)
        seed = int(hparams.get("seed", 0))
        self.model = ASRModel(
            input_feats=int(hparams.get("n_mels", 80)), d_model=int(hparams.get("d_model", 768)),
            nhead=int(hparams.get("nhead", 8)),
            num_encoder_layers=int(hparams.get("num_encoder_layers", 12)),
            num_decoder_layers=int(hparams.get("num_decoder_layers", 6)),
            d_ffn=int(hparams.get("d_ffn", 3072)), output_neurons=int(hparams.get("output_neurons", 5000)),
            generator=torch.Generator().manual_seed(seed), device=device)
        self.train_logger = hparams["train_logger"]
        self.epoch_counter = hparams["epoch_counter"]
        self.noam: NoamScheduler = hparams.get("noam_annealing") or NoamScheduler(
            lr_initial=float(hparams.get("lr_adam", 1.0)),
            n_warmup_steps=int(hparams.get("n_warmup_steps", 25000)),
            model_size=int(hparams.get("d_model", 768)))
        self.ctc_weight = float(hparams.get("ctc_weight", 0.3))
        self.label_smoothing = float(hparams.get("label_smoothing", 0.1))
        self.grad_accum = int(hparams.get("gradient_accumulation", 1))
        self.clip = hparams.get("gradient_clipping", 5.0)
        self.stage_one_epochs = int(hparams.get("stage_one_epochs", 90))
        self.lr_sgd = float(hparams.get("lr_sgd", 2.5e-5))
        self.augmentation = hparams.get("augmentation")
        self.generator = torch.Generator().manual_seed(seed)
        self._optimizer_name = "Adam"
        self.adam = Adam(1e-3, b1=0.9, b2=0.98, eps=1e-9)
        self.sgd = SGD(self.lr_sgd, momentum=0.99, nesterov=True)
        self.optimizer: Adam | SGD = self.adam
        self.params = dict(self.model.named_parameters())
        self.state = TrainState.create(self.params, {"opt": self.adam.init(self.params)},
                                       self.normalizer.init_state(self.device))
        self.metrics: dict = {}  # the last micro-batch's loss terms (device scalars)
        self.wer_metric = ErrorRateStats()
        use_mesh(mesh, self.fbank, self.normalizer)

    # -- compute ---------------------------------------------------------------------

    def _features(self, wavs, lens, epoch: int, train: bool, draws: SpecAugmentDraws | None = None):
        """-> (normalized [augmented] features, the new normalizer state)."""
        feats, new_norm = self.normalizer(self.state.norm_state, self.fbank(wavs), lens, epoch,
                                          training=train)
        if train and self.augmentation is not None:
            if draws is None:
                draws = self.augmentation.draw((feats.shape[0] * self.dp, *feats.shape[1:]), self.generator)
            feats = self.augmentation(feats, local_rows(draws, self.mesh))
        return feats, new_norm

    def _loss_terms(self, batch: ASRBatch, epoch: int, train: bool,
                    draws: SpecAugmentDraws | None = None):
        """-> (loss, loss_ctc, loss_seq, enc, p_ctc, new normalizer state). The
        model runs as the JAX recipe applies it: without ``train=True``. Under
        a mesh the losses are this rank's shares of the global batch's (the
        ``batchmean`` sums over the global batch size)."""
        feats, new_norm = self._features(batch.wavs, batch.lens, epoch, train, draws)
        enc, _, p_ctc, p_seq = self.model(feats, batch.tokens_bos, batch.lens)
        loss_seq = kldiv_loss(p_seq, batch.tokens_eos, batch.eos_lens, self.label_smoothing)
        loss_ctc = ctc_loss(p_ctc, batch.tokens, batch.lens, batch.tokens_lens, host=batch.host)
        loss_seq, loss_ctc = loss_seq / self.dp, loss_ctc / self.dp
        loss = self.ctc_weight * loss_ctc + (1.0 - self.ctc_weight) * loss_seq
        return loss, loss_ctc, loss_seq, enc, p_ctc, new_norm

    def _train_step(self, batch: ASRBatch, lr: float, epoch: int,
                    draws: SpecAugmentDraws | None = None) -> dict:
        """One micro-batch: its gradients into the accumulation buffer and, at
        the count, the update at ``lr``. -> the loss terms and ``stepped``."""
        loss, loss_ctc, loss_seq, _, _, new_norm = self._loss_terms(batch, epoch, True, draws)
        grads, terms = data_parallel_grads(loss, (loss, loss_ctc, loss_seq), self.params, self.mesh)
        self.state.norm_state = new_norm
        stepped = self.state.accumulate(grads, self.grad_accum)
        if stepped:
            self._apply(terms[0], lr)
        return {**dict(zip(("loss", "loss_ctc", "loss_seq"), terms)), "stepped": stepped}

    def _apply(self, loss: torch.Tensor, lr: float) -> None:
        """The update at the count (``kept_step``: the optimizer state advances
        whatever the finite check says; the parameters are kept where it fails)."""
        self.state.opt_state["opt"] = kept_step(self.params, self.state.accum_grads, self.optimizer,
                                                self.state.opt_state["opt"], lr, loss, self.clip)
        self.state.reset_accumulation()

    @torch.no_grad()
    def _eval_loss(self, batch: ASRBatch, epoch: int):
        """-> (loss at the train label smoothing, enc, p_ctc), normalizer frozen."""
        loss, _, _, enc, p_ctc, _ = self._loss_terms(batch, epoch, False)
        return psum(loss, self.mesh), enc, p_ctc

    @torch.no_grad()
    def _decode(self, wavs, lens, epoch: int, beam_size: int, length_normalization: bool):
        """The JAX recipe's decode: no LM, temperature 1."""
        hp = self.hparams
        cfg = BeamSearchConfig(
            beam_size=beam_size, bos_index=int(hp.get("bos_index", 1)), eos_index=int(hp.get("eos_index", 2)),
            blank_index=int(hp.get("blank_index", 0)), ctc_weight=float(hp.get("ctc_weight_decode", 0.4)),
            lm_weight=0.0, length_normalization=length_normalization)
        feats, _ = self._features(wavs, lens, epoch, False)
        return beam_decode(self.model, feats, lens, cfg, CACHE_DTYPES[hp.get("decode_cache_dtype", "float32")],
                           bool(hp.get("decode_paged_kv", True)))

    def _decode_valid(self, wavs, lens, epoch: int):
        return self._decode(wavs, lens, epoch, int(self.hparams.get("valid_beam_size", 10)), False)

    def _decode_test(self, wavs, lens, epoch: int):
        return self._decode(wavs, lens, epoch, int(self.hparams.get("test_beam_size", 10)), True)

    # -- optimizer staging ---------------------------------------------------------

    def check_and_reset_optimizer(self, epoch: int) -> None:
        """From epoch ``stage_one_epochs + 1`` on: SGD with a fresh state, and
        the ``optimizer_name`` recoverable registered."""
        if self._optimizer_name == "SGD" or epoch <= self.stage_one_epochs:
            return
        self.optimizer, self._optimizer_name = self.sgd, "SGD"
        self.state.opt_state["opt"] = self.sgd.init(self.params)
        if self.checkpointer is not None:
            self.checkpointer.add_recoverable("optimizer_name", _StrState(self))

    # -- state ---------------------------------------------------------------------

    def init_state(self) -> None:
        """Register the recoverables under the JAX recipe's names, in its trees."""
        if self.checkpointer is None:
            return
        self.checkpointer.add_recoverable("model", PytreeRecoverable(self._params_tree, self._set_params))
        self.checkpointer.add_recoverable("normalizer", PytreeRecoverable(
            lambda: normalizer_tree(self.state.norm_state), self._set_normalizer))
        self.checkpointer.add_recoverable("counter", self.epoch_counter)
        self.checkpointer.add_recoverable("noam_scheduler", self.noam)

    def _params_tree(self) -> dict:
        return asr_variables(self.model)["params"]

    def _set_params(self, params: dict) -> None:
        copy_into(self.params, asr_state_dict({"params": params}))

    def _set_normalizer(self, tree: dict) -> None:
        self.state.norm_state = normalizer_state(tree, self.device)

    # -- batches -------------------------------------------------------------------

    def _device_batch(self, batch) -> ASRBatch:
        wavs, lens = batch.sig
        tokens_bos, _ = batch.tokens_bos
        tokens_eos, eos_lens = batch.tokens_eos
        tokens, tokens_lens = batch.tokens
        dev = self.device

        def put(x, dtype):
            return torch.as_tensor(np.asarray(x), dtype=dtype).to(dev, non_blocking=True)

        host = (np.asarray(tokens), np.asarray(lens, np.float32), np.asarray(tokens_lens, np.float32))
        return ASRBatch(put(wavs, torch.float32), put(lens, torch.float32), put(tokens_bos, torch.int64),
                        put(tokens_eos, torch.int64), put(tokens, torch.int64), put(eos_lens, torch.float32),
                        put(tokens_lens, torch.float32), host)

    def fit_batch(self, batch, epoch: int, draws: SpecAugmentDraws | None = None) -> torch.Tensor:
        """One training micro-batch -> its loss (a device scalar). Noam
        advances on a micro-batch that steps, in either stage; the SGD stage
        steps at ``lr_sgd``. The accumulation count is the host's."""
        self.check_and_reset_optimizer(epoch)
        will_step = self.state.accum_count + 1 >= self.grad_accum
        lr = self.noam() if will_step else self.noam.current_lr
        if self._optimizer_name == "SGD":
            lr = self.lr_sgd
        self.metrics = self._train_step(self._device_batch(batch), lr, epoch, draws)
        return self.metrics["loss"]

    def evaluate_batch(self, batch, stage: Stage) -> torch.Tensor:
        db = self._device_batch(batch)
        epoch = self.epoch_counter.current
        loss, _, _ = self._eval_loss(db, epoch)
        decode_now = stage == Stage.TEST or (
            stage == Stage.VALID and epoch % int(self.hparams.get("valid_search_interval", 10)) == 0)
        if decode_now:
            fn = self._decode_test if stage == Stage.TEST else self._decode_valid
            tokens, lengths = fn(db.wavs, db.lens, epoch)[:2]
            predicted = [self.tokenizer.decode_ids(h).split(" ") for h in hyps_to_lists(tokens, lengths)]
            ids, predicted, words = (all_gather_concat(list(rows), self.mesh)
                                     for rows in (batch.id, predicted, [w.split(" ") for w in batch.wrd]))
            self.wer_metric.append(ids, predicted, words)
        return loss

    # -- hooks ---------------------------------------------------------------------

    def on_stage_start(self, stage: Stage, epoch: int | None = None) -> None:
        if stage != Stage.TRAIN:
            self.wer_metric = ErrorRateStats()

    def on_stage_end(self, stage: Stage, stage_loss: float, epoch: int | None = None) -> None:
        if stage == Stage.TRAIN:
            return
        stats = {"loss": stage_loss}
        if self.wer_metric.utts:
            stats["WER"] = self.wer_metric.summarize("error_rate")
        stats["ACC"] = -stage_loss  # a ranking key: lower loss ranks higher
        if stage == Stage.VALID:
            if not is_main_process():
                return
            self.train_logger.log_stats(
                {"epoch": epoch, "lr": self.noam.current_lr if self._optimizer_name == "Adam" else self.lr_sgd,
                 "steps": self.noam.n_steps, "optimizer": self._optimizer_name},
                train_stats=self.train_stats, valid_stats=stats)
            if self.checkpointer is not None:
                self.checkpointer.save_and_keep_only({"ACC": stats["ACC"], "epoch": epoch}, max_keys=["ACC"],
                                                     num_to_keep=5)
        else:
            self.train_logger.log_stats({"Epoch loaded": self.epoch_counter.current}, test_stats=stats)
            wer_file = self.hparams.get("wer_file")
            if wer_file and self.wer_metric.utts:
                with open(wer_file, "w") as f:
                    self.wer_metric.write_stats(f)
            self.test_stats = stats

    def on_evaluate_start(self, max_key: str | None = None, min_key: str | None = None) -> None:
        """The ``model`` trees of the top 5 checkpoints by ``max_key`` (ACC)
        averaged into the model; the normalizer stays as it is."""
        if self.checkpointer is None:
            return
        ckpts = self.checkpointer.find_checkpoints(max_key=max_key or "ACC", n=5)
        if ckpts:
            self._set_params(average_checkpoints(ckpts, "model", self._params_tree()))


class _StrState:
    """The ``optimizer_name`` recoverable: which stage the run is in."""

    def __init__(self, brain: ASRBrain):
        self.brain = brain

    def state_dict(self) -> dict:
        return {"optimizer": self.brain._optimizer_name}

    def load_state_dict(self, d: dict) -> None:
        if d.get("optimizer") == "SGD" and self.brain._optimizer_name != "SGD":
            self.brain.check_and_reset_optimizer(self.brain.stage_one_epochs + 1)


def train_tokenizer_if_needed(hparams: dict, train_data) -> UnigramTokenizer:
    """The tokenizer of ``tokenizer_path`` (or ``<save_folder>/tokenizer.json``)
    if it exists; else one trained on the train set's words at
    ``output_neurons`` pieces, and saved there."""
    tok_path = hparams.get("tokenizer_path") or os.path.join(hparams["save_folder"], "tokenizer.json")
    tok = UnigramTokenizer()
    if os.path.exists(tok_path):
        tok.Load(tok_path)
    else:
        tok.train(train_data.raw_values("wrd"), vocab_size=int(hparams.get("output_neurons", 5000)))
        if is_main_process():
            tok.save(tok_path)
    return tok


def main(argv: Sequence[str] | None = None) -> ASRBrain:
    """The ASR recipe, end to end: ``<config.yaml> [--key value ...]
    [--eval_only] [--device cuda|cpu]``, the JAX recipe's command line; on
    the card (the default) in fp32, TF32 off. Steps: the config; the
    experiment directory; the LibriSpeech CSVs; the tokenizer
    (:func:`train_tokenizer_if_needed`); the datasets and loaders of the
    anonymizer recipe (``dataio_prepare``, ``make_loaders``); the
    checkpointer (``async_checkpointing``); the brain; the newest checkpoint
    recovered; ``fit`` unless ``--eval_only``; each test set evaluated on the
    average of the top-5 ``ACC`` checkpoints, its WER in
    ``wer_<name>.txt``. Returns the brain. Under several processes
    (``anonymizer.launch``) rank 0 prepares the CSVs, saves a new tokenizer
    and writes the valid stage's log lines and checkpoints; as in the JAX
    recipe no mesh is given to the brain, so each process trains on its own
    batches."""
    config_path, run_opts, overrides = parse_arguments(list(argv) if argv is not None else sys.argv[1:])
    device = resolve_device("asr recipe", run_opts.get("device"))
    launch(device)
    hparams = load_config(config_path, overrides, device=device)
    create_experiment_directory(hparams["output_folder"], config_path, overrides)
    prepare_data(hparams)
    # the tokenizer first (it needs the train transcripts), then the datasets with it
    bootstrap, _, _ = dataio_prepare(hparams, tokenizer=None)
    tokenizer = train_tokenizer_if_needed(hparams, bootstrap)
    train_data, valid_data, test_datasets = dataio_prepare(hparams, tokenizer=tokenizer)
    train_loader, valid_loader, test_loaders = make_loaders(hparams, train_data, valid_data, test_datasets)
    checkpointer = Checkpointer(os.path.join(hparams["save_folder"], "ckpts"),
                                async_writes=bool(hparams.get("async_checkpointing", True)))
    brain = ASRBrain(hparams, tokenizer, checkpointer, device=device)
    brain.init_state()
    checkpointer.recover_if_possible()

    if not run_opts.get("eval_only", False):
        brain.fit(hparams["epoch_counter"], train_loader, valid_loader)

    for name, loader in test_loaders.items():
        brain.hparams["wer_file"] = os.path.join(hparams["output_folder"], f"wer_{name}.txt")
        brain.evaluate(loader, max_key="ACC")
    checkpointer.wait()
    return brain


if __name__ == "__main__":
    main()
