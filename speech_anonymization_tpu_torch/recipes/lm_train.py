"""The transformer-LM training recipe: the shallow-fusion LM of the test decode.

Counterpart of ``speech_anonymization_tpu/recipes/lm_train.py``
(``_read_transcripts``, ``_bucket_len``, ``TextBatchLoader``, ``LMBrain``,
``main``): transcripts -> the tokenizer's ids -> batches padded to static
token buckets (``lm_token_buckets``) -> ``TransformerLM`` in train mode
(dropout at ``lm_dropout``, its masks from a generator on the run's device
seeded by ``seed``) -> log-softmax -> ``kldiv_loss`` at
``lm_label_smoothing``; clip by the global norm, Adam (b1 0.9, b2 0.98, eps
1e-9) at Noam's lr on every batch, the parameters kept where the norm or the
loss is not finite (the optimizer state advances); the valid loss at label
smoothing 0, the checkpoint (top 5 by least ``loss``, the JAX package's
format: ``model``, ``counter``, ``noam_scheduler``), and before the test stage
the average of the kept ``model`` trees. ``load_lm``
(``recipes/asr_bundle.py``) reads the run's checkpoints. No kernel runs here:
the LM's full-sequence forward is cuBLAS and the plain attention.

Entry point::

    python -m speech_anonymization_tpu_torch.recipes.lm_train configs/lm.yaml
        --train_csv <csv> --valid_csv <csv> [--eval_only] [--device cuda|cpu]
"""

from __future__ import annotations

import csv
import os
import sys
from typing import Sequence

import numpy as np
import torch

from ..config import load_config, parse_arguments
from ..data.tokenizer import UnigramTokenizer
from ..losses.basic import kldiv_loss
from ..models.transformer import DropoutRng, TransformerLM
from ..parallel.mesh import is_main_process
from ..train.brain import Brain, Stage
from ..train.checkpoint import Checkpointer, PytreeRecoverable, average_checkpoints
from ..train.experiment import create_experiment_directory
from ..train.schedulers import NoamScheduler
from ..train.state import Adam, kept_step
from ..utils.convert import lm_state_dict, lm_variables
from .anonymizer import copy_into, launch, prepare_data, resolve_device


def _read_transcripts(csv_path: str) -> list[str]:
    """The non-empty ``wrd`` column of a LibriSpeech CSV, in file order."""
    with open(csv_path, newline="") as f:
        return [row["wrd"] for row in csv.DictReader(f) if row.get("wrd", "")]


def _bucket_len(n: int, buckets: Sequence[int]) -> int:
    """The least bucket holding ``n`` tokens (the largest when none does)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class TextBatchLoader:
    """Tokenized transcripts -> ``(tokens_bos, tokens_eos, rel_lens)`` numpy
    batches padded to static bucket lengths (pad 0, masked by the LM and the
    loss). Sentences are cut to the largest bucket less one and sorted by
    length; with ``shuffle`` the batches' order is drawn by
    ``default_rng(seed + epoch)``, each batch keeping its sentences (so one
    padded shape)."""

    def __init__(self, sentences, tokenizer, batch_size: int, buckets, bos: int = 1, eos: int = 2,
                 shuffle: bool = False, seed: int = 0):
        self.buckets = sorted(buckets)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.items = []
        for s in sentences:
            ids = tokenizer.encode_as_ids(s)[: self.buckets[-1] - 1]
            if ids:
                self.items.append((np.asarray([bos] + ids, np.int32), np.asarray(ids + [eos], np.int32)))
        self.items.sort(key=lambda p: len(p[0]))

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return -(-len(self.items) // self.batch_size)

    def __iter__(self):
        order = np.arange(len(self.items))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            starts = list(range(0, len(order), self.batch_size))
            rng.shuffle(starts)
            if starts:
                order = np.concatenate([order[s: s + self.batch_size] for s in starts])
        for i in range(0, len(order), self.batch_size):
            group = [self.items[int(j)] for j in order[i: i + self.batch_size]]
            pad_to = _bucket_len(max(len(b) for b, _ in group), self.buckets)
            bos_arr = np.zeros((len(group), pad_to), np.int32)
            eos_arr = np.zeros((len(group), pad_to), np.int32)
            lens = np.zeros((len(group),), np.float32)
            for j, (tb, te) in enumerate(group):
                bos_arr[j, : len(tb)] = tb
                eos_arr[j, : len(te)] = te
                lens[j] = len(tb) / pad_to
            yield bos_arr, eos_arr, lens


class LMBrain(Brain):
    """``hparams``: ``lm.yaml``'s keys with ``train_logger``, ``epoch_counter``
    and ``noam_annealing`` (None: one from ``lr_adam``, ``lm_warmup_steps``,
    ``lm_d_model``). The model is built here, on ``device``, from flax's
    initialisers drawn from ``seed``; dropout's masks come from ``dropout_rng``
    (a generator on ``device`` seeded by ``seed``; a test may swap in given
    masks). Batches are :class:`TextBatchLoader`'s."""

    def __init__(self, hparams: dict, tokenizer, checkpointer: Checkpointer | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__(hparams, checkpointer, hparams.get("ckpt_interval_minutes"))
        self.device = torch.device(device)
        self.tokenizer = tokenizer
        seed = int(hparams.get("seed", 0))
        self.model = TransformerLM(
            vocab=int(hparams.get("output_neurons", 5000)), d_model=int(hparams.get("lm_d_model", 768)),
            nhead=int(hparams.get("lm_nhead", 12)), num_layers=int(hparams.get("lm_num_layers", 12)),
            d_ffn=int(hparams.get("lm_d_ffn", 3072)), dropout=float(hparams.get("lm_dropout", 0.0)),
            generator=torch.Generator().manual_seed(seed), device=device)
        self.train_logger = hparams["train_logger"]
        self.epoch_counter = hparams["epoch_counter"]
        self.noam: NoamScheduler = hparams.get("noam_annealing") or NoamScheduler(
            lr_initial=float(hparams.get("lr_adam", 1.0)),
            n_warmup_steps=int(hparams.get("lm_warmup_steps", 25000)),
            model_size=int(hparams.get("lm_d_model", 768)))
        self.label_smoothing = float(hparams.get("lm_label_smoothing", 0.0))
        self.clip = hparams.get("gradient_clipping", 5.0)
        self.optimizer = Adam(1e-3, b1=0.9, b2=0.98, eps=1e-9)
        self.params = dict(self.model.named_parameters())
        self.opt_state = self.optimizer.init(self.params)
        self.dropout_rng = DropoutRng(torch.Generator(device=self.device).manual_seed(seed))

    def _device_batch(self, batch) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        tokens_bos, tokens_eos, lens = batch
        return (torch.as_tensor(np.asarray(tokens_bos), dtype=torch.int64).to(self.device),
                torch.as_tensor(np.asarray(tokens_eos), dtype=torch.int64).to(self.device),
                torch.as_tensor(np.asarray(lens), dtype=torch.float32).to(self.device))

    def _loss(self, batch) -> torch.Tensor:
        """The train loss: the LM in train mode (dropout), label smoothing."""
        tokens_bos, tokens_eos, lens = batch
        lp = torch.log_softmax(self.model(tokens_bos, train=True, rng=self.dropout_rng), dim=-1)
        return kldiv_loss(lp, tokens_eos, lens, self.label_smoothing)

    def _train_step(self, batch, lr: float) -> torch.Tensor:
        """One batch's update at ``lr``: clip, Adam (its state advances
        whatever the check says), the parameters kept where the norm or the
        loss is not finite. -> the loss."""
        loss = self._loss(batch)
        names = list(self.params)
        grads = torch.autograd.grad(loss, [self.params[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(self.params[k]) if g is None else g for k, g in zip(names, grads)}
        self.opt_state = kept_step(self.params, grads, self.optimizer, self.opt_state, lr, loss.detach(),
                                   self.clip)
        return loss.detach()

    @torch.no_grad()
    def _eval_loss(self, batch) -> torch.Tensor:
        """The LM in eval mode, label smoothing 0."""
        tokens_bos, tokens_eos, lens = batch
        return kldiv_loss(torch.log_softmax(self.model(tokens_bos), dim=-1), tokens_eos, lens, 0.0)

    def init_state(self) -> None:
        """Register the recoverables under the JAX recipe's names, in its trees."""
        if self.checkpointer is None:
            return
        self.checkpointer.add_recoverable("model", PytreeRecoverable(self._params_tree, self._set_params))
        self.checkpointer.add_recoverable("counter", self.epoch_counter)
        self.checkpointer.add_recoverable("noam_scheduler", self.noam)

    def _params_tree(self) -> dict:
        return lm_variables(self.model)["params"]

    def _set_params(self, params: dict) -> None:
        copy_into(self.params, lm_state_dict({"params": params}))

    def fit_batch(self, batch, epoch: int) -> torch.Tensor:
        return self._train_step(self._device_batch(batch), self.noam())

    def evaluate_batch(self, batch, stage: Stage) -> torch.Tensor:
        return self._eval_loss(self._device_batch(batch))

    def on_stage_end(self, stage: Stage, stage_loss: float, epoch: int | None = None) -> None:
        if stage == Stage.VALID and is_main_process():
            stats = {"loss": stage_loss, "ppl": float(np.exp(min(stage_loss, 20.0)))}
            self.train_logger.log_stats(
                {"epoch": epoch, "lr": self.noam.current_lr, "steps": self.noam.n_steps},
                train_stats=self.train_stats, valid_stats=stats)
            if self.checkpointer is not None:
                self.checkpointer.save_and_keep_only({"loss": stage_loss, "epoch": epoch}, min_keys=["loss"],
                                                     num_to_keep=5)
        elif stage == Stage.TEST:
            self.test_stats = {"loss": stage_loss, "ppl": float(np.exp(min(stage_loss, 20.0)))}
            self.train_logger.log_stats({"Epoch loaded": self.epoch_counter.current},
                                        test_stats=self.test_stats)

    def on_evaluate_start(self, max_key: str | None = None, min_key: str | None = None) -> None:
        """The ``model`` trees of the top 5 checkpoints by least ``min_key``
        (loss) averaged into the model."""
        if self.checkpointer is None:
            return
        ckpts = self.checkpointer.find_checkpoints(min_key=min_key or "loss", n=5)
        if ckpts:
            self._set_params(average_checkpoints(ckpts, "model", self._params_tree()))


def main(argv: Sequence[str] | None = None) -> LMBrain:
    """The LM recipe, end to end: ``<config.yaml> [--key value ...]
    [--eval_only] [--device cuda|cpu]``, the JAX recipe's command line; on
    the card (the default) in fp32, TF32 off. Steps: the config; the
    experiment directory; with ``data_folder`` and ``train_splits``, the
    LibriSpeech CSVs; the tokenizer (``tokenizer_path``, or
    ``<save_folder>/tokenizer.json``, trained on the train transcripts when
    absent); the loaders; the checkpointer; the brain; the newest checkpoint
    recovered; ``fit`` unless ``--eval_only``; each ``test_csv`` evaluated on
    the average of the top-5 least-loss checkpoints. Returns the brain.
    Under several processes (``anonymizer.launch``) rank 0 prepares the CSVs,
    saves a new tokenizer and writes the valid stage's log lines and
    checkpoints; each process trains on its own batches (``LMBrain`` takes
    no mesh, as in the JAX package)."""
    config_path, run_opts, overrides = parse_arguments(list(argv) if argv is not None else sys.argv[1:])
    device = resolve_device("lm recipe", run_opts.get("device"))
    launch(device)
    hparams = load_config(config_path, overrides, device=device)
    create_experiment_directory(hparams["output_folder"], config_path, overrides)
    if hparams.get("data_folder") and hparams.get("train_splits"):
        prepare_data(hparams)

    tok_path = hparams.get("tokenizer_path") or os.path.join(hparams["save_folder"], "tokenizer.json")
    tokenizer = UnigramTokenizer()
    train_sents = _read_transcripts(hparams["train_csv"])
    if os.path.exists(tok_path):
        tokenizer.Load(tok_path)
    else:
        tokenizer.train(train_sents, vocab_size=int(hparams.get("output_neurons", 5000)))
        if is_main_process():
            tokenizer.save(tok_path)

    buckets = list(hparams.get("lm_token_buckets", [16, 32, 64, 128]))
    batch_size = int(hparams.get("batch_size", 32))
    train_loader = TextBatchLoader(train_sents, tokenizer, batch_size, buckets, shuffle=True,
                                   seed=int(hparams.get("seed", 0)))
    valid_loader = TextBatchLoader(_read_transcripts(hparams["valid_csv"]), tokenizer, batch_size, buckets)
    checkpointer = Checkpointer(os.path.join(hparams["save_folder"], "ckpts"),
                                async_writes=bool(hparams.get("async_checkpointing", True)))
    brain = LMBrain(hparams, tokenizer, checkpointer, device=device)
    brain.init_state()
    checkpointer.recover_if_possible()

    if not run_opts.get("eval_only", False):
        brain.fit(hparams["epoch_counter"], train_loader, valid_loader)

    test_csvs = hparams.get("test_csv") or []
    for path in [test_csvs] if isinstance(test_csvs, str) else test_csvs:
        loader = TextBatchLoader(_read_transcripts(path), tokenizer, batch_size, buckets)
        brain.evaluate(loader, min_key="loss")
    checkpointer.wait()
    return brain


if __name__ == "__main__":
    main()
