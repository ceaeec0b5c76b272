"""Reduced-scale reproduction of the reference's headline research rows, on
the port.

Counterpart of ``scripts/repro_gender_row.py``. No LibriSpeech audio ships,
so this reproduces the KIND of result in BASELINE.md on the synthetic,
formant-rich gendered corpus (``data/synth.py``, disjoint test speakers),
end to end through the port's recipes:

  1. the gender_classifier recipe (x-vector + MLP head) on original audio
     -> test ACC (stage 1, the external evaluator);
  1.5 the asr_train recipe at the tiny utility ASR's widths (:data:`TINY_ASR`)
     -> test WER (stage 1.5);
  2. the anonymizer recipe (:data:`BASELINE_SCHEDULE`) with the stage-1
     classifier attached as the external evaluator and the stage-1.5 ASR as
     the utility model -> ACC_external on ORIGINAL vs ANONYMIZED features,
     Utility_Retention, WER.

Runs on the card unless ``--device cpu`` is given; with no card and no
``--device cpu`` it stops (``SystemExit``) and never falls back to the CPU.
The work dir is ``save/repro_gender_row_torch/`` (never the JAX scripts'
``save/repro_gender_row/``, whose cached stage markers would skip training
here)::

    python -m speech_anonymization_tpu_torch.scripts.repro_gender_row [--device cuda|cpu]

The sizes the JAX script hard-codes for the corpus and the stages' epochs
and gender batch are keyword parameters of :func:`ensure_stages` whose
defaults are the script's values, so a test or ``chip_smoke.py`` cuts depth
through the same code.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Sequence

from ..data.synth import build_corpus
from ..recipes.anonymizer import resolve_device
from ..utils.cuda_build import card_name
from . import archive_repro

BASE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "configs")


def parse_device(argv: Sequence[str]) -> tuple[str, list[str]]:
    """Take ``--device cuda|cpu`` (or ``--device=...``; default ``cuda``) out of
    a script's argv -> ``(device, the other arguments)``. Stops
    (``SystemExit``, the recipes' ``resolve_device``) on ``cuda`` without a
    card, or on any other name."""
    args, device, rest, i = list(argv), None, [], 0
    while i < len(args):
        if args[i] == "--device":
            if i + 1 >= len(args):
                raise SystemExit("--device needs a value (cuda or cpu)")
            device, i = args[i + 1], i + 2
            continue
        if args[i].startswith("--device="):
            device = args[i].split("=", 1)[1]
        else:
            rest.append(args[i])
        i += 1
    return resolve_device("research pipeline", device), rest


def _common(root, out):
    csv = os.path.join(root, "train-clean.csv")
    return [
        "--data_folder", root,
        "--train_splits", '["train-clean"]',
        "--dev_splits", '["train-clean"]',
        "--test_splits", '["test-clean"]',
        "--train_csv", csv,
        "--valid_csv", csv,
        "--output_folder", out,
        "--save_folder", os.path.join(out, "save"),
        "--train_log", os.path.join(out, "train_log.txt"),
        "--gradient_accumulation", "1",
    ]


def _cached(out, fn):
    """Stages cache their headline stats next to their checkpoints so a
    stage-2 schedule iteration doesn't re-train the (deterministic,
    schedule-independent) evaluator/ASR stages. Delete the stage dir to
    force a re-run."""
    marker = os.path.join(out, "repro_stats.json")
    if os.path.exists(marker):
        with open(marker) as f:
            return json.load(f)
    stats = fn()
    with open(marker, "w") as f:
        json.dump(stats, f)
    return stats


# tiny-ASR architecture shared by stage 1.5 training and every stage-2
# attach (the sweep must pass the identical shape or the checkpoint load
# fails)
TINY_ASR = [
    "--d_model", "64", "--nhead", "4", "--num_encoder_layers", "2",
    "--num_decoder_layers", "2", "--d_ffn", "128", "--output_neurons", "40",
    "--test_beam_size", "4",
]


def ensure_stages(work, *, device="cuda", utts=30, n_train_spk=8, n_test_spk=5, gender_batch=16,
                  gender_epochs=8, asr_epochs=40):
    """Build (or load from cache) the corpus + stage 1 evaluator + stage
    1.5 tiny ASR on ``device``. Returns (acc_orig, wer_asr). Each stage's
    cached stats also hold its wall, ``device`` and ``card``."""
    from ..recipes import asr_train, gender_classifier

    os.makedirs(work, exist_ok=True)
    root = os.path.join(work, "corpus")
    if not os.path.exists(os.path.join(root, "SPEAKERS.TXT")):
        # 30 utts/speaker: enough data that the tiny utility ASR actually
        # learns the acoustics (at 10 it memorized a word-prior and test
        # WER saturated ~85%)
        speakers, total_s = build_corpus(root, n_train_spk=n_train_spk, n_test_spk=n_test_spk, utts=utts)
        print(f"corpus: {len(speakers)} speakers, {total_s/60:.1f} min audio")
    test_csv = os.path.join(root, "test-clean.csv")
    card = card_name(device)

    # ---- stage 1: gender classifier on original audio ----------------------
    gout = os.path.join(work, "gender")

    def _stage1():
        t0 = time.time()
        gb = gender_classifier.main(
            [os.path.join(BASE, "gender_classifier.yaml")]
            + _common(root, gout)
            + ["--test_csv", test_csv, "--batch_size", str(gender_batch),
               "--number_of_epochs", str(gender_epochs), "--device", device]
        )
        return {"acc_orig": 1.0 - float(gb.test_stats["error"]), "wall_s": round(time.time() - t0, 1),
                "device": device, "card": card}

    acc_orig = _cached(gout, _stage1)["acc_orig"]
    print(f"[stage 1] gender ACC on ORIGINAL audio (held-out speakers): {acc_orig:.3f}")

    # ---- stage 1.5: tiny utility ASR (words ARE in the audio: WORD_PHONES) --
    aout = os.path.join(work, "asr")

    def _stage15():
        t0 = time.time()
        ab = asr_train.main(
            [os.path.join(BASE, "transformer.yaml")]
            + _common(root, aout)
            + ["--test_csv", f'["{test_csv}"]',
               "--batch_size", "8", "--number_of_epochs", str(asr_epochs),
               "--valid_beam_size", "2",
               "--valid_search_interval", "100",
               # scale-matched Noam (same reasoning as stage 2 below): peak lr
               # = 0.35 * 64^-0.5 * 60^-0.5 ~ 5.6e-3 at step 60 of ~800
               "--lr_adam", "0.35", "--n_warmup_steps", "60"]
            + TINY_ASR + ["--device", device]
        )
        return {"wer": float(ab.test_stats["WER"]), "wall_s": round(time.time() - t0, 1),
                "device": device, "card": card}

    wer_asr = _cached(aout, _stage15)["wer"]
    print(f"[stage 1.5] tiny ASR WER on ORIGINAL audio (held-out speakers): {wer_asr:.1f}%")
    return acc_orig, wer_asr


def run_stage2(work, out_name, schedule, model_type="fcae", epochs=40,
               seed=0, grl_scale=None, lr_adam=0.55, n_warmup_steps=100,
               eval_only=False, extra_args=(), *, device="cuda"):
    """One adversarial anonymizer run on ``device`` against the cached stage-1
    evaluator and stage-1.5 ASR. Returns the test-stats triple as a plain
    dict. ``eval_only`` re-evaluates an existing run dir (checkpoint
    recovery); ``extra_args`` pass through to the recipe CLI (e.g.
    checkpoint selection overrides). A second call in the same ``out_name``
    resumes the newest checkpoint there (parameters, the normalizer, Noam's
    step, the epoch counter; Adam starts afresh) under its own schedule: the
    sweep's warm protocol."""
    from ..recipes import anonymizer

    t0 = time.time()
    root = os.path.join(work, "corpus")
    gout = os.path.join(work, "gender")
    aout = os.path.join(work, "asr")
    test_csv = os.path.join(root, "test-clean.csv")
    nout = os.path.join(work, out_name)
    extra = list(extra_args)
    if eval_only:
        extra += ["--eval_only"]
    if grl_scale is not None:
        extra += ["--grl_scale", str(grl_scale)]
    # scale-matched optimizer: the reference's Noam(warmup 25000) never
    # leaves warmup in a few-hundred-step run (lr ~1e-6 -> the AE would
    # stay at init and privacy would be trivially chance on garbage); raw-Noam
    # peak lr = lr_adam * d_model^-0.5 * warmup^-0.5 = 0.55*0.0036 ~ 2e-3.
    nb = anonymizer.main(
        [os.path.join(BASE, "convae.yaml")]
        + _common(root, nout)
        + ["--test_csv", f'["{test_csv}"]',
           "--batch_size", "8", "--number_of_epochs", str(epochs),
           "--model_type", model_type,
           "--seed", str(seed),
           "--lr_adam", str(lr_adam), "--n_warmup_steps", str(n_warmup_steps),
           "--adversarial_schedule", schedule,
           "--external_classifier_dir", os.path.join(gout, "save", "ckpts"),
           # attach the stage-1.5 ASR: Utility_Retention becomes the
           # encoder cosine and the test loop decodes BOTH feature sets
           # for the WER_orig / WER(anon) pair (the reference's
           # train_log triple — speechbrain_convae_train.py:168-183)
           "--asr_checkpoint_dir", os.path.join(aout, "save", "ckpts"),
           "--tokenizer_path", os.path.join(aout, "save", "tokenizer.json"),
           ]
        + TINY_ASR + extra + ["--device", device]
    )
    s = nb.test_stats
    out = {
        "acc_ext_orig": float(s["ACC_external_orig"]),
        "acc_ext_anon": float(s["ACC_external"]),
        "acc_internal": float(s["ACC"]),
        "utility": float(s["Utility_Retention"]),  # ASR-encoder cosine
        "wer_anon": float(s["WER"]),
        "wer_orig": float(s.get("WER_orig", float("nan"))),
    }
    sel = getattr(nb, "selected_ckpt_meta", None)
    if sel is not None:  # eval_ckpt_select=valid_frontier bookkeeping
        out["selected_epoch"] = int(sel.get("epoch", -1))
        out["selected_valid_acc_ext"] = float(sel.get("ACC_external", float("nan")))
        out["selected_valid_utility"] = float(sel.get("Utility_Retention", float("nan")))
        out["selected_pool_n"] = int(sel.get("pool_n", -1))
        out["selected_kept_n"] = int(sel.get("kept_n", -1))
    print(f"[stage 2 {out_name}] ACC_external orig={out['acc_ext_orig']:.3f} "
          f"anon={out['acc_ext_anon']:.3f} internal={out['acc_internal']:.3f} "
          f"utility={out['utility']:.3f} "
          f"WER orig={out['wer_orig']:.1f}% anon={out['wer_anon']:.1f}% ({time.time() - t0:.1f} s)")
    return out


# recon0.5/sex0.5 (the shipped fullyconn_updatedsexclassifier run).
# The stronger recon0.1/sex0.9 schedule was tried and collapses at
# this scale: the AE drifts so much per adversary phase that the
# averaged checkpoint keeps the sex cue fully readable (ACC_ext 0.997)
# while losing decodability (WER 46%).
BASELINE_SCHEDULE = (
    '[{"weights": {"recon": 0.5, "sex": 0.5, "utility": 0.0, "confusion": 0.0},'
    ' "train": "generator"},'
    ' {"weights": {"recon": 0.0, "sex": 0.5, "utility": 0.0, "confusion": 0.0},'
    ' "train": "sex_classifier"}]'
)


def main(argv: Sequence[str] | None = None, *, work: str | None = None) -> int:
    """``repro_gender_row [--device cuda|cpu]``: the stages, then the
    baseline anonymizer run ``anon``."""
    device, rest = parse_device(argv if argv is not None else sys.argv[1:])
    if rest:
        raise SystemExit(f"repro_gender_row takes only --device, not {rest}")
    work = work or archive_repro.WORK
    ensure_stages(work, device=device)
    run_stage2(work, "anon", BASELINE_SCHEDULE, device=device)
    # EXPERIMENTS.md is rendered from recorded sweep results by
    # write_experiments (the sweep driver round4_sweep appends every run to
    # the work dir's sweep_results.jsonl).
    return 0


if __name__ == "__main__":
    sys.exit(main())
