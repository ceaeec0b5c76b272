"""Stage-2 (anonymizer) schedule sweep on the port.

Counterpart of ``scripts/round4_sweep.py``: reuses the cached stage-1
evaluator and stage-1.5 tiny ASR of ``repro_gender_row`` (built on demand),
trains ONLY the anonymizer under each named variant and appends one JSON
line per run to the work dir's ``sweep_results.jsonl``; a (variant, seed)
already recorded there is skipped. Render the table with
``write_experiments``::

    python -m speech_anonymization_tpu_torch.scripts.round4_sweep baseline e2e_alt conf ... [--device cuda|cpu]
    python -m speech_anonymization_tpu_torch.scripts.round4_sweep baseline --seeds=0,1,2   # seed spread

As in the JAX script, a variant that raises is reported with its traceback
and the sweep goes on to the next one; unlike it, :func:`main` then exits
non-zero (``SystemExit`` naming the failed runs), so a fault on the card
never ends a sweep with exit code 0.

Variant design notes (the JAX script's):

* ``e2e`` reproduces the reference's 1_5_endtoend family: model_type=endtoend
  trains the generator DIRECTLY against the frozen external classifier (its
  loss subtracts the sex NLL), no internal adversary. Cold-started it
  collapses (the -sex NLL is unbounded); the ``*_warm`` variants mirror the
  reference's protocol (its endtoend runs RESUMED recon-pretrained models)
  with a recon-only warm phase resumed in place: the second run in the same
  output dir recovers the warm run's newest checkpoint (parameters, the
  normalizer, Noam's step, the epoch counter; no checkpoint of either
  package holds Adam's moments, so Adam starts afresh) and goes on under its
  own schedule. ``e2e_conf`` replaces the unbounded -sex term with the bounded
  drive-the-EXTERNAL-head-to-uniform confusion objective.
* ``conf``/``mix`` use NEGATIVE confusion weights: for GRL models the
  confusion gradient also passes through the gradient-reversal layer, so +w
  pushes the head output AWAY from uniform; -w drives it to uniform.
* ``grl4`` scales the reversed gradient 4x.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback
from typing import Sequence

from ..utils.cuda_build import card_name
from . import archive_repro
from . import repro_gender_row as repro

GEN = ('{"weights": {"recon": %s, "sex": %s, "utility": 0.0, "confusion": %s},'
       ' "train": "generator"}')
ADV = ('{"weights": {"recon": 0.0, "sex": 0.5, "utility": 0.0, "confusion": 0.0},'
       ' "train": "sex_classifier"}')
E2E = ('{"weights": {"recon": %s, "sex": %s, "utility": %s, "confusion": 0.0},'
       ' "train": "all"}')
E2EC = ('{"weights": {"recon": %s, "sex": %s, "utility": %s, "confusion": %s},'
        ' "train": "all"}')


def _sched(*phases):
    return "[" + ",".join(phases) + "]"


VARIANTS = {
    # the shipped reference schedule (fullyconn_updatedsexclassifier_recon0.5_sex0.5)
    "baseline": dict(schedule=_sched(GEN % (0.5, 0.5, 0.0), ADV)),
    # stronger internal adversary between generator moves
    "adv2": dict(schedule=_sched(GEN % (0.5, 0.5, 0.0), ADV, ADV)),
    "adv4": dict(schedule=_sched(GEN % (0.5, 0.5, 0.0), ADV, ADV, ADV, ADV)),
    # uniform-output objective (negative weight: see module docstring)
    "conf": dict(schedule=_sched(GEN % (0.5, 0.0, -0.5), ADV)),
    "mix": dict(schedule=_sched(GEN % (0.5, 0.25, -0.25), ADV)),
    # 4x reversed-gradient scale on the baseline schedule
    "grl4": dict(schedule=_sched(GEN % (0.5, 0.5, 0.0), ADV), grl_scale=4.0),
    # reference 1_5_endtoend family: train against the FROZEN external
    # classifier (conv recon model, no internal adversary).
    # COLD start collapses immediately (-sex NLL is unbounded: measured
    # epoch 2 valid loss 858, utility 0.36, ACC_ext pinned 0.50 on garbage
    # features) — kept short to record the negative. The reference never
    # ran it cold either: 1_5_endtoend resumed a recon-pretrained model
    # (results/1_5_endtoend/8886/train_log.txt starts from a loaded ckpt).
    "e2e": dict(schedule=_sched(E2E % (0.4, 0.6, 0.0)), model_type="endtoend",
                epochs=10),
    # warm variants mirror the reference's resume protocol: recon-only
    # pretrain in the SAME output dir, then continue with the adversarial
    # schedule (checkpointer resume carries params + Noam state across).
    "e2e_warm": dict(schedule=_sched(E2E % (0.4, 0.6, 0.0)), model_type="endtoend",
                     warm_epochs=10, epochs=15, lr_adam=0.25),
    # bounded alternative to the unbounded -sex NLL: drive the EXTERNAL
    # head's output to uniform (confusion = MSE(log-probs, ln 1/2), min at
    # uniform). endtoend _total subtracts w_conf*confusion, so the
    # uniform-driving direction is confusion = -0.5.
    "e2e_conf": dict(schedule=_sched(E2EC % (0.5, 0.0, 0.0, -0.5)),
                     model_type="endtoend", warm_epochs=6, epochs=19,
                     lr_adam=0.25),
    # reference 1_5_endtoend_resume_with_asr: sex-heavy with a utility
    # anchor, resumed from a recon model (here: warm phase)
    "e2e_util": dict(schedule=_sched(E2E % (0.2, 0.7, 0.1)), model_type="endtoend",
                     warm_epochs=10, epochs=15, lr_adam=0.25),
}


def main(argv: Sequence[str] | None = None, *, work: str | None = None, archive_dir: str | None = None,
         stages: dict | None = None, epochs: int | None = None,
         warm_epochs: int | None = None) -> int:
    """``round4_sweep <variant> ... [--seeds=0,1,2] [--device cuda|cpu]``.

    Returns 0 when every run requested was recorded or skipped; raises
    ``SystemExit`` (exit code 1) after the loop when any run failed.
    ``stages`` are keyword sizes for ``repro.ensure_stages``; ``epochs`` and ``warm_epochs``, when given, replace
    every variant's (``warm_epochs`` only where the variant has a warm
    phase), and the rows record what ran."""
    device, args = repro.parse_device(argv if argv is not None else sys.argv[1:])
    names = [a for a in args if not a.startswith("--")]
    seeds = [0]
    for a in args:
        if a.startswith("--seeds"):
            seeds = [int(s) for s in a.split("=", 1)[1].split(",")] if "=" in a else seeds
    work = work or archive_repro.WORK
    results_path = os.path.join(work, "sweep_results.jsonl")
    done = set()
    if os.path.exists(results_path):
        with open(results_path) as f:
            for line in f:
                r = json.loads(line)
                done.add((r["variant"], r["seed"]))

    acc_orig, wer_asr = repro.ensure_stages(work, device=device, **(stages or {}))
    card = card_name(device)
    failed = []

    for name in names:
        spec = dict(VARIANTS[name])
        for seed in seeds:
            if (name, seed) in done:
                print(f"[skip] {name} seed={seed} already recorded")
                continue
            t0 = time.time()
            out_name = f"anon_{name}_s{seed}"
            mt = spec.get("model_type", "fcae")
            warm = spec.get("warm_epochs", 0)
            if warm and warm_epochs is not None:
                warm = warm_epochs
            n_epochs = spec.get("epochs", 40) if epochs is None else epochs
            lr = spec.get("lr_adam", 0.55)
            try:
                if warm:
                    # recon-only pretrain in the same dir; the adversarial
                    # run below resumes it (reference resume protocol)
                    warm_sched = _sched(
                        E2E % (1.0, 0.0, 0.0) if mt == "endtoend"
                        else GEN % (1.0, 0.0, 0.0)
                    )
                    repro.run_stage2(
                        work, out_name, warm_sched, model_type=mt,
                        epochs=warm, seed=seed, lr_adam=lr, device=device,
                    )
                out = repro.run_stage2(
                    work, out_name, spec["schedule"], model_type=mt,
                    epochs=warm + n_epochs, seed=seed,
                    grl_scale=spec.get("grl_scale"), lr_adam=lr, device=device,
                )
            except Exception as e:  # record and keep sweeping; main fails at the end
                traceback.print_exc()
                print(f"[FAILED] {name} seed={seed}: {e!r}")
                failed.append(f"{name} seed={seed}: {e!r}")
                continue
            row = {
                "variant": name, "seed": seed,
                "model_type": mt,
                "epochs": n_epochs,
                "warm_epochs": warm,
                "lr_adam": lr,
                "grl_scale": spec.get("grl_scale"),
                "schedule": spec["schedule"],
                "acc_orig": acc_orig, "wer_asr": wer_asr,
                "wall_s": round(time.time() - t0, 1),
                **out,
                "device": device, "card": card,
            }
            with open(results_path, "a") as f:
                f.write(json.dumps(row) + "\n")
            archive_repro.archive(work, archive_dir)  # durable copy after EVERY row
            print(f"[recorded] {name} seed={seed} ({row['wall_s']}s)")

    if failed:
        raise SystemExit("round4_sweep: " + str(len(failed)) + " run(s) failed:\n  " + "\n  ".join(failed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
