"""Attack-after-anonymization row on the port: RETRAIN a fresh gender
classifier ON the anonymized features of a swept variant and measure its
held-out accuracy (the gender_classifier recipe with
``configs/gender_classifier_recon.yaml``, the reference's
gender_classifier_train_recon.py).

Counterpart of ``scripts/attack_retrain.py``. A variant that only fools the
FIXED evaluator fails this test; one that removed the cue holds the
retrained attacker near chance::

    python -m speech_anonymization_tpu_torch.scripts.attack_retrain <variant> [seed] [frontier] [--device cuda|cpu]

With ``frontier`` the frozen anonymizer is the SAME valid_frontier checkpoint
the ``<variant>_frontier`` sweep row reports (instead of the default
max-utility one), and the row is recorded under ``<variant>_frontier``.
Appends one JSON line to the work dir's ``attack_results.jsonl``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Sequence

from ..utils.cuda_build import card_name
from . import archive_repro
from . import repro_gender_row as repro


def main(argv: Sequence[str] | None = None, *, work: str | None = None, archive_dir: str | None = None,
         epochs: int = 8, batch_size: int = 16) -> int:
    """``attack_retrain <variant> [seed] [frontier] [--device cuda|cpu]``;
    ``epochs`` and ``batch_size`` are the attacker's (the JAX script's 8 and 16)."""
    from ..recipes import gender_classifier

    device, args = repro.parse_device(argv if argv is not None else sys.argv[1:])
    if not args:
        raise SystemExit("usage: attack_retrain <variant> [seed] [frontier] [--device cuda|cpu]")
    variant = args[0]
    seed = args[1] if len(args) > 1 else "0"
    frontier = "frontier" in args[2:]
    work = work or archive_repro.WORK
    root = os.path.join(work, "corpus")
    test_csv = os.path.join(root, "test-clean.csv")
    anon_dir = os.path.join(work, f"anon_{variant}_s{seed}", "save", "ckpts")
    if not os.path.isdir(anon_dir):
        raise SystemExit(f"run round4_sweep {variant} first ({anon_dir})")
    # the sweep's variant specs record the model_type in sweep_results.jsonl
    model_type = "fcae"
    with open(os.path.join(work, "sweep_results.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            if r["variant"] == variant and str(r["seed"]) == seed:
                model_type = r["model_type"]
    tag = f"{variant}_frontier" if frontier else variant
    out = os.path.join(work, f"attack_{tag}_s{seed}")
    t0 = time.time()
    gb = gender_classifier.main(
        [os.path.join(repro.BASE, "gender_classifier_recon.yaml")]
        + repro._common(root, out)
        + ["--test_csv", test_csv, "--batch_size", str(batch_size),
           "--number_of_epochs", str(epochs),
           "--trained_recon_model_dir", anon_dir,
           "--recon_model_type", model_type]
        + (["--recon_ckpt_select", "valid_frontier"] if frontier else [])
        + ["--device", device]
    )
    row = {
        "variant": tag, "seed": int(seed), "model_type": model_type,
        "attack_acc": 1.0 - float(gb.test_stats["error"]),
        "wall_s": round(time.time() - t0, 1),
        "device": device, "card": card_name(device),
    }
    with open(os.path.join(work, "attack_results.jsonl"), "a") as f:
        f.write(json.dumps(row) + "\n")
    archive_repro.archive(work, archive_dir)  # durable copy after EVERY row
    print(f"[attack {tag} s{seed}] retrained-attacker ACC on anonymized "
          f"features = {row['attack_acc']:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
