"""Re-evaluate a finished sweep run under valid_frontier checkpoint
selection, on the port: no retraining.

Counterpart of ``scripts/reeval_frontier.py``. The adversarial game
oscillates epoch to epoch, so end-of-run utility-top-k averaging can land on
a privacy-poor point; the frontier pick (``recipes/anonymizer.py``
``eval_ckpt_select``) selects the epoch whose VALID ACC_external is closest
to chance subject to a utility floor, and this script records the resulting
TEST row as a new variant ``<name>_frontier`` in the work dir's
``sweep_results.jsonl`` (with ``selected_pool_n``/``selected_kept_n``: the
pool is only the checkpoints the run kept)::

    python -m speech_anonymization_tpu_torch.scripts.reeval_frontier conf [seed] [--device cuda|cpu]

It stops (``SystemExit``) without recording when the row is already there,
and when the frontier branch did not run (no kept checkpoint carries the
frontier meta: the recipe then falls back to top-k averaging, which would
mislabel an ordinary evaluation).
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


def main(argv: Sequence[str] | None = None, *, work: str | None = None, archive_dir: str | None = None) -> int:
    """``reeval_frontier <variant> [seed] [--device cuda|cpu]``."""
    device, args = repro.parse_device(argv if argv is not None else sys.argv[1:])
    if not args:
        raise SystemExit("usage: reeval_frontier <variant> [seed] [--device cuda|cpu]")
    variant = args[0]
    seed = int(args[1]) if len(args) > 1 else 0
    work = work or archive_repro.WORK
    results_path = os.path.join(work, "sweep_results.jsonl")
    base = None
    with open(results_path) as f:
        for line in f:
            r = json.loads(line)
            if r["variant"] == variant and r["seed"] == seed:
                base = r
            if r["variant"] == f"{variant}_frontier" and r["seed"] == seed:
                raise SystemExit(f"[skip] {variant}_frontier seed={seed} already "
                                 "recorded — delete the row to re-run")
    if base is None:
        raise SystemExit(f"no recorded run for {variant} seed={seed}")
    t0 = time.time()
    out = repro.run_stage2(
        work, f"anon_{variant}_s{seed}", base["schedule"],
        model_type=base["model_type"],
        epochs=base["warm_epochs"] + base["epochs"], seed=seed,
        grl_scale=base.get("grl_scale"), lr_adam=base["lr_adam"],
        eval_only=True,
        extra_args=["--eval_ckpt_select", "valid_frontier"],
        device=device,
    )
    if "selected_epoch" not in out:
        raise SystemExit(f"ABORT: the frontier branch did not run for {variant} "
                         f"seed={seed} (no kept checkpoint has ACC_external/"
                         "Utility_Retention meta) — nothing recorded")
    row = dict(base)
    row.update(out)
    row["variant"] = f"{variant}_frontier"
    row["wall_s"] = round(time.time() - t0, 1)
    row["device"], row["card"] = device, card_name(device)
    with open(results_path, "a") as f:
        f.write(json.dumps(row) + "\n")
    archive_repro.archive(work, archive_dir)  # durable copy after EVERY row
    print(f"[recorded] {row['variant']} seed={seed} ({row['wall_s']}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
