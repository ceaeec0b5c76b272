"""Vocoder-implementation sensitivity bound on the port.

Counterpart of ``scripts/vocoder_ab.py``: the pitch-norm recipe chain
(``recipes/gender_classifier_pitch_norm.py``) on the synthetic corpus TWICE,
once with the WORLD-class vocoder (``--pitch_method world``, the native
``native/world_vocoder.cc`` through ``data/pitch.py``) and once with the
structurally different TD-PSOLA resynthesis (``psola``), checking that the
downstream conclusion (gender ACC on pitch-normalized audio) does not depend
on the vocoder implementation. The vocoder runs on the host; the classifier
trains on the card unless ``--device cpu`` is given::

    python -m speech_anonymization_tpu_torch.scripts.vocoder_ab [--device cuda|cpu]

Appends one JSON line per method to the work dir's ``vocoder_ab.jsonl``; a
method already recorded there is skipped.
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
    """``vocoder_ab [--device cuda|cpu]``."""
    from ..recipes import gender_classifier_pitch_norm

    device, args = repro.parse_device(argv if argv is not None else sys.argv[1:])
    if args:
        raise SystemExit(f"vocoder_ab takes only --device, not {args}")
    work = work or archive_repro.WORK
    results_path = os.path.join(work, "vocoder_ab.jsonl")
    done = {}
    if os.path.exists(results_path):
        with open(results_path) as f:
            for line in f:
                r = json.loads(line)
                done[r["method"]] = r
    # stage 1 also anchors the ACC on ORIGINAL (non-pitch-normalized) audio
    acc_orig, _ = repro.ensure_stages(work, device=device)
    root = os.path.join(work, "corpus")
    test_csv = os.path.join(root, "test-clean.csv")
    card = card_name(device)

    for method in ("world", "psola"):
        if method in done:
            print(f"[skip] {method} already recorded: {done[method]}")
            continue
        out = os.path.join(work, f"pitch_{method}")
        t0 = time.time()
        gb = gender_classifier_pitch_norm.main(
            [os.path.join(repro.BASE, "gender_classifier_pitch_norm.yaml")]
            + repro._common(root, out)
            + ["--test_csv", test_csv, "--batch_size", "16",
               "--number_of_epochs", "8",
               "--pitch_method", method, "--device", device]
        )
        row = {
            "method": method,
            "acc_pitch_norm": 1.0 - float(gb.test_stats["error"]),
            "acc_orig_audio": acc_orig,
            "wall_s": round(time.time() - t0, 1),
            "device": device, "card": card,
        }
        done[method] = row
        with open(results_path, "a") as f:
            f.write(json.dumps(row) + "\n")
        archive_repro.archive(work, archive_dir)  # durable copy after EVERY row
        print(f"[vocoder_ab {method}] ACC on pitch-normalized audio = "
              f"{row['acc_pitch_norm']:.3f} (original-audio ACC {acc_orig:.3f})")

    if len(done) == 2:
        d = abs(done["world"]["acc_pitch_norm"] - done["psola"]["acc_pitch_norm"])
        print(f"[vocoder_ab] |ACC_world - ACC_psola| = {d:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
