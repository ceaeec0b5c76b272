"""Copy the pipeline's result files from the untracked work dir
(``save/repro_gender_row_torch/``) into the tracked ``artifacts/repro_torch/``.

Counterpart of ``scripts/archive_repro.py``: ``save/`` does not survive a
machine's end, and the result files are small JSON, so the durable copy is
committed. ``write_experiments`` falls back to the archive whenever the live
copy is absent::

    python -m speech_anonymization_tpu_torch.scripts.archive_repro   # then: git add artifacts/repro_torch
"""

from __future__ import annotations

import os
import shutil
import sys
from typing import Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WORK = os.path.join(REPO, "save", "repro_gender_row_torch")
ARCHIVE = os.path.join(REPO, "artifacts", "repro_torch")

FILES = [
    ("gender", "repro_stats.json"),
    ("asr", "repro_stats.json"),
    ("sweep_results.jsonl",),
    ("vocoder_ab.jsonl",),
    ("attack_results.jsonl",),
]


def archive(work: str | None = None, dest: str | None = None) -> list[str]:
    """Copy every present result file of ``work`` (default :data:`WORK`) to
    ``dest`` (default :data:`ARCHIVE`); the harnesses call it after every row
    they append. Returns the copies' paths relative to :data:`REPO`."""
    work, dest = work or WORK, dest or ARCHIVE
    copied = []
    for rel in FILES:
        src = os.path.join(work, *rel)
        if not os.path.exists(src):
            continue
        dst = os.path.join(dest, *rel)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copy2(src, dst)
        copied.append(os.path.relpath(dst, REPO))
    return copied


def main(argv: Sequence[str] | None = None, *, work: str | None = None, archive_dir: str | None = None) -> int:
    """``archive_repro`` (no arguments): :func:`archive`, then the list of copies."""
    if list(argv if argv is not None else sys.argv[1:]):
        raise SystemExit("usage: archive_repro (no arguments)")
    copied = archive(work, archive_dir)
    if copied:
        print("archived:\n  " + "\n  ".join(copied))
    else:
        print("nothing to archive (no result files under the work dir)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
