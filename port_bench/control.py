"""The readings the cells' limits are set from, for many seeds in one process.

    python -m port_bench.control --workload <cell> --seeds <n> [<n> ...] [--seconds <s>] [--control 0]

For each seed: the cell's set-up and a window of ``--seconds`` (0: none,
as a training cell needs), then the compared numbers twice: with the plain
reference as the benchmark's runs compute it (the program's reading), and
with the reference put in the program's place in the precision below the
configuration's (``control_precision``: TF32 operands for float32 products,
float8 e4m3 for the LM's bfloat16 ones), against the reference. One JSON
line a seed. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import run as bench
from .reference.numerics import EXACT, Precision


def readings(c: bench.Cell, seed: int, seconds: float, device: str, with_control: bool = True) -> dict:
    """-> {"program": numbers, "control": numbers} for one seed (without
    the control's where ``with_control`` is false)."""
    import torch

    entry = bench.entry_class(c.mix)(c.cfg, c.mix, seed, device)
    run = bench.Run(cfg=c.cfg)
    if seconds > 0:
        bench.window(entry, seconds, run)
    entry.release()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    program = entry.check(EXACT)
    t1 = time.perf_counter()
    out = {"seed": seed, "calls": len(run.calls), "program": program, "check_s": t1 - t0}
    if with_control:
        # the control's outputs replace what the timed calls kept, and the
        # same check compares them with the reference as the runs compute it
        entry.kept = entry.reference_outputs(Precision(**c.cfg["control_precision"]))
        out.update(control=entry.check(EXACT), control_s=time.perf_counter() - t1)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1, help="0: the program's readings alone")
    args = ap.parse_args(argv)
    c = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("port_bench.control needs a CUDA device", file=sys.stderr)
        return 2
    bench.prepare("cuda", c.cfg["host_threads"])
    for seed in args.seeds:
        print(json.dumps(readings(c, seed, args.seconds, "cuda", bool(args.control))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
