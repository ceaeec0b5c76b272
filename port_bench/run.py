"""The benchmark of ``speech_anonymization_tpu_torch`` on NVIDIA cards.

    python -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json`` ``workloads``)
names a configuration (``port_bench/configs/<config>.json``) and a traffic
mix (``port_bench/traffic/<mix>.json``); the mix names the program's entry
that it drives (``port_bench/entries/<entry>.py``); ``port_bench/cells/
<cell>.json`` holds the cell's limits on the compared numbers; each metric
is read by ``port_bench/metrics/<metric>.py``. A new configuration, mix,
cell or metric is a new file and a new ``BENCHMARK.json`` entry.

A run: builds (first run of a checkout) or loads the port's kernels into
``build/``, draws weights and inputs from the seed on the card, warms the
mix's shapes (all of it ``setup_s``), then calls the entry in a closed loop
for ``--seconds`` (each call ended by a synchronise); with ``--trace 1``
for at most ``port_bench.trace.TRACE_SECONDS``, under the profiler, and
then, where the cell has a roofline metric, for at most
``port_bench.trace.RECORDED_SECONDS`` more with the kernels' launches
recorded (``port_bench.trace.Recorders``), which only the rooflines read. After
the window it refuses to report if the process holds JAX or the JAX
package, frees the program's state, recomputes what
the timed calls produced with the plain reference
(``port_bench/reference``) and prints each compared number beside its limit
on standard error, then one JSON line on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and ``breakdown``, and
the compared numbers last (``checks``). No card, or fewer than the cell
asks for: exit 2 and no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "speech_anonymization_tpu")


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules, compared whole, that the run may not hold."""
    return sorted({name.partition(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` as ``BENCHMARK.json`` and its files define it."""
    bench = load_json(root / "BENCHMARK.json")
    w = next(w for w in bench["workloads"] if w["name"] == name)
    here = root / "port_bench"

    def metrics(kind):
        return [(m["name"], m["unit"]) for m in bench[kind] if name in m.get("workloads", [name])]

    return Cell(name, int(w["chips"]), load_json(here / "configs" / f"{w['config']}.json"),
                load_json(here / "traffic" / f"{w['traffic']}.json"),
                load_json(here / "cells" / f"{name}.json")["limits"], metrics("end_to_end"), metrics("per_layer"))


def metric(name: str):
    """The module of ``port_bench/metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name.replace('.', '_')}",
                                                  HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(name: str):
    return metric(name).read


@dataclass
class Run:
    cfg: dict
    setup_s: float = 0.0
    window_start: float = 0.0
    calls: list = field(default_factory=list)
    trace: object = None
    recorded: object = None
    launch_work: dict = field(default_factory=dict)


def entry_class(mix: dict):
    return importlib.import_module(f"port_bench.entries.{mix['entry']}").Entry


def window(entry, seconds: float, run: Run) -> None:
    """Call the entry in a closed loop until ``seconds`` have passed; each
    call runs to its end (its synchronise) and counts."""
    run.window_start = time.perf_counter()
    i = 0
    while time.perf_counter() - run.window_start < seconds:
        start = time.perf_counter()
        unit = entry.call(i)
        run.calls.append({**unit, "start": start, "end": time.perf_counter()})
        i += 1


def prepare(device: str, threads: int = 2) -> None:
    """TF32 off, as the configurations state; ``threads`` CPU threads for
    PyTorch's operators (the configuration's ``host_threads``); the kernels
    built or loaded; every cache in fixed directories of the checkout."""
    import torch

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(threads)
    if device == "cuda":
        from speech_anonymization_tpu_torch.utils import cuda_build

        cuda_build.build()


def run_cell(c: Cell, seed: int, seconds: float, trace: bool, device: str) -> tuple[dict, dict]:
    """One run of cell ``c`` on ``device`` -> (result line, compared numbers)."""
    import torch

    from . import trace as tracing
    from .reference.numerics import EXACT

    prepare(device, c.cfg["host_threads"])
    entry = entry_class(c.mix)(c.cfg, c.mix, seed, device)
    run = Run(cfg=c.cfg)
    segments = 0
    if device == "cuda":
        torch.cuda.synchronize()
        segments = torch.cuda.memory_stats().get("segment.all.allocated", 0)
    run.setup_s = time.perf_counter() - T_START
    if trace:
        # a short steady window: the trace of a whole one holds millions of
        # events, and reading them takes minutes
        _, run.trace = tracing.profiled(lambda: window(entry, min(seconds, tracing.TRACE_SECONDS), run), device)
    else:
        window(entry, seconds, run)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if device == "cuda":
        segments = torch.cuda.memory_stats().get("segment.all.allocated", 0) - segments
    if trace:
        # the rooflines' own window, each launch's arguments kept
        with tracing.Recorders({name: metric(name) for name, _ in c.per_layer}) as rec:
            if rec.metrics:
                _, run.recorded = tracing.profiled(
                    lambda: window(entry, min(seconds, tracing.RECORDED_SECONDS), Run(cfg=c.cfg)), device)
        run.launch_work = rec.work(c.cfg)
    walls = sorted(c_["end"] - c_["start"] for c_ in run.calls)
    if walls:
        print(f"calls {len(walls)}: wall s min {walls[0]:.4f} median {walls[len(walls) // 2]:.4f} "
              f"max {walls[-1]:.4f}; device memory segments allocated in the window {segments}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the run holds {', '.join(found)} after the window; no result")
    names = c.per_layer if trace else c.end_to_end
    metrics = {}
    for name, unit in names:
        value = reader(name)(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    device_info = {"platform": "gpu" if device == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                   "count": c.chips, "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": len(run.calls), "failed": 0, "metrics": metrics, "device": device_info}
    if trace:
        device_info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = {"device_ops": run.trace.device_ops, "idle_gaps": run.trace.idle_gaps}
    run.trace = run.recorded = None
    run.launch_work.clear()
    entry.release()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    gaps = entry.check(EXACT)
    print(f"the reference's check took {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    # a number the cell's limits name and the check did not give counts as failed
    checks = {k: {"value": gaps.get(k, float("inf")), "limit": c.limits.get(k)} for k in {**gaps, **c.limits}}
    bad = [k for k, v in checks.items() if v["limit"] is None or not (v["value"] <= v["limit"])
           or not math.isfinite(v["value"])]
    result.update(correct=not bad, failed=len(bad), checks=checks)
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    c = cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"port_bench: {args.workload} needs {c.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, checks = run_cell(c, args.seed, args.seconds, bool(args.trace), "cuda")
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
