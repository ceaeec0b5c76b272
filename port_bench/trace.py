"""The traced windows: ``torch.profiler`` over CUDA activity, reduced to the
device's kernels, its busy time and the longest idle gaps named by the
host's runtime call that spans them ("host" where none does); and, through
recorders set on the program's kernel entry points, each recorded launch's
own work.

The recorders keep references to each launch's arguments (a decode step's
mask, page table and parents, which the decode makes anew every step), so
they add no device work; the work is computed from them after the window
has closed. What they keep alive makes the allocator take new device memory
inside the window, so they run in a second, shorter traced window of their
own, which only the rooflines read.
"""

from __future__ import annotations

import bisect
import importlib
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field

import torch

TRACE_SECONDS = 15.0  # the traced window's most
RECORDED_SECONDS = 5.0  # the recorded window's most
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


@dataclass
class Trace:
    kernels: list = field(default_factory=list)   # (name, start us, duration us)
    host: list = field(default_factory=list)      # (name, start us, duration us)
    busy_s: float = 0.0
    window_s: float = 0.0
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


class Recorders:
    """Wrap the program's kernel entry points that the cell's roofline
    metrics name, keeping each launch's arguments. A metric's file names its
    entry point (``ENTRY``, ``module:function``) and defines ``keep(*args,
    **kwargs)``, what a launch keeps (None: not this kernel's launch), and
    ``work_of(kept, cfg)``, the launches' work once the window has closed."""

    def __init__(self, metrics: dict):
        self.metrics = {name: m for name, m in metrics.items() if hasattr(m, "ENTRY")}
        self.launches = {name: [] for name in self.metrics}
        self._undo = []

    def __enter__(self):
        for name, m in self.metrics.items():
            module_name, _, attr = m.ENTRY.partition(":")
            module = importlib.import_module(module_name)
            orig = getattr(module, attr)

            def wrapped(*args, _orig=orig, _keep=m.keep, _into=self.launches[name], **kwargs):
                kept = _keep(*args, **kwargs)
                if kept is not None:
                    _into.append(kept)
                return _orig(*args, **kwargs)

            setattr(module, attr, wrapped)
            self._undo.append((module, attr, orig))
        return self

    def __exit__(self, *exc):
        for module, attr, orig in reversed(self._undo):
            setattr(module, attr, orig)
        self._undo.clear()

    def work(self, cfg: dict) -> dict:
        """{metric: [work dict a launch]}."""
        return {name: m.work_of(self.launches[name], cfg) for name, m in self.metrics.items()}


def _union(intervals: list) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _host_name(host: list, starts: list, mid: float) -> str:
    """The innermost host activity that spans ``mid``."""
    best, best_dur = "host", float("inf")
    i = bisect.bisect_right(starts, mid)
    for name, s, d in host[max(0, i - 4000):i]:
        if s <= mid <= s + d and d < best_dur:
            best, best_dur = name, d
    return best


def _events(prof) -> list:
    """(category, name, start us, duration us) of every complete traced event,
    from the profiler's exported trace (in ``TMPDIR``, removed after)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return [(e.get("cat", ""), e.get("name", ""), float(e.get("ts", 0.0)), float(e.get("dur", 0.0)))
            for e in raw if e.get("ph") == "X"]


def profiled(fn, device) -> tuple[object, Trace]:
    """Run ``fn()`` under the profiler -> (its result, the reduced trace)."""
    from torch.profiler import ProfilerActivity, profile

    # on the card CUDA activity alone (kernels, copies and the runtime's
    # calls, which name the idle gaps): tracing the host's operators too
    # doubles the decode's wall and its idle share
    acts = [ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        result = fn()
        window_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    events = _events(prof)
    del prof
    t2 = time.perf_counter()
    tr = Trace(window_s=window_s)
    device_iv, by_name = [], {}
    for cat, name, ts, dur in events:
        if cat in DEVICE_CATS:
            device_iv.append((ts, ts + dur))
            by_name[name] = by_name.get(name, 0.0) + dur * 1e-6
            if cat == "kernel":
                tr.kernels.append((name, ts, dur))
        elif cat in HOST_CATS:
            tr.host.append((name, ts, dur))
    del events
    merged = _union(device_iv)
    tr.busy_s = sum(e - s for s, e in merged) * 1e-6
    tr.device_ops = sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:10]
    tr.host.sort(key=lambda h: h[1])
    starts = [h[1] for h in tr.host]
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)), reverse=True)[:10]
    tr.idle_gaps = [[_host_name(tr.host, starts, (s + e) / 2), g * 1e-6] for g, s, e in gaps]
    print(f"trace: {len(tr.kernels)} kernels; profiler stop {t1 - t0 - window_s:.1f} s, events read "
          f"{t2 - t1:.1f} s, reduced {time.perf_counter() - t2:.1f} s", file=sys.stderr)
    return result, tr
