"""What the metric readers share. A reader (``port_bench/metrics/<name>.py``)
defines ``read(run) -> float | None`` on a :class:`~port_bench.run.Run`:
the window's calls and their work, the set-up time, and in a traced run the
reduced trace and each recorded launch's work. A reader that finds nothing
to read returns None, and the metric is left out of the line."""

from __future__ import annotations

import re

import numpy as np

from . import work

GEMM = re.compile(r"gemm|cutlass|xmma|cublas|magma", re.I)
CONV = re.compile(r"conv|fprop|dgrad|wgrad|implicit_gemm|winograd", re.I)


def audio_rate(run) -> float | None:
    """Audio seconds of every call over the window's start to the last completion."""
    if not run.calls:
        return None
    return sum(c["audio_s"] for c in run.calls) / (run.calls[-1]["end"] - run.window_start)


def latency_quantile_ms(run, q: float) -> float | None:
    if not run.calls:
        return None
    return float(np.percentile([1e3 * (c["end"] - c["start"]) for c in run.calls], q))


def idle_share(run) -> float | None:
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(run) -> float | None:
    """Model FLOPs of the window's calls over the window's wall at the
    configuration's peak (``mfu_peak``: the fastest precision its timed path uses)."""
    if run.trace is None or not run.calls:
        return None
    flops = sum(c["flops"] for c in run.calls)
    return 100.0 * flops / ((run.calls[-1]["end"] - run.window_start) * work.PEAKS[run.cfg["mfu_peak"]])


def device_ms(run, pattern, exclude=None) -> float | None:
    if run.trace is None:
        return None
    ms = sum(d for n, _, d in run.trace.kernels if pattern.search(n) and not (exclude and exclude.search(n)))
    return ms * 1e-3 if ms else None


def per_decode_step(run, value) -> float | None:
    steps = sum(c.get("decode_steps", 0) for c in run.calls)
    return value / steps if value is not None and steps else None


def roofline(run, name: str, kernel) -> float | None:
    """Sum over the recorded window's launches of the kernel (its names
    matched by the pattern ``kernel``) of the least time their work needs,
    over the same launches' device time; None unless every traced launch
    has its recorded work."""
    if run.recorded is None:
        return None
    durs = [d for n, _, d in run.recorded.kernels if kernel.search(n)]
    launches = run.launch_work.get(name, [])
    if not durs or len(durs) != len(launches):
        return None
    least = sum(work.least_s(w["bytes"], w.get("flops", 0), w.get("tc_flops", 0), w.get("tf32_flops", 0))
                for w in launches)
    return 100.0 * least / (sum(durs) * 1e-6)
