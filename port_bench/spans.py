"""The program's spans (``speech_anonymization_tpu_torch/utils/profiler.py``)
in the traced window, for the readers of their durations and device times,
and placed on the window's trace clock for the readers that split the
device's idle time by what the host was doing.

The program records a span only while the profiler is on: its name, its id
and its parent's, ``time.perf_counter_ns()`` at entry and exit (the clock of
``run.calls``) and, for some, the device time between a CUDA event pair.
The window's spans are those whose times fall inside its calls; a recording
whose buffer dropped spans gives none. Durations and device times need no
placement. The idle split does: each timed call ends with a
``cudaDeviceSynchronize`` (the program itself never synchronises the
device), so the calls' ends are matched in order to those events' ends, and
the offset from ``perf_counter`` to the trace's clock is the median of the
per-call offsets, whose spread is printed on standard error.

Idle time here is the placed window less the union of its kernels: the
reduced trace keeps no copy or set intervals, so the time copies and sets
run outside every kernel (the kernels' idle less ``device_idle``'s) is
printed as its own line and left in the idle that the split shares out. An
idle instant is inside a name when a span of that name is open then; the
share outside is the rest of the same intervals. On standard error: the
placement, each name's spans, mean and self time and the idle time while it
is the innermost span open, and the ten longest idle gaps with the innermost
span (other than a root) that holds at least 90% of each, or where none does
the two spans at one depth that hold most of it.

A program without spans (none in the window, or no ``utils/profiler.py``, as
before the spans were added) gives nothing here: every reader returns None.
"""

from __future__ import annotations

import bisect
import statistics
import sys
import weakref
from dataclasses import dataclass, field

from .trace import _union

SYNC = "cudaDeviceSynchronize"
GAPS = 10  # the longest idle gaps printed
HELD = 0.9  # the share of a gap a span must hold to name it


@dataclass
class Window:
    """A traced window's spans, and where a clock places them, on the trace's clock (µs)."""
    spans: list
    names: dict = field(default_factory=dict)  # name -> [span index]
    times: list | None = None                  # (start, end) a span; None: no clock
    idle: list = field(default_factory=list)   # (start, end): no kernel running
    window_us: float = 0.0


_cache: list = [None, None]  # [weakref to the trace, Window or None]


def _profiler():
    try:
        from speech_anonymization_tpu_torch.utils import profiler
    except ImportError:
        return None
    return profiler


def program_spans() -> list:
    """The program's finished spans of its last recording; none where the
    program records no spans, or its buffer dropped some."""
    profiler = _profiler()
    get = getattr(profiler, "spans", None)
    if not callable(get):
        return []
    lost = getattr(profiler, "dropped", lambda: 0)()
    if lost:
        print(f"spans: the recording dropped {lost} spans (its buffer was full); none read", file=sys.stderr)
        return []
    return list(get())


def _sync_offset(run) -> tuple[float, list] | None:
    """µs to add to ``perf_counter`` µs for the trace's clock, and the
    per-call offsets: the calls' ends against the ``cudaDeviceSynchronize``
    events' ends, over the run of consecutive events that spreads least."""
    ends = sorted(ts + dur for name, ts, dur in run.trace.host if name == SYNC)
    calls = [c["end"] * 1e6 for c in run.calls]
    if len(ends) < len(calls):
        return None
    best = None
    for k in range(len(ends) - len(calls) + 1):
        offs = [ends[k + i] - c for i, c in enumerate(calls)]
        spread = max(offs) - min(offs)
        if best is None or spread < best[0]:
            best = (spread, offs)
    return statistics.median(best[1]), best[1]


def _idle(run, w0: float, w1: float) -> list:
    """The window's idle intervals (µs): no kernel running."""
    out, at = [], w0
    for ts, end in sorted((ts, ts + d) for _, ts, d in run.trace.kernels):
        if end <= at:
            continue
        if ts > at:
            out.append((at, min(ts, w1)))
        at = end
        if at >= w1:
            break
    if at < w1:
        out.append((at, w1))
    return [(a, b) for a, b in out if b > a]


def _innermost(times: list) -> list:
    """Segments (start, end, span index) in which each span is the innermost
    one open; spans nest (one host thread)."""
    order = sorted(range(len(times)), key=lambda i: (times[i][0], -times[i][1]))
    segs, stack = [], []
    at = None
    for i in order:
        s, e = times[i]
        while stack and times[stack[-1]][1] <= s:
            j = stack.pop()
            if at < times[j][1]:
                segs.append((at, times[j][1], j))
            at = max(at, times[j][1])
        if stack and at < s:
            segs.append((at, s, stack[-1]))
        stack.append(i)
        at = s
    while stack:
        j = stack.pop()
        if at < times[j][1]:
            segs.append((at, times[j][1], j))
        at = max(at, times[j][1])
    return segs


def _overlap(a: list, b: list) -> list:
    """Per segment of ``b`` (sorted, disjoint), the length ``a`` (sorted,
    disjoint intervals) covers of it."""
    out = [0.0] * len(b)
    i = 0
    for k, (s, e, *_) in enumerate(b):
        while i < len(a) and a[i][1] <= s:
            i += 1
        j = i
        while j < len(a) and a[j][0] < e:
            out[k] += min(e, a[j][1]) - max(s, a[j][0])
            j += 1
    return out


def placed(run) -> Window | None:
    """The traced window's spans, placed where a clock allows (computed once a trace)."""
    if run.trace is None or not run.calls:
        return None
    if _cache[0] is not None and _cache[0]() is run.trace:
        return _cache[1]
    _cache[0], _cache[1] = weakref.ref(run.trace), _place(run)
    return _cache[1]


def _place(run) -> Window | None:
    start, end = run.calls[0]["start"] * 1e9, run.calls[-1]["end"] * 1e9
    spans = [s for s in program_spans() if start <= s.start_ns and s.end_ns <= end]
    if not spans:
        return None
    out = Window(spans)
    for i, s in enumerate(spans):
        out.names.setdefault(s.name, []).append(i)
    sync = _sync_offset(run)
    if sync is None:
        print(f"spans: {len(spans)} in the window, no clock to place them on", file=sys.stderr)
        return out
    offset, offs = sync
    q = statistics.quantiles(offs, n=4) if len(offs) > 1 else [offs[0]] * 3
    print(f"spans: placed by the calls' synchronise, offset spread over {len(offs)} calls "
          f"max-min {max(offs) - min(offs):.1f} us, IQR {q[2] - q[0]:.1f} us", file=sys.stderr)
    out.times = [(s.start_ns * 1e-3 + offset, s.end_ns * 1e-3 + offset) for s in spans]
    w0 = run.window_start * 1e6 + offset
    out.window_us = run.trace.window_s * 1e6
    out.idle = _idle(run, w0, w0 + out.window_us)
    _report(run, out)
    return out


def _report(run, w: Window) -> None:
    spans, times = w.spans, w.times
    ids = {s.id: i for i, s in enumerate(spans)}
    parents = [ids.get(s.parent) for s in spans]
    segs = _innermost(times)
    own_idle = [0.0] * len(spans)
    for (_, _, i), v in zip(segs, _overlap(w.idle, segs)):
        own_idle[i] += v
    idle_us = sum(b - a for a, b in w.idle)
    copies_us = idle_us - (run.trace.window_s - run.trace.busy_s) * 1e6
    print(f"spans: {len(spans)} placed; no kernel running {100 * idle_us / w.window_us:.2f}% of "
          f"{w.window_us * 1e-6:.3f} s, {100 * (idle_us - sum(own_idle)) / w.window_us:.2f}% with no span open; "
          f"copies and sets outside every kernel {100 * copies_us / w.window_us:.2f}% (not placed)", file=sys.stderr)
    for name, idx in sorted(w.names.items()):
        self_ms = sum(getattr(spans[i], "self_ns", 0) for i in idx) * 1e-6
        print(f"span {name}: {len(idx)}, mean {statistics.fmean(times[i][1] - times[i][0] for i in idx) * 1e-3:.3f} "
              f"ms, self {self_ms:.1f} ms, idle while innermost {sum(own_idle[i] for i in idx) * 1e-3:.1f} ms "
              f"({100 * sum(own_idle[i] for i in idx) / w.window_us:.2f}% of the window)", file=sys.stderr)
    starts = sorted((t[0], i) for i, t in enumerate(times))
    keys = [s for s, _ in starts]
    for a, b in sorted(w.idle, key=lambda g: g[0] - g[1])[:GAPS]:
        # (share of the gap held, depth, name) of each span under a root that overlaps it
        held = [((min(b, times[i][1]) - max(a, times[i][0])) / (b - a), _depth(i, parents), spans[i].name)
                for _, i in starts[:bisect.bisect_left(keys, b)]]
        held = [h for h in held if h[0] > 0]
        open_ = sum(h[0] for h in held if h[1] == 0)  # roots do not overlap
        held = [h for h in held if h[1] > 0]
        full = [h for h in held if h[0] >= HELD]
        best = max(full, key=lambda h: h[1]) if full else max(held, default=None)
        where = f"{100 * best[0]:.1f}% inside {best[2]}" if best else "inside no span under a root"
        if best and not full:  # a gap across two spans: the next one at the same depth
            beside = max((h for h in held if h[1] == best[1] and h is not best), default=None)
            where += f" and {100 * beside[0]:.1f}% inside {beside[2]}" if beside else ""
        print(f"idle gap {(b - a) * 1e-3:.3f} ms: {where}, {100 * (1 - open_):.1f}% with no span open",
              file=sys.stderr)


def _depth(i: int, parents: list) -> int:
    d = 0
    while parents[i] is not None:
        i, d = parents[i], d + 1
    return d


def mean_ms(run, name: str) -> float | None:
    """The mean duration of the window's spans of ``name``, on the host's clock."""
    w = placed(run)
    if w is None or name not in w.names:
        return None
    return statistics.fmean(w.spans[i].end_ns - w.spans[i].start_ns for i in w.names[name]) * 1e-6


def device_ms_per(run, name: str, per: str) -> float | None:
    """The device ms between the CUDA events of the window's spans of
    ``name``, summed, over the number of its spans of ``per``; None unless
    every span of ``name`` has its reading."""
    w = placed(run)
    if w is None or name not in w.names or per not in w.names:
        return None
    got = [getattr(w.spans[i], "device_ms", lambda: None)() for i in w.names[name]]
    return None if None in got else sum(got) / len(w.names[per])


def _idle_split(run, name: str) -> tuple[float, float] | None:
    """% of the window with no kernel running and a span of ``name`` open,
    and the rest of the same idle intervals."""
    w = placed(run)
    if w is None or w.times is None or name not in w.names or run.trace.busy_s <= 0:
        return None
    inside = sum(_overlap(w.idle, _union([w.times[i] for i in w.names[name]])))
    outside = sum(b - a for a, b in w.idle) - inside
    return max(0.0, 100.0 * inside / w.window_us), max(0.0, 100.0 * outside / w.window_us)


def idle_inside(run, name: str) -> float | None:
    """% of the window in which no kernel ran and a span of ``name`` was open."""
    split = _idle_split(run, name)
    return split[0] if split else None


def idle_outside(run, name: str) -> float | None:
    """% of the window in which no kernel ran and no span of ``name`` was open."""
    split = _idle_split(run, name)
    return split[1] if split else None
