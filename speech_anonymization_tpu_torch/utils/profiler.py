"""Spans inside the program, and trace capture around a window of training steps.

``span(name)`` marks where a layer's work happens: the test stage's batch
and its parts, the beam search's step and its parts, the training
micro-batch and its parts. It records only while ``torch.profiler`` (or the
autograd profiler) is on; otherwise it returns one shared object that does
nothing, so an untraced run pays one read of the profiler's flag a span::

    with span("decode.step"):
        with span("decode.ctc", device=True):
            ...

While the profiler is on, a span keeps its name, an id, its parent's and
its root's ids (the root is the outermost span: one test batch, one
micro-batch), ``time.perf_counter_ns()`` at entry and exit, and the time
its child spans cover (so its self time). It also enters
``torch.profiler.record_function(name)``, so wherever the profiler traces
the host (``TraceProfiler``, ``tools/profile_*.py``) the span shows in the
exported trace on the trace's own clock. With ``device=True`` it records a
CUDA event pair on the current stream (not while the stream captures a
CUDA graph); :meth:`Span.device_ms` reads the pair once the caller has
synchronised. The events come from a pool: a loop that opens device spans
calls :func:`reserve` before it, which creates what the pool lacks for the
loop, so no event is created inside the loop; a new recording takes the
last one's events back into the pool.

The spans stay in memory, in a buffer of at most ``MAX_SPANS`` a recording
that counts what it drops (:func:`dropped`); :func:`spans` gives the
recording's finished spans. A recording starts when a span first finds the
profiler on after finding it off.

``TraceProfiler``, on ``torch.profiler`` (CPU and, where a card is present,
CUDA activity), writes a Chrome trace under ``logdir``, the spans in it.
Wired into ``Brain.fit`` through hparams::

    profile_dir: /path/to/traces   # a trace of steps 10..20
    profile_start_step: 10
    profile_num_steps: 10
"""

from __future__ import annotations

import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler

MAX_SPANS = 1 << 17  # spans kept a recording


class _Off:
    """The span of an untraced run: enters and leaves, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span:
    """One recorded span (module docstring); made by :func:`span`."""

    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns", "child_ns", "_device", "_events", "_rf")

    def __init__(self, name: str, device: bool):
        self.name, self._device = name, device
        self.end_ns = None
        self.child_ns = 0
        self._events = None

    def __enter__(self):
        rec = _RECORDER
        rec.next_id += 1
        self.id = rec.next_id
        up = rec.stack[-1] if rec.stack else None
        self.parent, self.root = (up.id, up.root) if up is not None else (0, self.id)
        if len(rec.spans) < MAX_SPANS:
            rec.spans.append(self)
            if self._device and _can_record():
                self._events = rec.take()
        else:
            rec.dropped += 1
        rec.stack.append(self)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if self._events is not None:
            self._events[0].record()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record()
        self._rf.__exit__(*exc)
        self._rf = None
        rec = _RECORDER
        rec.stack.pop()
        if rec.stack:
            rec.stack[-1].child_ns += self.end_ns - self.start_ns
        return False

    @property
    def self_ns(self) -> int:
        """The span's duration less the time its child spans cover."""
        return self.end_ns - self.start_ns - self.child_ns

    def device_ms(self) -> float | None:
        """Device ms between the span's CUDA events, once both have completed
        (after the caller's synchronise); None for a span without events."""
        if self._events is None or self.end_ns is None or not self._events[1].query():
            return None
        return self._events[0].elapsed_time(self._events[1])


def _can_record() -> bool:
    return torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing()


class _Recorder:
    def __init__(self):
        self.spans: list[Span] = []
        self.stack: list[Span] = []
        self.dropped = 0
        self.next_id = 0
        self.off = True
        self._pool: list = []

    def restart(self) -> None:
        for s in self.spans:
            if s._events is not None:
                self._pool.extend(s._events)
                s._events = None
        self.spans, self.dropped = [], 0
        self.off = False

    def take(self) -> tuple:
        pool = self._pool
        return (pool.pop() if pool else torch.cuda.Event(enable_timing=True),
                pool.pop() if pool else torch.cuda.Event(enable_timing=True))

    def reserve(self, n: int) -> None:
        while len(self._pool) < 2 * n:
            event = torch.cuda.Event(enable_timing=True)
            event.record()  # the CUDA event is created at its first record
            self._pool.append(event)


_RECORDER = _Recorder()


def _recording() -> _Recorder | None:
    """The recorder while the profiler is on (a new recording after it was off); else None."""
    if not _autograd_profiler._is_profiler_enabled:
        _RECORDER.off = True
        return None
    if _RECORDER.off:
        _RECORDER.restart()
    return _RECORDER


def span(name: str, device: bool = False):
    """A context manager marking ``name``'s work (module docstring)."""
    if not _autograd_profiler._is_profiler_enabled:  # as _recording(), inline: the untraced path
        _RECORDER.off = True
        return _OFF
    if _RECORDER.off:
        _RECORDER.restart()
    return Span(name, device)


def reserve(n: int) -> None:
    """Make ready the CUDA events of ``n`` device spans before a loop opens
    them (module docstring); nothing while the profiler is off."""
    rec = _recording()
    if rec is not None and _can_record():
        rec.reserve(n)


def spans() -> list[Span]:
    """The recording's finished spans, in the order they were entered."""
    return [s for s in _RECORDER.spans if s.end_ns is not None]


def dropped() -> int:
    """Spans this recording entered and did not keep: the buffer was full."""
    return _RECORDER.dropped


class TraceProfiler:
    """``torch.profiler`` capture over a step window -> ``<logdir>/trace.json``."""

    def __init__(self, logdir: str, start_step: int = 10, num_steps: int = 10):
        self.logdir = logdir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof: torch.profiler.profile | None = None
        self._done = False

    def maybe_start(self, step: int):
        if not self._done and self._prof is None and step >= self.start_step:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.start()

    def maybe_stop(self, step: int):
        if self._prof is not None and step >= self.stop_step:
            self.close()

    def close(self):
        if self._prof is not None:
            self._prof.stop()
            os.makedirs(self.logdir, exist_ok=True)
            self._prof.export_chrome_trace(os.path.join(self.logdir, "trace.json"))
            self._prof = None
            self._done = True
