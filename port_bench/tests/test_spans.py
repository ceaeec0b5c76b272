"""``port_bench/spans.py`` and the readers of the program's spans: the
placement on synthetic traces with a known offset, the idle split against
``idle_share`` and the copies' share, durations without a clock, nothing
without spans or from a recording that dropped some, and a whole traced CPU
run of each cell that reads them."""

import sys
from types import SimpleNamespace

import pytest

from port_bench import run as bench
from port_bench import spans as placing
from port_bench.readers import idle_share
from port_bench.trace import Trace

from . import tiny

OFF = -99_000_000.0  # the trace's µs less perf_counter's
READERS = ("host_ms_per_step.eval", "ctc_ms_per_step.eval", "idle_in_decode.eval", "idle_outside_decode.eval",
           "optimizer_ms_per_update.train", "idle_in_optimizer.train")


class FakeSpan:
    def __init__(self, name, id_, parent, start_s, end_s, device_ms=None):
        self.name, self.id, self.parent = name, id_, parent
        self.start_ns, self.end_ns = round(start_s * 1e9), round(end_s * 1e9)
        self.self_ns, self._device_ms = 0, device_ms

    def device_ms(self):
        return self._device_ms


def us(t_s: float) -> float:
    """perf_counter seconds on the trace's clock."""
    return t_s * 1e6 + OFF


# two calls of 10 ms from t = 100 s; kernels (perf s) and spans as the program records them
KERNELS = [(100.0, 100.0015), (100.003, 100.005), (100.009, 100.012), (100.014, 100.02)]
# (a step's two CTC spans, its scoring and its advance, as the beam search has them in its first step)
SPANS = [FakeSpan("eval.batch", 1, 0, 100.0, 100.0095), FakeSpan("decode", 2, 1, 100.001, 100.006),
         FakeSpan("decode.step", 3, 2, 100.002, 100.004), FakeSpan("decode.ctc", 4, 3, 100.0025, 100.003, 0.5),
         FakeSpan("decode.ctc", 5, 3, 100.0035, 100.0038, 0.125),
         FakeSpan("eval.batch", 6, 0, 100.01, 100.0195), FakeSpan("decode", 7, 6, 100.011, 100.013),
         FakeSpan("decode.step", 8, 7, 100.011, 100.0125), FakeSpan("decode.ctc", 9, 8, 100.0115, 100.012, 0.25),
         FakeSpan("train.optimizer", 10, 0, 99.0, 99.5)]  # before the window: left out


def synthetic_run(host) -> bench.Run:
    run = bench.Run(cfg={})
    run.window_start = 100.0
    run.calls = [{"start": 100.0, "end": 100.01}, {"start": 100.01, "end": 100.02}]
    run.trace = Trace(kernels=[("k", us(a), (b - a) * 1e6) for a, b in KERNELS], host=host,
                      busy_s=sum(b - a for a, b in KERNELS), window_s=0.02)
    return run


def syncs(jitter_us: float = 12.0) -> list:
    """A synchronise before the window, one ending each call, and the profiler's own after."""
    ends = [us(99.9), us(100.01) + jitter_us, us(100.02), us(100.0205)]
    return [("cudaDeviceSynchronize", e - 3.0, 3.0) for e in ends]


@pytest.fixture
def program(monkeypatch):
    got = list(SPANS)
    monkeypatch.setattr(placing, "program_spans", lambda: got)
    return got


def test_sync_placement_and_the_idle_split(program, capsys):
    run = synthetic_run(syncs())
    # idle in the window: 1.5-3.0, 5.0-9.0 and 12.0-14.0 ms (7.5 of 20 ms);
    # with a decode open: 1.5-3.0, 5.0-6.0 and 12.0-13.0 ms (3.5)
    # (the 12 µs jitter of one call's end moves the placement by 6 µs: 0.03%
    # of the window a span boundary)
    inside, outside = placing.idle_inside(run, "decode"), placing.idle_outside(run, "decode")
    assert placing.placed(run).times is not None
    assert inside == pytest.approx(17.5, abs=0.1) and outside == pytest.approx(20.0, abs=0.1)
    assert inside + outside == pytest.approx(idle_share(run), abs=0.04)
    assert placing.mean_ms(run, "decode.step") == pytest.approx(1.75)
    assert placing.mean_ms(run, "decode") == pytest.approx(3.5)
    # three CTC spans over two steps
    assert placing.device_ms_per(run, "decode.ctc", "decode.step") == pytest.approx(0.875 / 2)
    assert placing.mean_ms(run, "train.optimizer") is None  # outside the window
    err = capsys.readouterr().err
    assert "offset spread over 2 calls max-min 12.0 us" in err
    assert "idle gap 1.500 ms: 100.0% inside decode" in err and "idle gap 4.000 ms: 25.2% inside decode" in err


def test_a_gap_across_two_spans_names_both(program, capsys):
    # the WER's alignment after the first decode: 6.2-9.4 ms, so the 5.0-9.0
    # ms gap lies 25% inside the decode and 70% inside it, none 90%
    program.append(FakeSpan("eval.wer", 11, 1, 100.0062, 100.0094))
    assert placing.placed(synthetic_run(syncs(0.0))) is not None
    assert "idle gap 4.000 ms: 70.0% inside eval.wer and 25.0% inside decode," in capsys.readouterr().err


def test_the_split_sums_to_idle_share_on_every_name(program):
    run = synthetic_run(syncs(0.0))
    for name in ("eval.batch", "decode", "decode.step", "decode.ctc"):
        assert placing.idle_inside(run, name) + placing.idle_outside(run, name) == pytest.approx(idle_share(run))
    assert placing.idle_inside(run, "eval.batch") == pytest.approx(100 * (1.5 + 4.0 + 2.0) / 20)
    # a step's two CTC spans: idle 2.5-3.0 ms under the first, none under the second
    assert placing.idle_inside(run, "decode.ctc") == pytest.approx(100 * 0.5 / 20)


def test_copies_and_sets_stay_in_the_kernels_idle_and_print_their_share(program, capsys):
    # 0.7 ms of copies and sets outside every kernel: device_idle counts them
    # busy, and the trace keeps no interval to place them by
    run = synthetic_run(syncs(0.0))
    run.trace.busy_s += 0.0007
    inside, outside = placing.idle_inside(run, "decode"), placing.idle_outside(run, "decode")
    assert inside == pytest.approx(17.5) and outside == pytest.approx(20.0)
    assert inside + outside == pytest.approx(idle_share(run) + 3.5)
    assert "copies and sets outside every kernel 3.50% (not placed)" in capsys.readouterr().err


def test_readers_by_name_read_the_spans(program):
    run = synthetic_run(syncs(0.0))
    got = {name: bench.reader(name)(run) for name in READERS}
    assert got["host_ms_per_step.eval"] == pytest.approx(1.75)
    assert got["ctc_ms_per_step.eval"] == pytest.approx(0.4375)
    assert got["idle_in_decode.eval"] + got["idle_outside_decode.eval"] == pytest.approx(idle_share(run))
    assert got["optimizer_ms_per_update.train"] is None and got["idle_in_optimizer.train"] is None


def test_a_span_without_its_device_reading_leaves_the_ctc_reader_out(program, monkeypatch):
    monkeypatch.setattr(program[4], "_device_ms", None)
    assert bench.reader("ctc_ms_per_step.eval")(synthetic_run(syncs(0.0))) is None


def test_nothing_without_spans(monkeypatch):
    import speech_anonymization_tpu_torch.utils as utils

    # a program without utils/profiler.py
    monkeypatch.delattr(utils, "profiler", raising=False)
    monkeypatch.setitem(sys.modules, "speech_anonymization_tpu_torch.utils.profiler", None)
    assert placing.program_spans() == []
    run = synthetic_run(syncs())
    assert all(bench.reader(name)(run) is None for name in READERS)
    monkeypatch.setattr(placing, "program_spans", lambda: [])
    assert all(bench.reader(name)(synthetic_run(syncs())) is None for name in READERS)


@pytest.mark.parametrize("lost", [0, 3])
def test_a_recording_that_dropped_spans_gives_none(monkeypatch, capsys, lost):
    monkeypatch.setattr(placing, "_profiler", lambda: SimpleNamespace(spans=lambda: SPANS, dropped=lambda: lost))
    run = synthetic_run(syncs(0.0))
    got = {name: bench.reader(name)(run) for name in READERS}
    if lost:
        assert placing.program_spans() == [] and all(v is None for v in got.values())
        assert "dropped 3 spans" in capsys.readouterr().err
    else:
        assert placing.program_spans() == SPANS and got["host_ms_per_step.eval"] == pytest.approx(1.75)


def test_durations_need_no_clock_and_the_idle_split_does(program, capsys):
    run = synthetic_run([("cudaDeviceSynchronize", us(100.02), 1.0)])  # fewer synchronises than calls
    got = {name: bench.reader(name)(run) for name in READERS}
    assert got["host_ms_per_step.eval"] == pytest.approx(1.75) and got["ctc_ms_per_step.eval"] == pytest.approx(0.4375)
    assert got["idle_in_decode.eval"] is None and got["idle_outside_decode.eval"] is None
    assert "no clock to place them on" in capsys.readouterr().err


@pytest.mark.parametrize("name,reads", [("asr_lm.eval_d2", "host_ms_per_step.eval"),
                                        ("convae.train_b8", "optimizer_ms_per_update.train")])
def test_a_traced_cpu_run_reads_the_spans(name, reads, capsys):
    """On the CPU the trace holds no synchronise and no kernels, so the host
    times read and the idle shares do not."""
    result, _ = bench.run_cell(tiny.cell(name), 7, 1.0, True, "cpu")
    assert result["correct"], result["checks"]
    assert result["metrics"][reads]["value"] > 0
    # no kernels and no CUDA events on the CPU
    assert not [m for m in result["metrics"] if m.startswith(("idle_", "ctc_"))]
    assert "spans:" in capsys.readouterr().err
