"""The port's spans (``speech_anonymization_tpu_torch/utils/profiler.py``) on the CPU:
nothing recorded or called while the profiler is off; names, nesting, ids and
self times while it is on, and the same names in the exported trace; the
beam search's step and its five parts; the training micro-batch and its
optimizer span; the buffer's bound; the device spans' event pool;
``TraceProfiler``'s trace."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from speech_anonymization_tpu_torch.decoding import BeamSearchConfig, beam_search
from speech_anonymization_tpu_torch.recipes.anonymizer import AnonymizerTrainer
from speech_anonymization_tpu_torch.train.brain import Brain
from speech_anonymization_tpu_torch.train.schedulers import NoamScheduler
from speech_anonymization_tpu_torch.utils import profiler
from speech_anonymization_tpu_torch.utils.profiler import span

STEP_PARTS = ("decode.decoder", "decode.lm", "decode.ctc", "decode.topk", "decode.reorder")
V, T_ENC, MAX_STEPS, BATCH, BEAM = 12, 7, 6, 2, 3


def _table_cached(table: torch.Tensor) -> tuple:
    """A (V_prev, S, V) logit table as a cached decoder (the state is the table)."""
    return (lambda n, u_max: table,
            lambda state, prev, step: (state[prev, step], state),
            lambda state, parent, step: state)


def _toy_decode(seed: int = 0):
    """A beam search with joint CTC and an LM over random logit tables."""
    rng = np.random.default_rng(seed)
    att, lm = (torch.from_numpy(rng.standard_normal((V, MAX_STEPS, V)).astype(np.float32) * 2) for _ in range(2))
    ctc = torch.from_numpy(np.log(rng.dirichlet(np.ones(V), size=(BATCH, T_ENC))).astype(np.float32))
    cfg = BeamSearchConfig(beam_size=BEAM, ctc_weight=0.4, lm_weight=0.6, temperature=1.15, temperature_lm=1.15,
                           length_normalization=True)
    return beam_search(_table_cached(att), torch.zeros((BATCH, T_ENC, 4)), torch.tensor([1.0, 0.6]), ctc, cfg,
                       max_steps=MAX_STEPS, lm_cached=_table_cached(lm))


def _traced(fn):
    """``fn()`` under the profiler with CPU activity, as a recording of its own
    (a span finds the profiler off first) -> (result, the profiler)."""
    with span("outside"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _count(name: str) -> int:
    return sum(s.name == name for s in profiler.spans())


def _annotations(prof, tmp_path) -> list:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e["name"] for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def test_off_records_nothing_and_calls_nothing(monkeypatch):
    """Off: one shared object, no span made, no CUDA event, stream query or
    ``record_function``; a whole decode runs through the spans that way."""
    assert not torch.autograd.profiler._is_profiler_enabled
    rec = profiler._RECORDER
    before = (list(rec.spans), rec.next_id, list(rec._pool), rec.dropped)

    def refused(*a, **k):
        raise AssertionError("called with the profiler off")

    monkeypatch.setattr(profiler, "Span", refused)
    monkeypatch.setattr(torch.cuda, "Event", refused)
    monkeypatch.setattr(torch.cuda, "is_initialized", refused)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", refused)
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    profiler.reserve(100)
    first = span("decode.step")
    assert span("decode.ctc", device=True) is first and span("eval.batch") is first
    with first as entered:
        assert entered is first
    _toy_decode()
    assert (list(rec.spans), rec.next_id, list(rec._pool), rec.dropped) == before


def test_on_records_nesting_ids_self_times_and_trace_names(tmp_path):
    def work():
        with span("eval.batch"):
            with span("eval.anonymize"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            with span("eval.similarity"):
                with span("eval.wer"):
                    sum(range(10000))
        with span("train.micro_batch"):
            pass

    _, prof = _traced(work)
    got = profiler.spans()
    assert [s.name for s in got] == ["eval.batch", "eval.anonymize", "eval.similarity", "eval.wer",
                                     "train.micro_batch"]
    batch, anon, sim, wer, micro = got
    assert (batch.parent, batch.root) == (0, batch.id)
    assert (anon.parent, anon.root) == (batch.id, batch.id)
    assert (sim.parent, sim.root) == (batch.id, batch.id)
    assert (wer.parent, wer.root) == (sim.id, batch.id)
    assert (micro.parent, micro.root) == (0, micro.id)
    assert len({s.id for s in got}) == 5
    for s in got:
        assert s.start_ns <= s.end_ns and s.device_ms() is None
    assert batch.start_ns <= anon.start_ns <= anon.end_ns <= sim.start_ns <= wer.start_ns <= wer.end_ns
    assert wer.end_ns <= sim.end_ns <= batch.end_ns <= micro.start_ns
    assert batch.self_ns == batch.end_ns - batch.start_ns - (anon.end_ns - anon.start_ns) - (sim.end_ns - sim.start_ns)
    assert sim.self_ns == sim.end_ns - sim.start_ns - (wer.end_ns - wer.start_ns)
    assert wer.self_ns == wer.end_ns - wer.start_ns
    assert sorted(_annotations(prof, tmp_path)) == sorted(s.name for s in got)


def test_beam_search_records_each_step_and_its_five_parts():
    _traced(_toy_decode)
    got = profiler.spans()
    steps = [s for s in got if s.name == "decode.step"]
    assert len(steps) == MAX_STEPS
    for step in steps:
        assert step.parent == 0 and step.root == step.id
        children = [s for s in got if s.parent == step.id]
        assert sorted(s.name for s in children) == sorted(STEP_PARTS)
        # the advance of the chosen prefixes' CTC state, inside the reorder
        reorder = next(s for s in children if s.name == "decode.reorder")
        assert [s.name for s in got if s.parent == reorder.id] == ["decode.ctc"]
    assert _count("decode.ctc") == 2 * MAX_STEPS
    # no card: the CTC span keeps no device events
    assert all(s.device_ms() is None for s in got if s.name == "decode.ctc")


def test_decode_is_bit_identical_with_spans_on_and_off():
    off = _toy_decode(3)
    on, _ = _traced(lambda: _toy_decode(3))
    assert _count("decode.step") == MAX_STEPS
    for a, b in zip(off, on):
        assert torch.equal(a, b)


@pytest.fixture
def trainer():
    hp = {"model_type": "convae", "gradient_accumulation": 3, "gradient_clipping": 5.0, "seed": 0,
          "noam_annealing": NoamScheduler(1e-3, 1, 1)}
    return AnonymizerTrainer(hp, device="cpu")


def _batch(i: int):
    g = torch.Generator().manual_seed(i)
    return torch.randn(2, 3200, generator=g) * 0.1, torch.ones(2), torch.tensor([0, 1])


def test_optimizer_span_only_on_the_stepping_micro_batch(trainer):
    def three():
        return [trainer.fit_batch(_batch(i), 0) for i in range(3)]

    _traced(three)
    got = profiler.spans()
    roots = [s for s in got if s.name == "train.micro_batch"]
    assert len(roots) == 3 and all(s.parent == 0 for s in roots)
    for i, root in enumerate(roots):
        children = [s.name for s in got if s.parent == root.id]
        want = ["train.forward", "train.backward", "train.accumulate"] + (["train.optimizer"] if i == 2 else [])
        assert children == want
        assert all(s.root == root.id for s in got if s.parent == root.id)
    assert _count("train.optimizer") == 1


def test_buffer_keeps_its_bound_and_counts_drops(monkeypatch):
    monkeypatch.setattr(profiler, "MAX_SPANS", 5)

    def eight():
        with span("decode"):
            for _ in range(7):
                with span("decode.step"):
                    pass

    _traced(eight)
    assert len(profiler.spans()) == 5 and profiler.dropped() == 3
    # the kept ones nest as they did: the dropped spans still had their parent
    kept = profiler.spans()
    assert all(s.parent == kept[0].id for s in kept[1:])


def test_a_new_recording_starts_after_the_profiler_was_off():
    def one():
        with span("eval.batch"):
            pass

    _traced(one)
    first = profiler.spans()
    with profile(activities=[ProfilerActivity.CPU]):  # the same recording: not seen off
        one()
    assert [s.name for s in profiler.spans()] == ["eval.batch"] * 2 and profiler.spans()[0] is first[0]
    with span("eval.batch"):  # seen off
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        one()
    assert [s.name for s in profiler.spans()] == ["eval.batch"] and profiler.spans()[0] is not first[0]
    assert profiler.dropped() == 0


class _FakeEvent:
    """A CUDA event on the CPU: made, recorded, completed at once."""
    made = 0

    def __init__(self, enable_timing=False):
        type(self).made += 1
        self.at = None

    def record(self, stream=None):
        self.at = _FakeEvent.clock = getattr(_FakeEvent, "clock", 0.0) + 1.0

    def query(self):
        return True

    def elapsed_time(self, end):
        return end.at - self.at


@pytest.fixture
def fake_events(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    _FakeEvent.made = 0
    yield
    rec = profiler._RECORDER  # no fake event left in the pool
    rec.restart()
    rec._pool.clear()


def test_device_spans_take_reserved_events_and_a_new_recording_takes_them_back(fake_events):
    """``reserve`` makes the events before a loop, so a loop of device spans
    makes none; the next recording reuses the last one's events."""

    def loops():
        for _ in range(3):
            profiler.reserve(4)
            made = _FakeEvent.made
            for _ in range(4):
                with span("decode.ctc", device=True):
                    pass
            assert _FakeEvent.made == made  # none made inside the loop

    _traced(loops)
    got = profiler.spans()
    assert len(got) == 12 and _FakeEvent.made == 24
    assert all(s.device_ms() == 1.0 for s in got)
    _traced(loops)
    assert _FakeEvent.made == 24 and all(s.device_ms() == 1.0 for s in profiler.spans())
    assert got[0].device_ms() is None  # its events went back to the pool


def test_trace_profiler_trace_shows_the_spans(trainer, tmp_path):
    class Fit(Brain):
        def fit_batch(self, batch, epoch):
            return trainer.fit_batch(batch, epoch)

    brain = Fit({"profile_dir": str(tmp_path), "profile_start_step": 2, "profile_num_steps": 3})
    brain.fit([0], [_batch(i) for i in range(5)])
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    # from the start of step 2 to the end of step 5: of those micro-batches, 3 steps
    assert names.count("train.micro_batch") == 4 and names.count("train.optimizer") == 1
    assert {"train.forward", "train.backward", "train.accumulate"} <= set(names)
