"""BENCHMARK.json against the benchmark's contract, and every cell, mix,
configuration, entry and metric found by name from its own file."""

import json
import re

import pytest

from port_bench import run as bench

from .conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
# cells whose files stay, unlisted, until BENCHMARK.json takes them (back):
# <config>.<mix> by name; the CPU tests still hold their check
KEPT = sorted({p.stem for p in (ROOT / "port_bench" / "cells").glob("*.json")} - set(CELLS))
METRICS = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert SPEC["paths"] == ["port_bench"] and len(SPEC["command"]) <= 32
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(METRICS)) == len(METRICS) and len(set(CELLS)) == len(CELLS)
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(CELLS) // 4)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    c = bench.cell(name)
    assert c.end_to_end and c.per_layer and ("setup_s", "s") in c.end_to_end
    assert c.limits and all(v >= 0 for v in c.limits.values())
    assert bench.entry_class(c.mix).__name__ == "Entry"
    for layer in c.per_layer:
        moves = next(m["moves"] for m in SPEC["per_layer"] if m["name"] == layer[0])
        assert moves in [n for n, _ in c.end_to_end]


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_found_by_name(name):
    assert callable(bench.reader(name))


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_configuration_file(conf):
    data = json.loads((ROOT / conf["file"]).read_text())
    assert data["source"] == conf["source"] and data["reduced"] == conf["reduced"]
    assert all(k in data for k in conf["reduced"])
    assert any(w["config"] == conf["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("name", [m for m in METRICS if hasattr(bench.metric(m), "ENTRY")])
def test_recorded_entry_point_exists(name):
    """A roofline's file names a kernel pattern and an entry point of the
    program whose parameters its ``keep`` takes."""
    import importlib
    import inspect

    m = bench.metric(name)
    module, _, attr = m.ENTRY.partition(":")
    entry = getattr(importlib.import_module(module), attr)
    want = [p.name for p in inspect.signature(entry).parameters.values() if p.kind != p.VAR_KEYWORD]
    got = [p.name for p in inspect.signature(m.keep).parameters.values() if p.kind != p.VAR_KEYWORD]
    assert got == want[: len(got)] and callable(m.work_of) and m.KERNEL.pattern
