"""The cells at a size the CPU tests hold: the configurations' widths cut,
the mixes' batches and lengths cut, everything else as the files say."""

from __future__ import annotations

import torch

from port_bench import run as bench

WIDTHS = dict(d_model=32, nhead=4, num_encoder_layers=2, num_decoder_layers=1, d_ffn=64, vocab=64,
              lm_d_model=32, lm_nhead=4, lm_num_layers=2, lm_d_ffn=64, test_beam_size=4)
SAMPLES = 71 * 160  # 72 frames: 18 encoder frames, 18 decode steps


def unlisted(name: str) -> bench.Cell:
    """A cell that ``BENCHMARK.json`` does not list, from its files:
    ``configs/<config>.json`` and ``traffic/<mix>.json`` for the name
    ``<config>.<mix>``, its limits, and ``setup_s`` alone to report."""
    here = bench.HERE
    config, _, mix = name.partition(".")
    return bench.Cell(name, 1, bench.load_json(here / "configs" / f"{config}.json"),
                      bench.load_json(here / "traffic" / f"{mix}.json"),
                      bench.load_json(here / "cells" / f"{name}.json")["limits"], [("setup_s", "s")], [])


def cell(name: str) -> bench.Cell:
    torch.set_num_threads(2)
    listed = any(w["name"] == name for w in bench.load_json(bench.ROOT / "BENCHMARK.json")["workloads"])
    c = bench.cell(name) if listed else unlisted(name)
    c.cfg.update({k: v for k, v in WIDTHS.items() if k in c.cfg})
    if "batch_size" in c.cfg:
        c.cfg["batch_size"] = 4
    if "batch" in c.mix:
        c.mix["batch"] = 2
    c.mix["samples"] = SAMPLES
    c.mix["pool"] = min(c.mix["pool"], 3)
    return c


def run(name: str, seed: int = 5, seconds: float = 0.3):
    return bench.run_cell(cell(name), seed, seconds, False, "cpu")[0]
