"""The plain reference agrees with the program at a tiny size on the CPU
(the program's plain twins), through a whole run of each cell."""

import pytest
import torch

from . import tiny
from .test_bench_files import CELLS, KEPT


@pytest.mark.parametrize("name", CELLS + KEPT)
def test_run_is_correct_at_a_tiny_size(name):
    result = tiny.run(name)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and set(result["metrics"]) >= {"setup_s"}
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name", ["asr_lm.eval_d2", "asr_lm.eval_d1"])
def test_reference_beam_search_finds_the_programs_hypotheses(name):
    """At a tiny size, where the two agree to rounding, the reference's own
    search ends on the program's hypotheses with the program's scores."""
    from port_bench import run as bench
    from port_bench.entries import evaluate
    from port_bench.reference import beam_search, models

    c = tiny.cell(name)
    bench.prepare("cpu")
    e = evaluate.Entry(c.cfg, c.mix, 7, "cpu")
    feats = torch.randn(3, 72, 80, generator=torch.Generator().manual_seed(3))
    lens = torch.ones(3)
    tokens, lengths, scores = e.bundle._decode_test(feats, lens)[:3]
    enc = models.asr_encode(e.w_asr, feats, lens, c.cfg["nhead"])
    want = beam_search.beam_search(e.w_asr, e.w_lm, enc, lens, e._scoring_cfg(), c.cfg["test_beam_size"], e.steps,
                                   c.cfg["nhead"], c.cfg["lm_nhead"])
    assert torch.equal(lengths, want[1])
    for i in range(3):
        n = int(lengths[i])
        assert torch.equal(tokens[i, :n], want[0][i, :n])
    assert float((scores.double() - want[2]).abs().max()) < 1e-4
