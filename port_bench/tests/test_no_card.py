"""A run with no card exits non-zero and prints no result."""

import subprocess
import sys

import pytest

from .conftest import ROOT


@pytest.mark.parametrize("workload", ["convae.anon_b32", "asr_lm.eval_d2"])
def test_no_card_no_result(workload):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", workload, "--seed", "3000000000",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == "" and "CUDA" in out.stderr
