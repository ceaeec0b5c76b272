"""The port stands alone: it imports neither JAX nor the JAX package."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "speech_anonymization_tpu_torch"

_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|flax|optax|msgpack)\b|from\s+(jax|flax|optax|msgpack)\b"
    r"|import\s+speech_anonymization_tpu\b(?!_)|from\s+speech_anonymization_tpu\b(?!_))",
    re.MULTILINE,
)


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_pulls_in_no_jax():
    code = (
        "import sys, speech_anonymization_tpu_torch.recipes.anonymizer, "
        "speech_anonymization_tpu_torch.recipes.asr_bundle, speech_anonymization_tpu_torch.decoding, "
        "speech_anonymization_tpu_torch.models.asr, speech_anonymization_tpu_torch.eval.wer, "
        "speech_anonymization_tpu_torch.ops.attention_step, speech_anonymization_tpu_torch.ops.attention_step_paged, "
        "speech_anonymization_tpu_torch.ops.beam_gather, speech_anonymization_tpu_torch.ops.lm_megastep, "
        "speech_anonymization_tpu_torch.tools.profile_decode, "
        "speech_anonymization_tpu_torch.tools.profile_lm_megastep, "
        "speech_anonymization_tpu_torch.utils.cuda_build, speech_anonymization_tpu_torch.utils.seeded_init, "
        "speech_anonymization_tpu_torch.train, speech_anonymization_tpu_torch.train.schedulers, "
        "speech_anonymization_tpu_torch.train.state, speech_anonymization_tpu_torch.ops.specaugment, "
        "speech_anonymization_tpu_torch.models.cyclegan, speech_anonymization_tpu_torch.models.endtoend, "
        "speech_anonymization_tpu_torch.tools.train_parity, speech_anonymization_tpu_torch.utils.msgpack, "
        "speech_anonymization_tpu_torch.utils.convert, speech_anonymization_tpu_torch.train.checkpoint, "
        "speech_anonymization_tpu_torch.train.brain, speech_anonymization_tpu_torch.train.epoch_loop, "
        "speech_anonymization_tpu_torch.train.logger, speech_anonymization_tpu_torch.train.experiment, "
        "speech_anonymization_tpu_torch.train.profiler, speech_anonymization_tpu_torch.losses.mi, "
        "speech_anonymization_tpu_torch.eval.evaluator\n"
        "bad = [m for m in ('jax', 'flax', 'optax', 'msgpack', 'speech_anonymization_tpu') if m in sys.modules]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_has_no_jax_import(path):
    assert not _FORBIDDEN.search(path.read_text()), path


def test_scan_catches_forbidden_imports():
    for line in ("import jax", "from flax import linen", "import msgpack", "import speech_anonymization_tpu.ops",
                 "from speech_anonymization_tpu import models",
                 "from speech_anonymization_tpu.ops import fbank"):
        assert _FORBIDDEN.search(line), line
    for line in ("import speech_anonymization_tpu_torch", "from speech_anonymization_tpu_torch.ops import x",
                 "from ..utils import msgpack"):
        assert not _FORBIDDEN.search(line), line


def test_chip_smoke_refuses_to_run_without_cuda():
    """Without a card the smoke script exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present; the smoke script would run")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
