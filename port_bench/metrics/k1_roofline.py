"""K1's share of its roofline over the recorded window's launches: the least
time their operations and bytes need over their device time. K1 is the
fused log-mel kernel (``csrc/fbank.cu``), entered through ``ops/fbank.py``."""

import re

from port_bench import work
from port_bench.readers import roofline

KERNEL = re.compile(r"\bfbank_kernel\b")
ENTRY = "speech_anonymization_tpu_torch.ops.fbank:fused_fbank"


def keep(frames, dft, mel, frag):
    return {"rows": frames.numel() // frames.shape[-1], "win": frames.shape[-1], "bins": mel.shape[0],
            "mels": mel.shape[1]}


def work_of(kept: list, cfg: dict) -> list:
    return [work.k1_work(r["rows"], r["win"], r["bins"], r["mels"]) for r in kept]


def read(run):
    return roofline(run, "k1_roofline", KERNEL)
