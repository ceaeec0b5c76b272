"""K8's share of its roofline over the recorded window's launches: the least
time their bytes need over their device time. K8 is the one-pass bias +
InstanceNorm + SiLU kernel (``csrc/norm_silu.cu``), entered through
``ops/norm_silu.py``.

A call reads its (rows, length) float32 input once and writes its output
once, and reads the bias (and, with the norm, its weight and shift) once:
rows x length x 4 x 2 bytes plus 4 bytes a channel for each vector. Its
least time is those bytes at 3.35 TB/s (the operations, ~12 an element, are
0.3 a byte). A call whose norm rows exceed one cluster (``MAX_LENGTH``)
launches twice and reads the input twice; its least time is the same, held
against both launches' time."""

import re
from pathlib import Path

from port_bench.readers import roofline

KERNEL = re.compile(r"\bnorm_silu_(?:rows|bias|moments|apply)\b")
# the recorders import ENTRY's module, so ENTRY is named only in a checkout
# that has it: an older program's traced run then records nothing here
if (Path(__file__).resolve().parents[2] / "speech_anonymization_tpu_torch" / "ops" / "norm_silu.py").is_file():
    ENTRY = "speech_anonymization_tpu_torch.ops.norm_silu:norm_silu"


def keep(x, bias, weight=None, beta=None, eps=None):
    if not x.is_cuda:
        return None  # the plain twin: no launch
    from speech_anonymization_tpu_torch.ops.norm_silu import MAX_LENGTH

    return {"rows": x.numel() // x.shape[-1], "length": x.shape[-1], "channels": bias.numel(),
            "vectors": 1 if weight is None else 3,
            "launches": 2 if weight is not None and x.shape[-1] > MAX_LENGTH else 1}


def work_of(kept: list, cfg: dict) -> list:
    out = []
    for r in kept:
        out.append({"bytes": 4 * (2 * r["rows"] * r["length"] + r["vectors"] * r["channels"])})
        out += [{"bytes": 0}] * (r["launches"] - 1)
    return out


def read(run):
    return roofline(run, "k8_roofline", KERNEL)
