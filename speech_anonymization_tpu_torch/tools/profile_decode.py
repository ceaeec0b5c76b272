"""Device-time breakdown of one beam decode (``ASRBundle._decode_test``).

Usage, on a machine with one NVIDIA card:

    python -m speech_anonymization_tpu_torch.tools.profile_decode [D1|D2|D3|B3] [paged|physical]
        [--lm] [--bf16 | --int8]

D1 (default) is scripts/bench_decode.py's shape: 8 utterances of T = 504
feature frames (126 encoder frames), 64 decode steps; D2 is bench.py's
length: T = 1008 (252 encoder frames), 252 steps; D3 is the JAX package's
30 s int8 serving shape, run with ``--int8``: T = 3001 (751 encoder frames),
448 steps (U 512); B3 is configs/convae.yaml's evaluation batch at D1's
length: 3 utterances (N 198 at beam 66, not a multiple of 8, so the paging
rule keeps its caches physical whichever layout is asked: K2 and K3). The full-width
``ASRModel()`` with seeded random weights decodes seeded features at beam 66,
CTC 0.4, temperature 1.15, f32 caches, fp32 with TF32 off, with paged caches
(the default: K5 at D1, K6 at D2) or physical ones (``decode_paged_kv:
false``: K2 and K3 at D1, K2 and K4 at D2). ``--lm`` attaches a seeded
``TransformerLM()`` at its published widths (vocab 5000, d_model 768, 12
heads, 12 layers, d_ffn 3072), fused at lm_weight 0.6 as the reference's
test decode: at D2 paged its step is one K7 launch, elsewhere 12 attention
launches of the ASR's kind. ``--bf16`` takes bf16 caches
(``decode_cache_dtype: bfloat16``, the serving setting): D2 then pages by 32
(U 256 is within the bf16 whole-row bound), so K5 serves every layer, the
LM's too, and K7 does not run. ``--int8`` takes int8 caches
(``decode_cache_dtype: int8``, the quantized serving mode): whole-row at D1
and D2 (U 256 is within the int8 whole-row bound of 426), so K5 serves every
paged layer and K3 with K2 every physical one; chunked at D3 (U 512), so K6
on the fused page-64 cache serves every paged layer (the LM's step one K7
launch) and K4 with K2 every physical one. After a warm-up,
one decode runs under ``torch.profiler``; the script prints one JSON line:
the wall time with and without the profiler, summed device time, the
device's busy share of the profiled wall time, the number of kernel launches,
and device time by kernel name (cut to 80 characters), largest first. Exits
non-zero without CUDA or when the trace holds no device time.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..models import TransformerLM
from ..models.asr import ASRModel
from ..recipes.asr_bundle import ASRBundle
from ..utils.seeded_init import seeded_init_

# utterances, frames, max_decode_steps
SHAPES = {"D1": (8, 504, 64), "D2": (8, 1008, None), "D3": (8, 3001, 448), "B3": (3, 504, 64)}
TOP = 15


class _Tok:
    def decode_ids(self, ids):
        return " ".join(str(i) for i in ids)


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("profile_decode: CUDA is not available", file=sys.stderr)
        return 1
    with_lm = "--lm" in argv
    if "--bf16" in argv and "--int8" in argv:
        print("profile_decode: --bf16 and --int8 exclude each other", file=sys.stderr)
        return 2
    cache_dtype = "bfloat16" if "--bf16" in argv else "int8" if "--int8" in argv else "float32"
    argv = [a for a in argv if a not in ("--lm", "--bf16", "--int8")]
    name = argv[0] if argv else "D1"
    layout = argv[1] if len(argv) > 1 else "paged"
    if layout not in ("paged", "physical"):
        print(f"profile_decode: layout {layout!r} is neither paged nor physical", file=sys.stderr)
        return 2
    batch, frames, max_steps = SHAPES[name]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.standard_normal((batch, frames, 80)).astype(np.float32)).cuda()
    lens = torch.ones(batch, device="cuda")
    model = seeded_init_(ASRModel(device="cuda"), 3)
    bundle = ASRBundle(model, _Tok(), {"test_beam_size": 66, "ctc_weight_decode": 0.4,
                                       "temperature": 1.15, "max_decode_steps": max_steps,
                                       "decode_paged_kv": layout == "paged",
                                       "decode_cache_dtype": cache_dtype},
                       lm=seeded_init_(TransformerLM(device="cuda"), 4) if with_lm else None)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        bundle._decode_test(feats, lens)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bundle._decode_test(feats, lens)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_kernel: dict[str, float] = {}
    launches = 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernel = evt.name[:80]  # kernels of one template family share a row
            by_kernel[kernel] = by_kernel.get(kernel, 0.0) + evt.time_range.elapsed_us() / 1e3
            launches += 1
    device_ms = sum(by_kernel.values())
    if device_ms == 0.0:
        print("profile_decode: the trace holds no device time", file=sys.stderr)
        return 1
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:TOP]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "shape": name, "layout": layout, "lm": with_lm,
        "cache_dtype": cache_dtype, "batch": batch,
        "frames": frames,
        "wall_ms_unprofiled_median": statistics.median(walls[1:]), "wall_ms": wall_ms,
        "device_ms": device_ms, "busy_share": device_ms / wall_ms, "device_launches": launches,
        "kernels_ms": dict(top),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
