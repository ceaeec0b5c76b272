"""K3's device time at the decode's shapes, for this checkout or another one.

Usage, on a machine with one NVIDIA card:

    python speech_anonymization_tpu_torch/tools/profile_k3.py [--root CHECKOUT]

Times ``attention_step`` (K3, the whole-row kernel on physical caches) of the
package under CHECKOUT (default: the checkout that holds this file) on inputs
this script makes, so that two commits compare on the same inputs in one
call: unpack the other one with ``git archive <commit> | tar -x -C
build/parent`` and run, in turns, ``--root build/parent``, then without
``--root``, and so on. The cases (``K3_CASES``) are the decode's whole-row
physical shapes, N 528 (8 utterances x beam 66), 6 layers, M 768, layer 3:
f32 at D1's U 72, step 31; bf16 and int8 at D1's U 72, step 31, and D2's U
256, step 125 (the mean live steps of a 64- and a 252-step decode); each at
the ASR's 8 x 96 heads and the LM's 12 x 64. Seeded content as
``chip_smoke.py``'s: pad keys, odd rows' fresh token masked, NaN and Inf
(int8: code -128 and NaN scales) wherever the step may not read; int8 codes
and scales are ``quantize_rows`` of N(0, 1) rows, what a decode writes.
One JSON line a case: the mean CUDA-event time of 50 launches after 5, in
ms.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

N, LAYERS, M, LAYER = 528, 6, 768, 3
# (cache dtype name, shape name, U, step, heads)
K3_CASES = [(dtype, shape, u, step, nhead)
            for dtype, shapes in (("float32", (("D1", 72, 31),)),
                                  ("bfloat16", (("D1", 72, 31), ("D2", 256, 125))),
                                  ("int8", (("D1", 72, 31), ("D2", 256, 125))))
            for shape, u, step in shapes for nhead in (8, 12)]


def k3_inputs(case, gen, device="cuda", n: int = N):
    """(q, kh, vh, mask, ck, cv, ks, vs) of a case at n rows (default N); ks
    and vs None but int8."""
    import torch

    dtype, _, u, step, _ = case
    q, kh, vh = (torch.randn(n, M, generator=gen, device=device) for _ in range(3))
    mask = torch.rand(n, u, generator=gen, device=device) > 0.2
    mask[:, 0] = True
    mask[0::2, step] = True
    mask[1::2, step] = False
    if dtype != "int8":
        caches = []
        for _ in range(2):
            c = torch.randn(LAYERS, n, u, M, generator=gen, device=device).to(getattr(torch, dtype))
            c[:, :, step + 1:] = float("nan")
            c[:, :, step + 2:, ::5] = float("inf")
            caches.append(c)
        return q, kh, vh, mask, *caches, None, None
    from speech_anonymization_tpu_torch.ops.attention_step import quantize_rows

    hidden = ~mask
    hidden[:, step:] = True
    out = []
    for _ in range(2):
        codes = torch.empty(LAYERS, n, u, M, dtype=torch.int8, device=device)
        scales = torch.empty(LAYERS, n, u, device=device)
        for layer in range(LAYERS):
            codes[layer], scales[layer] = quantize_rows(
                torch.randn(n, u, M, generator=gen, device=device))
        codes[:, hidden] = -128
        scales[:, hidden] = float("nan")
        out.append((codes, scales))
    (ck, ks), (cv, vs) = out
    return q, kh, vh, mask, ck, cv, ks, vs


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    args = parser.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("profile_k3: CUDA is not available", file=sys.stderr)
        return 1
    from speech_anonymization_tpu_torch.ops import attention_step as k3

    if not str(Path(k3.__file__).resolve()).startswith(str(root)):
        raise RuntimeError(f"imported {k3.__file__}, not the package under {root}")
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for case in K3_CASES:
        q, kh, vh, mask, ck, cv, ks, vs = k3_inputs(case, gen)
        step, nhead = case[3], case[4]

        def run():
            return k3.attention_step(q, kh, vh, mask, ck, cv, step, LAYER, nhead, ks, vs)

        entry = {"root": str(root), "card": card, "dtype": case[0], "shape": case[1],
                 "cache": [LAYERS, N, case[2], M], "step": step, "heads": nhead,
                 "ms": cuda_ms(run)}
        print(json.dumps(entry), flush=True)
        del q, kh, vh, mask, ck, cv, ks, vs
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
