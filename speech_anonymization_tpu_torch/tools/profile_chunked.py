"""K4 and K6 (the chunked attention kernels) at the 30 s decode's shape, for
this checkout or another one.

Usage, on a machine with one NVIDIA card:

    python speech_anonymization_tpu_torch/tools/profile_chunked.py [--root CHECKOUT]
        [--dtypes int8,float32,bfloat16] [--steps 63,223,447] [--no-real]

Times ``attention_step_chunked`` (K4, physical caches) and
``attention_step_paged_chunked`` (K6, the fused page-64 cache) of the package
under CHECKOUT (default: the checkout that holds this file) on inputs this
script makes, so that two commits compare on the same inputs in one call:
unpack the other one with ``git archive <commit> | tar -x -C build/parent``
and run, in turns, ``--root build/parent``, then without ``--root``, and so
on (CHECKOUT's ``utils/cuda_build.py`` must have ``card_name``). Shape D3
(8 utterances of 30 s at beam 66: N 528, U 512, 6 layers, M
768, layer 3), at the ASR's 8 x 96 heads and the LM's 12 x 64, int8, f32 and
bf16 caches, at steps 63, 223 and 447 (the first page's last step, the mean
live step of a 448-step decode, the last step). Two histories:

* ``simulated``: ``chip_smoke.py``'s content (seeded, ~20% pad keys, odd
  rows' fresh token masked, NaN or code -128 and NaN scales wherever the step
  may not read; int8 codes and scales are ``quantize_rows`` of N(0, 1) rows)
  and, for K6, a beam history of ``step`` reorders whose parents lean to the
  best beams, so rows share pages;
* ``real``: one layer's inputs captured from a real int8 decode at D3 (the
  full-width ``ASRModel()``, seeded weights, seeded features, beam 66, CTC
  0.4), paged (K6) and physical (K4), at 8 x 96 only.

One JSON line a case: the mean CUDA-event time of 50 launches after 5, in ms;
the kernel's registers and spilled bytes (nvcc's report of the CHECKOUT's
build), its shared memory, the blocks an SM that registers and shared memory
allow; the bytes the step must move (each distinct cache position that some
row holds valid once, the parents' active positions, the merged pages and
the fresh rows' writes, int8 the scales, q/kh/vh/out, mask and tables), and
its bound: the larger of those bytes at 3.35 TB/s and the arithmetic of
every row's dot products (4 flops a valid position and head element) at the
f32 peak, 67 TFLOP/s.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

N, LAYERS, U, M, LAYER = 528, 6, 512, 768, 3
BEAMS = 66
HEADS = (8, 12)
PEAK_BYTES_PER_S, PEAK_FP32_FLOPS = 3.35e12, 67e12
THREADS, WARPS = 128, 4
SM_REGISTERS, SM_SMEM, BLOCK_RESERVED, SM_BLOCKS = 65536, 233_472, 1024, 32
ITEMSIZE = {"int8": 1, "bfloat16": 2, "float32": 4}


def kernel_smem(design_int8: bool, dtype: str, d_head: int, owners: int) -> int:
    """Dynamic shared memory of one K4/K6 block at U 512: ``chunked_i8_smem``
    of the int8 body (``design_int8``: the checkout has it), else
    ``chunked_smem_floats`` plus the page owners (csrc/attention_step.cuh)."""
    if dtype == "int8" and design_int8:
        stages = 2  # csrc/attention_step.cu kI8Stages
        slot = 2 * 16 * (d_head + 16) + 2 * 16 * 4
        return WARPS * stages * slot + 4 * WARPS + ((U + 15) & ~15) + 4 * owners
    vec = 16 // ITEMSIZE[dtype]
    groups = THREADS // (d_head // vec)
    return 4 * (2 * 64 + 2 * WARPS + 1 + groups * d_head) + 4 * owners


def blocks_per_sm(registers: int, smem: int) -> int:
    """128-thread blocks an H100 SM holds: registers are allocated per warp in
    units of 256 (8 a thread), shared memory per block with 1 KB reserved."""
    per_warp = -(-registers * 32 // 256) * 256
    by_regs = (SM_REGISTERS // per_warp) // WARPS
    by_smem = SM_SMEM // (smem + BLOCK_RESERVED)
    return min(by_regs, by_smem, SM_BLOCKS)


def parse_ptxas(report: str) -> dict[str, tuple[int, int]]:
    """{mangled kernel name: (registers, spill store bytes)} from nvcc's
    ``-Xptxas -v`` lines."""
    out, name, spill = {}, None, 0
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), spill)
            name = None
    return out


def kernel_symbol(kernels: dict, dtype: str, paged: bool, d_head: int) -> str | None:
    """The mangled name of the K4/K6 instantiation a case launches: the int8
    body's ``attn_step_chunked_int8<kPaged, d_head / 16>`` where the
    checkout has it, else ``attn_step_chunked<T, kPaged>``."""
    flag = "Lb1E" if paged else "Lb0E"
    if dtype == "int8":
        want = f"attn_step_chunked_int8I{flag}Li{d_head // 16}E"
        hit = [k for k in kernels if want in k]
        if hit:
            return hit[0]
    code = {"int8": "a", "bfloat16": "13__nv_bfloat16", "float32": "f"}[dtype]
    hit = [k for k in kernels if f"attn_step_chunkedI{code}{flag}" in k]
    return hit[0] if hit else None


def _physical_inputs(torch, dtype: str, step: int, gen, quantize_rows):
    """q, kh, vh, mask, ck, cv, ks, vs (ks, vs None but int8)."""
    q, kh, vh = (torch.randn(N, M, generator=gen, device="cuda") for _ in range(3))
    mask = torch.rand(N, U, generator=gen, device="cuda") > 0.2
    mask[:, 0] = True
    mask[0::2, step] = True
    mask[1::2, step] = False
    if dtype != "int8":
        caches = []
        for _ in range(2):
            c = torch.randn(LAYERS, N, U, M, generator=gen, device="cuda").to(getattr(torch, dtype))
            c[:, :, step + 1:] = float("nan")
            caches.append(c)
        return q, kh, vh, mask, *caches, None, None
    hidden = ~mask
    hidden[:, step:] = True
    out = []
    for _ in range(2):
        codes = torch.empty(LAYERS, N, U, M, dtype=torch.int8, device="cuda")
        scales = torch.empty(LAYERS, N, U, device="cuda")
        for layer in range(LAYERS):
            codes[layer], scales[layer] = quantize_rows(torch.randn(N, U, M, generator=gen,
                                                                    device="cuda"))
        codes[:, hidden] = -128
        scales[:, hidden] = float("nan")
        out.append((codes, scales))
    (ck, ks), (cv, vs) = out
    return q, kh, vh, mask, ck, cv, ks, vs


def _paged_inputs(torch, pkg, dtype: str, step: int, nhead: int, gen):
    """q, kh, vh, mask and a fused page-64 cache after ``step`` reorders of a
    simulated beam history, as chip_smoke.py's ``_paged_inputs``."""
    tr, paged = pkg["transformer"], pkg["paged"]
    cache = tr.make_kv_cache(N, 448 + 1, LAYERS, nhead, M // nhead,
                             torch.int8 if dtype == "int8" else torch.float32,
                             device="cuda", paged=True, fused=True)
    for t in range(step):
        r = torch.rand(N // BEAMS, BEAMS, generator=gen, device="cuda")
        cache = tr.beam_reorder_cache(cache, (BEAMS * r * r).long(), t)
    page = paged.page_views(cache)[0].shape[3]
    p_act, o = divmod(step, page)
    if dtype == "int8":
        quantize_rows = pkg["attention_step"].quantize_rows
        for key in ("kv", "kv_act"):
            codes = torch.empty(cache[key].shape, dtype=torch.int8, device="cuda")
            scales = torch.empty(cache[key].shape[:-1], device="cuda")
            for layer in range(LAYERS):
                codes[layer], scales[layer] = quantize_rows(
                    torch.randn(cache[key].shape[1:], generator=gen, device="cuda"))
            cache[key].copy_(codes)
            if key == "kv":  # each page's rows are [K-page, V-page]
                by_page = scales.view(*scales.shape[:2], -1, 2, page)
                for j, sk in enumerate(("k_scale", "v_scale")):
                    cache[sk].copy_(by_page[:, :, :, j].reshape(cache[sk].shape))
        stale = -128
    else:
        cache = {k: v.to(getattr(torch, dtype)) if v.is_floating_point() else v
                 for k, v in cache.items()}
        for key in ("kv", "kv_act"):
            cache[key].normal_(generator=gen)
        stale = float("nan")
    for pages, act in zip(paged.page_views(cache)[:2], paged.page_views(cache)[2:]):
        pages[:, :, p_act:] = stale
        act[:, :, step % 2] = stale
        act[:, :, (step + 1) % 2, o:] = stale
    q, kh, vh = (torch.randn(N, M, generator=gen, device="cuda") for _ in range(3))
    mask = torch.rand(N, cache["tokens"].shape[1], generator=gen, device="cuda") > 0.2
    mask[:, 0] = True
    mask[0::2, step] = True
    mask[1::2, step] = False
    if dtype == "int8":
        hidden = ~mask
        hidden[:, step:] = True
        for key in ("k_scale", "v_scale"):
            cache[key][:, hidden] = float("nan")
    return q, kh, vh, mask, cache


def physical_bytes(mask, step: int, itemsize: int, quant: bool) -> int:
    """One physical K4 step's bytes: the valid cached positions' k and v (int8
    with their scales), the fresh rows written, q/kh/vh/out and the mask."""
    n, m = mask.shape[0], M
    valid_cached = int(mask[:, :step].sum())
    per_pos = m * itemsize + (4 if quant else 0)
    return 2 * (valid_cached + n) * per_pos + 4 * n * m * 4 + n * (step + 1)


def paged_bytes(cache: dict, mask, step: int, itemsize: int, quant: bool) -> int:
    """One K6 step's bytes: each distinct (owner row, position) that some row
    holds valid, the parents' active positions (read whole, for the merged
    page), the merged pages' writes, int8 the scales (by own row and
    position: each row's valid ones read, the fresh ones written),
    q/kh/vh/out, the mask and the tables."""
    import torch

    table, act_src = cache["table"], cache["act_src"]
    n, up = table.shape
    u = cache["tokens"].shape[1]
    page = u // up
    p_act, o = divmod(step, page)
    pos = torch.arange(p_act * page, device=table.device)
    owner_pos = table[:, pos // page].long() * u + pos
    main = int(torch.unique(owner_pos[mask[:, :p_act * page]]).numel())
    active = int(torch.unique(act_src).numel()) * o
    total = 2 * (main + active + n * (o + 1)) * M * itemsize
    if quant:
        total += 8 * (int(mask[:, :step].sum()) + n)
    return total + 4 * n * M * 4 + n * (step + 1) + 4 * (n * p_act + n)


def bound(nbytes: int, mask, step: int) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the bytes at the HBM rate
    and every row's dot products (q . k and the weighted v, 2 + 2 flops a
    valid position and element of M) at the f32 peak."""
    flops = 4 * int(mask[:, :step + 1].sum()) * M
    b_ms, o_ms = 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * flops / PEAK_FP32_FLOPS
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def cuda_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
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


def real_captures(torch, pkg, steps) -> dict:
    """{(layout, step): inputs} of layer LAYER from real int8 D3 decodes, paged
    (K6's q, kh, vh, mask, one-layer cache) and physical (K4's q, kh, vh,
    mask, one-layer k, v and scales); each step's inputs as the decode's
    kernel got them, before it ran."""
    import numpy as np

    tr = pkg["transformer"]
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.standard_normal((8, 3001, 80)).astype(np.float32)).cuda()
    lens = torch.ones(8, device="cuda")
    model = pkg["seeded_init_"](pkg["ASRModel"](device="cuda"), 3)

    class Tok:
        def decode_ids(self, ids):
            return " ".join(str(i) for i in ids)

    got = {}
    originals = {name: getattr(tr, name)
                 for name in ("cached_attention_step_paged", "cached_attention_step")}

    def paged_hook(q, kh, vh, mask, cache, step, layer, nhead):
        if layer == LAYER and step in steps and ("paged", step) not in got:
            sl = {k: (v[layer:layer + 1] if k in ("kv", "kv_act", "k_scale", "v_scale") else v)
                  .clone() for k, v in cache.items()}
            got["paged", step] = (q.clone(), kh.clone(), vh.clone(), mask.clone(), sl)
        return originals["cached_attention_step_paged"](q, kh, vh, mask, cache, step, layer, nhead)

    def physical_hook(q, kh, vh, mask, k, v, step, layer, nhead, ks=None, vs=None):
        if layer == LAYER and step in steps and ("physical", step) not in got:
            got["physical", step] = tuple(x.clone() for x in (q, kh, vh, mask)) + tuple(
                x[layer:layer + 1].clone() for x in (k, v, ks, vs))
        return originals["cached_attention_step"](q, kh, vh, mask, k, v, step, layer, nhead, ks, vs)

    tr.cached_attention_step_paged, tr.cached_attention_step = paged_hook, physical_hook
    try:
        for paged in (True, False):
            bundle = pkg["ASRBundle"](model, Tok(), {
                "test_beam_size": BEAMS, "ctc_weight_decode": 0.4, "temperature": 1.15,
                "max_decode_steps": 448, "decode_paged_kv": paged, "decode_cache_dtype": "int8"})
            bundle._decode_test(feats, lens)
            torch.cuda.synchronize()
    finally:
        for name, fn in originals.items():
            setattr(tr, name, fn)
    return got


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    parser.add_argument("--dtypes", default="int8,float32,bfloat16")
    parser.add_argument("--steps", default="63,223,447")
    parser.add_argument("--no-real", action="store_true", help="skip the real decode's cases")
    args = parser.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("profile_chunked: CUDA is not available", file=sys.stderr)
        return 1
    from speech_anonymization_tpu_torch.models import transformer
    from speech_anonymization_tpu_torch.models.asr import ASRModel
    from speech_anonymization_tpu_torch.ops import attention_step, attention_step_paged
    from speech_anonymization_tpu_torch.recipes.asr_bundle import ASRBundle
    from speech_anonymization_tpu_torch.utils import cuda_build
    from speech_anonymization_tpu_torch.utils.seeded_init import seeded_init_

    if not str(Path(attention_step.__file__).resolve()).startswith(str(root)):
        raise RuntimeError(f"imported {attention_step.__file__}, not the package under {root}")
    pkg = {"transformer": transformer, "paged": attention_step_paged,
           "attention_step": attention_step, "ASRModel": ASRModel, "ASRBundle": ASRBundle,
           "seeded_init_": seeded_init_}
    card = cuda_build.card_name()
    report = cuda_build.build(["attention_step"])["attention_step"]["ptxas"]
    kernels = parse_ptxas(report)
    design_int8 = "chunked_i8_smem" in (root / "speech_anonymization_tpu_torch" / "csrc" /
                                        "attention_step.cuh").read_text()
    k4 = attention_step.attention_step_chunked
    k6 = attention_step_paged.attention_step_paged_chunked
    steps = [int(s) for s in args.steps.split(",")]

    def emit(kernel: str, dtype: str, nhead: int, step: int, history: str, fn, nbytes, mask,
             extra=None):
        d = M // nhead
        paged = kernel == "K6"
        sym = kernel_symbol(kernels, dtype, paged, d)
        regs, spill = kernels.get(sym, (None, None))
        smem = kernel_smem(design_int8, dtype, d, U // 64 if paged else 0)
        b_ms, b_by = bound(nbytes, mask, step)
        entry = {"root": str(root), "card": card, "kernel": kernel, "dtype": dtype,
                 "heads": f"{nhead}x{d}", "step": step, "history": history,
                 "ms": cuda_ms(torch, fn),
                 "registers": regs, "spill_bytes": spill, "smem_bytes": smem,
                 "blocks_per_sm": blocks_per_sm(regs, smem) if regs else None,
                 "mbytes": nbytes / 1e6, "bound_ms": b_ms, "bound_by": b_by, **(extra or {})}
        entry["share_of_bound"] = b_ms / entry["ms"]
        print(json.dumps(entry), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in args.dtypes.split(","):
        quant = dtype == "int8"
        for nhead in HEADS:
            for step in steps:
                q, kh, vh, mask, ck, cv, ks, vs = _physical_inputs(torch, dtype, step, gen,
                                                                   attention_step.quantize_rows)
                emit("K4", dtype, nhead, step, "simulated",
                     lambda: k4(q, kh, vh, mask, ck, cv, step, LAYER, nhead, ks, vs),
                     physical_bytes(mask, step, ITEMSIZE[dtype], quant), mask)
                del q, kh, vh, mask, ck, cv, ks, vs
                q, kh, vh, mask, cache = _paged_inputs(torch, pkg, dtype, step, nhead, gen)
                emit("K6", dtype, nhead, step, "simulated",
                     lambda: k6(q, kh, vh, mask, cache, step, LAYER, nhead),
                     paged_bytes(cache, mask, step, ITEMSIZE[dtype], quant), mask)
                del q, kh, vh, mask, cache
                torch.cuda.empty_cache()
    if not args.no_real and "int8" in args.dtypes.split(","):
        captured = real_captures(torch, pkg, set(steps))
        for step in steps:
            q, kh, vh, mask, cache = captured["paged", step]
            table = cache["table"]
            distinct = int(torch.unique(table[:, :step // 64].long() * (U // 64)
                                        + torch.arange(step // 64, device=table.device)).numel())
            emit("K6", "int8", 8, step, "real decode",
                 lambda: k6(q, kh, vh, mask, cache, step, 0, 8),
                 paged_bytes(cache, mask, step, 1, True), mask,
                 {"distinct_owner_pages_per_reader": distinct / max(1, N * (step // 64))})
            q, kh, vh, mask, ck, cv, ks, vs = captured["physical", step]
            emit("K4", "int8", 8, step, "real decode",
                 lambda: k4(q, kh, vh, mask, ck, cv, step, 0, 8, ks, vs),
                 physical_bytes(mask, step, 1, True), mask)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
