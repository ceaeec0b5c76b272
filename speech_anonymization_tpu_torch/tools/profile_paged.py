"""K5 (the whole-row attention kernel on the paged page-32 cache) at the
decode's shapes, for this checkout or another one, beside K3 int8 on the
same logical content.

Usage, on a machine with one NVIDIA card:

    python speech_anonymization_tpu_torch/tools/profile_paged.py [--root CHECKOUT]
        [--dtypes int8,float32,bfloat16] [--no-real]

Times ``attention_step_paged`` (K5) of the package under CHECKOUT (default:
the checkout that holds this file) on inputs this script makes, so that two
commits compare on the same inputs in one call: unpack the other one with
``git archive <commit> | tar -x -C build/parent`` and run, in turns,
``--root build/parent``, then without ``--root``, and so on (CHECKOUT's
``utils/cuda_build.py`` must have ``card_name``). The cases are
the split page-32 caches K5 serves: N 528 (8 utterances x beam 66), 6
layers, M 768, layer 3, D1 (U 96, step 31) and D2 (U 256, step 125: the mean
live steps of a 64- and a 252-step decode), at the ASR's 8 x 96 heads and
the LM's 12 x 64, for int8, f32 (D1 only: longer f32 caches page by 64,
for K6) and bf16 caches. Two tables:

* ``simulated``: ``step`` reorders of a beam history whose parents lean to
  the best beams (``chip_smoke.py``'s), so rows share most pages;
* ``real decode``: the table, ``act_src`` and mask of layer 3 at that step of
  a real int8 decode (the full-width ``ASRModel()``, seeded weights and
  features, beam 66, CTC 0.4), which shares far fewer pages.

The content is seeded: N(0, 1) rows (int8: their ``quantize_rows`` codes
and scales, what a decode writes), ~20% pad keys, odd rows' fresh token
masked, NaN (int8: code -128 and NaN scales) wherever the step may not read.
On int8 cases K3 (``attention_step``) also runs on the same logical content
as a physical cache: its time, and whether its output equals K5's bit for
bit.

One JSON line a case: the mean CUDA-event time of 50 launches after 5, in
ms, and the host's time to launch one (``host_ms``: where it nears ``ms``,
the host set the pace); the kernel's registers and spilled bytes (nvcc's report of the
CHECKOUT's build: the first run of a checkout in a process that builds it),
its shared memory and the blocks an SM that those allow; the bytes the step
must move and its bound (``profile_chunked.py``'s ``paged_bytes`` and
``bound``: each distinct valid cached position once, the parents' active
positions, the merged pages, int8 the scales, at 3.35 TB/s; the dot
products at the f32 peak).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

N, LAYERS, M, LAYER, PAGE = 528, 6, 768, 3, 32
BEAMS = 66
HEADS = (8, 12)
# (shape, feature frames, decode steps, the step timed): chip_smoke.py's D1
# (8 x 5.03 s, 64 steps) and D2 (8 x 10.07 s, a step an encoder frame)
SHAPES = (("D1", 504, 64, 31), ("D2", 1008, 252, 125))
ITEMSIZE = {"int8": 1, "bfloat16": 2, "float32": 4}


def kernel_symbol(kernels: dict, dtype: str, d_head: int) -> str | None:
    """The mangled name of the K5 instantiation a case launches: int8 on
    ``attn_step_whole_row<int8_t, 8, true>`` where the checkout has it, else
    ``attn_step_paged_rows<T, kGroup>``."""
    code = {"int8": "a", "bfloat16": "13__nv_bfloat16", "float32": "f"}[dtype]
    nvec = d_head * ITEMSIZE[dtype] // 16
    group = 8 if nvec <= 8 else (16 if nvec <= 16 else 32)
    for want in (f"attn_step_whole_rowI{code}Li{group}ELb1E", f"attn_step_paged_rowsI{code}Li{group}E"):
        hit = [k for k in kernels if want in k]
        if hit:
            return hit[0]
    return None


def kernel_smem(pkg, k3_int8: bool, dtype: str, d_head: int, u: int, step: int) -> int:
    """Dynamic shared memory of one K5 block: int8 K5's ring, K3's
    ``whole_row_layout`` (``k3_int8``: the checkout builds int8 K5 from K3's
    kernel), else ``launch_k5``'s scores, scratch, value partials and page
    owners."""
    if dtype == "int8" and k3_int8:
        return pkg["attention_step"].whole_row_layout(step, d_head, 1)[2]
    groups = 128 // (d_head * ITEMSIZE[dtype] // 16)
    return 4 * (u + 4 + groups * d_head) + 4 * (u // PAGE)


def paged_cache(torch, pkg, dtype: str, shape: tuple, nhead: int, gen, table=None, act_src=None,
                mask=None):
    """q, kh, vh, mask and a split page-32 cache at ``shape``'s step: the
    given table, act_src and mask, or a simulated beam history; seeded
    content, stale wherever the step may not read."""
    tr, paged = pkg["transformer"], pkg["paged"]
    _, _, steps, step = shape
    quant = dtype == "int8"
    cache = tr.make_kv_cache(N, steps + 1, LAYERS, nhead, M // nhead,
                             torch.int8 if quant else getattr(torch, dtype), device="cuda",
                             paged=True)
    if table is None:
        for t in range(step):
            r = torch.rand(N // BEAMS, BEAMS, generator=gen, device="cuda")
            cache = tr.beam_reorder_cache(cache, (BEAMS * r * r).long(), t)
    else:
        cache["table"].copy_(table)
        cache["act_src"].copy_(act_src)
    u = cache["tokens"].shape[1]
    p_act, o = divmod(step, PAGE)
    if quant:
        quantize_rows = pkg["attention_step"].quantize_rows
        for key in ("k", "v", "k_act", "v_act"):
            codes = torch.empty(cache[key].shape, dtype=torch.int8, device="cuda")
            scales = torch.empty(cache[key].shape[:-1], device="cuda")
            for layer in range(LAYERS):
                codes[layer], scales[layer] = quantize_rows(
                    torch.randn(cache[key].shape[1:], generator=gen, device="cuda"))
            cache[key].copy_(codes)
            if key in ("k", "v"):
                cache[f"{key}_scale"].copy_(scales)
        stale = -128
    else:
        for key in ("k", "v", "k_act", "v_act"):
            cache[key].normal_(generator=gen)
        stale = float("nan")
    for pages, act in zip(paged.page_views(cache)[:2], paged.page_views(cache)[2:]):
        pages[:, :, p_act:] = stale
        act[:, :, step % 2] = stale
        act[:, :, (step + 1) % 2, o:] = stale
    q, kh, vh = (torch.randn(N, M, generator=gen, device="cuda") for _ in range(3))
    if mask is None:
        mask = torch.rand(N, u, generator=gen, device="cuda") > 0.2
        mask[:, 0] = True
        mask[0::2, step] = True
        mask[1::2, step] = False
    if quant:
        hidden = ~mask
        hidden[:, step:] = True
        for key in ("k_scale", "v_scale"):
            cache[key][:, hidden] = float("nan")
    return q, kh, vh, mask, cache


def host_ms(torch, fn, iters: int = 50) -> float:
    """Mean host time of one call of ``fn`` in ms, its launches only (no
    synchronise inside): where it nears the CUDA-event time, that time is
    the host's pace, not the kernel's."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / iters


def physical_of(torch, pkg, cache: dict, step: int):
    """(L, N, U, M) physical k and v caches holding the paged cache's logical
    content at positions < step, code -128 from the step on."""
    k_pages, v_pages, k_act, v_act = pkg["paged"].page_views(cache)
    layers, n, up, page, m = k_pages.shape
    p_act, o = divmod(step, page)
    owners, parent = cache["table"].long(), cache["act_src"].long()
    cols = torch.arange(up, device=owners.device)
    out = []
    for pages, act in ((k_pages, k_act), (v_pages, v_act)):
        c = pages[:, owners, cols].reshape(layers, n, up * page, m).clone()
        c[:, :, p_act * page:p_act * page + o] = act[:, parent, (step + 1) % 2, :o]
        c[:, :, step:] = -128
        out.append(c.contiguous())
    return out


def real_tables(torch, pkg) -> dict:
    """{shape name: (table, act_src, mask)} of layer LAYER at each shape's
    timed step of a real int8 paged decode, as K5 got them."""
    import numpy as np

    tr = pkg["transformer"]
    model = pkg["seeded_init_"](pkg["ASRModel"](device="cuda"), 3)

    class Tok:
        def decode_ids(self, ids):
            return " ".join(str(i) for i in ids)

    got, want = {}, None
    original = tr.cached_attention_step_paged

    def hook(q, kh, vh, mask, cache, step, layer, nhead):
        if layer == LAYER and step == want and want not in got:
            got[want] = (cache["table"].clone(), cache["act_src"].clone(), mask.bool())
        return original(q, kh, vh, mask, cache, step, layer, nhead)

    rng = np.random.default_rng(0)
    tr.cached_attention_step_paged = hook
    try:
        out = {}
        for name, frames, steps, step in SHAPES:
            feats = torch.from_numpy(rng.standard_normal((8, frames, 80)).astype(np.float32)).cuda()
            want = step
            bundle = pkg["ASRBundle"](model, Tok(), {
                "test_beam_size": BEAMS, "ctc_weight_decode": 0.4, "temperature": 1.15,
                "max_decode_steps": steps, "decode_paged_kv": True, "decode_cache_dtype": "int8"})
            bundle._decode_test(feats, torch.ones(8, device="cuda"))
            torch.cuda.synchronize()
            out[name] = got.pop(step)
    finally:
        tr.cached_attention_step_paged = original
    return out


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    parser.add_argument("--dtypes", default="int8,float32,bfloat16")
    parser.add_argument("--no-real", action="store_true", help="skip the real decode's tables")
    args = parser.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("profile_paged: CUDA is not available", file=sys.stderr)
        return 1
    from speech_anonymization_tpu_torch.models import transformer
    from speech_anonymization_tpu_torch.models.asr import ASRModel
    from speech_anonymization_tpu_torch.ops import attention_step, attention_step_paged
    from speech_anonymization_tpu_torch.recipes.asr_bundle import ASRBundle
    from speech_anonymization_tpu_torch.tools import profile_chunked as pc
    from speech_anonymization_tpu_torch.utils import cuda_build
    from speech_anonymization_tpu_torch.utils.seeded_init import seeded_init_

    if not str(Path(attention_step.__file__).resolve()).startswith(str(root)):
        raise RuntimeError(f"imported {attention_step.__file__}, not the package under {root}")
    pkg = {"transformer": transformer, "paged": attention_step_paged,
           "attention_step": attention_step, "ASRModel": ASRModel, "ASRBundle": ASRBundle,
           "seeded_init_": seeded_init_}
    card = cuda_build.card_name()
    kernels = pc.parse_ptxas(cuda_build.build(["attention_step"])["attention_step"]["ptxas"])
    k3_int8 = "paged_boxes" in (root / "speech_anonymization_tpu_torch" / "csrc" /
                                "attention_step.cu").read_text()
    k5 = attention_step_paged.attention_step_paged
    k3 = attention_step.attention_step
    histories = [("simulated", None)]
    if not args.no_real:
        histories.append(("real decode", real_tables(torch, pkg)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    for history, tables in histories:
        for dtype in args.dtypes.split(","):
            for shape in SHAPES:
                name, _, _, step = shape
                if dtype == "float32" and name == "D2":
                    continue  # f32 caches past 213 positions page by 64, for K6
                for nhead in HEADS:
                    d = M // nhead
                    q, kh, vh, mask, cache = paged_cache(torch, pkg, dtype, shape, nhead, gen,
                                                         *(tables[name] if tables else ()))
                    u = cache["tokens"].shape[1]
                    sym = kernel_symbol(kernels, dtype, d)
                    regs, spill = kernels.get(sym, (None, None))
                    smem = kernel_smem(pkg, k3_int8, dtype, d, u, step)
                    nbytes = pc.paged_bytes(cache, mask, step, ITEMSIZE[dtype], dtype == "int8")
                    b_ms, b_by = pc.bound(nbytes, mask, step)
                    table = cache["table"]
                    p_act = step // PAGE
                    distinct = int(torch.unique(table[:, :p_act].long() * (u // PAGE) +
                                                torch.arange(p_act, device=table.device)).numel())
                    entry = {"root": str(root), "card": card, "kernel": "K5", "dtype": dtype,
                             "shape": name, "cache": [LAYERS, N, u, M], "step": step,
                             "heads": f"{nhead}x{d}", "history": history,
                             "distinct_owner_pages_per_reader": distinct / (N * p_act) if p_act
                             else None,
                             "ms": pc.cuda_ms(torch, lambda: k5(q, kh, vh, mask, cache, step,
                                                                 LAYER, nhead)),
                             "registers": regs, "spill_bytes": spill, "smem_bytes": smem,
                             "blocks_per_sm": pc.blocks_per_sm(regs, smem) if regs else None,
                             "mbytes": nbytes / 1e6, "bound_ms": b_ms, "bound_by": b_by}
                    entry["host_ms"] = host_ms(torch, lambda: k5(q, kh, vh, mask, cache, step,
                                                                 LAYER, nhead))
                    entry["share_of_bound"] = b_ms / entry["ms"]
                    if dtype == "int8":
                        ck, cv = physical_of(torch, pkg, cache, step)
                        ks, vs = cache["k_scale"].clone(), cache["v_scale"].clone()
                        paged_out = k5(q, kh, vh, mask, cache, step, LAYER, nhead)
                        physical_out = k3(q, kh, vh, mask, ck, cv, step, LAYER, nhead, ks, vs)
                        entry["k3_bit_identical"] = bool(torch.equal(paged_out, physical_out))
                        entry["k3_int8_ms"] = pc.cuda_ms(torch, lambda: k3(
                            q, kh, vh, mask, ck, cv, step, LAYER, nhead, ks, vs))
                        del ck, cv, ks, vs
                    print(json.dumps(entry), flush=True)
                    del q, kh, vh, mask, cache
                    torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
