"""Device time of each phase of K7 (``csrc/lm_megastep.cu``) at D2's LM step.

Usage, on a machine with one NVIDIA card:

    python -m speech_anonymization_tpu_torch.tools.profile_lm_megastep [step ...] [--bf16 | --int8]

K7 runs every layer of a TransformerLM decode step as seven phases separated
by grid-wide barriers (q/k/v, attention, out-projection, add + LayerNorm 1,
W1, W2, add + LayerNorm 2), after a prologue (x0 to bf16). No profiler sees
inside one launch, so this builds the same source with ``SA_LM_MEGA_STAMPS``
defined (through ``utils/cuda_build.py``, into a library of its own), in
which block 0 reads the card's global timer after two back-to-back grid
barriers (``barrier_us``: one barrier's cost) and after every barrier of the
step, and runs it on a seeded ``TransformerLM()`` at its published widths
(12 layers, d_model 768, 12 heads, d_ffn 3072) over D2's fused paged LM cache
(N 528 = 8 utterances x beam 66, U 256, page 64, f32 or bf16), or with
``--int8`` D3's (U 512, int8 codes with seeded scales), after ``step``
reorders of a simulated beam history (default steps 0 and 125). One JSON
line per step: the launch's CUDA-event time (K7 itself, median of 10), and
the microseconds a layer spends in each phase, averaged over the layers (a
phase's time includes the wait at its closing barrier). The stamped build
computes what K7 computes: its x_out must equal K7's, bit for bit, or the
script exits non-zero.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import sys

import torch

from ..models import TransformerLM
from ..models.transformer import beam_reorder_cache, make_kv_cache
from ..ops import lm_megastep as k7
from ..utils import cuda_build
from ..utils.seeded_init import seeded_init_

PHASES = ("qkv", "attention", "out_proj", "add_ln1", "w1_gelu", "w2", "add_ln2")
N, U, BEAM = 528, 256, 66
U_INT8 = 512  # D3's LM cache: int8 caches are fused page 64 only above 426 positions
STAMPS = 1024  # kStamps of the source
LEAD = 3  # stamps before the first layer's: two lone barriers, then the prologue


def _state(lm: TransformerLM, step: int, dtype: torch.dtype, gen: torch.Generator):
    """x0, mask and D2's fused LM cache (D3's for int8) after ``step``
    reorders (parents drawn towards the best beams, so beams share them),
    seeded content."""
    quant = dtype == torch.int8
    u = U_INT8 if quant else U
    cache = make_kv_cache(N, u, lm.num_layers, lm.nhead, lm.d_model // lm.nhead,
                          torch.int8 if quant else torch.float32, device="cuda", paged=True,
                          fused=True)
    for t in range(step):
        r = torch.rand(N // BEAM, BEAM, generator=gen, device="cuda")
        cache = beam_reorder_cache(cache, (BEAM * r * r).long(), t)
    if quant:
        for key in ("kv", "kv_act"):
            cache[key].random_(-127, 128, generator=gen)
        for key in ("k_scale", "v_scale"):
            cache[key].uniform_(1e-3, 0.05, generator=gen)
    else:
        cache = {k: v.to(dtype) if v.is_floating_point() else v for k, v in cache.items()}
        cache["kv"].normal_(generator=gen)
        cache["kv_act"].normal_(generator=gen)
    x0 = torch.randn(N, lm.d_model, generator=gen, device="cuda")
    mask = torch.rand(N, u, generator=gen, device="cuda") > 0.2
    mask[:, 0] = True
    return x0, mask, cache


def _ms(fn, iters: int = 10) -> float:
    fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bind(lib) -> ctypes.CDLL:
    fn = lib.sa_lm_megastep
    fn.argtypes = k7._entry().argtypes
    fn.restype = ctypes.c_int
    return fn


STAMPED = ("SA_LM_MEGA_STAMPS",)


def stamped_phases(run, layers: int) -> dict:
    """K7's device time by phase for ``run``, a call that launches K7 through
    ``ops.lm_megastep`` and returns its x_out: ``run`` is called with the
    build the wrapper holds, then with the stamped build, whose x_out must
    equal the first bit for bit (else AssertionError). Returns ``stamped_ms``
    (prologue and layers), ``barrier_us`` (one grid barrier), ``prologue_us``
    and ``us_per_layer`` (each phase, the mean over the layers)."""
    lib = cuda_build.load("lm_megastep", defines=STAMPED)
    stamped = _bind(lib)
    want = run()
    held = k7._fn
    k7._fn = stamped  # the wrapper launches the stamped build (its count still moves)
    try:
        got = run()
    finally:
        k7._fn = held
    stamps = (ctypes.c_ulonglong * STAMPS)()
    torch.cuda.synchronize()
    if lib.sa_lm_megastep_stamps(stamps) != 0:
        raise RuntimeError("reading the stamps failed")
    gap = float((got - want).abs().max())
    if gap != 0.0:
        raise AssertionError(f"the stamped build differs from K7 by {gap}")
    n_phases = len(PHASES)
    t = list(stamps)[:1 + LEAD + n_phases * layers]
    us = [(t[i + 1] - t[i]) / 1e3 for i in range(LEAD, len(t) - 1)]
    return {"stamped_ms": (t[-1] - t[LEAD - 1]) / 1e6, "barrier_us": (t[2] - t[1]) / 1e3,
            "prologue_us": (t[LEAD] - t[LEAD - 1]) / 1e3,
            "us_per_layer": {p: statistics.fmean(us[j::n_phases]) for j, p in enumerate(PHASES)}}


@torch.no_grad()
def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("profile_lm_megastep: CUDA is not available", file=sys.stderr)
        return 1
    dtype = (torch.bfloat16 if "--bf16" in argv else torch.int8 if "--int8" in argv
             else torch.float32)
    steps = [int(a) for a in argv if a not in ("--bf16", "--int8")] or [0, 125]
    cuda_build.build(["lm_megastep"], also=(("lm_megastep", STAMPED),))
    lm = seeded_init_(TransformerLM(device="cuda"), 4)
    wall, vecs = lm.prepare_megastep()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for step in steps:
        x0, mask, cache = _state(lm, step, dtype, gen)

        def run():
            return k7.lm_megastep(x0, mask, cache["kv"], cache["kv_act"], cache["table"],
                                  cache["act_src"], step, wall, vecs, lm.nhead,
                                  k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"))[0]

        ms = _ms(run)
        try:
            phases = stamped_phases(run, lm.num_layers)
        except (AssertionError, RuntimeError) as err:
            print(f"profile_lm_megastep: {err}", file=sys.stderr)
            return 1
        print(json.dumps({"device": torch.cuda.get_device_name(0), "dtype": str(dtype)[6:],
                          "step": step, "ms": ms, **phases}), flush=True)
        del x0, mask, cache
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
