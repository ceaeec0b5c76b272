#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port, ``speech_anonymization_tpu_torch``.

Usage (from the root of a checkout, on a machine with one NVIDIA card):

    python3 chip_smoke.py

Phases, one JSON line each (several for ``kernels`` and ``decode``); any
failure raises and exits non-zero:

  build    compile every CUDA source under speech_anonymization_tpu_torch/csrc
           with nvcc, and K7's stamped variant (one process each, all at once);
  kernels  each kernel at the main paths' shapes against its plain PyTorch
           twin, with its time, its plain twin's, a PyTorch library yardstick
           and the card's lower bound (CUDA events, after warm-up): K1 at the
           slice's frames (bound: its DFT product in three TF32 passes on the
           tensor cores, and ``fp32_bound_ms``, the same function all in fp32
           FMA); K2 (beam_gather) at D1's cache (and, bit-exact, f32 at
           B3's: N 198, the recipe's test decode), K3
           (attention_step) at D1, K4 (attention_step_chunked) at D2, each
           with f32 and bf16 caches, masked fresh tokens and NaN planted
           beyond the step; the other of K3/K4 is also timed at each shape;
           K5 (attention_step_paged) at D1's paged cache (f32, bf16) and on
           D2's bf16 layout (page 32, U 256: the serving decode), at the
           ASR's 8 x 96 heads and the LM's 12 x 64, and K6
           (attention_step_paged_chunked) at D2's fused one, f32 and bf16, at
           8 x 96 and (after K7, K7's attention on its own) 12 x 64,
           with the table and act_src of a simulated beam history (beams
           sharing parents) and NaN planted wherever the step may not read,
           out within 1e-5 and every written page and slot equal to the
           plain twin's; each timed case reports how its rows share pages
           (``page_sharing``); K7 (lm_megastep)
           at D2's LM cache (N 528, U 256 fused page 64, 12 layers, M 768, 12
           heads, d_ffn 3072), f32 and bf16, steps 0, 63, 64, 125, 251 of a
           simulated beam history with NaN planted where a step may not read,
           against its plain twin: a layer at a time, both fed the kernel's
           x (x within K7_LAYER_ATOL, every written page and slot within one
           bf16 ulp, the count of differing elements reported), then in one
           launch for all layers (x_out's max and mean gap within K7_ATOL and
           K7_MEAN_ATOL, the head's log-probs within rtol 0.1, atol 0.12),
           one exact-GELU step, and timed at step 125 beside the twin and the
           per-layer path (cuBLAS f32 GEMMs + K6 x 12, ``per_layer_ms``), on a
           bf16 cache too (``bf16_ms``), with its device time by phase from
           the stamped build of tools/profile_lm_megastep.py (``us_per_layer``,
           ``barrier_us``; that build's x_out must equal K7's bit for bit);
           then the int8 modes, each its own row of the kernel table
           (``<kernel>_int8``): K2 on D1's and D2's physical int8 caches
           (bit-exact), K3 at D1 (U 72) and D2 (U 256), K5 at D1's paged
           cache (U 96) and D2's page-32 one (U 256), at 8 x 96 and 12 x
           64; and the chunked int8 modes at D3 (the 30 s shape, U 512): K4
           on the physical cache, K6 on the fused page-64 one (simulated
           beam history, ``page_sharing``) at 8 x 96 and 12 x 64, both at
           steps 0, 63, 64 and 447, timed at 223; every int8 cache holds
           what a decode writes (quantize_rows of N(0, 1) rows), with code
           -128 and NaN scales wherever the step may not read: out within
           1e-5, every written code, page, slot and scale equal to the
           twin's; the library reference is two calls (torch.mul
           dequantizing the stacked k/v codes, then SDPA); last K7 on D3's
           int8 LM cache at
           steps 0, 63, 64, 223 and 447, a layer at a time (x within
           K7_LAYER_ATOL, written codes within one, their differing share
           reported, scales within K7_INT8_SCALE_RTOL) and in one launch
           (K7_ATOL, K7_MEAN_ATOL, the log-prob tolerance), timed at 223
           beside its twin, the bf16 K7 and the int8 per-layer path (cuBLAS
           + K6 int8 x 12) on the same shape; last K3 at every whole-row
           physical shape of the decode (tools/profile_k3.py ``K3_CASES``:
           f32 at D1, bf16 and int8 at D1 and D2, at 8 x 96 and 12 x 64;
           then f32 at B3's N 198, steps 1, 31 and 63: the recipe's test
           decode), each held to its twin and timed beside its twin, the library
           yardstick and its bound, with its ring, shared memory and
           registers (``"case": "k3"`` lines);
  slice    the anonymization path at bench.py's shape (32 utterances of
           161,120 samples = 10.07 s, T = 1008 frames), seeded random weights:
           anonymize, then evaluate_batch (full forward, x-vector scoring of
           clean and reconstructed features). Launch counts are reset right
           before and read right after; then the path is timed;
  train    the anonymizer's training step at convae.yaml's configuration
           (ConvAutoencoder + TDNN head, 533,123 seeded parameters, the frozen
           full-width ASRModel()'s utility term, SpecAugment from a seeded
           generator, accumulation 3, clip 5, Noam): 8 x 10.07 s (D2's
           waveforms) with 40 seeded tokens each, 6 micro-batches of the
           "generator" phase then 6 of "sex_classifier". Checks finite losses,
           K1 once a micro-batch (counts reset and read around the run), the
           masks (the frozen group bit-equal to its start, some trained
           parameter moved) and the BatchNorm statistics moving on every
           micro-batch, and K1 against its plain version on the path's own
           frames; reports ms per micro-batch and per update cycle (medians),
           audio seconds trained per wall second (summed walls after the
           first), peak memory and K1's time beside its plain version's and
           two ``torch.matmul``'s (the kernel line's yardstick) on those frames;
  train_parity  one accumulation cycle on the card and on the CPU from the
           same weights, batches and draws (tools/train_parity.py): the
           generator phase and a recon + utility one, 4 speech-like
           utterances of 2 s, a small ASR, at the CPU tests' tolerances;
  parity   the same weights and two utterances on the card and on the CPU;
  decode   the decode path at the full published ASR width (ASRModel(), 161 M
           parameters), beam 66, CTC 0.4, temperature 1.15, f32 caches:
           waveforms -> fbank (K1) -> normalizer -> ConvAutoencoder ->
           evaluate_batch with the ASR bundle (encoder similarity, beam decode
           of reconstructed and clean features, WER against seeded
           references), once with paged caches (the default on the card: K5
           at D1, K6 at D2) and once physical (``decode_paged_kv: false``: K2
           with K3 at D1, with K4 at D2). Two shapes: D1, 8 x 80,480 samples
           (5.03 s, 126 encoder frames, 64 steps; U = 72 physical, 96 paged)
           and D2, 8 x 161,120 samples (10.07 s, 252 frames, 252 steps,
           U = 256). Then the reference's LM-fused test decode: the same with a
           seeded full-width TransformerLM (vocab 5000, d_model 768, 12 heads,
           12 layers, d_ffn 3072) at lm_weight 0.6, temperature_lm 1.15: D1
           paged (K5 for all 18 layers) and physical (K3 + K2), D2 paged (K6
           for the ASR, one K7 launch a step for the LM) and D2 paged with
           ``decode_lm_megastep: false`` (K6 for all 18 layers); then D2's
           serving decode, bf16 caches (page 32: K5 for the ASR's 6 layers,
           and for the LM's 12 too; no K7), without and with the LM; and the
           int8 serving decode (whole-row caches: K5 paged, K2 + K3
           physical): D1 paged and physical with the LM, D2 paged without
           and with the LM and physical without; and D3, the JAX package's
           30 s int8 serving shape (8 x 480,000 samples, 3,001 frames, 448
           steps, U 512: the chunked int8 kernels): paged with the LM (K6 for
           the ASR, one K7 launch a step for the LM), paged with the LM per
           layer (K6 x 18), paged without it (K6 x 6) and physical (K4 + K2),
           its timing 2 decodes after the launch check; and B3,
           configs/convae.yaml's evaluation batch (3 utterances x beam 66:
           N 198) at D1's length with the LM and f32 caches, once with the
           default hparams (no decode_paged_kv override: the paging rule
           must keep N 198 physical, K3 + K2 and no paged kernel) and once
           with decode_paged_kv false, the two held token for token. Launch counts
           are reset right before each run and read right after; one more
           decode checks the launches of a single decode; then
           ``_decode_test`` is timed (``run_s``: the whole run's wall).
           Paged and physical decodes on the card give identical tokens,
           scores within 1e-4 (with the LM, and in int8, D3's too); for D2's
           and D3's K7 decode against its per-layer one, and for
           the bf16 and int8 decodes against the f32 (and bf16) ones, the
           share of identical hypotheses and the score gap are reported (bf16
           arithmetic, quantization);
  decode_parity  two utterances, beam 4, the same weights on the card (paged:
           K5 at 40 steps, D1's features; K6 at 230 steps, D2's) and on the
           CPU (physical): identical tokens and lengths, scores within 1e-3;
           the card's physical decode equal to its paged one within 1e-4;
           the LM-fused D1 decode (beam 4, 40 steps, K5 in both stacks on
           the card) against the CPU alike; and the int8 decode of D1's
           features (K5 on the card, the twins' physical path on the CPU)
           alike;
  recipe   the anonymizer recipe's epoch loop, ``SexAnonymizationBrain``, at
           convae.yaml's settings (batch 3, accumulation 3, clip 5, Noam, the
           two-phase schedule, SpecAugment, the normalizer updating): ``fit``
           for 2 epochs of 3 micro-batches of 3 x 10.07 s (the frozen
           ASRModel()'s utility), a valid batch after each (the full-width
           x-vector evaluator, the ASR encoders' similarity) saving a
           checkpoint in the JAX package's format asynchronously, then
           ``evaluate(max_key="Utility_Retention")`` on two of B3's batches
           (the checkpoints averaged; WER and WER_orig from beam-66 decodes
           with the LM at 0.6, K3 + K2; MI_bits). Checks: finite losses, both
           checkpoints on disk with the metas saved and logged, a fresh brain
           recovering the newest bit-equal, the evaluated parameters bit-equal
           to the mean of the two saved trees, ``valid_frontier`` restoring
           parameters only, the test stage's launches (K1, K2, K3, no K4-K7),
           finite WER, WER_orig, ACC_external and MI_bits; then K1 against
           its plain version on one train and one test batch's frames (3,024
           and 1,512 rows, each ending in a part block). Reports ms per
           micro-batch, the epoch and valid walls, the ms the loop spends in
           ``save_and_keep_only``, the test stage's wall and its decodes',
           peak memory and the stats.

Then the whole run's wall time (``{"phase": "wall", ...}``), the card's name
and power limit (nvidia-smi), the kernel table as one JSON object, and last
``{"ok": true, "device": {...}}``. Without CUDA the
script exits non-zero before printing any result. fp32 throughout, TF32 off
(K7 computes with bf16 weights and activations, by its contract; K1's
three-pass TF32 product keeps fp32 accuracy; the bf16 decodes keep bf16
caches, the int8 decodes int8 codes with f32 scales).
"""

from __future__ import annotations

import copy
import functools
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch.nn.functional as F  # noqa: E402

from speech_anonymization_tpu_torch.decoding import hyps_to_lists  # noqa: E402
from speech_anonymization_tpu_torch.eval.evaluator import FeatureClassifier  # noqa: E402
from speech_anonymization_tpu_torch.models import (  # noqa: E402
    ASRModel,
    ConvAutoencoder,
    TransformerLM,
    Xvector,
    XvectorClassifier,
)
from speech_anonymization_tpu_torch.ops.attention_step import (  # noqa: E402
    attention_step,
    attention_step_chunked,
    attention_step_plain,
    max_u_whole_row,
    quantize_rows,
    whole_row_layout,
)
from speech_anonymization_tpu_torch.ops.attention_step_paged import (  # noqa: E402
    attention_step_paged,
    attention_step_paged_chunked,
    attention_step_paged_fused_plain,
    attention_step_paged_plain,
    page_views,
)
from speech_anonymization_tpu_torch.ops.beam_gather import (  # noqa: E402
    beam_gather,
    beam_gather_faults,
    beam_gather_plain,
)
from speech_anonymization_tpu_torch.ops.fbank import Fbank, frame_signal  # noqa: E402
from speech_anonymization_tpu_torch.ops.lm_megastep import (  # noqa: E402
    lm_megastep,
    lm_megastep_plain,
)
from speech_anonymization_tpu_torch.ops.fbank_kernel import fused_fbank, mel_power_plain  # noqa: E402
from speech_anonymization_tpu_torch.ops.normalization import InputNormalizer, NormalizerState  # noqa: E402
from speech_anonymization_tpu_torch.recipes import anonymizer as recipe  # noqa: E402
from speech_anonymization_tpu_torch.models.transformer import (  # noqa: E402
    beam_reorder_cache,
    make_kv_cache,
)
from speech_anonymization_tpu_torch.recipes.asr_bundle import ASRBundle  # noqa: E402
from speech_anonymization_tpu_torch.tools import profile_lm_megastep  # noqa: E402
from speech_anonymization_tpu_torch.tools.profile_k3 import K3_CASES, N as K3_N, k3_inputs  # noqa: E402
from speech_anonymization_tpu_torch.tools.train_parity import (  # noqa: E402
    compare_cycle,
    convae_hparams,
    train_batch,
)
from speech_anonymization_tpu_torch.train.checkpoint import Checkpointer, read_tree  # noqa: E402
from speech_anonymization_tpu_torch.train.epoch_loop import EpochCounter  # noqa: E402
from speech_anonymization_tpu_torch.train.logger import FileTrainLogger, _format_value  # noqa: E402
from speech_anonymization_tpu_torch.train.schedulers import NoamScheduler  # noqa: E402
from speech_anonymization_tpu_torch.utils import cuda_build  # noqa: E402
from speech_anonymization_tpu_torch.utils.convert import anonymizer_state_dict  # noqa: E402
from speech_anonymization_tpu_torch.utils.seeded_init import seeded_init_  # noqa: E402

DEVICE = "cuda"
SEED = 0
BATCH = 32
N_SAMPLES = (36 * 28 - 1) * 160  # 161,120 samples: 10.07 s at 16 kHz, T = 1008 frames
SAMPLE_RATE = 16000
# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, HBM3 bandwidth (700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_TC_FLOPS = 989e12  # dense bf16 on the tensor cores
PEAK_TF32_TC_FLOPS = 495e12  # dense TF32 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
K1_RTOL = K1_ATOL = 1e-4
PARITY_ATOL = 1e-3  # card vs CPU: cuDNN and the CPU sum in different orders
# K3/K4 vs the plain twin on the same card: both f32 accumulations (bf16 caches
# round the same operands the same way), summed in other orders
ATTN_RTOL = ATTN_ATOL = 1e-5
# The decode path: ASRModel() at its published widths, the test decode without
# the LM (beam 66, CTC 0.4, temperature 1.15, length normalization, f32 caches)
DECODE_HPARAMS = {"test_beam_size": 66, "ctc_weight_decode": 0.4, "temperature": 1.15,
                  "decode_cache_dtype": "float32"}
# name: (utterances, samples, max_decode_steps); D1 is scripts/bench_decode.py's shape
# (T = 504 frames, 126 encoder frames), D2 bench.py's length (T = 1008, 252 frames),
# D3 the JAX package's 30 s int8 serving shape (BENCHMARKS.md:223-229: T = 3001,
# 751 encoder frames, 448 steps, U 512), decoded with int8 caches only
# B3 is configs/convae.yaml's evaluation batch (batch_size 3, test_beam_size
# 66: N 198, not a multiple of 8, so the paging rule keeps its caches
# physical) at D1's length
DECODE_SHAPES = {"D1": (8, 80_480, 64), "D2": (8, 161_120, None), "D3": (8, 480_000, 448),
                 "B3": (3, 80_480, 64)}
# (iters, warmup) of each shape's timed decodes; D3's launch-check decode
# right before is its warm-up
DECODE_TIMING = {"D1": (3, 1), "D2": (3, 1), "D3": (2, 0), "B3": (3, 1)}
DECODE_PARITY_ATOL = 1e-3  # scores, card vs CPU: cuBLAS and the CPU sum in other orders
# paged vs physical on the card: the same kernels' arithmetic on the same
# content (K5 is K3's, K6 K4's, with other addresses)
LAYOUT_PARITY_ATOL = 1e-4
TRAIN_BATCH = 8  # D2's waveforms: 8 x 161,120 samples
TRAIN_TOKENS = 40  # tokens_bos per utterance for the utility term
TRAIN_MICRO_BATCHES = 6  # per phase: 2 updates at gradient_accumulation 3
TRAIN_PARITY_BATCH = 4
TRAIN_PARITY_SAMPLES = 32_000  # 2 s
TRAIN_PARITY_ASR = dict(d_model=64, nhead=4, num_encoder_layers=2, num_decoder_layers=2,
                        d_ffn=128, output_neurons=100)
DECODE_LAYERS = 6  # ASRModel()'s decoder layers: one attention launch each per step
LM_LAYERS = 12  # TransformerLM()'s layers
# K7 vs its twin on the card: the same rounding points, products summed in
# other orders, so a bf16 rounding of q/k/v, the context or the hidden can
# flip by one ulp and carry through the later layers. Measured at D2's LM
# cache with seeded random weights: the x gap grows with depth, max
# 0.006-0.011 after one layer, 0.017 after two, 0.07-0.15 after twelve (mean
# 0.009-0.012).
# Checked a layer at a time (both fed the kernel's x): x within
# K7_LAYER_ATOL and every written page and slot within one bf16 ulp, past
# K7_ULP_SLACK absolute (two f32 sums in other orders differ by ~1e-6 near
# zero, where a bf16 ulp is far smaller). Checked in one launch: x_out's max
# and mean gap, and the head's log-probs at the JAX package's own tolerance
# for its megastep (rtol 0.1, atol 0.12).
K7_LAYER_ATOL = 0.02
K7_ATOL = 0.25
K7_MEAN_ATOL = 0.03
K7_ULP_SLACK = 1e-5
K7_LOGP_RTOL, K7_LOGP_ATOL = 0.1, 0.12
# int8 K7 a layer at a time: both quantize bf16-valued k/v from products
# summed in other orders, so an element, and with it the row's amax, can
# differ by one bf16 ulp: codes within one, scales within 2^-7 relative
K7_INT8_SCALE_RTOL = 2.0 ** -7
KERNEL_SOURCES = {
    "fused_fbank": ("speech_anonymization_tpu_torch/csrc/fbank.cu",
                    "speech_anonymization_tpu/ops/pallas/fbank_kernel.py:61"),
    "beam_gather": ("speech_anonymization_tpu_torch/csrc/beam_gather.cu",
                    "speech_anonymization_tpu/ops/pallas/beam_gather.py:57"),
    "attention_step": ("speech_anonymization_tpu_torch/csrc/attention_step.cu",
                       "speech_anonymization_tpu/ops/pallas/attention_step.py:50"),
    "attention_step_chunked": ("speech_anonymization_tpu_torch/csrc/attention_step.cu",
                               "speech_anonymization_tpu/ops/pallas/attention_step.py:182"),
    "attention_step_paged": ("speech_anonymization_tpu_torch/csrc/attention_step.cu",
                             "speech_anonymization_tpu/ops/pallas/attention_step.py:411"),
    "attention_step_paged_chunked": ("speech_anonymization_tpu_torch/csrc/attention_step.cu",
                                     "speech_anonymization_tpu/ops/pallas/attention_step.py:618"),
    "lm_megastep": ("speech_anonymization_tpu_torch/csrc/lm_megastep.cu",
                    "speech_anonymization_tpu/ops/pallas/lm_megastep.py:111"),
}
# the int8 modes of every kernel but K1: the same kernels' int8
# instantiations, each its own row of the table (launches counted over the
# int8 decodes)
INT8_KERNELS = ("beam_gather", "attention_step", "attention_step_chunked", "attention_step_paged",
                "attention_step_paged_chunked", "lm_megastep")
KERNEL_SOURCES.update({f"{name}_int8": KERNEL_SOURCES[name] for name in INT8_KERNELS})


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``iters`` calls."""
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


def host_median_s(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median wall time of ``fn`` in s, each call ended by a device synchronise."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def ops_ms(flops: float = 0.0, tc_flops: float = 0.0, tf32_flops: float = 0.0) -> float:
    """Least time in ms for ``flops`` at the fp32 peak and, on the tensor
    cores, ``tc_flops`` at the bf16 and ``tf32_flops`` at the TF32 peak: the
    CUDA cores and the tensor cores run at once, so the longer of the two."""
    return 1e3 * max(flops / PEAK_FP32_FLOPS,
                     tc_flops / PEAK_BF16_TC_FLOPS + tf32_flops / PEAK_TF32_TC_FLOPS)


def kernel_entry(name: str, max_abs_err: float, ms: float, plain_ms: float, flops: float,
                 nbytes: float, library_ms: float | None, tc_flops: float = 0.0,
                 tf32_flops: float = 0.0) -> dict:
    """One row of the kernel table; the bound is the larger of the operation
    time (:func:`ops_ms`) and the byte time at the HBM rate."""
    op_ms = ops_ms(flops, tc_flops, tf32_flops)
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    source, replaces = KERNEL_SOURCES[name]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": None, "max_abs_err": max_abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(op_ms, bytes_ms),
            "bound_by": "operations" if op_ms >= bytes_ms else "bytes", "library_ms": library_ms}


BUILD_REPORT: dict = {}  # phase_build's: nvcc's time and -Xptxas -v report by source


def phase_build() -> None:
    t0 = time.perf_counter()
    # and K7's stamped build, for its time by phase (phase_k7)
    BUILD_REPORT.update(cuda_build.build(also=(("lm_megastep", profile_lm_megastep.STAMPED),)))
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "sources": BUILD_REPORT})


def phase_kernels(wavs: torch.Tensor, fbank: Fbank) -> dict:
    frames = frame_signal(wavs).contiguous()
    dft, mel, frag = fbank.dft, fbank.mel, fbank.dft_frag
    rows, win = frames.shape[0] * frames.shape[1], frames.shape[2]
    n_bins, n_mels = mel.shape

    got = fused_fbank(frames, dft, mel, frag)
    want = mel_power_plain(frames, dft, mel)
    torch.cuda.synchronize()
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-30)).max())
    ok = bool(torch.allclose(got, want, rtol=K1_RTOL, atol=K1_ATOL))

    kernel_ms = cuda_ms(lambda: fused_fbank(frames, dft, mel, frag))
    plain_ms = cuda_ms(lambda: mel_power_plain(frames, dft, mel))
    spec = torch.matmul(frames, dft)
    power = spec[..., :n_bins] ** 2 + spec[..., n_bins:] ** 2
    library_ms = cuda_ms(lambda: (torch.matmul(frames, dft), torch.matmul(power, mel)))

    # the least operations an fp32-accurate result needs: the DFT product in
    # three TF32 passes on the tensor cores over the 2 * n_bins columns, re^2
    # + im^2 in fp32, and the mel product in fp32 FMA beside the tensor cores
    # or in three TF32 passes on them, whichever bounds lower
    dft_tf32 = 3 * 2 * rows * win * 2 * n_bins
    power, mel_fp32 = 3 * rows * n_bins, 2 * rows * n_bins * n_mels
    split = min(({"flops": power + mel_fp32, "tf32_flops": dft_tf32},
                 {"flops": power, "tf32_flops": dft_tf32 + 3 * mel_fp32}),
                key=lambda k: ops_ms(**k))
    nbytes = 4 * (rows * win + frag.numel() + n_bins * n_mels + rows * n_mels)
    entry = kernel_entry("fused_fbank", max_abs, kernel_ms, plain_ms, split["flops"], nbytes,
                         library_ms, tf32_flops=split["tf32_flops"])
    # the same function's bound with every product in fp32 FMA (the earlier design's)
    fp32_flops = 2 * rows * win * 2 * n_bins + power + mel_fp32
    fp32_bound_ms = max(ops_ms(fp32_flops), 1e3 * nbytes / PEAK_BYTES_PER_S)
    emit({"phase": "kernels", "kernel": "fused_fbank", "rows": rows, "shape": [rows, win, n_bins, n_mels],
          "max_abs_err": max_abs, "max_rel_err": max_rel, "rtol": K1_RTOL, "atol": K1_ATOL,
          "allclose": ok, "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
          "bound_ms": entry["bound_ms"], "bound_by": entry["bound_by"],
          "fp32_bound_ms": fp32_bound_ms, "gflop_tf32": split["tf32_flops"] / 1e9,
          "gflop_fp32": split["flops"] / 1e9, "mbytes": nbytes / 1e6,
          "share_of_bound": entry["bound_ms"] / kernel_ms})
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain twin: max abs {max_abs}, max rel {max_rel}")
    return entry


def _decode_steps(name: str) -> int:
    """Decode steps at shape D1 or D2: max_decode_steps, else one per encoder
    frame (max_decode_ratio 1.0; two stride-2 convs over T frames)."""
    _, n_samples, max_steps = DECODE_SHAPES[name]
    return max_steps or (1 + n_samples // 160 + 3) // 4


def _decode_cache_shape(name: str) -> tuple[int, int, int, int]:
    """(L, N, U, M) of the decode caches at shape D1 or D2 (make_kv_cache's U rounding)."""
    u = -(-(_decode_steps(name) + 1) // 8) * 8
    if u > max_u_whole_row(768, 4):
        u = -(-u // 64) * 64
    return 6, DECODE_SHAPES[name][0] * DECODE_HPARAMS["test_beam_size"], u, 768


def _beam_sources(n: int, gen: torch.Generator) -> torch.Tensor:
    """Seeded flat parent rows of n beam rows: each utterance's beams pick
    parents among its own."""
    beams = DECODE_HPARAMS["test_beam_size"]
    parents = torch.randint(0, beams, (n // beams, beams), generator=gen, device=DEVICE)
    return (torch.arange(n // beams, device=DEVICE)[:, None] * beams + parents).view(-1).int()


def _check_k2(a: torch.Tensor, src: torch.Tensor, steps, shape_name: str, checks: list) -> float:
    """K2 on ``a`` at each step, bit-equal to its plain twin with the tail
    left untouched; appends each check to ``checks``, returns the max abs err."""
    out, want = torch.empty_like(a), torch.empty_like(a)
    max_err = 0.0
    for step in steps:
        out.fill_(float("nan"))
        beam_gather(a, src, step, out)
        beam_gather_plain(a, src, step, want)
        torch.cuda.synchronize()
        p = step + 1
        same = torch.equal(out[:, :, :p], want[:, :, :p])
        untouched = bool(out[:, :, p:].isnan().all())
        checks.append({"shape": shape_name, "rows": a.shape[1], "dtype": str(a.dtype), "step": step,
                       "equal": same, "tail_untouched": untouched})
        if not (same and untouched):
            raise AssertionError(f"K2 disagrees with its plain twin: {checks[-1]}")
        max_err = max(max_err, float((out[:, :, :p].float() - want[:, :, :p].float()).abs().max()))
    return max_err


def phase_k2(gen: torch.Generator) -> dict:
    """K2 at D1's cache: f32 and bf16, steps 0, 31, 63 (K2a) and U - 1 (K2b);
    then f32 at the recipe's test decode (B3, N 198) on its own generator, so
    that later phases keep their inputs."""
    layers, n, u, m = _decode_cache_shape("D1")
    src = _beam_sources(n, gen)
    rows_read = int(torch.unique(src).numel())  # beams share parents: only these rows must be read
    max_err, checks = 0.0, []
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.randn(layers, n, u, m, generator=gen, device=DEVICE).to(dtype)
        out, want = torch.empty_like(a), torch.empty_like(a)
        max_err = max(max_err, _check_k2(a, src, (0, 31, 63, u - 1), "D1", checks))
        if dtype == torch.float32:
            # K2a at the mean live step of a 64-step decode, and K2b (whole rows)
            timed = {}
            for step in (31, u - 1):
                p, src_long = step + 1, src.long()
                ms = cuda_ms(lambda: beam_gather(a, src, step, out))
                plain_ms = cuda_ms(lambda: beam_gather_plain(a, src, step, want))
                library_ms = cuda_ms(lambda: torch.index_select(a[:, :, :p], 1, src_long))
                nbytes = layers * (rows_read + n) * p * m * a.element_size() + 4 * n
                timed[step] = kernel_entry("beam_gather", 0.0, ms, plain_ms, 0, nbytes, library_ms)
                timed[step]["achieved_gbps"] = nbytes / ms / 1e6
        del a, out, want
    b3 = torch.Generator(device=DEVICE).manual_seed(SEED + 21)
    b3_shape = _decode_cache_shape("B3")
    a = torch.randn(*b3_shape, generator=b3, device=DEVICE)
    src_b3 = _beam_sources(b3_shape[1], b3)
    max_err = max(max_err, _check_k2(a, src_b3, (0, 31, 63, b3_shape[2] - 1), "B3", checks))
    del a
    if beam_gather_faults(DEVICE):
        raise AssertionError("K2 met an out-of-range parent")
    entry = timed[31]
    entry["max_abs_err"] = max_err
    emit({"phase": "kernels", "kernel": "beam_gather", "cache": [layers, n, u, m],
          "distinct_parents": rows_read, "checks": checks,
          "timed": {f"step {k}": {key: e[key] for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                         "bound_by", "achieved_gbps")}
                    for k, e in timed.items()}})
    del entry["achieved_gbps"]
    return entry


def phase_k2_int8(gen: torch.Generator) -> dict:
    """K2 on int8 codes at D1's and D2's physical caches (U 72 and 256),
    steps 0, 31, 63 and U - 1, bit-exact against the twin; timed at D1's step
    31 and D2's step 125. (An int8 cache's scales move by an index_select in
    ``beam_reorder_cache``, not by K2.)"""
    beams = DECODE_HPARAMS["test_beam_size"]
    checks, timed = [], {}
    for shape_name, timed_step in (("D1", 31), ("D2", 125)):
        layers, n, u, m = _decode_cache_shape(shape_name)
        parents = torch.randint(0, beams, (n // beams, beams), generator=gen, device=DEVICE)
        src = (torch.arange(n // beams, device=DEVICE)[:, None] * beams + parents).view(-1).int()
        rows_read = int(torch.unique(src).numel())
        a = torch.randint(-128, 128, (layers, n, u, m), generator=gen, device=DEVICE,
                          dtype=torch.int8)
        out, want = torch.empty_like(a), torch.empty_like(a)
        for step in sorted({0, 31, 63, timed_step, u - 1}):
            out.fill_(99)
            want.fill_(99)
            beam_gather(a, src, step, out)
            beam_gather_plain(a, src, step, want)
            torch.cuda.synchronize()
            same = torch.equal(out, want)  # every byte: positions > step untouched on both
            checks.append({"shape": shape_name, "step": step, "equal": same})
            if not same:
                raise AssertionError(f"int8 K2 disagrees with its plain twin: {checks[-1]}")
        p, src_long = timed_step + 1, src.long()
        ms = cuda_ms(lambda: beam_gather(a, src, timed_step, out))
        plain_ms = cuda_ms(lambda: beam_gather_plain(a, src, timed_step, want))
        library_ms = cuda_ms(lambda: torch.index_select(a[:, :, :p], 1, src_long))
        nbytes = layers * (rows_read + n) * p * m + 4 * n
        timed[shape_name] = kernel_entry("beam_gather_int8", 0.0, ms, plain_ms, 0, nbytes,
                                         library_ms)
        timed[shape_name].update(step=timed_step, cache=[layers, n, u, m],
                                 achieved_gbps=nbytes / ms / 1e6)
        del a, out, want
    if beam_gather_faults(DEVICE):
        raise AssertionError("int8 K2 met an out-of-range parent")
    emit({"phase": "kernels", "kernel": "beam_gather_int8", "checks": checks,
          "timed": {k: {key: e[key] for key in ("step", "cache", "ms", "plain_ms", "library_ms",
                                                 "bound_ms", "bound_by", "achieved_gbps")}
                    for k, e in timed.items()}})
    entry = {k: v for k, v in timed["D1"].items() if k not in ("step", "cache", "achieved_gbps")}
    return entry


def _attention_inputs(shape, dtype, step: int, gen: torch.Generator):
    """Seeded operands; odd rows' fresh token masked, NaN and Inf beyond the step."""
    layers, n, u, m = shape
    q, kh, vh = (torch.randn(n, m, generator=gen, device=DEVICE) for _ in range(3))
    mask = torch.rand(n, u, generator=gen, device=DEVICE) > 0.2
    mask[:, 0] = True
    mask[0::2, step] = True
    mask[1::2, step] = False
    caches = []
    for _ in range(2):
        c = torch.randn(layers, n, u, m, generator=gen, device=DEVICE).to(dtype)
        c[:, :, step + 1:] = float("nan")
        c[:, :, step + 2:, ::5] = float("inf")
        caches.append(c)
    return q, kh, vh, mask, *caches


def phase_attention(kernel, shape_name: str, steps, timed_step: int, gen: torch.Generator) -> dict:
    """K3 or K4 at a decode shape against attention_step_plain, f32 and bf16."""
    shape = _decode_cache_shape(shape_name)
    layers, n, u, m = shape
    nhead, layer = 8, 3
    max_err, checks = 0.0, []
    for dtype in (torch.float32, torch.bfloat16):
        for step in steps:
            q, kh, vh, mask, ck, cv = _attention_inputs(shape, dtype, step, gen)
            ck2, cv2 = ck.clone(), cv.clone()
            got = kernel(q, kh, vh, mask, ck, cv, step, layer, nhead)
            want = attention_step_plain(q, kh, vh, mask, ck2, cv2, step, layer, nhead)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ok = bool(torch.isfinite(got).all()) and bool(
                torch.allclose(got, want, rtol=ATTN_RTOL, atol=ATTN_ATOL))
            writeback = all(bool(((x == y) | (x.isnan() & y.isnan())).all())
                            for x, y in ((ck, ck2), (cv, cv2)))
            checks.append({"dtype": str(dtype), "step": step, "max_abs_err": err, "allclose": ok,
                           "cache_equal": writeback})
            if not (ok and writeback):
                raise AssertionError(f"{kernel.__name__} disagrees with its plain twin: {checks[-1]}")
            if dtype == torch.float32:
                max_err = max(max_err, err)
            del q, kh, vh, mask, ck, cv, ck2, cv2
    q, kh, vh, mask, ck, cv = _attention_inputs(shape, torch.float32, timed_step, gen)
    p, d = timed_step + 1, m // nhead
    ms = cuda_ms(lambda: kernel(q, kh, vh, mask, ck, cv, timed_step, layer, nhead))
    plain_ms = cuda_ms(lambda: attention_step_plain(q, kh, vh, mask, ck, cv, timed_step, layer, nhead))
    # the other kernel on the same inputs, to see where the K3/K4 boundary should lie
    other = attention_step_chunked if kernel is attention_step else attention_step
    other_err = float((other(q, kh, vh, mask, ck, cv, timed_step, layer, nhead)
                       - attention_step_plain(q, kh, vh, mask, ck, cv, timed_step, layer,
                                              nhead)).abs().max())
    if not other_err <= ATTN_ATOL:
        raise AssertionError(f"{other.__name__} at {shape_name} disagrees with its twin: {other_err}")
    other_ms = cuda_ms(lambda: other(q, kh, vh, mask, ck, cv, timed_step, layer, nhead))
    live = [c[layer, :, :p].view(n, p, nhead, d).transpose(1, 2) for c in (ck, cv)]
    q4, live_mask = q.view(n, nhead, 1, d), mask[:, None, None, :p]
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, *live, attn_mask=live_mask))
    # Only valid cached positions before the step are read (masked ones never
    # are); the step's k/v come from kh/vh. Count what this run's mask needs.
    itemsize = 4
    valid_cached = int(mask[:, :timed_step].sum())
    valid = valid_cached + int(mask[:, timed_step].sum())
    flops = 4 * valid * d * nhead + n * nhead * p
    nbytes = (4 * n * m * 4 + n * p + 2 * valid_cached * m * itemsize
              + 2 * n * m * itemsize)
    entry = kernel_entry(kernel.__name__, max_err, ms, plain_ms, flops, nbytes, library_ms)
    emit({"phase": "kernels", "kernel": kernel.__name__, "shape": shape_name, "cache": list(shape),
          "checks": checks, "rtol": ATTN_RTOL, "atol": ATTN_ATOL, "timed_step": timed_step,
          "valid_cached_positions": valid_cached, "kernel_ms": ms, "plain_ms": plain_ms,
          "library_ms": library_ms, "bound_ms": entry["bound_ms"], "bound_by": entry["bound_by"],
          "achieved_gbps": nbytes / ms / 1e6, "share_of_bound": entry["bound_ms"] / ms,
          "other_kernel": other.__name__, "other_ms": other_ms, "other_max_abs_err": other_err,
          "other_share_of_bound": entry["bound_ms"] / other_ms})
    return entry


def _quantized(shape, gen: torch.Generator):
    """Codes (L, ..., M) and scales (L, ...): ``quantize_rows`` of seeded
    N(0, 1) rows, a layer at a time, the content a decode writes. (Codes
    drawn uniformly in +-127 at scales up to 0.05 hold values twice as
    large; over D3's 448 positions the f32 sums of K4 and its twin, taken in
    other orders, then differed by 1.3e-5 on an H100, past ATTN_ATOL, with
    every code and scale equal.)"""
    codes = torch.empty(shape, dtype=torch.int8, device=DEVICE)
    scales = torch.empty(shape[:-1], device=DEVICE)
    for layer in range(shape[0]):
        codes[layer], scales[layer] = quantize_rows(
            torch.randn(shape[1:], generator=gen, device=DEVICE))
    return codes, scales


def _int8_attention_inputs(shape, step: int, gen: torch.Generator):
    """Seeded f32 q/kh/vh, int8 codes and (L, N, U) scales (:func:`_quantized`);
    code -128 (which the quantizer never writes) and NaN scales from the step
    on and at masked positions, where no read may reach; odd rows' fresh
    token masked."""
    _, n, u, m = shape
    q, kh, vh = (torch.randn(n, m, generator=gen, device=DEVICE) for _ in range(3))
    mask = torch.rand(n, u, generator=gen, device=DEVICE) > 0.2
    mask[:, 0] = True
    mask[0::2, step] = True
    mask[1::2, step] = False
    codes, scales = zip(*(_quantized(shape, gen) for _ in range(2)))
    hidden = ~mask
    hidden[:, step:] = True
    for c, sc in zip(codes, scales):
        c[:, hidden] = -128
        sc[:, hidden] = float("nan")
    return q, kh, vh, mask, *codes, *scales


def _same_nan(x: torch.Tensor, y: torch.Tensor) -> bool:
    return bool(((x == y) | (x.isnan() & y.isnan())).all())


def _dequant_sdpa_ms(q, codes, scales, mask, nhead: int) -> float:
    """The two-call library reference of an int8 step: one torch.mul that
    dequantizes the stacked k/v codes (2, N, p, M) by their (2, N, p) scales,
    then SDPA; the stacked operands are made outside the timing."""
    _, n, p, m = codes.shape
    d = m // nhead
    c = codes.view(2, n, p, nhead, d).transpose(2, 3)
    sc = scales.view(2, n, 1, p, 1)
    q4, live_mask = q.view(n, nhead, 1, d), mask[:, None, None, :p]
    return cuda_ms(lambda: F.scaled_dot_product_attention(q4, *torch.mul(c, sc).unbind(0),
                                                          attn_mask=live_mask))


def phase_attention_int8(kernel, cases, gen: torch.Generator) -> dict:
    """K3 or K4 on int8 caches at the ASR's 8 x 96 heads against
    attention_step_plain: out within 1e-5, every code and scale bit for bit,
    at each (shape, steps, timed step) of ``cases``, timed at its timed step.
    The first case's timing is the kernels line's entry."""
    nhead, layer = 8, 3
    name = kernel.__name__ + "_int8"
    checks, timed, max_err, result = [], {}, 0.0, None
    for shape_name, steps, timed_step in cases:
        shape = _decode_cache_shape(shape_name)
        layers, n, u, m = shape
        for step in steps:
            q, kh, vh, mask, ck, cv, ks, vs = _int8_attention_inputs(shape, step, gen)
            twin = [x.clone() for x in (ck, cv, ks, vs)]
            got = kernel(q, kh, vh, mask, ck, cv, step, layer, nhead, ks, vs)
            want = attention_step_plain(q, kh, vh, mask, *twin[:2], step, layer, nhead, *twin[2:])
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ok = bool(torch.isfinite(got).all()) and bool(
                torch.allclose(got, want, rtol=ATTN_RTOL, atol=ATTN_ATOL))
            written = all(_same_nan(x, y) for x, y in zip((ck, cv, ks, vs), twin))
            checks.append({"shape": shape_name, "step": step, "max_abs_err": err, "allclose": ok,
                           "codes_and_scales_equal": written})
            if not (ok and written):
                raise AssertionError(f"{name} disagrees with its plain twin: {checks[-1]}")
            max_err = max(max_err, err)
            del q, kh, vh, mask, ck, cv, ks, vs, twin
        q, kh, vh, mask, ck, cv, ks, vs = _int8_attention_inputs(shape, timed_step, gen)
        p, d = timed_step + 1, m // nhead
        ms = cuda_ms(lambda: kernel(q, kh, vh, mask, ck, cv, timed_step, layer, nhead, ks, vs))
        plain_ms = cuda_ms(lambda: attention_step_plain(q, kh, vh, mask, ck, cv, timed_step,
                                                        layer, nhead, ks, vs))
        codes = torch.stack([c[layer, :, :p] for c in (ck, cv)])
        scales = torch.stack([sc[layer, :, :p] for sc in (ks, vs)])
        library_ms = _dequant_sdpa_ms(q, codes, scales, mask, nhead)
        # valid cached positions before the step are read (codes and own-row
        # scales); the step's k/v come from kh/vh and are written quantized
        valid_cached = int(mask[:, :timed_step].sum())
        valid = valid_cached + int(mask[:, timed_step].sum())
        flops = 4 * valid * d * nhead + n * nhead * p + 2 * valid_cached * m
        nbytes = (4 * n * m * 4 + n * p + 2 * valid_cached * (m + 4) + 2 * n * (m + 4))
        entry = kernel_entry(name, max_err, ms, plain_ms, flops, nbytes, library_ms)
        timed[shape_name] = {"step": timed_step, "cache": list(shape),
                             "valid_cached_positions": valid_cached, "kernel_ms": ms,
                             "plain_ms": plain_ms, "library_ms": library_ms,
                             "bound_ms": entry["bound_ms"], "bound_by": entry["bound_by"],
                             "achieved_gbps": nbytes / ms / 1e6,
                             "share_of_bound": entry["bound_ms"] / ms}
        if result is None:
            result = entry
        del q, kh, vh, mask, ck, cv, ks, vs, codes, scales
    result["max_abs_err"] = max_err
    emit({"phase": "kernels", "kernel": name, "nhead": nhead, "checks": checks,
          "rtol": ATTN_RTOL, "atol": ATTN_ATOL, "timed": timed,
          "library": "two calls: torch.mul dequantizing the stacked k/v codes, then SDPA"})
    return result


def _paged_inputs(shape_name: str, dtype, fused: bool, step: int, gen: torch.Generator,
                  layers: int = DECODE_LAYERS, nhead: int = 8):
    """A paged decode cache at a decode shape, after ``step`` reorders of a
    simulated beam history (parents drawn towards the best beams, so beams
    share them: the table's pages coalesce as in a real decode), with seeded
    content and NaN or Inf wherever the step may not read; seeded q/kh/vh and
    a mask with ~20% pad keys and odd rows' fresh token masked. ``layers``
    and ``nhead``: the ASR decoder's by default, the LM's for K7."""
    _, n, _, m = _decode_cache_shape(shape_name)
    beams = DECODE_HPARAMS["test_beam_size"]
    # the layout the decode takes for this dtype; the fused one is page 64's,
    # built in f32 (int8: in int8, whose fused layout is D3's)
    cache = make_kv_cache(n, _decode_steps(shape_name) + 1, layers, nhead, m // nhead,
                          torch.float32 if fused and dtype != torch.int8 else dtype,
                          device=DEVICE, paged=True, fused=fused)
    for t in range(step):
        r = torch.rand(n // beams, beams, generator=gen, device=DEVICE)
        cache = beam_reorder_cache(cache, (beams * r * r).long(), t)
    if dtype == torch.int8:
        return _paged_int8_content(cache, step, gen)
    cache = {k: v.to(dtype) if v.is_floating_point() else v for k, v in cache.items()}
    for key in ("k", "v", "kv", "k_act", "v_act", "kv_act"):
        if key in cache:
            cache[key].normal_(generator=gen)
    page = page_views(cache)[0].shape[3]
    p_act, o = divmod(step, page)
    for pages, act in zip(page_views(cache)[:2], page_views(cache)[2:]):
        pages[:, :, p_act:] = float("nan")  # the active and later pages
        act[:, :, step % 2] = float("nan")  # the slot this step writes
        act[:, :, step % 2, :, ::7] = float("inf")
        act[:, :, (step + 1) % 2, o:] = float("nan")  # the parent's slot beyond its content
    q, kh, vh = (torch.randn(n, m, generator=gen, device=DEVICE) for _ in range(3))
    mask = torch.rand(n, cache["tokens"].shape[1], generator=gen, device=DEVICE) > 0.2
    mask[:, 0] = True
    mask[0::2, step] = True
    mask[1::2, step] = False
    return q, kh, vh, mask, cache


def _paged_int8_content(cache: dict, step: int, gen: torch.Generator):
    """``_paged_inputs``' int8 content: :func:`_quantized` codes, each
    main-cache row's scale at its position, with code -128 (never written by
    the quantizer) in the pages and slots the step may not read and NaN
    scales from the step on and at masked positions."""
    n, m = cache["table"].shape[0], page_views(cache)[0].shape[-1]
    page = page_views(cache)[0].shape[3]
    for key in ("k", "v", "k_act", "v_act", "kv", "kv_act"):
        if key not in cache:
            continue
        codes, scales = _quantized(cache[key].shape, gen)
        cache[key].copy_(codes)
        if key in ("k", "v"):
            cache[f"{key}_scale"].copy_(scales)
        elif key == "kv":  # each page's rows are [K-page, V-page]
            by_page = scales.view(*scales.shape[:2], -1, 2, page)
            for j, sk in enumerate(("k_scale", "v_scale")):
                cache[sk].copy_(by_page[:, :, :, j].reshape(cache[sk].shape))
    p_act, o = divmod(step, page)
    for pages, act in zip(page_views(cache)[:2], page_views(cache)[2:]):
        pages[:, :, p_act:] = -128
        act[:, :, step % 2] = -128
        act[:, :, (step + 1) % 2, o:] = -128
    q, kh, vh = (torch.randn(n, m, generator=gen, device=DEVICE) for _ in range(3))
    mask = torch.rand(n, cache["tokens"].shape[1], generator=gen, device=DEVICE) > 0.2
    mask[:, 0] = True
    mask[0::2, step] = True
    mask[1::2, step] = False
    hidden = ~mask
    hidden[:, step:] = True
    for key in ("k_scale", "v_scale"):
        cache[key][:, hidden] = float("nan")
    return q, kh, vh, mask, cache


def _paged_logical(cache: dict, step: int, layer: int, kh, vh):
    """One layer's (N, step + 1, M) k and v as the step sees them, the fresh
    token at ``step`` (for the library yardstick; not timed)."""
    k_pages, v_pages, k_act, v_act = page_views(cache)
    n, page, m = k_pages.shape[1], k_pages.shape[3], k_pages.shape[4]
    p_act, o = divmod(step, page)
    owners, parent = cache["table"][:, :p_act].long(), cache["act_src"].long()
    cols = torch.arange(p_act, device=owners.device)
    return [torch.cat([pages[layer][owners, cols].reshape(n, p_act * page, m),
                       act[layer, parent, (step + 1) % 2, :o], fresh.to(pages.dtype)[:, None]], 1)
            for pages, act, fresh in ((k_pages, k_act, kh), (v_pages, v_act, vh))]


def _paged_cache_bytes(cache: dict, mask, step: int, itemsize: int) -> int:
    """Cache bytes one layer's paged step must move: each distinct (owner
    row, position) of the completed pages that some reader row holds valid,
    each parent's active positions (copied whole into the merged page), and
    the merged page's writeback."""
    table, act_src = cache["table"], cache["act_src"]
    n, up = table.shape
    u = cache["tokens"].shape[1]
    page = u // up
    p_act, o = divmod(step, page)
    pos = torch.arange(p_act * page, device=table.device)
    owner_pos = table[:, pos // page].long() * u + pos
    main = int(torch.unique(owner_pos[mask[:, :p_act * page]]).numel())
    active = int(torch.unique(act_src).numel()) * o
    m = page_views(cache)[0].shape[-1]
    return 2 * (main + active + n * (o + 1)) * m * itemsize


def _mask_table_bytes(cache: dict, step: int) -> int:
    """The mask up to the step, the table's completed columns and act_src."""
    n, up = cache["table"].shape
    p_act = step // (cache["tokens"].shape[1] // up)
    return n * (step + 1) + 4 * (n * p_act + n)


def _paged_bytes(cache: dict, mask, step: int, itemsize: int) -> int:
    """Bytes one paged attention launch must move: one layer's cache bytes,
    q/kh/vh/out, the mask and the table."""
    n, m = cache["table"].shape[0], page_views(cache)[0].shape[-1]
    return (_paged_cache_bytes(cache, mask, step, itemsize) + 4 * n * m * 4
            + _mask_table_bytes(cache, step))


def _equal_buffers(a: dict, b: dict) -> bool:
    """Every k/v buffer (and int8 scale) equal, NaN where NaN, layer by layer."""
    for key in ("k", "v", "kv", "k_act", "v_act", "kv_act", "k_scale", "v_scale"):
        if key in a:
            for x, y in zip(a[key], b[key]):
                if not bool(((x == y) | (x.isnan() & y.isnan())).all()):
                    return False
    return True


def _page_sharing(cache: dict, step: int) -> dict:
    """How the rows share the completed pages one step reads: reader pages
    (rows x completed pages) and the distinct (owner row, page) pairs among
    them."""
    table = cache["table"]
    n, up = table.shape
    p_act = step // (cache["tokens"].shape[1] // up)
    cols = torch.arange(p_act, device=table.device)
    distinct = int(torch.unique(table[:, :p_act].long() * up + cols).numel())
    readers = n * p_act
    return {"reader_pages": readers, "distinct_owner_pages": distinct,
            "distinct_per_reader": distinct / readers if readers else None}


def phase_paged_attention(kernel, checks_at, timed_at, gen: torch.Generator, nhead: int = 8) -> dict:
    """K5 (split layout) or K6 (fused) against its plain twin: out within
    rtol/atol 1e-5 and every page and slot (and int8 scale) equal, at each
    (shape, dtype, steps) of ``checks_at``; then timed at each (shape, dtype,
    step) of ``timed_at`` (the first is the kernels line's entry; int8 cases
    make an ``_int8`` entry, with the two-call dequantize + SDPA reference).
    ``nhead``: 8 (the ASR's 8 x 96) or 12 (the LM's 12 x 64)."""
    layer = 3
    fused = kernel is attention_step_paged_chunked
    quant = {dtype for _, dtype, _ in checks_at} == {torch.int8}
    name = kernel.__name__ + ("_int8" if quant else "")
    twin = attention_step_paged_fused_plain if fused else attention_step_paged_plain
    max_err, checks = 0.0, []
    for shape_name, dtype, steps in checks_at:
        for step in steps:
            q, kh, vh, mask, cache = _paged_inputs(shape_name, dtype, fused, step, gen)
            twin_cache = {k: v.clone() for k, v in cache.items()}
            got = kernel(q, kh, vh, mask, cache, step, layer, nhead)
            want = twin(q, kh, vh, mask, twin_cache, step, layer, nhead)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ok = bool(torch.isfinite(got).all()) and bool(
                torch.allclose(got, want, rtol=ATTN_RTOL, atol=ATTN_ATOL))
            same = _equal_buffers(cache, twin_cache)
            checks.append({"shape": shape_name, "dtype": str(dtype), "step": step,
                           "max_abs_err": err, "allclose": ok, "pages_and_slots_equal": same,
                           "distinct_parents": int(torch.unique(cache["act_src"]).numel())})
            if not (ok and same):
                raise AssertionError(f"{name} disagrees with its plain twin: {checks[-1]}")
            max_err = max(max_err, err)
            del q, kh, vh, mask, cache, twin_cache
    timed, result = {}, None
    for case_shape, dtype, step in timed_at:
        q, kh, vh, mask, cache = _paged_inputs(case_shape, dtype, fused, step, gen)
        d = q.shape[1] // nhead
        ms = cuda_ms(lambda: kernel(q, kh, vh, mask, cache, step, layer, nhead))
        plain_ms = cuda_ms(lambda: twin(q, kh, vh, mask, cache, step, layer, nhead))
        valid = int(mask[:, :step + 1].sum())
        flops = 4 * valid * d * nhead + mask.shape[0] * nhead * (step + 1)
        nbytes = _paged_bytes(cache, mask, step, dtype.itemsize)
        if quant:
            # the fresh token's codes and scale, then the logical codes
            fresh = [quantize_rows(x) for x in (kh, vh)]
            codes = torch.stack(_paged_logical(cache, step, layer, *(c for c, _ in fresh)))
            scales = torch.stack([torch.cat([cache[key][layer, :, :step], sc[:, None]], 1)
                                  for key, (_, sc) in zip(("k_scale", "v_scale"), fresh)])
            library_ms = _dequant_sdpa_ms(q, codes, scales, mask, nhead)
            valid_cached = int(mask[:, :step].sum())
            # own-row scales read at the valid cached positions and written at
            # the step (k and v, 4 B each); each cached code is dequantized once
            nbytes += 8 * (valid_cached + mask.shape[0])
            flops += 2 * valid_cached * q.shape[1]
            del codes, scales
        else:
            k_log, v_log = (x.view(x.shape[0], step + 1, nhead, d).transpose(1, 2)
                            for x in _paged_logical(cache, step, layer, kh, vh))
            q4, live_mask = q.to(dtype).view(-1, nhead, 1, d), mask[:, None, None, :step + 1]
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, k_log, v_log,
                                                                         attn_mask=live_mask))
            del k_log, v_log
        entry = kernel_entry(name, max_err, ms, plain_ms, flops, nbytes, library_ms)
        timed[f"{case_shape} {str(dtype)[6:]}"] = {
            "cache": [list(v.shape) for k, v in cache.items() if k in ("k", "kv")][0],
            "table": list(cache["table"].shape), "step": step,
            "distinct_parents": int(torch.unique(cache["act_src"]).numel()),
            "page_sharing": _page_sharing(cache, step),
            "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": entry["bound_ms"], "bound_by": entry["bound_by"],
            "mbytes": nbytes / 1e6, "achieved_gbps": nbytes / ms / 1e6,
            "share_of_bound": entry["bound_ms"] / ms}
        if result is None:
            result = entry
        del q, kh, vh, mask, cache
    emit({"phase": "kernels", "kernel": name, "nhead": nhead,
          "layout": "fused" if fused else "split", "checks": checks, "rtol": ATTN_RTOL,
          "atol": ATTN_ATOL, "timed": timed,
          "library": ("two calls: torch.mul dequantizing the stacked logical k/v codes, then SDPA"
                      if quant else "SDPA")
          + " over the logical buffer, materialized outside the timing"})
    return result


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor, slack: float = 0.0) -> torch.Tensor:
    """Per element (|a - b| - slack)+ in bf16 ulps of the larger magnitude; 0
    where equal (Inf too) or both NaN."""
    a, b = a.float(), b.float()
    big = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    ulps = ((a - b).abs() - slack).clamp_min(0.0) / torch.exp2(torch.floor(torch.log2(big)) - 7)
    return torch.where((a == b) | (a.isnan() & b.isnan()), torch.zeros_like(ulps), ulps)


@torch.no_grad()
def phase_k7(lm: TransformerLM, gen: torch.Generator) -> dict:
    """K7 at D2's LM cache against its plain twin, f32 and bf16, then timed at
    step 125 (f32) beside the twin and the per-layer path on the same state."""
    wall, vecs = lm.prepare_megastep()
    nhead, layers, nf = lm.nhead, lm.num_layers, lm.d_ffn // lm.d_model
    nb = 4 + 2 * nf  # weight blocks a layer
    checks, max_err = [], 0.0

    def run(kernel, x0, mask, cache, step, exact_gelu=False):
        return kernel(x0, mask, cache["kv"], cache["kv_act"], cache["table"], cache["act_src"], step,
                      wall, vecs, nhead, exact_gelu=exact_gelu)[0]

    def layer_of(layer, c):
        return {"kv": c["kv"][layer:layer + 1], "kv_act": c["kv_act"][layer:layer + 1],
                "table": c["table"], "act_src": c["act_src"]}

    cases = [(dtype, step, False) for dtype in (torch.float32, torch.bfloat16)
             for step in (0, 63, 64, 125, 251)] + [(torch.bfloat16, 125, True)]
    for dtype, step, exact in cases:
        x0, _, _, mask, cache = _paged_inputs("D2", dtype, True, step, gen, layers, nhead)
        twin_cache = {k: v.clone() for k, v in cache.items()}
        # 1. a layer at a time, both fed the kernel's x: every layer's written
        # pages and slots within one bf16 ulp, its x within K7_LAYER_ATOL
        pages = {key: {"differing": 0, "beyond_one_ulp": 0, "max_ulps_past_slack": 0.0,
                       "nan_matches": True} for key in ("kv", "kv_act")}
        x, layer_errs = x0, []
        for layer in range(layers):
            lw, lv = wall[layer * nb:(layer + 1) * nb], vecs[layer:layer + 1]
            c, tc = layer_of(layer, cache), layer_of(layer, twin_cache)
            got_l = lm_megastep(x, mask, c["kv"], c["kv_act"], c["table"], c["act_src"], step, lw, lv,
                                nhead, exact_gelu=exact)[0]
            want_l = lm_megastep_plain(x, mask, tc["kv"], tc["kv_act"], tc["table"], tc["act_src"],
                                       step, lw, lv, nhead, exact_gelu=exact)[0]
            layer_errs.append(float((got_l - want_l).abs().max()))
            for key, stats in pages.items():
                a, b = cache[key][layer], twin_cache[key][layer]
                ulps = _bf16_ulps(a, b, K7_ULP_SLACK)
                stats["differing"] += int(((a != b) & ~(a.isnan() & b.isnan())).sum())
                stats["beyond_one_ulp"] += int((ulps > 1).sum())
                stats["max_ulps_past_slack"] = max(stats["max_ulps_past_slack"], float(ulps.max()))
                stats["nan_matches"] &= bool((a.isnan() == b.isnan()).all())
                del ulps
            x = got_l
        # 2. one launch for every layer against the twin from the same state
        # (the step never reads what it writes: the written pages are rewritten)
        got = run(lm_megastep, x0, mask, cache, step, exact)
        want = run(lm_megastep_plain, x0, mask, twin_cache, step, exact)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        mean_err = float((got - want).abs().mean())
        lp_got, lp_want = (torch.log_softmax(lm._head(x), -1) for x in (got, want))
        lp_err = float((lp_got - lp_want).abs().max())
        lp_ok = bool(torch.allclose(lp_got, lp_want, rtol=K7_LOGP_RTOL, atol=K7_LOGP_ATOL))
        ok = (bool(torch.isfinite(got).all()) and err <= K7_ATOL and mean_err <= K7_MEAN_ATOL
              and lp_ok and max(layer_errs) <= K7_LAYER_ATOL
              and all(p["beyond_one_ulp"] == 0 and p["nan_matches"] for p in pages.values()))
        checks.append({"dtype": str(dtype), "step": step, "exact_gelu": exact, "max_abs_err": err,
                       "mean_abs_err": mean_err, "log_prob_max_abs_err": lp_err,
                       "layer_by_layer_max_abs_err": layer_errs, "written": pages, "ok": ok})
        if not ok:
            raise AssertionError(f"lm_megastep disagrees with its plain twin: {checks[-1]}")
        if dtype == torch.float32:
            max_err = max(max_err, err)
        del x0, mask, cache, twin_cache, got, want
        torch.cuda.empty_cache()

    step = 125
    x0, _, _, mask, cache = _paged_inputs("D2", torch.float32, True, step, gen, layers, nhead)
    ms = cuda_ms(lambda: run(lm_megastep, x0, mask, cache, step), iters=10)
    plain_ms = cuda_ms(lambda: run(lm_megastep_plain, x0, mask, cache, step), iters=3, warmup=1)
    per_layer_ms = cuda_ms(lambda: lm.step_layers(x0, cache, mask, step), iters=10)
    # the device time by phase, from the stamped build (which must equal K7 bit for bit)
    phases = profile_lm_megastep.stamped_phases(lambda: run(lm_megastep, x0, mask, cache, step),
                                                layers)
    x0b, _, _, maskb, cacheb = _paged_inputs("D2", torch.bfloat16, True, step, gen, layers, nhead)
    bf16_ms = cuda_ms(lambda: run(lm_megastep, x0b, maskb, cacheb, step), iters=10)
    del x0b, maskb, cacheb
    n, m = x0.shape
    d = m // nhead
    valid = int(mask[:, :step + 1].sum())
    flops = layers * (4 * valid * d * nhead + n * nhead * (step + 1))
    tc_flops = 2 * n * m * m * (4 + 2 * nf) * layers
    # q/k/v, the context and the layers' x stay in K7's L2-resident scratch:
    # the function moves each layer's cache bytes, the mask and table once,
    # the weights, and x in and out
    nbytes = (layers * _paged_cache_bytes(cache, mask, step, 4) + _mask_table_bytes(cache, step)
              + wall.numel() * 2 + vecs.numel() * 4 + 2 * n * m * 4)
    entry = kernel_entry("lm_megastep", max_err, ms, plain_ms, flops, nbytes, None, tc_flops)
    entry.update(per_layer_ms=per_layer_ms, bf16_ms=bf16_ms, barrier_us=phases["barrier_us"],
                 us_per_layer=phases["us_per_layer"])
    emit({"phase": "kernels", "kernel": "lm_megastep", "cache": list(cache["kv"].shape),
          "slots": list(cache["kv_act"].shape), "layers": layers, "nhead": nhead, "d_ffn": lm.d_ffn,
          "checks": checks, "atol": K7_ATOL, "mean_atol": K7_MEAN_ATOL,
          "layer_atol": K7_LAYER_ATOL, "ulp_slack": K7_ULP_SLACK,
          "log_prob_rtol_atol": [K7_LOGP_RTOL, K7_LOGP_ATOL], "timed_step": step,
          "distinct_parents": int(torch.unique(cache["act_src"]).numel()), "kernel_ms": ms,
          "plain_ms": plain_ms, "per_layer_ms": per_layer_ms, "bf16_ms": bf16_ms, **phases,
          "library_ms": None,
          "bound_ms": entry["bound_ms"], "bound_by": entry["bound_by"], "mbytes": nbytes / 1e6,
          "gflop_tensor_core": tc_flops / 1e9, "gflop_fp32": flops / 1e9,
          "achieved_gbps": nbytes / ms / 1e6, "share_of_bound": entry["bound_ms"] / ms})
    del x0, mask, cache
    torch.cuda.empty_cache()
    return entry


def _k7_run(kernel, x0, mask, cache, step, wall, vecs, nhead):
    """x_out of one K7 (or twin) call on a fused int8 cache dict and its scales."""
    return kernel(x0, mask, cache["kv"], cache["kv_act"], cache["table"], cache["act_src"], step,
                  wall, vecs, nhead, k_scale=cache["k_scale"], v_scale=cache["v_scale"])[0]


@torch.no_grad()
def phase_k7_int8(lm: TransformerLM, gen: torch.Generator) -> dict:
    """K7 on D3's int8 LM cache (U 512, fused page 64) against its plain twin
    at steps 0, 63, 64, 223 and 447 of a simulated beam history, code -128
    and NaN scales wherever the step may not read: a layer at a time, both
    fed the kernel's x (x within K7_LAYER_ATOL; the written codes within
    one of the twin's, the share that differs reported; the step's scales
    within K7_INT8_SCALE_RTOL; every other code and scale equal), then in one
    launch (K7_ATOL, K7_MEAN_ATOL, the log-prob tolerance); timed at step 223
    beside the twin, the bf16 K7 and the int8 per-layer path."""
    wall, vecs = lm.prepare_megastep()
    nhead, layers, nf = lm.nhead, lm.num_layers, lm.d_ffn // lm.d_model
    nb = 4 + 2 * nf
    i8 = torch.int8
    checks, max_err = [], 0.0

    def layer_of(layer, c):
        return {key: c[key][layer:layer + 1] for key in ("kv", "kv_act", "k_scale", "v_scale")} | {
            "table": c["table"], "act_src": c["act_src"]}

    for step in (0, 63, 64, 223, 447):
        x0, _, _, mask, cache = _paged_inputs("D3", i8, True, step, gen, layers, nhead)
        twin_cache = {k: v.clone() for k, v in cache.items()}
        n, m = x0.shape
        written = {"codes": 2 * layers * n * m, "codes_differing": 0, "codes_beyond_one": 0,
                   "scale_max_rel_err": 0.0, "unwritten_equal": True}
        x, layer_errs = x0, []
        for layer in range(layers):
            lw, lv = wall[layer * nb:(layer + 1) * nb], vecs[layer:layer + 1]
            c, tc = layer_of(layer, cache), layer_of(layer, twin_cache)
            got_l = _k7_run(lm_megastep, x, mask, c, step, lw, lv, nhead)
            want_l = _k7_run(lm_megastep_plain, x, mask, tc, step, lw, lv, nhead)
            layer_errs.append(float((got_l - want_l).abs().max()))
            for key in ("kv", "kv_act"):
                diff = (cache[key][layer].int() - twin_cache[key][layer].int()).abs()
                written["codes_differing"] += int((diff > 0).sum())
                written["codes_beyond_one"] += int((diff > 1).sum())
            for key in ("k_scale", "v_scale"):
                a, b = cache[key][layer], twin_cache[key][layer]
                rel = float((a[:, step] / b[:, step] - 1).abs().max())
                written["scale_max_rel_err"] = max(written["scale_max_rel_err"], rel)
                written["unwritten_equal"] &= (_same_nan(a[:, :step], b[:, :step])
                                               and _same_nan(a[:, step + 1:], b[:, step + 1:]))
            x = got_l
        got = _k7_run(lm_megastep, x0, mask, cache, step, wall, vecs, nhead)
        want = _k7_run(lm_megastep_plain, x0, mask, twin_cache, step, wall, vecs, nhead)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        mean_err = float((got - want).abs().mean())
        lp_got, lp_want = (torch.log_softmax(lm._head(y), -1) for y in (got, want))
        lp_err = float((lp_got - lp_want).abs().max())
        lp_ok = bool(torch.allclose(lp_got, lp_want, rtol=K7_LOGP_RTOL, atol=K7_LOGP_ATOL))
        written["codes_differing_share"] = written["codes_differing"] / written["codes"]
        ok = (bool(torch.isfinite(got).all()) and err <= K7_ATOL and mean_err <= K7_MEAN_ATOL
              and lp_ok and max(layer_errs) <= K7_LAYER_ATOL and written["codes_beyond_one"] == 0
              and written["scale_max_rel_err"] <= K7_INT8_SCALE_RTOL and written["unwritten_equal"])
        checks.append({"step": step, "max_abs_err": err, "mean_abs_err": mean_err,
                       "log_prob_max_abs_err": lp_err, "layer_by_layer_max_abs_err": layer_errs,
                       "written": written, "ok": ok})
        if not ok:
            raise AssertionError(f"lm_megastep_int8 disagrees with its plain twin: {checks[-1]}")
        max_err = max(max_err, err)
        del x0, mask, cache, twin_cache, got, want
        torch.cuda.empty_cache()

    step = 223
    x0, _, _, mask, cache = _paged_inputs("D3", i8, True, step, gen, layers, nhead)
    ms = cuda_ms(lambda: _k7_run(lm_megastep, x0, mask, cache, step, wall, vecs, nhead), iters=10)
    plain_ms = cuda_ms(lambda: _k7_run(lm_megastep_plain, x0, mask, cache, step, wall, vecs,
                                       nhead), iters=3, warmup=1)
    per_layer_ms = cuda_ms(lambda: lm.step_layers(x0, cache, mask, step), iters=10)
    phases = profile_lm_megastep.stamped_phases(
        lambda: _k7_run(lm_megastep, x0, mask, cache, step, wall, vecs, nhead), layers)
    x0b, _, _, maskb, cacheb = _paged_inputs("D3", torch.bfloat16, True, step, gen, layers, nhead)
    bf16_ms = cuda_ms(lambda: lm_megastep(x0b, maskb, cacheb["kv"], cacheb["kv_act"],
                                          cacheb["table"], cacheb["act_src"], step, wall, vecs,
                                          nhead)[0], iters=10)
    del x0b, maskb, cacheb
    n, m = x0.shape
    d = m // nhead
    valid = int(mask[:, :step + 1].sum())
    valid_cached = int(mask[:, :step].sum())
    # each cached code dequantized once a layer
    flops = layers * (4 * valid * d * nhead + n * nhead * (step + 1) + 2 * valid_cached * m)
    tc_flops = 2 * n * m * m * (4 + 2 * nf) * layers
    # each layer's codes, its own-row scales read at the valid cached
    # positions and written at the step (k and v), the mask and table once,
    # the weights, and x in and out
    nbytes = (layers * (_paged_cache_bytes(cache, mask, step, 1) + 8 * (valid_cached + n))
              + _mask_table_bytes(cache, step) + wall.numel() * 2 + vecs.numel() * 4
              + 2 * n * m * 4)
    entry = kernel_entry("lm_megastep_int8", max_err, ms, plain_ms, flops, nbytes, None, tc_flops)
    entry.update(per_layer_ms=per_layer_ms, bf16_ms=bf16_ms, barrier_us=phases["barrier_us"],
                 us_per_layer=phases["us_per_layer"])
    emit({"phase": "kernels", "kernel": "lm_megastep_int8", "cache": list(cache["kv"].shape),
          "slots": list(cache["kv_act"].shape), "layers": layers, "nhead": nhead,
          "d_ffn": lm.d_ffn, "checks": checks, "atol": K7_ATOL, "mean_atol": K7_MEAN_ATOL,
          "layer_atol": K7_LAYER_ATOL, "scale_rtol": K7_INT8_SCALE_RTOL,
          "log_prob_rtol_atol": [K7_LOGP_RTOL, K7_LOGP_ATOL], "timed_step": step,
          "distinct_parents": int(torch.unique(cache["act_src"]).numel()),
          "page_sharing": _page_sharing(cache, step), "kernel_ms": ms, "plain_ms": plain_ms,
          "per_layer_ms": per_layer_ms, "bf16_ms": bf16_ms, **phases, "library_ms": None,
          "bound_ms": entry["bound_ms"], "bound_by": entry["bound_by"], "mbytes": nbytes / 1e6,
          "gflop_tensor_core": tc_flops / 1e9, "gflop_fp32": flops / 1e9,
          "achieved_gbps": nbytes / ms / 1e6, "share_of_bound": entry["bound_ms"] / ms})
    del x0, mask, cache
    torch.cuda.empty_cache()
    return entry


def _k3_registers() -> dict:
    """Registers of each K3 instantiation (cache type, score lanes a
    position), from phase_build's -Xptxas -v report."""
    types = {"f": "float32", "13__nv_bfloat16": "bfloat16", "a": "int8"}
    regs, name = {}, None
    for line in BUILD_REPORT.get("attention_step", {}).get("ptxas", "").splitlines():
        m = re.search(r"Compiling entry function '\S*attn_step_whole_rowI(f|13__nv_bfloat16|a)Li(\d+)E", line)
        if m:
            name = f"{types[m[1]]} group {m[2]}"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            regs[name], name = int(m[1]), None
    return regs


# K3 at the recipe's test decode (B3: 3 utterances x beam 66 = N 198, U 72,
# f32 caches), steps 1, 31 and 63 (at step 0 k3_inputs masks every position
# of its odd rows), at 8 x 96 and 12 x 64
_, B3_ROWS, B3_U, _ = _decode_cache_shape("B3")
K3_B3_CASES = [("float32", "B3", B3_U, step, nhead) for step in (1, 31, 63) for nhead in (8, 12)]


def phase_k3() -> list[dict]:
    """K3 at the decode's whole-row physical shapes (tools/profile_k3.py
    ``K3_CASES``: f32 at D1, bf16 and int8 at D1 and D2, at 8 x 96 and 12 x
    64, N 528, on that tool's seeded inputs; then ``K3_B3_CASES`` at N 198):
    out within 1e-5 of the plain twin's and the caches (codes, scales)
    written alike; then K3's time, the twin's, the library's (SDPA; int8 two
    calls), the bound and its share, the launch's shared memory and the
    registers nvcc reports. Its own generator, so every earlier phase keeps
    its inputs."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    regs = _k3_registers()
    rows = []
    for case, n_rows in [(c, K3_N) for c in K3_CASES] + [(c, B3_ROWS) for c in K3_B3_CASES]:
        dtype_name, shape_name, u, step, nhead = case
        q, kh, vh, mask, ck, cv, ks, vs = k3_inputs(case, gen, DEVICE, n=n_rows)
        n, m = q.shape
        d, p, int8 = m // nhead, step + 1, dtype_name == "int8"
        twin = [None if x is None else x.clone() for x in (ck, cv, ks, vs)]
        got = attention_step(q, kh, vh, mask, ck, cv, step, 3, nhead, ks, vs)
        want = attention_step_plain(q, kh, vh, mask, *twin[:2], step, 3, nhead, *twin[2:])
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(torch.isfinite(got).all()) and bool(
            torch.allclose(got, want, rtol=ATTN_RTOL, atol=ATTN_ATOL))
        written = all(_same_nan(x, y) for x, y in zip((ck, cv, ks, vs), twin) if x is not None)
        if not (ok and written):
            raise AssertionError(f"K3 {case} disagrees with its plain twin: max abs {err}, "
                                 f"caches equal {written}")
        run = lambda: attention_step(q, kh, vh, mask, ck, cv, step, 3, nhead, ks, vs)  # noqa: E731
        ms = cuda_ms(run)
        plain_ms = cuda_ms(lambda: attention_step_plain(q, kh, vh, mask, ck, cv, step, 3, nhead,
                                                        ks, vs))
        if int8:
            codes = torch.stack([c[3, :, :p] for c in (ck, cv)])
            scales = torch.stack([sc[3, :, :p] for sc in (ks, vs)])
            library_ms = _dequant_sdpa_ms(q, codes, scales, mask, nhead)
            del codes, scales
        else:
            live = [c[3, :, :p].view(n, p, nhead, d).transpose(1, 2) for c in (ck, cv)]
            q4, live_mask = q.view(n, nhead, 1, d).to(ck.dtype), mask[:, None, None, :p]
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q4, *live,
                                                                        attn_mask=live_mask))
        # valid cached positions before the step are read (int8 with their
        # own-row scales); the step's k/v come from kh/vh and are written
        valid_cached = int(mask[:, :step].sum())
        valid = valid_cached + int(mask[:, step].sum())
        flops = 4 * valid * d * nhead + n * nhead * p
        if int8:
            flops += 2 * valid_cached * m
            nbytes = 4 * n * m * 4 + n * p + 2 * valid_cached * (m + 4) + 2 * n * (m + 4)
        else:
            itemsize = ck.element_size()
            nbytes = 4 * n * m * 4 + n * p + 2 * valid_cached * m * itemsize + 2 * n * m * itemsize
        entry = kernel_entry("attention_step_int8" if int8 else "attention_step", err, ms,
                             plain_ms, flops, nbytes, library_ms)
        chunk, slots, smem = whole_row_layout(step, d, ck.element_size())
        vecs = d * ck.element_size() // 16
        group = 8 if vecs <= 8 else (16 if vecs <= 16 else 32)
        row = {"phase": "kernels", "kernel": "attention_step", "case": "k3", "dtype": dtype_name,
               "shape": shape_name, "cache": list(ck.shape), "step": step, "heads": nhead,
               "max_abs_err": err, "rtol": ATTN_RTOL, "atol": ATTN_ATOL, "kernel_ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": entry["bound_ms"],
               "bound_by": entry["bound_by"], "share_of_bound": entry["bound_ms"] / ms,
               "valid_cached_positions": valid_cached, "ring": {"chunk": chunk, "slots": slots},
               "smem_bytes": smem, "registers": regs.get(f"{dtype_name} group {group}")}
        emit(row)
        rows.append(row)
        del q, kh, vh, mask, ck, cv, ks, vs, twin, got, want
        torch.cuda.empty_cache()
    return rows


def phase_decode_kernels(lm: TransformerLM) -> list[dict]:
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    # timed at each shape's mean live step: 31 of 0..63 (D1), 125 of 0..251 (D2)
    entries = [phase_k2(gen),
               phase_attention(attention_step, "D1", (0, 7, 8, 63), 31, gen),
               phase_attention(attention_step_chunked, "D2", (0, 63, 64, 251), 125, gen)]
    torch.cuda.empty_cache()
    # the same timed steps as K3 and K4; the checks cross page completions
    # (page 32: step 31 writes main page 0; the fused page 64: step 63). K5
    # serves D1's f32 caches and D2's bf16 ones (page 32, U 256: the serving
    # decode), at the ASR's 8 x 96 heads and the LM's 12 x 64
    f32, bf16 = torch.float32, torch.bfloat16
    k5_checks = [("D1", f32, (0, 31, 32, 50, 95)), ("D1", bf16, (0, 31, 32, 50, 95)),
                 ("D2", bf16, (0, 31, 32, 125, 255))]
    k5_timed = [("D1", f32, 31), ("D2", bf16, 125)]
    entries += [phase_paged_attention(attention_step_paged, k5_checks, k5_timed, gen),
                phase_paged_attention(attention_step_paged_chunked,
                                      [("D2", dt, (0, 63, 64, 125, 251)) for dt in (f32, bf16)],
                                      [("D2", f32, 125)], gen)]
    phase_paged_attention(attention_step_paged, k5_checks, k5_timed, gen, nhead=12)
    torch.cuda.empty_cache()
    entries.append(phase_k7(lm, gen))
    # K6 at the LM's 12 x 64, the shape of K7's attention phase; after K7, so
    # that K7's seeded inputs are those of earlier trees
    phase_paged_attention(attention_step_paged_chunked,
                          [("D2", dt, (0, 63, 64, 125, 251)) for dt in (f32, bf16)],
                          [("D2", f32, 125), ("D2", bf16, 125)], gen, nhead=12)
    torch.cuda.empty_cache()
    # int8 (K2, K3, K5), after every earlier phase so that theirs keep the
    # seeded inputs of earlier trees: D1's and D2's caches, both whole-row
    i8 = torch.int8
    k5_int8_checks = [("D1", i8, (0, 31, 32, 50, 95)), ("D2", i8, (0, 31, 32, 125, 255))]
    k5_int8_timed = [("D1", i8, 31), ("D2", i8, 125)]
    k3_int8 = (("D1", (0, 7, 8, 31, 63), 31), ("D2", (0, 63, 64, 125, 251), 125))
    entries += [phase_k2_int8(gen), phase_attention_int8(attention_step, k3_int8, gen),
                phase_paged_attention(attention_step_paged, k5_int8_checks, k5_int8_timed, gen)]
    phase_paged_attention(attention_step_paged, k5_int8_checks, k5_int8_timed, gen, nhead=12)
    torch.cuda.empty_cache()
    # the chunked int8 modes (K4, K6, K7) at D3, after the whole-row ones:
    # steps before, on and after page 0's completion and the last, timed at
    # the mean live step of a 448-step decode
    d3_steps = (0, 63, 64, 447)
    entries.append(phase_attention_int8(attention_step_chunked, (("D3", d3_steps, 223),), gen))
    torch.cuda.empty_cache()
    k6_int8 = ([("D3", i8, d3_steps)], [("D3", i8, 223)])
    entries.append(phase_paged_attention(attention_step_paged_chunked, *k6_int8, gen))
    phase_paged_attention(attention_step_paged_chunked, *k6_int8, gen, nhead=12)
    torch.cuda.empty_cache()
    entries.append(phase_k7_int8(lm, gen))
    torch.cuda.empty_cache()
    phase_k3()
    return entries


def build_models(device: str):
    model = seeded_init_(ConvAutoencoder(device=device), SEED)
    emb = seeded_init_(Xvector(device=device), SEED + 1)
    clf = seeded_init_(XvectorClassifier(device=device), SEED + 2)
    return model, emb, clf


def _finite(name: str, x: torch.Tensor, shape: tuple) -> None:
    if tuple(x.shape) != shape:
        raise AssertionError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
    if not bool(torch.isfinite(x).all()):
        raise AssertionError(f"{name}: non-finite values")


def phase_slice(wavs, lens, labels, fbank, normalizer, models, card: str) -> dict:
    model, emb, clf = models
    t_frames = 1 + N_SAMPLES // 160
    # frozen normalizer statistics, as after training: one update on this batch
    _, norm_state = normalizer(normalizer.init_state(DEVICE), fbank(wavs), lens, 0, training=True)
    ext = FeatureClassifier(emb, clf, normalizer.init_state(DEVICE), normalizer)
    metrics = recipe.EvalMetrics()
    torch.cuda.synchronize()

    fused_fbank.launches = 0
    recon = recipe.anonymize(model, fbank, normalizer, norm_state, wavs, lens)
    loss = recipe.evaluate_batch(model, fbank, normalizer, norm_state, wavs, lens, labels, metrics, ext)
    torch.cuda.synchronize()
    launches = {"fused_fbank": fused_fbank.launches}
    if launches["fused_fbank"] == 0:
        raise AssertionError("the main path never launched the fbank kernel")

    _finite("anonymize", recon, (BATCH, t_frames, 80))
    _finite("loss", loss, ())
    _, sex_lp, recon_e, clean = recipe.eval_step(model, fbank, normalizer, norm_state, wavs,
                                                 lens, labels)
    _finite("sex_log_probs", sex_lp, (BATCH, 2))
    _finite("eval recon", recon_e, (BATCH, t_frames, 80))
    for name, feats in (("ext clean", clean), ("ext recon", recon_e)):
        _finite(name, ext.classify_feats(feats)[0], (BATCH, 2))
    scores = {
        "acc": metrics.sex_acc.summarize(),
        "acc_ext": metrics.sex_acc_extern.summarize(),
        "acc_ext_orig": metrics.sex_acc_extern_orig.summarize(),
        "cos_sim": metrics.utility_similarity.summarize(),
    }
    if not all(np.isfinite(v) for v in scores.values()) or metrics.sex_acc.total != BATCH:
        raise AssertionError(f"bad scores {scores}")

    run = lambda: recipe.anonymize(model, fbank, normalizer, norm_state, wavs, lens)  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    median_s = host_median_s(run)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    feats, _ = normalizer(norm_state, fbank(wavs), lens)
    model.eval()
    with torch.no_grad():
        stages_ms = {
            "fbank": cuda_ms(lambda: fbank(wavs), iters=10),
            "normalizer": cuda_ms(lambda: normalizer(norm_state, feats, lens), iters=10),
            "autoencoder": cuda_ms(lambda: model.anonymize(feats), iters=5),
            "eval_step": cuda_ms(lambda: recipe.eval_step(model, fbank, normalizer, norm_state, wavs,
                                                          lens, labels), iters=5),
            "classify_feats": cuda_ms(lambda: ext.classify_feats(feats), iters=5),
        }
    audio_s = BATCH * N_SAMPLES / SAMPLE_RATE
    emit({"phase": "slice", "card": card, "batch": BATCH, "samples": N_SAMPLES, "frames": t_frames,
          "launches": launches, "loss": float(loss), "scores": scores,
          "anonymize_median_s": median_s, "audio_s": audio_s,
          "realtime_factor": audio_s / median_s, "peak_mem_gib": peak_gib, "stages_ms": stages_ms})
    return launches


def check_k1(wavs: torch.Tensor, fb: Fbank, where: str) -> tuple[float, torch.Tensor]:
    """K1 against its plain version on the frames ``fb`` makes of ``wavs``
    (K1_RTOL, K1_ATOL; raises otherwise): (max abs err, the frames)."""
    frames = frame_signal(wavs).contiguous()
    got = fused_fbank(frames, fb.dft, fb.mel, fb.dft_frag)
    want = mel_power_plain(frames, fb.dft, fb.mel)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=K1_RTOL, atol=K1_ATOL):
        raise AssertionError(f"K1 disagrees with its plain twin at the {where} shape "
                             f"({frames.shape[0] * frames.shape[1]} rows): max abs {err}")
    return err, frames


def phase_train(asr: ASRModel, card: str) -> dict:
    """The adversarial training step at convae.yaml's configuration: the
    ConvAutoencoder (533,123 parameters, seeded) with the frozen full-width
    ASR's utility term, 8 utterances of 10.07 s, TRAIN_MICRO_BATCHES of the
    "generator" phase (epoch 0), then as many of the "sex_classifier" phase
    (epoch 1). Checks: finite losses, K1 once a micro-batch, the masks (after
    the generator phase every sex-head parameter is bit-equal to its start
    and some generator parameter moved; after the classifier phase the
    reverse), the BatchNorm running statistics moving on every micro-batch,
    and K1 against its plain version on this path's frames (K1_RTOL,
    K1_ATOL). Reports the median wall per micro-batch and per update (each
    ended by a synchronise), audio seconds trained per wall second over the
    micro-batches after the first (their audio over their summed wall), peak
    memory, and K1's and its plain version's device times at this shape."""
    t_phase = time.perf_counter()
    batch = train_batch(TRAIN_BATCH, N_SAMPLES, SEED + 9, DEVICE, tokens=TRAIN_TOKENS, speech=False)
    bundle = ASRBundle(asr, StubTokenizer(), DECODE_HPARAMS)
    trainer = recipe.AnonymizerTrainer(convae_hparams(DEVICE), asr_bundle=bundle,
                                       device=DEVICE)
    seeded_init_(trainer.model, SEED)
    params = dict(trainer.model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    stats = [b for name, b in trainer.model.named_buffers() if name.endswith(("running_mean", "running_var"))]

    def snapshot(head: bool) -> dict:
        return {k: p.detach().clone() for k, p in params.items() if recipe.is_classifier_param(k) == head}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_fbank.launches = 0
    walls, stepped, terms = [], [], []
    for epoch, frozen_head in ((0, True), (1, False)):
        frozen, trained = snapshot(frozen_head), snapshot(not frozen_head)
        for _ in range(TRAIN_MICRO_BATCHES):
            before = [b.clone() for b in stats]
            t0 = time.perf_counter()
            trainer.fit_batch(batch, epoch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            stepped.append(trainer.metrics["stepped"])
            terms.append({k: float(v) for k, v in trainer.metrics.items() if k != "stepped"})
            if not all(np.isfinite(v) for v in terms[-1].values()):
                raise AssertionError(f"non-finite loss terms {terms[-1]}")
            if any(torch.equal(a, b) for a, b in zip(before, stats)):
                raise AssertionError("a BatchNorm running statistic did not move")
        moved = [k for k, p in frozen.items() if not torch.equal(p, params[k])]
        if moved:
            raise AssertionError(f"epoch {epoch}: frozen parameters moved: {moved[:4]}")
        if all(torch.equal(p, params[k]) for k, p in trained.items()):
            raise AssertionError(f"epoch {epoch}: no trained parameter moved")
    torch.cuda.synchronize()
    launches = {"fused_fbank": fused_fbank.launches}
    if launches["fused_fbank"] != len(walls):
        raise AssertionError(f"K1 launched {launches['fused_fbank']} times in {len(walls)} micro-batches")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # K1 against its plain version on this path's own frames (8 x 10.07 s)
    fb = trainer.fbank
    k1_err, frames = check_k1(batch[0], fb, "train")
    k1_ms = cuda_ms(lambda: fused_fbank(frames, fb.dft, fb.mel, fb.dft_frag))
    k1_plain_ms = cuda_ms(lambda: mel_power_plain(frames, fb.dft, fb.mel))
    # the kernel line's yardstick (phase_kernels) on these frames: two torch.matmul
    n_bins = fb.mel.shape[0]
    spec = torch.matmul(frames, fb.dft)
    power = spec[..., :n_bins] ** 2 + spec[..., n_bins:] ** 2
    k1_library_ms = cuda_ms(lambda: (torch.matmul(frames, fb.dft), torch.matmul(power, fb.mel)))
    step_walls = [w for w, s in zip(walls, stepped) if s]
    cycles = [sum(walls[i:i + 3]) for i in range(0, len(walls), 3)]
    median_s = statistics.median(walls)
    audio_s = TRAIN_BATCH * N_SAMPLES / SAMPLE_RATE
    # the rate over every micro-batch after the first (which holds cuDNN's
    # algorithm search): their audio over their summed wall, stalls included
    steady = walls[1:]
    emit({"phase": "train", "card": card, "model": "convae", "params": n_params,
          "batch": TRAIN_BATCH, "samples": N_SAMPLES, "tokens": TRAIN_TOKENS,
          "micro_batches": len(walls), "updates": sum(stepped), "launches": launches,
          "ms_per_micro_batch": 1e3 * median_s,
          "ms_per_stepping_micro_batch": 1e3 * statistics.median(step_walls),
          "ms_per_update_cycle": 1e3 * statistics.median(cycles),
          "ms_first_micro_batch": 1e3 * walls[0], "walls_ms": [1e3 * w for w in walls],
          "audio_s_per_wall_s": audio_s * len(steady) / sum(steady), "peak_mem_gib": peak_gib,
          "k1_ms": k1_ms, "k1_plain_ms": k1_plain_ms, "k1_library_ms": k1_library_ms,
          "k1_max_abs_err": k1_err,
          "k1_rtol": K1_RTOL, "k1_atol": K1_ATOL, "k1_rows": frames.shape[0] * frames.shape[1],
          "noam_lr": trainer.noam.current_lr, "loss_terms_first": terms[0], "loss_terms_last": terms[-1],
          "seconds": time.perf_counter() - t_phase})
    del trainer, bundle, batch
    torch.cuda.empty_cache()
    return launches


TRAIN_PARITY_SCHEDULES = {
    "generator": recipe.DEFAULT_SCHEDULE,  # sex 0.8, utility 0.2: the sex term's tolerances
    "recon_utility": [{"weights": {"recon": 1.0, "utility": 1.0}, "train": "all"}],  # the tight ones
}


def phase_train_parity() -> None:
    """One accumulation cycle on the card and on the CPU, TF32 off, for each
    of TRAIN_PARITY_SCHEDULES: TRAIN_PARITY_BATCH speech-like utterances of
    2 s, a small seeded ASR for the utility term, the same weights, batches
    and SpecAugment draws; Noam at lr 1e-3 so that the update shows in f32
    weights. ``tools/train_parity.py`` holds the loss terms, gradients, Adam
    moments and updated parameters at the CPU parity tests' tolerances and
    counts the sign-only elements it excludes (trap e). Four utterances, not
    two: over a batch of two the sex head's BatchNorm of pooled features
    leaves the sex term's f32 gradients 20-40% apart card vs CPU on an H100."""
    asr = {d: seeded_init_(ASRModel(**TRAIN_PARITY_ASR, device=d), SEED + 5) for d in (DEVICE, "cpu")}
    batches = [train_batch(TRAIN_PARITY_BATCH, TRAIN_PARITY_SAMPLES, SEED + 20 + i, "cpu",
                           TRAIN_PARITY_ASR["output_neurons"], TRAIN_TOKENS) for i in range(3)]
    for name, schedule in TRAIN_PARITY_SCHEDULES.items():
        def make(device, schedule=schedule):
            hp = convae_hparams(device, schedule, NoamScheduler(1e-3, 1, 1))
            trainer = recipe.AnonymizerTrainer(
                hp, asr_bundle=ASRBundle(asr[device], StubTokenizer(), {}), device=device)
            seeded_init_(trainer.model, SEED)
            return trainer

        t0 = time.perf_counter()
        report = compare_cycle(make, batches, 0, device=DEVICE)
        emit({"phase": "train_parity", "weights": schedule[0]["weights"], "mode": schedule[0]["train"],
              "utterances": TRAIN_PARITY_BATCH, "samples": TRAIN_PARITY_SAMPLES,
              "asr": TRAIN_PARITY_ASR, "seconds": time.perf_counter() - t0, **report})


def phase_parity(wavs, lens, labels, fbank, normalizer, models) -> None:
    wavs2, lens2, labels2 = wavs[:2], lens[:2], labels[:2]
    _, state_gpu = normalizer(normalizer.init_state(DEVICE), fbank(wavs2), lens2, 0, training=True)

    def run(device, model, emb, clf, fb, state):
        w, ln, lb = wavs2.to(device), lens2.to(device), labels2.to(device)
        ext = FeatureClassifier(emb, clf, normalizer.init_state(device), normalizer)
        recon = recipe.anonymize(model, fb, normalizer, state, w, ln)
        _, sex_lp, recon_e, clean = recipe.eval_step(model, fb, normalizer, state, w, ln, lb)
        out = {"anonymize": recon, "eval_recon": recon_e, "clean": clean, "sex_log_probs": sex_lp,
               "ext_clean": ext.classify_feats(clean)[0], "ext_recon": ext.classify_feats(recon_e)[0]}
        return {k: v.float().cpu() for k, v in out.items()}

    gpu = run(DEVICE, *models, fbank, state_gpu)
    cpu_models = [copy.deepcopy(m).to("cpu") for m in models]
    state_cpu = NormalizerState(*(x.cpu() for x in state_gpu))
    cpu = run("cpu", *cpu_models, Fbank(device="cpu"), state_cpu)
    gaps = {k: float((gpu[k] - cpu[k]).abs().max()) for k in gpu}
    emit({"phase": "parity", "utterances": 2, "max_abs_gap": gaps, "atol": PARITY_ATOL})
    bad = {k: v for k, v in gaps.items() if not v <= PARITY_ATOL}
    if bad:
        raise AssertionError(f"card and CPU disagree beyond {PARITY_ATOL}: {bad}")


class StubTokenizer:
    """Token ids as words (the decode benchmark's stub; no tokenizer model is in the repo)."""

    def decode_ids(self, ids):
        return " ".join(str(i) for i in ids)


# The decodes of each shape, in order: (layout, with the LM, decode_lm_megastep,
# cache dtype). D2's bf16 runs are the serving decode (bf16 caches, as the
# JAX package's serving and benchmarks take): page 32, K5 in every layer. The
# int8 runs are the quantized serving decode (whole-row at D1 and D2: K5
# paged, K2 + K3 physical, in both stacks); D1's with the LM is the JAX
# package's "5 s, 64 steps" int8 shape. D3's are the 30 s int8 serving
# decode (U 512: K6 and K7, or K4 with K2). B3's are the anonymizer recipe's
# test decode with the LM: its default hparams ("default": decode_paged_kv not
# set), which must take the physical layout at N 198 (K3 + K2), and the same
# with decode_paged_kv false.
DECODE_RUNS = {"D1": (("paged", False, True, "float32"), ("physical", False, True, "float32"),
                      ("paged", True, True, "float32"), ("physical", True, True, "float32"),
                      ("paged", True, True, "int8"), ("physical", True, True, "int8")),
               "D2": (("paged", False, True, "float32"), ("physical", False, True, "float32"),
                      ("paged", True, True, "float32"), ("paged", True, False, "float32"),
                      ("paged", False, True, "bfloat16"), ("paged", True, True, "bfloat16"),
                      ("paged", False, True, "int8"), ("paged", True, True, "int8"),
                      ("physical", False, True, "int8")),
               "D3": (("paged", True, True, "int8"), ("paged", True, False, "int8"),
                      ("paged", False, True, "int8"), ("physical", False, True, "int8")),
               "B3": (("default", True, True, "float32"), ("physical", True, True, "float32"))}
# pairs of runs that must give identical tokens (scores within 1e-4), and
# pairs that are only reported (K7 computes in bf16, the per-layer path in
# f32; bf16 caches round what f32 ones keep)
SAME_RUNS = {"D1": (("paged", "physical"), ("paged_lm", "physical_lm"),
                    ("paged_lm_int8", "physical_lm_int8")),
             "D2": (("paged", "physical"), ("paged_int8", "physical_int8")),
             "D3": (("paged_int8", "physical_int8"),),
             "B3": (("default_lm", "physical_lm"),)}
REPORTED_RUNS = {"D1": (("paged_lm", "paged_lm_int8"),),
                 "D2": (("paged_lm", "paged_lm_per_layer"), ("paged", "paged_bf16"),
                        ("paged_lm", "paged_lm_bf16"), ("paged", "paged_int8"),
                        ("paged_bf16", "paged_int8"), ("physical", "physical_int8"),
                        ("paged_lm", "paged_lm_int8"), ("paged_lm_bf16", "paged_lm_int8")),
                 "D3": (("paged_lm_int8", "paged_lm_int8_per_layer"),)}


def _run_label(layout: str, with_lm: bool, mega: bool, dtype: str) -> str:
    return (layout + ("_lm" if with_lm else "")
            + {"float32": "", "bfloat16": "_bf16", "int8": "_int8"}[dtype]
            + ("" if mega else "_per_layer"))


def _expected_launches(name: str, layout: str, with_lm: bool, mega: bool, dtype: str,
                       steps: int) -> dict:
    """Kernel launches of one decode at shape ``name`` (K1 aside): the ASR's 6
    decoder layers and, with the LM, its 12 layers, one attention launch each a
    step, except the LM's fused page-64 cache (f32 at D2) under K7 (one launch
    a step for all 12); physical caches add K2's k and v reorder of each cache
    a step. Paged caches page by 32 (K5) up to the whole-row bound of their
    dtype (213 f32, 426 bf16 and int8 at M 768), else by 64, fused (K6).
    "default" (decode_paged_kv not set) is expected physical: it runs only
    at B3, whose N 198 the paging rule keeps physical."""
    expected = dict.fromkeys(("beam_gather", "attention_step", "attention_step_chunked",
                              "attention_step_paged", "attention_step_paged_chunked",
                              "lm_megastep"), 0)
    lm_layers = LM_LAYERS if with_lm else 0
    u = _decode_cache_shape(name)[2]
    long_cache = u > max_u_whole_row(768, max(getattr(torch, dtype).itemsize, 2))
    if layout in ("physical", "default"):
        expected["attention_step_chunked" if long_cache else "attention_step"] = (
            (DECODE_LAYERS + lm_layers) * steps)
        expected["beam_gather"] = 2 * (1 + with_lm) * steps
        return expected
    kernel = "attention_step_paged_chunked" if long_cache else "attention_step_paged"
    expected[kernel] = DECODE_LAYERS * steps
    if with_lm and long_cache and mega:
        expected["lm_megastep"] = steps
    else:
        expected[kernel] += lm_layers * steps
    return expected


def phase_decode(asr: ASRModel, lm: TransformerLM, ae: ConvAutoencoder, fbank: Fbank,
                 normalizer: InputNormalizer, card: str):
    """D1 and D2 through evaluate_batch with the ASR bundle, without and with
    the LM (``DECODE_RUNS``); returns the launch counts of those runs by kernel
    (the int8 runs' under ``<kernel>_int8``) and, per shape, the first two
    clean feature rows (for decode_parity)."""
    counters = (fused_fbank, beam_gather, attention_step, attention_step_chunked,
                attention_step_paged, attention_step_paged_chunked, lm_megastep)
    totals = dict.fromkeys((c.__name__ for c in counters), 0)
    totals.update(dict.fromkeys((f"{name}_int8" for name in INT8_KERNELS), 0))
    rng = np.random.default_rng(SEED + 10)
    parity_feats = {}
    for name, (batch, n_samples, max_steps) in DECODE_SHAPES.items():
        wavs = torch.from_numpy((rng.standard_normal((batch, n_samples)) * 0.1).astype(np.float32))
        wavs = wavs.to(DEVICE)
        lens = torch.ones(batch, device=DEVICE)
        labels = torch.from_numpy(rng.integers(0, 2, batch)).to(DEVICE)
        ids = [f"{name}-{i}" for i in range(batch)]
        words = [" ".join(map(str, rng.integers(3, 5000, rng.integers(8, 20)))) for _ in ids]
        _, norm_state = normalizer(normalizer.init_state(DEVICE), fbank(wavs), lens, 0, training=True)
        t_frames = 1 + n_samples // 160
        steps = _decode_steps(name)
        # one input for every run: cuDNN's autoencoder is not bit-reproducible
        # run to run, and a 1e-6 input change can flip a near tie of the beam search
        _, _, recon, clean = recipe.eval_step(ae, fbank, normalizer, norm_state, wavs, lens, labels)
        # eval_step pads the features to a multiple of recipe.features' 36 frames
        _finite(f"{name} recon", recon, (batch, -(-t_frames // 36) * 36, 80))
        rerun = recipe.eval_step(ae, fbank, normalizer, norm_state, wavs, lens, labels)
        emit({"phase": "decode_input", "shape": name,
              "recon_rerun_max_abs_diff": float((rerun[2] - recon).abs().max()),
              "clean_rerun_max_abs_diff": float((rerun[3] - clean).abs().max())})
        del rerun
        outputs = {}
        for layout, with_lm, mega, dtype in DECODE_RUNS[name]:
            t_run = time.perf_counter()
            label = _run_label(layout, with_lm, mega, dtype)
            hp = {**DECODE_HPARAMS, "max_decode_steps": max_steps, "decode_cache_dtype": dtype,
                  "decode_lm_megastep": mega}
            if layout != "default":
                hp["decode_paged_kv"] = layout == "paged"
            bundle = ASRBundle(asr, StubTokenizer(), hp, lm=lm if with_lm else None)
            metrics = recipe.EvalMetrics()
            bundle.start_test(metrics)
            torch.cuda.synchronize()

            for c in counters:
                c.launches = 0
            recipe.evaluate_batch(ae, fbank, normalizer, norm_state, wavs, lens, labels, metrics,
                                  asr_bundle=bundle, ids=ids, words=words, stage="test")
            torch.cuda.synchronize()
            launches = {c.__name__: c.launches for c in counters}
            for key, value in launches.items():
                if dtype == "int8" and key in INT8_KERNELS:
                    totals[f"{key}_int8"] += value
                else:
                    totals[key] += value

            for c in counters:
                c.launches = 0
            toks, lengths, scores = bundle._decode_test(recon, lens)
            torch.cuda.synchronize()
            per_decode = {c.__name__: c.launches for c in counters[1:]}
            expected = _expected_launches(name, layout, with_lm, mega, dtype, steps)
            if per_decode != expected:
                raise AssertionError(f"{name} {label} decode launched {per_decode}, expected {expected}")
            _finite(f"{name} {label} scores", scores, (batch,))
            if tuple(toks.shape) != (batch, steps) or not bool(((lengths >= 0) & (lengths <= steps)).all()):
                raise AssertionError(f"{name}: tokens {tuple(toks.shape)}, lengths {lengths.tolist()}")
            distinct = len({tuple(h) for h in hyps_to_lists(toks, lengths)})
            if distinct < 2 and not with_lm:
                raise AssertionError(f"{name}: every utterance decoded to the same hypothesis")
            outputs[label] = (toks, lengths, scores)

            torch.cuda.reset_peak_memory_stats()
            iters, warmup = DECODE_TIMING[name]
            median_s = host_median_s(lambda: bundle._decode_test(recon, lens), iters=iters,
                                     warmup=warmup)
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            audio_s = batch * n_samples / SAMPLE_RATE
            wer, wer_clean = metrics.wer_metric.summarize("WER"), metrics.wer_metric2.summarize("WER")
            rows = batch * bundle.beam_size
            paged = bundle.pages(rows, steps + 1, DEVICE)  # the ASR's and the LM's: both d_model 768
            tdtype = getattr(torch, dtype)
            caches = {"asr": make_kv_cache(rows, steps + 1, DECODE_LAYERS, 8, 96, tdtype,
                                           device="meta", paged=paged)}  # shapes only
            if with_lm:
                caches["lm"] = make_kv_cache(rows, steps + 1, LM_LAYERS, lm.nhead,
                                             lm.d_model // lm.nhead, tdtype, device="meta",
                                             paged=paged)
            emit({"phase": "decode", "shape": name, "layout": layout,
                  "layout_taken": "paged" if paged else "physical", "lm": with_lm,
                  "lm_megastep": bool(per_decode["lm_megastep"]), "cache_dtype": dtype,
                  "card": card, "batch": batch,
                  "samples": n_samples, "frames": t_frames, "steps": steps,
                  "beam": DECODE_HPARAMS["test_beam_size"],
                  "cache": {c: {k: list(v.shape) for k, v in cache.items()}
                            for c, cache in caches.items()},
                  "launches": launches, "launches_per_decode": per_decode,
                  "decode_median_s": median_s, "ms_per_step": 1e3 * median_s / steps,
                  "audio_s": audio_s, "audio_s_per_wall_s": audio_s / median_s,
                  "peak_mem_gib": peak_gib, "run_s": time.perf_counter() - t_run,
                  "wer_recon": wer, "wer_clean": wer_clean,
                  "utility_similarity": metrics.utility_similarity.summarize(),
                  "distinct_hypotheses": distinct, "lengths": lengths.tolist(),
                  "scores": scores.tolist()})
            del bundle, caches
            torch.cuda.empty_cache()
        for a, b in SAME_RUNS[name]:
            (at, al, asc), (bt, bl, bsc) = outputs[a], outputs[b]
            same = torch.equal(at, bt) and torch.equal(al, bl)
            gap = float((asc - bsc).abs().max())
            emit({"phase": "decode_layouts", "shape": name, "runs": [a, b], "identical_tokens": same,
                  "score_gap": gap, "atol": LAYOUT_PARITY_ATOL})
            if not (same and gap <= LAYOUT_PARITY_ATOL):
                raise AssertionError(f"{name}: {a} and {b} decodes disagree: tokens equal {same}, "
                                     f"gap {gap}")
        for a, b in REPORTED_RUNS.get(name, ()):
            ha, hb = (hyps_to_lists(*outputs[r][:2]) for r in (a, b))
            emit({"phase": "decode_layouts", "shape": name, "runs": [a, b], "reported_only": True,
                  "identical_hypotheses_share": sum(x == y for x, y in zip(ha, hb)) / len(ha),
                  "identical_tokens": torch.equal(outputs[a][0], outputs[b][0]),
                  "score_gap": float((outputs[a][2] - outputs[b][2]).abs().max())})
        parity_feats[name] = (clean[:2], lens[:2])
        del wavs, recon, clean, outputs
        torch.cuda.empty_cache()
    if beam_gather_faults(DEVICE):
        raise AssertionError("the decode's cache reorder met an out-of-range parent")
    missing = [key for key, value in totals.items() if value == 0]
    if missing:
        raise AssertionError(f"the decode path never launched {missing}")
    return totals, parity_feats


def phase_decode_parity(asr: ASRModel, lm: TransformerLM, parity_feats: dict) -> None:
    """Paged on the card against the CPU (which never pages): K5 at D1's
    features over 40 steps (a page completes at step 31), K6 at D2's over
    230 steps (U 256, fused), and the LM-fused D1 decode over 40 steps (K5 for
    the ASR's and the LM's layers; the LM's cache at D1 is not fused, so no K7
    and no bf16 arithmetic), and the int8 decode at D1's features over 40
    steps (K5 on the card). The card's physical decode of the same input is
    also compared with its paged one (identical tokens and scores within
    1e-4): a card-vs-CPU disagreement that both card layouts share is the
    card's arithmetic, not the paged path. (At 220 steps D2's second
    utterance meets such a near tie at position 171 on both card layouts,
    scores 2.9e-6 apart; the step count avoids it.)"""
    cpu_model = copy.deepcopy(asr).to("cpu")
    cpu_lm = copy.deepcopy(lm).to("cpu")
    for name, steps, kernel, with_lm, dtype in (
            ("D1", 40, attention_step_paged, False, "float32"),
            ("D2", 230, attention_step_paged_chunked, False, "float32"),
            ("D1", 40, attention_step_paged, True, "float32"),
            ("D1", 40, attention_step_paged, False, "int8")):
        feats, lens = parity_feats[name]
        hp = {**DECODE_HPARAMS, "test_beam_size": 4, "max_decode_steps": steps,
              "decode_cache_dtype": dtype}
        card_lm, host_lm = (lm, cpu_lm) if with_lm else (None, None)
        kernel.launches = 0
        gpu = ASRBundle(asr, StubTokenizer(), hp, lm=card_lm)._decode_test(feats, lens)
        torch.cuda.synchronize()
        layers = DECODE_LAYERS + (LM_LAYERS if with_lm else 0)
        if kernel.launches != layers * steps:
            raise AssertionError(f"the {name} parity decode launched {kernel.__name__} "
                                 f"{kernel.launches} times")
        physical = ASRBundle(asr, StubTokenizer(), {**hp, "decode_paged_kv": False},
                             lm=card_lm)._decode_test(feats, lens)
        cpu = ASRBundle(cpu_model, StubTokenizer(), hp, lm=host_lm)._decode_test(feats.cpu(),
                                                                                lens.cpu())
        same_layouts = torch.equal(gpu[0], physical[0]) and torch.equal(gpu[1], physical[1])
        layout_gap = float((gpu[2] - physical[2]).abs().max())
        same_tokens = torch.equal(gpu[0].cpu(), cpu[0]) and torch.equal(gpu[1].cpu(), cpu[1])
        gap = float((gpu[2].cpu() - cpu[2]).abs().max())
        emit({"phase": "decode_parity", "shape": name, "lm": with_lm, "cache_dtype": dtype,
              "utterances": 2, "beam": 4,
              "steps": steps, "card_kernel": kernel.__name__, "identical_tokens": same_tokens,
              "score_gap": gap, "atol": DECODE_PARITY_ATOL,
              "card_layouts_identical_tokens": same_layouts, "card_layouts_score_gap": layout_gap,
              "hypotheses_head": [h[:16] for h in hyps_to_lists(cpu[0], cpu[1])]})
        if not (same_layouts and layout_gap <= LAYOUT_PARITY_ATOL):
            raise AssertionError(f"paged and physical card decodes disagree at {name}: tokens equal "
                                 f"{same_layouts}, gap {layout_gap}")
        if not (same_tokens and gap <= DECODE_PARITY_ATOL):
            raise AssertionError(f"card and CPU decodes disagree at {name}: tokens equal "
                                 f"{same_tokens}, gap {gap}")


# The anonymizer recipe's epoch loop at configs/convae.yaml's settings: batch
# 3, accumulation 3 (one update an epoch of 3 micro-batches), clip 5, Noam, the
# two-phase schedule (epoch 1: sex_classifier, epoch 2: generator), SpecAugment,
# the normalizer updating; a valid batch after each epoch. The test set is two
# of B3's batches (3 x 80,480 samples, beam 66, 64 steps, the LM, f32 caches,
# default hparams): MI's k-NN estimate (k 3) needs k + 1 = 4 utterances a
# draw, two of each sex, which one batch of 3 cannot give.
RECIPE_BATCH = 3
RECIPE_EPOCHS = 2
RECIPE_MICRO_BATCHES = 3  # an epoch's
RECIPE_TEST_BATCHES = 2


class TimedBrain(recipe.SexAnonymizationBrain):
    """The recipe's brain with the smoke's clocks: each micro-batch's wall and
    each stage's start and end (ended by a synchronise), and the time the
    train loop spends in ``save_and_keep_only`` with the meta it saved."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.walls, self.marks, self.saves, self.stage_losses = [], [], [], []
        save = self.checkpointer.save_and_keep_only

        def timed_save(meta, **kw):
            t0 = time.perf_counter()
            ckpt = save(meta, **kw)
            self.saves.append((1e3 * (time.perf_counter() - t0), dict(meta)))
            return ckpt

        self.checkpointer.save_and_keep_only = timed_save

    def fit_batch(self, batch, epoch):
        t0 = time.perf_counter()
        loss = super().fit_batch(batch, epoch)
        torch.cuda.synchronize()
        self.walls.append(time.perf_counter() - t0)
        return loss

    def on_stage_start(self, stage, epoch=None):
        torch.cuda.synchronize()
        self.marks.append((stage.name, epoch, time.perf_counter()))
        super().on_stage_start(stage, epoch)

    def on_stage_end(self, stage, stage_loss, epoch=None):
        super().on_stage_end(stage, stage_loss, epoch)
        torch.cuda.synchronize()
        self.marks.append((stage.name, epoch, time.perf_counter()))
        self.stage_losses.append((stage.name, epoch, stage_loss))


def _recipe_batch(b: int, n_samples: int, seed: int, first_label: int = 0):
    """The recipe's PaddedBatch duck type on the card: white-noise waveforms
    at 0.1, alternating sexes from ``first_label``, seeded tokens and words."""
    wavs, lens, _, tokens = train_batch(b, n_samples, seed, DEVICE, tokens=TRAIN_TOKENS, speech=False)
    rng = np.random.default_rng(seed)
    return SimpleNamespace(sig=(wavs, lens), gender=(np.arange(b) + first_label) % 2,
                           tokens_bos=(tokens, None), id=[f"r{seed}-{i}" for i in range(b)],
                           wrd=[" ".join(map(str, rng.integers(3, 5000, rng.integers(8, 20))))
                                for _ in range(b)])


def _recipe_hparams(work: Path, **extra) -> dict:
    return {**convae_hparams(DEVICE), "train_logger": FileTrainLogger(str(work / "train_log.txt")),
            "epoch_counter": EpochCounter(RECIPE_EPOCHS), "measure_mi": True,
            "wer_file": str(work / "wer.txt"), **extra}


def _saved_state(brain) -> dict:
    ns = brain.trainer.state.norm_state
    return {**{k: v.detach().cpu() for k, v in brain.model.state_dict().items()},
            **{f"normalizer.{k}": getattr(ns, k).detach().cpu() for k in ns._fields}}


def _params_of(ckpt) -> dict:
    tree = read_tree(str(Path(ckpt.path) / "model.ckpt"))
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in anonymizer_state_dict({"params": tree}).items()}


def phase_recipe(asr: ASRModel, lm: TransformerLM, emb: Xvector, clf: XvectorClassifier,
                 card: str) -> dict:
    """The port's SexAnonymizationBrain on the card: ``fit`` for RECIPE_EPOCHS
    of RECIPE_MICRO_BATCHES micro-batches of RECIPE_BATCH x 10.07 s (the frozen
    full-width ASR's utility, SpecAugment, masked Adam), a valid batch after
    each epoch (the x-vector evaluator's ACC_external, the ASR encoders'
    similarity) saving a checkpoint asynchronously, then ``evaluate(max_key=
    "Utility_Retention")`` on B3's batches (the checkpoints averaged; WER and
    WER_orig from beam-66 decodes with the LM at 0.6; MI_bits). Checks: finite
    losses; both checkpoints on disk with the metas saved (and logged); a fresh
    brain recovering the newest bit-equal to what was saved; the averaged
    parameters bit-equal to the mean of the two saved trees in rank order;
    ``valid_frontier`` restoring the pick's parameters and no BatchNorm
    statistic; the test stage's launches (K1, K2, K3 > 0; K4-K7 none) and
    finite WER, WER_orig, ACC_external and MI_bits. Returns the phase's launch
    counts by kernel."""
    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="recipe_"))
    counters = (fused_fbank, beam_gather, attention_step, attention_step_chunked, attention_step_paged,
                attention_step_paged_chunked, lm_megastep)
    try:
        bundle = ASRBundle(asr, StubTokenizer(), {**DECODE_HPARAMS, "max_decode_steps":
                                                   DECODE_SHAPES["B3"][2]}, lm=lm)
        ext = FeatureClassifier(emb, clf, InputNormalizer(dim=80).init_state(DEVICE))
        ckpt_dir = str(work / "ckpts")
        brain = TimedBrain(_recipe_hparams(work), Checkpointer(ckpt_dir, async_writes=True),
                           external_classifier=ext, asr_bundle=bundle, device=DEVICE)
        seeded_init_(brain.model, SEED)
        brain.init_state()
        train = [_recipe_batch(RECIPE_BATCH, N_SAMPLES, SEED + 30 + i) for i in range(RECIPE_MICRO_BATCHES)]
        valid = [_recipe_batch(RECIPE_BATCH, N_SAMPLES, SEED + 40)]
        n_test = DECODE_SHAPES["B3"][1]
        test = [_recipe_batch(RECIPE_BATCH, n_test, SEED + 50 + i, first_label=i)
                for i in range(RECIPE_TEST_BATCHES)]
        decode_walls = []
        decode = bundle._decode_test

        def timed_decode(feats, lens):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = decode(feats, lens)
            torch.cuda.synchronize()
            decode_walls.append(time.perf_counter() - t0)
            return out

        bundle._decode_test = timed_decode
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        brain.fit(brain.epoch_counter, train, valid)
        fit_s = time.perf_counter() - t0
        losses = {f"{stage.lower()}_{epoch}": loss for stage, epoch, loss in brain.stage_losses}
        if len(losses) != 2 * RECIPE_EPOCHS or not all(np.isfinite(v) for v in losses.values()):
            raise AssertionError(f"recipe losses {losses}")
        ckpts = brain.checkpointer.list_checkpoints()
        saved = [{k: v for k, v in c.meta.items() if k != "unixtime"} for c in
                 sorted(ckpts, key=lambda c: c.meta["epoch"])]
        if saved != [meta for _, meta in brain.saves] or len(saved) != RECIPE_EPOCHS:
            raise AssertionError(f"checkpoints on disk {saved}, saved {brain.saves}")
        log_lines = (work / "train_log.txt").read_text().splitlines()
        for line, meta in zip(log_lines, saved):
            if f"valid ACC_external: {_format_value(meta['ACC_external'])}" not in line:
                raise AssertionError(f"log line {line!r} does not hold the meta {meta}")

        # a fresh brain recovers the newest checkpoint, bit for bit
        fresh = recipe.SexAnonymizationBrain(_recipe_hparams(work / "fresh"), Checkpointer(ckpt_dir),
                                             external_classifier=ext, asr_bundle=bundle, device=DEVICE)
        fresh.init_state()
        newest = fresh.checkpointer.recover_if_possible()
        want, got = _saved_state(brain), _saved_state(fresh)
        differ = [k for k in want if not torch.equal(want[k], got[k])]
        if newest.meta["epoch"] != RECIPE_EPOCHS or differ or (
                fresh.epoch_counter.current, fresh.noam.state_dict()) != (
                brain.epoch_counter.current, brain.noam.state_dict()):
            raise AssertionError(f"the recovered brain differs from the saved one: {differ[:6]}")

        # valid_frontier, once: the pick's parameters, the BatchNorm statistics as they were
        frontier = recipe.SexAnonymizationBrain(
            _recipe_hparams(work / "frontier", eval_ckpt_select="valid_frontier"), Checkpointer(ckpt_dir),
            external_classifier=ext, asr_bundle=bundle, device=DEVICE)
        frontier.init_state()
        frontier.checkpointer.recover_if_possible()
        stats = {k: b for k, b in frontier.model.named_buffers() if k.endswith(("running_mean", "running_var"))}
        with torch.no_grad():
            for b in stats.values():
                b.mul_(2.0)
        before = {k: b.clone() for k, b in stats.items()}
        frontier.on_evaluate_start()
        pick = [c for c in ckpts if c.meta["epoch"] == frontier.selected_ckpt_meta["epoch"]]
        params = dict(frontier.model.named_parameters())
        if (len(pick) != 1 or not all(torch.equal(params[k].cpu(), v) for k, v in _params_of(pick[0]).items())
                or not all(torch.equal(before[k], b) for k, b in stats.items())):
            raise AssertionError(f"valid_frontier restored other state than the pick's parameters "
                                 f"({frontier.selected_ckpt_meta})")
        frontier_pick = dict(frontier.selected_ckpt_meta)
        del fresh, frontier

        # the test stage, after on_evaluate_start's average of the ranked checkpoints
        ranked = brain.checkpointer.find_checkpoints(max_key="Utility_Retention")
        trees = [_params_of(c) for c in ranked]
        mean = {k: functools.reduce(torch.add, (t[k] for t in trees)) / np.float32(len(trees))
                for k in trees[0]}
        fit_launches = {c.__name__: c.launches for c in counters}
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        brain.evaluate(test, max_key="Utility_Retention")
        torch.cuda.synchronize()
        test_s = time.perf_counter() - t0
        test_launches = {c.__name__: c.launches for c in counters}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        params = dict(brain.model.named_parameters())
        if not all(torch.equal(params[k].cpu(), v) for k, v in mean.items()):
            raise AssertionError("the evaluated parameters are not the mean of the ranked checkpoints")
        off = [k for k in ("attention_step_chunked", "attention_step_paged", "attention_step_paged_chunked",
                           "lm_megastep") if test_launches[k]]
        if off or not all(test_launches[k] for k in ("fused_fbank", "beam_gather", "attention_step")):
            raise AssertionError(f"the test stage launched {test_launches}")
        ts = brain.test_stats
        if not all(np.isfinite(ts[k]) for k in ("WER", "WER_orig", "ACC_external", "MI_bits")):
            raise AssertionError(f"test stats {ts}")
        # K1 against its plain version on one train and one test batch's frames
        # (3,024 and 1,512 rows, neither a whole number of K1's 128-row blocks)
        k1_checks = {}
        for where, b in (("train", train[0]), ("test", test[0])):
            err, frames = check_k1(b.sig[0], brain.trainer.fbank, where)
            k1_checks[where] = {"rows": frames.shape[0] * frames.shape[1], "max_abs_err": err}

        epochs = [(brain.marks[i][2], brain.marks[i + 1][2]) for i in range(0, 4 * RECIPE_EPOCHS, 2)]
        emit({"phase": "recipe", "card": card, "model": "convae", "batch": RECIPE_BATCH,
              "samples": N_SAMPLES, "epochs": RECIPE_EPOCHS, "micro_batches": len(brain.walls),
              "updates": brain.noam.n_steps, "test_batches": RECIPE_TEST_BATCHES, "test_samples": n_test,
              "ms_per_micro_batch": 1e3 * statistics.median(brain.walls),
              "micro_batch_walls_ms": [1e3 * w for w in brain.walls],
              "epoch_walls_s": [b - a for a, b in epochs[0::2]],
              "valid_walls_s": [b - a for a, b in epochs[1::2]],
              "save_and_keep_only_ms": [ms for ms, _ in brain.saves], "fit_s": fit_s,
              "test_stage_s": test_s, "test_decodes_s": decode_walls,
              "peak_mem_gib": peak_gib, "launches_fit": fit_launches, "launches_test": test_launches,
              "k1_checks": k1_checks, "k1_rtol": K1_RTOL, "k1_atol": K1_ATOL,
              "losses": losses, "checkpoints": saved, "frontier_pick": frontier_pick,
              "test_stats": ts, "seconds": time.perf_counter() - t_phase})
        return {k: fit_launches[k] + test_launches[k] for k in fit_launches}
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip()

    phase_build()
    rng = np.random.default_rng(SEED)
    wavs = torch.from_numpy((rng.standard_normal((BATCH, N_SAMPLES)) * 0.1).astype(np.float32)).to(DEVICE)
    lens = torch.ones(BATCH, device=DEVICE)
    labels = torch.from_numpy(rng.integers(0, 2, BATCH)).to(DEVICE)
    fbank = Fbank(device=DEVICE)
    normalizer = InputNormalizer(dim=80)
    models = build_models(DEVICE)

    lm = seeded_init_(TransformerLM(device=DEVICE), SEED + 4)
    k1 = phase_kernels(wavs, fbank)
    decode_kernels = phase_decode_kernels(lm)
    launches = phase_slice(wavs, lens, labels, fbank, normalizer, models, card)
    asr = seeded_init_(ASRModel(device=DEVICE), SEED + 3)
    train_launches = phase_train(asr, card)
    phase_train_parity()
    k1["launches"] = launches["fused_fbank"] + train_launches["fused_fbank"]
    k1["launches_by_path"] = {"slice": launches["fused_fbank"], "train": train_launches["fused_fbank"]}
    phase_parity(wavs, lens, labels, fbank, normalizer, models)
    del wavs

    decode_launches, parity_feats = phase_decode(asr, lm, models[0], fbank, normalizer, card)
    phase_decode_parity(asr, lm, parity_feats)
    recipe_launches = phase_recipe(asr, lm, models[1], models[2], card)
    k1["launches"] += recipe_launches["fused_fbank"]
    k1["launches_by_path"]["recipe"] = recipe_launches["fused_fbank"]
    for entry in decode_kernels:
        entry["launches"] = decode_launches[entry["name"]]
        if entry["name"] in ("beam_gather", "attention_step"):  # the recipe's test decodes: f32, physical
            entry["launches_by_path"] = {"decode": entry["launches"],
                                         "recipe": recipe_launches[entry["name"]]}
            entry["launches"] += recipe_launches[entry["name"]]

    emit({"phase": "wall", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"kernels": [k1, *decode_kernels]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
