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
           64, each timed case also against K3 on the same logical content
           as a physical cache (outputs equal bit for bit, ``k3_ms``; the
           entry carries K5's registers and shared memory); and the chunked
           int8 modes at D3 (the 30 s shape, U 512): K4
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
           registers (``"case": "k3"`` lines); and K8 (norm_silu, no TPU
           counterpart) at the ConvAutoencoder's block epilogues of the
           slice's shape (enc_conv0's (32, 32, 80,640) without the norm;
           (32, 64, 40,320), (32, 128, 20,160) and (32, 32, 80,640) with
           it) and past one cluster (4 x 80.6 s, dec_in2's (4, 32, 645,120):
           the two streaming launches), against its twin in float64 within
           K8_RTOL and K8_ATOL, timed beside the twin in fp32 (the PyTorch
           passes it replaces), its bound the bytes read and written once;
  slice    the anonymization path at bench.py's shape (32 utterances of
           161,120 samples = 10.07 s, T = 1008 frames), seeded random weights:
           anonymize, then evaluate_batch (full forward, x-vector scoring of
           clean and reconstructed features). Launch counts are reset right
           before and read right after (K8: exactly 7 for the anonymize
           call); then the path is timed;
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
  distributed  parallel/ on torch.distributed at ``train``'s configuration
           (one cycle of the generator phase, 8 x 10.07 s speech-like
           utterances, the frozen full-width ASR's utility, the global
           batch's SpecAugment draws): (a) world size 1 over NCCL in this
           process from the SATPU_* environment (a free localhost port), the
           barrier and run_on_main, the cycle through
           ``AnonymizerTrainer(mesh=make_mesh())`` against the same cycle at
           ``mesh=None`` on the same tensors (tools/train_parity.py
           ``compare_records``), K1 once a micro-batch, the group torn down
           after; (b) two spawned ranks on the one card over gloo (a file
           store), each on its 4 rows: rank 0's cycle against (a)'s
           unsharded one, each rank's K1 once a micro-batch and against its
           plain version on its shard; a rank's failure fails the smoke.
           Reports each part's wall, ms a micro-batch per rank, the gradient
           all-reduce's ms, peak memory and K1's launches per rank;
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
           layer (K6 x 18), paged without it (K6 x 6), physical (K4 + K2)
           and physical with the LM (K4 x 18 + K2), its timing 1 decode
           after the launch check; and B3,
           configs/convae.yaml's evaluation batch (3 utterances x beam 66:
           N 198) at D1's length with the LM and f32 caches, once with the
           default hparams (no decode_paged_kv override: the paging rule
           must keep N 198 physical, K3 + K2 and no paged kernel) and once
           with decode_paged_kv false, the two held token for token. Launch counts
           are reset right before each run and read right after; one more
           decode checks the launches of a single decode; then
           ``_decode_test`` is timed (``run_s``: the whole run's wall).
           Paged and physical decodes on the card give identical tokens,
           scores within 1e-4 (with the LM, and in int8, D3's too, with the
           LM against the paged per-layer decode); for D2's
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
           peak memory and the stats;
  main     the recipe's entry point, ``recipes/anonymizer.py`` ``main(argv)``,
           on configs/convae.yaml at full width (the ConvAutoencoder, the
           frozen ASRModel() and TransformerLM() and the x-vector evaluator,
           this run's seeded models written as checkpoints in the JAX
           package's format by the port's Checkpointer) over a corpus on disk
           (data/synth.py build_corpus: 18 train and 6 test utterances of
           ~10 s, WAV, the test split as valid too) with a tokenizer trained
           on its transcripts: 2 epochs (one of each schedule phase, 6
           micro-batches of 3 each, the utility 0.2 through the frozen ASR in
           the generator's), then the same argv with ``--eval_only``; the test
           decodes stop at MAIN_DECODE_STEPS (N 198, physical). Checks: K1,
           K2, K3 launched through main(), K4-K7 not; K1 against its plain
           version on a train batch's frames; the eval-only run's recovered
           and averaged parameters bit-equal to the first run's and its ACC
           stats equal; the run's files and the checkpoints' metas. Reports
           stage walls, the micro-batch median, the loader's ms a batch and its
           share of the train stage, which audio reader served, each run's
           peak memory (the first run's brain dropped before the second),
           the launches, the ConvAutoencoder's reconstruction gap with TF32
           on against off (one batch) and the test stats;
  gender   the gender recipes' entry points, ``recipes/gender_classifier.py``
           and ``recipes/gender_classifier_pitch_norm.py`` ``main(argv)``, at
           configs/gender_classifier.yaml's full width (Xvector 512 x 4 + 1500
           -> 128, 3.2 M parameters, XvectorClassifier, batch 32) over a
           corpus on disk (build_corpus: 64 train and 32 test utterances of
           ~3.3 s, the test split as valid too): the plain recipe for 2
           epochs (4 steps) and its test stage; one fit_batch with EnvCorrupt
           + TimeDomainSpecAugment (the batch doubles to 64; the augmentations
           on the card equal to their CPU cores on the same draws); the recon
           variant (gender_classifier_recon.yaml, 1 epoch) on ConvAutoencoder
           checkpoints written in the phase, the ``valid_frontier`` pick; the
           pitch-norm recipe on 16 + 8 utterances of ~2.1 s (batch 8, 2
           epochs; the native vocoder serves every pitch call, the WAV cache
           every later read). Checks: K1 launched once a batch the loops fed
           in every run, K2-K7 never; finite losses and test stats; the plain
           run's files and its one kept checkpoint, a fresh GenderBrain
           recovering it bit-equal, the external evaluator
           (FeatureClassifier.from_checkpoint) scoring a test batch as that
           brain does (1e-5); K1 against its plain version on a train batch's
           frames, timed there beside its yardsticks and bound; the recon run's
           frozen anonymizer equal to the pick. Reports each run's walls, step
           median, loader share, peak memory and launches;
  asr_lm   the ASR and LM recipes' entry points, ``recipes/asr_train.py`` and
           ``recipes/lm_train.py`` ``main(argv)``, at full width. (a) The ASR
           on configs/transformer.yaml (ASRModel(), 161 M parameters, batch
           10, accumulation 4, CTC 0.3 + KLdiv 0.7) over a corpus on disk
           (build_corpus: 40 train and 10 test utterances of ~10 s, the test
           split as valid too) with ``--number_of_epochs 2
           --stage_one_epochs 1 --valid_search_interval 1``: epoch 1 on Adam,
           epoch 2 on SGD, each valid stage a beam-10 decode (N 100), the
           test stage one beam-66 decode (N 660; both physical: K2 + K4 at U
           256), then the same argv with ``--eval_only``. Checks: finite
           losses, the switch to SGD, both checkpoints on disk (ACC metas;
           ``optimizer_name`` in the second), each run's evaluated parameters
           bit-equal to the mean of the kept trees, the WER file; K1, K2 and
           K4 (or K3) launched through main(), K5-K7 not; K1 against its plain
           version on a train batch's frames, K2 and K4 (or K3) on inputs
           captured from the test decode (N 660, step 125); ``load_asr_bundle``
           on the run's directory: its encoder on one batch equal to the best
           checkpoint's tree (ASR_LOAD_ATOL). (b) The LM on configs/lm.yaml
           (TransformerLM(), 92.7 M parameters, batch 32, the ASR run's
           tokenizer) over a text CSV of LM_SENTENCES sentences of the
           corpus's words, their lengths spread over the 16/32/64/128
           buckets, 2 epochs: no kernel launched; one fit_batch at
           lm_dropout 0.1 (finite, the masks' kept share reported);
           ``load_lm`` on its directory giving the least-loss tree's logits.
           Reports each run's wall, stage walls, ms a micro-batch and an
           update, the loader's share, the checkpoint saves' ms, each decode's
           wall and ms a step, peak memory and the launches;
  reference  the reference's own checkpoints: seeded state dicts in
           SpeechBrain's layout at full width (tools/sb_layout.py; asr.ckpt at
           transformer.yaml's widths, lm.ckpt, an FC-AE with the HEAD sex
           classifier under save/CKPT+.../model.ckpt, normalizer.ckpt from
           D2's fbank statistics, noam_scheduler.ckpt, counter.ckpt) written
           with torch.save, then read by the port's loaders on the card
           (utils/reference_ckpts.py, utils/sb_compat.py): every key of
           asr.ckpt and lm.ckpt read, the parameter counts the files', the
           states equal to what was written; the loaded ASRModel(sb_compat)
           on the card against the CPU (PARITY_ATOL) and its cached decode (K3)
           against decode_one_step (REF_CACHED_ATOL); D2's test decode of the
           published pair (K1 -> the loaded normalizer -> the sb_compat ASR,
           beam 66, CTC 0.4, the sb_compat LM fused at 0.6, paged: K6 x 6 and
           one K7 exact-GELU launch a step), counts reset right before and
           read right after, then timed (two decodes); K7's exact-GELU build
           (a layer at a time and whole, K7's tolerances) and K6 (1e-5, the
           pages and slots exact) against their twins on that decode's own
           step-125 inputs, K7 timed beside its twin, its tanh build and the
           per-layer path; gender_classifier's recon variant through main()
           (configs/gender_classifier_recon.yaml, 1 epoch, the gender phase's
           corpus) on the seeded reference save/ directory: K1 once a batch,
           its frozen FC-AE's reconstruction 0.0 from load_reference_fcae's;
  experiments  the research pipeline through its entry points
           (speech_anonymization_tpu_torch/scripts/, the counterparts of the JAX
           package's scripts/) in a temporary work dir at a cut depth
           (EXP_STAGES: build_corpus at 2 + 1 speakers of each sex, 3
           utterances each; 1 epoch a stage): round4_sweep ``conf`` for 2
           epochs (building stage 1, the x-vector evaluator at
           gender_classifier.yaml's width, and stage 1.5, the tiny utility ASR:
           d_model 64, 4 heads of 16, physical caches, beam 4), reeval_frontier
           ``conf``, round4_sweep ``e2e_warm`` at 1 warm epoch + 1 (the second
           run resuming the first in place), attack_retrain ``conf 0
           frontier`` for 1 epoch and write_experiments; the launch counts set
           to 0 right before and read right after: K1, K2 and K3 must launch
           (K4 is reported), K5-K7 not. Then the sweep's failure exit: a
           variant whose run raises must end round4_sweep.main with a
           non-zero SystemExit and no row. Checks: every row finite, the
           frontier row's ``selected_epoch``, the warm run's checkpoints at
           epochs 1 and 2 with Noam's steps going on, the rendered table;
           ``conf``'s checkpoints evaluated again with ``--eval_only`` on the
           CPU: ACC_external, ACC_external_orig, WER and WER_orig equal to the
           card's row, Utility_Retention within EXP_UTILITY_ATOL, and utterance
           by utterance the external classifier's predicted class on both
           feature sets and both test decodes' tokens equal to the card's conf
           run's, their scores within EXP_SCORE_ATOL; K1 against its plain
           version on the pipeline's first fbank frames, K2 and K3 on the
           inputs of its first decode's step EXP_CAPTURE_STEP and of that
           decode's last step. Reports each step's wall and the stages'
           walls.

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
import gc
import json
import re
import os
import shutil
import socket
import statistics
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch.nn.functional as F  # noqa: E402

from speech_anonymization_tpu_torch.config import load_config, parse_arguments  # noqa: E402
from speech_anonymization_tpu_torch.data import audio, pitch  # noqa: E402
from speech_anonymization_tpu_torch.data.synth import build_corpus  # noqa: E402
from speech_anonymization_tpu_torch.data.tokenizer import UnigramTokenizer  # noqa: E402
from speech_anonymization_tpu_torch.decoding import hyps_to_lists  # noqa: E402
from speech_anonymization_tpu_torch.eval.evaluator import FeatureClassifier  # noqa: E402
from speech_anonymization_tpu_torch.eval.metrics import AccuracyStats  # noqa: E402
from speech_anonymization_tpu_torch.models import (  # noqa: E402
    ASRModel,
    ConvAutoencoder,
    FullyConnectedAutoencoder,
    TransformerLM,
    Xvector,
    XvectorClassifier,
)
from speech_anonymization_tpu_torch.ops.attention_step import (  # noqa: E402
    attention_step,
    attention_step_chunked,
    attention_step_plain,
    cached_attention_step,
    max_u_whole_row,
    quantize_rows,
    uses_chunked,
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
from speech_anonymization_tpu_torch.ops import augment  # noqa: E402
from speech_anonymization_tpu_torch.ops.fbank import Fbank, frame_signal  # noqa: E402
from speech_anonymization_tpu_torch.ops.lm_megastep import (  # noqa: E402
    lm_megastep,
    lm_megastep_plain,
)
from speech_anonymization_tpu_torch.ops.fbank_kernel import fused_fbank, mel_power_plain  # noqa: E402
from speech_anonymization_tpu_torch.ops import norm_silu as k8  # noqa: E402
from speech_anonymization_tpu_torch.ops.normalization import InputNormalizer, NormalizerState  # noqa: E402
from speech_anonymization_tpu_torch.recipes import anonymizer as recipe  # noqa: E402
from speech_anonymization_tpu_torch.recipes import asr_train, lm_train  # noqa: E402
from speech_anonymization_tpu_torch.recipes import gender_classifier as gender  # noqa: E402
from speech_anonymization_tpu_torch.recipes import gender_classifier_pitch_norm as gender_pitch  # noqa: E402
from speech_anonymization_tpu_torch.models import transformer  # noqa: E402
from speech_anonymization_tpu_torch.models.transformer import (  # noqa: E402
    DropoutRng,
    beam_reorder_cache,
    make_kv_cache,
)
from speech_anonymization_tpu_torch.recipes.asr_bundle import ASRBundle, load_asr_bundle, load_lm  # noqa: E402
from speech_anonymization_tpu_torch.ops import fbank as fbank_ops  # noqa: E402
from speech_anonymization_tpu_torch.scripts import attack_retrain, reeval_frontier, round4_sweep  # noqa: E402
from speech_anonymization_tpu_torch.scripts import repro_gender_row as repro  # noqa: E402
from speech_anonymization_tpu_torch.scripts import write_experiments  # noqa: E402
from speech_anonymization_tpu_torch.tools import profile_lm_megastep, sb_layout  # noqa: E402
from speech_anonymization_tpu_torch.tools.profile_k3 import K3_CASES, N as K3_N, k3_inputs  # noqa: E402
from speech_anonymization_tpu_torch.parallel import (  # noqa: E402
    global_barrier,
    initialize_distributed,
    local_rows,
    make_mesh,
    run_on_main,
    shutdown_distributed,
)
from speech_anonymization_tpu_torch.tools.train_parity import (  # noqa: E402
    compare_cycle,
    compare_records,
    convae_hparams,
    cycle_record,
    train_batch,
)
from speech_anonymization_tpu_torch.train.checkpoint import Checkpointer, PytreeRecoverable, read_tree  # noqa: E402
from speech_anonymization_tpu_torch.train.epoch_loop import EpochCounter  # noqa: E402
from speech_anonymization_tpu_torch.train.logger import FileTrainLogger, _format_value  # noqa: E402
from speech_anonymization_tpu_torch.train.schedulers import NoamScheduler  # noqa: E402
from speech_anonymization_tpu_torch.utils import cuda_build  # noqa: E402
from speech_anonymization_tpu_torch.utils.convert import (  # noqa: E402
    anonymizer_state_dict,
    anonymizer_variables,
    asr_state_dict,
    indexed_state_dict,
    asr_variables,
    lm_state_dict,
    lm_variables,
    load_numpy_state,
    normalizer_tree,
    xvector_variables,
)
from speech_anonymization_tpu_torch.utils.reference_ckpts import (  # noqa: E402
    load_reference_asr,
    load_reference_fcae,
    load_reference_lm,
    port_sb_asr_state_dict,
    port_sb_lm_state_dict,
)
from speech_anonymization_tpu_torch.utils.sb_compat import (  # noqa: E402
    load_counter_ckpt,
    load_noam_ckpt,
    load_normalizer_ckpt,
    load_state_dict_ckpt,
)
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
# right before is its warm-up. D3 times one decode, so that the whole run
# stays within ~600 s
DECODE_TIMING = {"D1": (3, 1), "D2": (3, 1), "D3": (1, 0), "B3": (3, 1)}
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
# K8 against its twin in float64 (tests/test_torch_cuda.py's): fp32 moments
# and __expf; atol for outputs near 0, where the SiLU's relative error
# follows the absolute error of its argument
K8_RTOL = K8_ATOL = 1e-5
# (block, shape, with the norm): the slice's epilogues, one of each kind, then
# a row past one cluster (k8.MAX_LENGTH), which takes the streaming launches
K8_SHAPES = (("enc_conv0", (BATCH, 32, 80_640), False), ("enc_in1", (BATCH, 64, 40_320), True),
             ("enc_in3", (BATCH, 128, 20_160), True), ("dec_in2", (BATCH, 32, 80_640), True),
             ("dec_in2_80s", (4, 32, 645_120), True))
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
    # no TPU counterpart: the JAX package leaves the block epilogue to XLA
    "norm_silu": ("speech_anonymization_tpu_torch/csrc/norm_silu.cu", None),
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
    entry, report = k1_measure(frame_signal(wavs).contiguous(), fbank)
    emit({"phase": "kernels", "kernel": "fused_fbank", **report})
    if not report["allclose"]:
        raise AssertionError(f"K1 disagrees with its plain twin: max abs {report['max_abs_err']}, "
                             f"max rel {report['max_rel_err']}")
    return entry


def k1_measure(frames: torch.Tensor, fbank: Fbank) -> tuple[dict, dict]:
    """K1 on ``frames`` against its plain twin (K1_RTOL, K1_ATOL), timed beside
    it and beside two ``torch.matmul`` calls (the library yardstick), with its
    bound. -> (the kernel-table entry, the report)."""
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
    return entry, {"rows": rows, "shape": [rows, win, n_bins, n_mels],
                   "max_abs_err": max_abs, "max_rel_err": max_rel, "rtol": K1_RTOL, "atol": K1_ATOL,
                   "allclose": ok, "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": entry["bound_ms"], "bound_by": entry["bound_by"],
                   "fp32_bound_ms": fp32_bound_ms, "gflop_tf32": split["tf32_flops"] / 1e9,
                   "gflop_fp32": split["flops"] / 1e9, "mbytes": nbytes / 1e6,
                   "share_of_bound": entry["bound_ms"] / kernel_ms}


def _k8_operands(shape, norm: bool, gen: torch.Generator):
    """Rows of one standard normal each scaled and shifted by its own amount
    (shifts to +-3, so the mean matters), a bias, the norm's weight and shift."""
    b, c, _ = shape
    x = torch.randn(shape, device=DEVICE, generator=gen)
    x.mul_(0.2 + 2.8 * torch.rand(b, c, 1, device=DEVICE, generator=gen))
    x.add_(6.0 * torch.rand(b, c, 1, device=DEVICE, generator=gen) - 3.0)
    vecs = tuple(s * torch.randn(c, device=DEVICE, generator=gen) + m for s, m in ((0.5, 0.0), (0.1, 1.0), (0.1, 0.0)))
    return (x, *vecs) if norm else (x, vecs[0])


def phase_k8() -> dict:
    """K8 at K8_SHAPES against its twin in float64 (K8_RTOL, K8_ATOL), timed
    beside the twin in fp32; its bound: the input read and the output written
    once, each vector read once. -> the kernel-table entry at dec_in2's shape
    (the cluster path), every shape's figures in its phase line."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    rows, entry = [], None
    for block, shape, norm in K8_SHAPES:
        ops = _k8_operands(shape, norm, gen)
        before = k8.norm_silu.launches
        got = k8.norm_silu(*ops)
        torch.cuda.synchronize()
        launched = k8.norm_silu.launches - before
        want = k8.norm_silu_plain(*(a.double() for a in ops))
        err = (got.double() - want).abs()
        max_abs = float(err.max())
        ok = bool(torch.allclose(got.double(), want, rtol=K8_RTOL, atol=K8_ATOL))
        del want, err, got
        ms = cuda_ms(lambda: k8.norm_silu(*ops))
        plain_ms = cuda_ms(lambda: k8.norm_silu_plain(*ops), iters=10)
        nbytes = 4 * (2 * ops[0].numel() + (len(ops) - 1) * shape[1])
        e = kernel_entry("norm_silu", max_abs, ms, plain_ms, 0, nbytes, None)
        rows.append({"block": block, "shape": list(shape), "norm": norm, "launches_a_call": launched,
                     "max_abs_err": max_abs, "allclose": ok, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": e["bound_ms"], "share_of_bound": e["bound_ms"] / ms})
        if block == "dec_in2":
            entry = e
        del ops
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "kernel": "norm_silu", "rtol": K8_RTOL, "atol": K8_ATOL,
          "max_length": k8.MAX_LENGTH, "shapes": rows})
    bad = [r["block"] for r in rows if not r["allclose"]]
    if bad:
        raise AssertionError(f"K8 disagrees with its plain twin at {bad}")
    wrong = [r["block"] for r in rows
             if r["launches_a_call"] != (2 if r["norm"] and r["shape"][-1] > k8.MAX_LENGTH else 1)]
    if wrong:
        raise AssertionError(f"K8 launched an unexpected number of kernels at {wrong}")
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


def _k3_on_paged_content(q, kh, vh, mask, cache: dict, step: int, layer: int, nhead: int) -> dict:
    """K3 on a one-layer physical int8 cache holding the paged cache's
    logical content (code -128 from the step on; the own-row scales):
    raises unless its output equals K5's bit for bit; K3's time."""
    got = attention_step_paged(q, kh, vh, mask, cache, step, layer, nhead)
    n, u = mask.shape
    physical = []
    for logical in _paged_logical(cache, step, layer, kh, vh):
        c = torch.full((1, n, u, logical.shape[-1]), -128, dtype=torch.int8, device=DEVICE)
        c[0, :, :step] = logical[:, :step]
        physical.append(c)
    scales = [cache[key][layer:layer + 1].clone() for key in ("k_scale", "v_scale")]
    want = attention_step(q, kh, vh, mask, *physical, step, 0, nhead, *scales)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"int8 K5 and K3 differ on the same content at step {step}, "
                             f"{nhead} heads: max abs {float((got - want).abs().max())}")
    return {"k3_bit_identical": True,
            "k3_ms": cuda_ms(lambda: attention_step(q, kh, vh, mask, *physical, step, 0, nhead,
                                                    *scales))}


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
        k3_twin = {}
        if quant and not fused:  # int8 K5 against K3 on the same logical content
            k3_twin = _k3_on_paged_content(q, kh, vh, mask, cache, step, layer, nhead)
            entry["registers"] = _whole_row_registers().get("int8 group 8 paged")
            entry["smem_bytes"] = whole_row_layout(step, d, 1)[2]
        timed[f"{case_shape} {str(dtype)[6:]}"] = {
            **k3_twin,
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


def _k7_call(kernel, x0, mask, cache, step, wall, vecs, nhead, exact_gelu=False):
    """x_out of one K7 (or twin) call on a fused page-64 cache dict."""
    return kernel(x0, mask, cache["kv"], cache["kv_act"], cache["table"], cache["act_src"], step, wall,
                  vecs, nhead, exact_gelu=exact_gelu)[0]


@torch.no_grad()
def _k7_check(lm: TransformerLM, wall, vecs, x0, mask, cache, step: int, exact: bool) -> dict:
    """K7 against its plain twin from the same state (``cache`` is written;
    the twin runs on a copy): a layer at a time, both fed the kernel's x (x
    within K7_LAYER_ATOL, every written page and slot within one bf16 ulp),
    then one launch for all layers (x_out's max and mean gap, the head's
    log-probs). Raises on a disagreement; returns the check's report."""
    nhead, layers = lm.nhead, lm.num_layers
    nb = wall.shape[0] // layers  # weight blocks a layer
    twin_cache = {k: v.clone() for k, v in cache.items()}

    def layer_of(layer, c):
        return {"kv": c["kv"][layer:layer + 1], "kv_act": c["kv_act"][layer:layer + 1],
                "table": c["table"], "act_src": c["act_src"]}

    pages = {key: {"differing": 0, "beyond_one_ulp": 0, "max_ulps_past_slack": 0.0,
                   "nan_matches": True} for key in ("kv", "kv_act")}
    x, layer_errs = x0, []
    for layer in range(layers):
        lw, lv = wall[layer * nb:(layer + 1) * nb], vecs[layer:layer + 1]
        got_l = _k7_call(lm_megastep, x, mask, layer_of(layer, cache), step, lw, lv, nhead, exact)
        want_l = _k7_call(lm_megastep_plain, x, mask, layer_of(layer, twin_cache), step, lw, lv, nhead,
                          exact)
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
    # one launch for every layer against the twin from the same state (the
    # step never reads what it writes: the written pages are rewritten)
    got = _k7_call(lm_megastep, x0, mask, cache, step, wall, vecs, nhead, exact)
    want = _k7_call(lm_megastep_plain, x0, mask, twin_cache, step, wall, vecs, nhead, exact)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    mean_err = float((got - want).abs().mean())
    lp_got, lp_want = (torch.log_softmax(lm._head(x), -1) for x in (got, want))
    lp_err = float((lp_got - lp_want).abs().max())
    lp_ok = bool(torch.allclose(lp_got, lp_want, rtol=K7_LOGP_RTOL, atol=K7_LOGP_ATOL))
    ok = (bool(torch.isfinite(got).all()) and err <= K7_ATOL and mean_err <= K7_MEAN_ATOL
          and lp_ok and max(layer_errs) <= K7_LAYER_ATOL
          and all(p["beyond_one_ulp"] == 0 and p["nan_matches"] for p in pages.values()))
    check = {"dtype": str(cache["kv"].dtype), "step": step, "exact_gelu": exact, "max_abs_err": err,
             "mean_abs_err": mean_err, "log_prob_max_abs_err": lp_err,
             "layer_by_layer_max_abs_err": layer_errs, "written": pages, "ok": ok}
    if not ok:
        raise AssertionError(f"lm_megastep disagrees with its plain twin: {check}")
    del twin_cache
    return check


def _k7_work(lm: TransformerLM, wall, vecs, x0, mask, cache, step: int) -> tuple[int, int, int]:
    """One K7 step's (fp32 flops, tensor-core flops, bytes) on this step's
    valid positions. q/k/v, the context and the layers' x stay in K7's
    L2-resident scratch: the function moves each layer's cache bytes, the mask
    and table once, the weights, and x in and out."""
    nhead, layers, nf = lm.nhead, lm.num_layers, lm.d_ffn // lm.d_model
    n, m = x0.shape
    valid = int(mask[:, :step + 1].sum())
    flops = layers * (4 * valid * (m // nhead) * nhead + n * nhead * (step + 1))
    tc_flops = 2 * n * m * m * (4 + 2 * nf) * layers
    nbytes = (layers * _paged_cache_bytes(cache, mask, step, cache["kv"].element_size())
              + _mask_table_bytes(cache, step) + wall.numel() * 2 + vecs.numel() * 4 + 2 * n * m * 4)
    return flops, tc_flops, nbytes


@torch.no_grad()
def phase_k7(lm: TransformerLM, gen: torch.Generator) -> dict:
    """K7 at D2's LM cache against its plain twin, f32 and bf16, then timed at
    step 125 (f32) beside the twin and the per-layer path on the same state."""
    wall, vecs = lm.prepare_megastep()
    nhead, layers = lm.nhead, lm.num_layers
    checks, max_err = [], 0.0

    def run(kernel, x0, mask, cache, step):
        return _k7_call(kernel, x0, mask, cache, step, wall, vecs, nhead)

    cases = [(dtype, step, False) for dtype in (torch.float32, torch.bfloat16)
             for step in (0, 63, 64, 125, 251)] + [(torch.bfloat16, 125, True)]
    for dtype, step, exact in cases:
        x0, _, _, mask, cache = _paged_inputs("D2", dtype, True, step, gen, layers, nhead)
        checks.append(_k7_check(lm, wall, vecs, x0, mask, cache, step, exact))
        if dtype == torch.float32:
            max_err = max(max_err, checks[-1]["max_abs_err"])
        del x0, mask, cache
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
    flops, tc_flops, nbytes = _k7_work(lm, wall, vecs, x0, mask, cache, step)
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


def _whole_row_registers() -> dict:
    """Registers of each instantiation of the whole-row kernel (cache type,
    score lanes a position; "paged": int8 K5's, else K3's), from
    phase_build's -Xptxas -v report."""
    types = {"f": "float32", "13__nv_bfloat16": "bfloat16", "a": "int8"}
    regs, name = {}, None
    for line in BUILD_REPORT.get("attention_step", {}).get("ptxas", "").splitlines():
        m = re.search(r"Compiling entry function '\S*attn_step_whole_rowI(f|13__nv_bfloat16|a)Li(\d+)ELb([01])E",
                      line)
        if m:
            name = f"{types[m[1]]} group {m[2]}" + (" paged" if m[3] == "1" else "")
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
    regs = _whole_row_registers()
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
    k8.norm_silu.launches = 0
    recon = recipe.anonymize(model, fbank, normalizer, norm_state, wavs, lens)
    if k8.norm_silu.launches != 7:
        raise AssertionError(f"anonymize launched K8 {k8.norm_silu.launches} times, not once a block (7)")
    loss = recipe.evaluate_batch(model, fbank, normalizer, norm_state, wavs, lens, labels, metrics, ext)
    torch.cuda.synchronize()
    launches = {"fused_fbank": fused_fbank.launches, "norm_silu": k8.norm_silu.launches}
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


DIST_RANKS = 2  # part (b): gloo ranks on the one card
DIST_SCHEDULE = [recipe.DEFAULT_SCHEDULE[0]]  # the generator phase: sex 0.8, utility 0.2


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _dist_trainer(asr: ASRModel, device: str, mesh=None) -> recipe.AnonymizerTrainer:
    """``train``'s configuration (the full-width frozen ASR's utility, seeded
    ConvAutoencoder), Noam at lr 1e-3 so that one update shows in f32 weights."""
    hp = convae_hparams(device, DIST_SCHEDULE, NoamScheduler(1e-3, 1, 1))
    trainer = recipe.AnonymizerTrainer(hp, asr_bundle=ASRBundle(asr, StubTokenizer(), DECODE_HPARAMS),
                                       device=device, mesh=mesh)
    seeded_init_(trainer.model, SEED)
    return trainer


def _timed_cycle(trainer, batches, draws) -> tuple[dict, list]:
    """``cycle_record`` of one cycle, each micro-batch's wall ended by a synchronise."""
    walls, fit = [], trainer.fit_batch

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = fit(*args, **kwargs)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return out

    trainer.fit_batch = timed
    return cycle_record(trainer, batches, 0, draws), walls


def _distributed_rank(rank: int, world: int, folder: str, device: str, asr_widths: dict) -> None:
    """Part (b)'s rank: gloo on the one card (NCCL refuses two ranks on one
    device), its rows of the global batches, the global draws; one update
    cycle through ``AnonymizerTrainer(mesh=)``; K1 counted over the cycle and
    held to its plain version on the rank's shard; the gradient all-reduce
    timed. Writes its record and measurements to ``rank<r>.pt``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device == "cuda":
        torch.cuda.set_device(0)
    else:  # a CPU rehearsal of the phase: no device to synchronise or measure
        torch.cuda.synchronize = torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
        torch.cuda.max_memory_allocated = lambda *a, **k: 0
    initialize_distributed(f"file://{Path(folder) / 'store'}", world, rank, backend="gloo")
    try:
        inputs = torch.load(Path(folder) / "inputs.pt", weights_only=False)
        mesh = make_mesh(device=device)
        asr = seeded_init_(ASRModel(**asr_widths, device=device), SEED + 3)
        trainer = _dist_trainer(asr, device, mesh)
        batches = [tuple(local_rows(x, mesh).to(device) for x in b) for b in inputs["batches"]]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fused_fbank.launches = 0
        record, walls = _timed_cycle(trainer, batches, inputs["draws"])
        launches = fused_fbank.launches
        if device == "cuda" and launches != len(batches):
            raise AssertionError(f"rank {rank}: K1 launched {launches} times in {len(batches)} micro-batches")
        peak = torch.cuda.max_memory_allocated() / 2**30
        k1_err, _ = check_k1(batches[0][0], trainer.fbank, f"distributed rank {rank}")
        flat = torch.zeros(sum(p.numel() for p in trainer.params.values()), device=device)
        allreduce_s = host_median_s(lambda: (torch.distributed.all_reduce(flat), torch.cuda.synchronize()))
        torch.save({"record": record, "walls": walls, "k1_launches": launches, "k1_max_abs_err": k1_err,
                    "peak_mem_gib": peak, "allreduce_ms": 1e3 * allreduce_s, "grad_floats": flat.numel()},
                   Path(folder) / f"rank{rank}.pt")
    finally:
        shutdown_distributed()


def phase_distributed(asr: ASRModel, card: str, asr_widths: dict | None = None) -> dict:
    """``parallel/`` on the card, at ``train``'s configuration: one update
    cycle (accumulation 3, TRAIN_BATCH x 10.07 s, the generator phase with
    the full-width frozen ASR's utility) of the ConvAutoencoder. (a) World
    size 1 over NCCL in this process, from the recipes' environment
    (``SATPU_COORDINATOR`` on a free localhost port): the barrier,
    ``run_on_main``, then the cycle through ``AnonymizerTrainer(mesh=
    make_mesh())`` against the same cycle at ``mesh=None`` on the same input
    tensors and draws (``compare_records``), K1 once a micro-batch; the group
    torn down after. (b) DIST_RANKS spawned ranks on the one card over gloo,
    each on its rows of the same batches: rank 0's cycle against (a)'s
    unsharded one, every other rank's updated parameters equal to rank 0's, every rank's K1 once a micro-batch and within K1_RTOL /
    K1_ATOL of its plain version on its shard. A rank's failure fails the
    spawn and the smoke. Reports each part's wall, ms a micro-batch per rank,
    the gradient all-reduce's ms, each rank's peak memory and K1's launches.
    ``asr_widths``: the ranks' ASR (seeded as ``asr`` is); default full width.
    Returns K1's launches in this process."""
    t_phase = time.perf_counter()
    asr_widths = asr_widths or {}
    batches = [train_batch(TRAIN_BATCH, N_SAMPLES, SEED + 30 + i, "cpu", asr.heads.seq_lin.out_features,
                           TRAIN_TOKENS) for i in range(3)]
    frames = 1 + N_SAMPLES // 160
    aug = convae_hparams("cpu")["augmentation"]
    draws = [aug.draw((TRAIN_BATCH, frames + (-frames) % 36, 80), torch.Generator().manual_seed(SEED + 33 + i))
             for i in range(3)]
    on_card = [tuple(x.to(DEVICE) for x in b) for b in batches]
    # (a) one rank over NCCL
    t0 = time.perf_counter()
    os.environ.update(SATPU_COORDINATOR=f"127.0.0.1:{_free_port()}", SATPU_NUM_PROCESSES="1",
                      SATPU_PROCESS_ID="0")
    try:
        if not initialize_distributed():
            raise AssertionError("initialize_distributed did not start a group from the environment")
        backend = torch.distributed.get_backend()
        global_barrier()
        if run_on_main(lambda: "rank 0 ran") != "rank 0 ran":
            raise AssertionError("run_on_main did not run on rank 0")
        plain = _dist_trainer(asr, DEVICE)
        start = {k: p.detach().clone().cpu() for k, p in plain.params.items()}
        want, plain_walls = _timed_cycle(plain, on_card, draws)
        del plain
        mesh = make_mesh()
        trainer = _dist_trainer(asr, DEVICE, mesh)
        torch.cuda.synchronize()
        fused_fbank.launches = 0
        got, mesh_walls = _timed_cycle(trainer, on_card, draws)
        launches = {"fused_fbank": fused_fbank.launches}
        del trainer
    finally:
        shutdown_distributed()
        for name in ("SATPU_COORDINATOR", "SATPU_NUM_PROCESSES", "SATPU_PROCESS_ID"):
            os.environ.pop(name, None)
    if launches["fused_fbank"] != len(on_card):
        raise AssertionError(f"K1 launched {launches['fused_fbank']} times in {len(on_card)} micro-batches")
    one_rank = compare_records(got, want, start, "the one-rank NCCL mesh and mesh=None")
    wall_a = time.perf_counter() - t0
    torch.cuda.empty_cache()
    # (b) two gloo ranks on the one card
    t0 = time.perf_counter()
    folder = Path(tempfile.mkdtemp(prefix="distributed_"))
    try:
        torch.save({"batches": batches, "draws": draws}, folder / "inputs.pt")
        torch.multiprocessing.start_processes(_distributed_rank, args=(DIST_RANKS, str(folder), DEVICE, asr_widths),
                                              nprocs=DIST_RANKS, join=True, start_method="spawn")
        ranks = [torch.load(folder / f"rank{r}.pt", weights_only=False) for r in range(DIST_RANKS)]
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    two_ranks = compare_records(ranks[0]["record"], want, start, f"{DIST_RANKS} gloo ranks and mesh=None")
    for r, other in enumerate(ranks[1:], 1):  # every rank took rank 0's update, bit for bit
        for k, p in ranks[0]["record"]["params"].items():
            if not torch.equal(p, other["record"]["params"][k]):
                raise AssertionError(f"rank {r}'s {k} differs from rank 0's after the update")
    wall_b = time.perf_counter() - t0
    emit({"phase": "distributed", "card": card, "batch": TRAIN_BATCH, "samples": N_SAMPLES,
          "micro_batches": len(on_card), "schedule": DIST_SCHEDULE[0],
          "one_rank_nccl": {"backend": backend, "wall_s": wall_a, "launches": launches,
                            "ms_per_micro_batch": [1e3 * w for w in mesh_walls],
                            "mesh_none_ms_per_micro_batch": [1e3 * w for w in plain_walls], "gaps": one_rank},
          "gloo_ranks": {"ranks": DIST_RANKS, "wall_s": wall_b, "gaps_rank0": two_ranks,
                         "ms_per_micro_batch": [[1e3 * w for w in r["walls"]] for r in ranks],
                         "allreduce_ms": [r["allreduce_ms"] for r in ranks],
                         "grad_floats": ranks[0]["grad_floats"],
                         "peak_mem_gib": [r["peak_mem_gib"] for r in ranks],
                         "k1_launches": [r["k1_launches"] for r in ranks],
                         "k1_max_abs_err": [r["k1_max_abs_err"] for r in ranks], "k1_rtol": K1_RTOL,
                         "k1_atol": K1_ATOL},
          "seconds": time.perf_counter() - t_phase})
    return launches


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
                      ("paged", False, True, "int8"), ("physical", False, True, "int8"),
                      ("physical", True, True, "int8")),
               "B3": (("default", True, True, "float32"), ("physical", True, True, "float32"))}
# pairs of runs that must give identical tokens (scores within 1e-4), and
# pairs that are only reported (K7 computes in bf16, the per-layer path in
# f32; bf16 caches round what f32 ones keep)
SAME_RUNS = {"D1": (("paged", "physical"), ("paged_lm", "physical_lm"),
                    ("paged_lm_int8", "physical_lm_int8")),
             "D2": (("paged", "physical"), ("paged_int8", "physical_int8")),
             "D3": (("paged_int8", "physical_int8"),
                    ("paged_lm_int8_per_layer", "physical_lm_int8")),
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


class Timed:
    """A brain mixin with the smoke's clocks: each micro-batch's wall and
    each stage's start and end (ended by a synchronise), the time the train
    loop spends in ``save_and_keep_only`` with the meta it saved, and the
    batches the loops fed (``batches``: train and evaluation)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.walls, self.marks, self.saves, self.stage_losses = [], [], [], []
        self.batches = 0
        save = self.checkpointer.save_and_keep_only

        def timed_save(meta, **kw):
            t0 = time.perf_counter()
            ckpt = save(meta, **kw)
            self.saves.append((1e3 * (time.perf_counter() - t0), dict(meta)))
            return ckpt

        self.checkpointer.save_and_keep_only = timed_save

    def fit_batch(self, batch, epoch, *args, **kwargs):
        t0 = time.perf_counter()
        loss = super().fit_batch(batch, epoch, *args, **kwargs)
        torch.cuda.synchronize()
        self.walls.append(time.perf_counter() - t0)
        self.batches += 1
        return loss

    def evaluate_batch(self, batch, stage):
        self.batches += 1
        return super().evaluate_batch(batch, stage)

    def on_stage_start(self, stage, epoch=None):
        torch.cuda.synchronize()
        self.marks.append((stage.name, epoch, time.perf_counter()))
        super().on_stage_start(stage, epoch)

    def on_stage_end(self, stage, stage_loss, epoch=None):
        super().on_stage_end(stage, stage_loss, epoch)
        torch.cuda.synchronize()
        self.marks.append((stage.name, epoch, time.perf_counter()))
        self.stage_losses.append((stage.name, epoch, stage_loss))


class TimedBrain(Timed, recipe.SexAnonymizationBrain):
    """The anonymizer recipe's brain with the smoke's clocks."""


class TimedGenderBrain(Timed, gender.GenderBrain):
    """The gender recipe's brain with the smoke's clocks."""


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


# Phase main: the recipe's entry point, recipes/anonymizer.py main(), on a
# corpus on disk. build_corpus's synthetic LibriSpeech at words_per_utt 24
# (~10 s an utterance): MAIN_SPEAKERS train and test speakers of each sex,
# MAIN_UTTS utterances each, so 18 train utterances (6 micro-batches of 3 an
# epoch at convae.yaml's batch 3 and accumulation 3) and 6 test ones (2 batches
# of 3), the test split serving as valid too. The frozen ASR, LM and x-vector
# are this run's seeded full-width models, written as checkpoints in the JAX
# package's format; the tokenizer is trained on the train transcripts. The test
# decodes stop at MAIN_DECODE_STEPS (beam 66, N 198: the physical path, K3 +
# K2, as in phase recipe's B3).
MAIN_SPEAKERS = (3, 1)
MAIN_UTTS = 3
MAIN_WORDS = 24
MAIN_EPOCHS = 2
MAIN_DECODE_STEPS = 64
MAIN_COUNTERS = ("fused_fbank", "beam_gather", "attention_step", "attention_step_chunked",
                 "attention_step_paged", "attention_step_paged_chunked", "lm_megastep")


class TimedLoader:
    """A loader whose batches are timed as they are drawn (the host's wall
    from asking for a batch to having it); it keeps the first batch."""

    def __init__(self, loader):
        self.loader = loader
        self.draws: list[float] = []
        self.first = None

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def state_dict(self):
        return self.loader.state_dict()

    def load_state_dict(self, d) -> None:
        self.loader.load_state_dict(d)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.draws.append(time.perf_counter() - t0)
            if self.first is None:
                self.first = batch
            yield batch


def _write_frozen(work: Path, asr: ASRModel, lm: TransformerLM, emb: Xvector,
                  clf: XvectorClassifier) -> dict:
    """The frozen models' checkpoint directories in the JAX package's format,
    written by the port's own Checkpointer: the ASR's ``model`` (meta ACC), the
    LM's (meta loss) and the x-vector evaluator's ``embedding_model``,
    ``classifier``, ``model_state`` and ``normalizer`` (meta error)."""
    def save(name: str, trees: dict, meta: dict) -> str:
        ckpt = Checkpointer(str(work / name / "ckpts"))
        for key, tree in trees.items():
            ckpt.add_recoverable(key, PytreeRecoverable(lambda tree=tree: tree, lambda _: None))
        ckpt.save_checkpoint(meta)
        return ckpt.checkpoints_dir

    ev, cv = xvector_variables(emb), xvector_variables(clf)
    return {
        "asr_checkpoint_dir": save("asr", {"model": asr_variables(asr)["params"]}, {"ACC": 0.5}),
        "lm_checkpoint_dir": save("lm", {"model": lm_variables(lm)["params"]}, {"loss": 1.0}),
        "external_classifier_dir": save("xvector", {
            "embedding_model": ev["params"], "classifier": cv["params"],
            "model_state": {"embedding_model": {"batch_stats": ev["batch_stats"]},
                            "classifier": {"batch_stats": cv["batch_stats"]}},
            "normalizer": normalizer_tree(InputNormalizer(dim=80).init_state(DEVICE))}, {"error": 0.5}),
    }


def _recipe_argv(config: str, root: Path, out: Path, test_csv: str, **extra) -> list[str]:
    """A recipe's command line on build_corpus's splits (the test split as
    valid too), writing under ``out``, on DEVICE."""
    args = {"data_folder": str(root), "train_splits": '["train-clean"]', "dev_splits": '["test-clean"]',
            "test_splits": '["test-clean"]', "train_csv": str(root / "train.csv"),
            "valid_csv": str(root / "test-clean.csv"), "test_csv": test_csv,
            "output_folder": str(out), "save_folder": str(out / "save"),
            "train_log": str(out / "train_log.txt"), **{k: str(v) for k, v in extra.items()}, "device": DEVICE}
    argv = [str(Path(__file__).resolve().parent / "configs" / config)]
    for k, v in args.items():
        argv += [f"--{k}", v]
    return argv


def _main_argv(root: Path, out: Path, dirs: dict) -> list[str]:
    return _recipe_argv("convae.yaml", root, out, f'["{root / "test-clean.csv"}"]',
                        number_of_epochs=MAIN_EPOCHS, max_decode_steps=MAIN_DECODE_STEPS, **dirs)


def _main_first_run_checks(brain: TimedBrain, batch) -> tuple[float, int, float, float]:
    """On the first ``main()`` run's brain and first train batch: K1 against
    its plain version on the batch's frames, and the ConvAutoencoder's
    reconstruction with TF32 on against off. -> (K1's max abs error, its rows,
    the TF32 gap's max abs, the reconstruction's max abs)."""
    wavs = torch.as_tensor(batch.sig[0], device=DEVICE)
    k1_err, frames = check_k1(wavs, brain.trainer.fbank, "main train")
    lens = torch.as_tensor(batch.sig[1], device=DEVICE)
    feats, _ = recipe.features(brain.trainer.fbank, brain.trainer.normalizer,
                               brain.trainer.state.norm_state, wavs, lens)
    recons = {}
    with torch.no_grad():
        for tf32 in (False, True):
            recipe.set_tf32(tf32)
            recons[tf32] = brain.model.eval()(feats)[0]
        recipe.set_tf32(False)
    gap = float((recons[True] - recons[False]).abs().max())
    return k1_err, frames.shape[0] * frames.shape[1], gap, float(recons[False].abs().max())


def phase_main(asr: ASRModel, lm: TransformerLM, emb: Xvector, clf: XvectorClassifier, card: str) -> dict:
    """The port's ``main()`` on the card at convae.yaml's full width: a corpus on
    disk (build_corpus), a tokenizer trained on it, the frozen models'
    checkpoints, then ``main(argv)`` for MAIN_EPOCHS epochs (one of each schedule
    phase; utility 0.2 through the frozen ASR in the generator's) and the same
    argv with ``--eval_only``. Checks: K1, K2 and K3 launched through main(), no
    K4-K7; K1 against its plain version on a train batch's frames; the eval-only
    run's recovered and averaged parameters bit-equal to the first run's, and its
    ACC stats equal; the run's files (train_log.txt, wer_test-clean.txt,
    hyperparams.yaml, env.log) and the checkpoints' metas. Reports stage walls,
    the micro-batch median, the loader's ms a batch and share of the epoch, the
    audio reader that served (its decodes counted by wrapping the port's
    ``audio`` module for the phase), each run's peak memory, the launches, the
    ConvAutoencoder's reconstruction gap with TF32 on against off on one batch,
    and the test stats. Returns the launches by kernel over both runs."""
    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="main_"))
    counters = {c.__name__: c for c in (fused_fbank, beam_gather, attention_step, attention_step_chunked,
                                        attention_step_paged, attention_step_paged_chunked, lm_megastep)}
    make_loaders, brain_cls = recipe.make_loaders, recipe.SexAnonymizationBrain
    native_lib, read_wav_numpy = audio._native_lib, audio._read_wav_numpy
    try:
        root, out = work / "LibriSpeech", work / "out"
        t0 = time.perf_counter()
        _, audio_s = build_corpus(str(root), n_train_spk=MAIN_SPEAKERS[0], n_test_spk=MAIN_SPEAKERS[1],
                                  utts=MAIN_UTTS, words_per_utt=MAIN_WORDS, seed=SEED)
        corpus_s = time.perf_counter() - t0
        lines = [ln.split(" ", 1)[1] for f in sorted((root / "train-clean").rglob("*.trans.txt"))
                 for ln in f.read_text().splitlines()]
        UnigramTokenizer().train(lines, vocab_size=5000).save(str(work / "asr" / "tokenizer.json"))
        t0 = time.perf_counter()
        dirs = _write_frozen(work, asr, lm, emb, clf)
        write_s = time.perf_counter() - t0
        argv = _main_argv(root, out, dirs)
        native_loaded = bool(native_lib())
        # every read_audio call asks for the library once; a numpy read is a fallback
        reads = {"read_audio": 0, "numpy": 0}

        def counted_lib():
            reads["read_audio"] += 1
            return native_lib()

        def counted_numpy(path):
            reads["numpy"] += 1
            return read_wav_numpy(path)

        loaders: list[TimedLoader] = []

        def timed_loaders(*args):
            train, valid, tests = make_loaders(*args)
            loaders.append(TimedLoader(train))
            return loaders[-1], valid, tests

        recipe.make_loaders, recipe.SexAnonymizationBrain = timed_loaders, TimedBrain
        audio._native_lib, audio._read_wav_numpy = counted_lib, counted_numpy
        launches, walls, peaks = {}, {}, {}
        for name, extra in (("fit", []), ("eval_only", ["--eval_only"])):
            for c in counters.values():
                c.launches = 0
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            brain = recipe.main(argv + extra)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            peaks[name] = {"peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                           "resident_before_gib": resident / 2**30,
                           "added_gib": (torch.cuda.max_memory_allocated() - resident) / 2**30}
            launches[name] = {k: c.launches for k, c in counters.items()}
            if name == "fit":
                first = brain
                # K1, the TF32 gap and the kept results, before the brain is dropped
                if len(first.walls) != MAIN_EPOCHS * len(loaders[0]):
                    raise AssertionError(f"main() trained {len(first.walls)} micro-batches")
                k1_err, k1_rows, tf32_gap, tf32_scale = _main_first_run_checks(first, loaders[0].first)
                p1 = {k: v.detach().clone() for k, v in first.model.named_parameters()}
                b1 = {k: v.detach().clone() for k, v in first.model.named_buffers()}
                ts, first_walls, marks = first.test_stats, first.walls, first.marks
                del first, brain
        total = {k: launches["fit"][k] + launches["eval_only"][k] for k in counters}
        off = [k for k in MAIN_COUNTERS[3:] if total[k]]
        if off or not all(total[k] for k in MAIN_COUNTERS[:3]):
            raise AssertionError(f"main() launched {launches}")
        second = brain

        # the eval-only run recovers, averages and scores as the first did
        p2 = dict(second.model.named_parameters())
        differ = [k for k in p1 if not torch.equal(p1[k], p2[k])]
        b2 = dict(second.model.named_buffers())
        acc = ("ACC", "ACC_external", "ACC_external_orig")
        if differ or any(ts[k] != second.test_stats[k] for k in acc):
            raise AssertionError(f"the eval-only run differs: parameters {differ[:6]}, "
                                 f"{ts} vs {second.test_stats}")
        missing = [f for f in ("train_log.txt", "wer_test-clean.txt", "hyperparams.yaml", "env.log")
                   if not (out / f).is_file()]
        ckpts = Checkpointer(str(out / "save" / "ckpts")).list_checkpoints()
        if missing or not ckpts or not all({"ACC_external", "Utility_Retention"} <= set(c.meta) for c in ckpts):
            raise AssertionError(f"main()'s files: missing {missing}, checkpoints {[c.meta for c in ckpts]}")
        if not all(np.isfinite(ts[k]) for k in ("loss", "WER", "WER_orig", "ACC_external", "Utility_Retention")):
            raise AssertionError(f"test stats {ts}")

        train_draws = loaders[0].draws
        stage = [(marks[i][0], marks[i][1], marks[i + 1][2] - marks[i][2]) for i in range(0, len(marks), 2)]
        train_walls = [w for name, _, w in stage if name == "TRAIN"]
        emit({"phase": "main", "card": card, "model": "convae", "config": "configs/convae.yaml",
              "corpus": {"train_utterances": 2 * MAIN_SPEAKERS[0] * MAIN_UTTS,
                         "test_utterances": 2 * MAIN_SPEAKERS[1] * MAIN_UTTS, "audio_s": audio_s,
                         "words_per_utt": MAIN_WORDS, "build_s": corpus_s},
              "frozen_checkpoints_write_s": write_s, "run_walls_s": walls,
              "stage_walls_s": [{"stage": n, "epoch": e, "s": w} for n, e, w in stage],
              "micro_batches": len(first_walls), "ms_per_micro_batch": 1e3 * statistics.median(first_walls),
              "micro_batch_walls_ms": [1e3 * w for w in first_walls],
              "loader_ms_per_batch": 1e3 * statistics.median(train_draws),
              "loader_share_of_train": sum(train_draws) / sum(train_walls),
              "audio_reader": {"native_loaded": native_loaded, "reads": reads["read_audio"],
                               "native": reads["read_audio"] - reads["numpy"], "numpy": reads["numpy"]},
              "memory_by_run": peaks, "launches": launches,
              "k1_check": {"rows": k1_rows, "max_abs_err": k1_err,
                           "rtol": K1_RTOL, "atol": K1_ATOL},
              "tf32_recon_gap": {"max_abs": tf32_gap, "recon_max_abs": tf32_scale,
                                 "relative": tf32_gap / tf32_scale},
              "eval_only_params_equal": not differ,
              "eval_only_buffers_equal": all(torch.equal(b1[k], b2[k]) for k in b1),
              "checkpoints": [c.meta for c in ckpts], "test_stats": ts,
              "eval_only_test_stats": second.test_stats, "seconds": time.perf_counter() - t_phase})
        return total
    finally:
        recipe.make_loaders, recipe.SexAnonymizationBrain = make_loaders, brain_cls
        audio._native_lib, audio._read_wav_numpy = native_lib, read_wav_numpy
        recipe.set_tf32(False)
        shutil.rmtree(work, ignore_errors=True)


GENDER_SPEAKERS = (8, 4)  # speakers of each sex: train, test (the test split is the valid one too)
GENDER_UTTS = 4
GENDER_WORDS = 8  # ~3.3 s an utterance
GENDER_EPOCHS = 2
PITCH_SPEAKERS = (4, 2)
PITCH_UTTS = 2
PITCH_WORDS = 5  # ~2.1 s an utterance
PITCH_BATCH = 8
GENDER_AUG_ATOL = 1e-5  # the augmentations, card against the CPU on the same draws
EVALUATOR_ATOL = 1e-5  # FeatureClassifier.from_checkpoint against the recovered brain


def _gender_argv(config: str, root: Path, out: Path, **extra) -> list[str]:
    return _recipe_argv(config, root, out, str(root / "test-clean.csv"), **extra)


def _gender_run(entry, argv: list[str], counters: dict, loaders: list) -> tuple:
    """One ``entry.main(argv)`` with the launch counts set to 0 right before
    and read right after: K1 must launch once a batch the loops fed, K2-K7
    never. -> (the brain, the run's report)."""
    for c in counters.values():
        c.launches = 0
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    n_loaders = len(loaders)
    t0 = time.perf_counter()
    brain = entry.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    if launches["fused_fbank"] != brain.batches or any(launches[k] for k in MAIN_COUNTERS[1:]):
        raise AssertionError(f"{entry.__name__}.main() fed {brain.batches} batches, launched {launches}")
    losses = [loss for _, _, loss in brain.stage_losses]
    if not all(np.isfinite(losses)) or not all(np.isfinite(list(brain.test_stats.values()))):
        raise AssertionError(f"{entry.__name__}.main(): stage losses {brain.stage_losses}, test {brain.test_stats}")
    train, marks = loaders[n_loaders][0], brain.marks
    stage = [(marks[i][0], marks[i][1], marks[i + 1][2] - marks[i][2]) for i in range(0, len(marks), 2)]
    train_walls = [w for name, _, w in stage if name == "TRAIN"]
    peak = torch.cuda.max_memory_allocated()
    return brain, {
        "wall_s": wall, "batches": brain.batches, "launches": launches,
        "stage_walls_s": [{"stage": n, "epoch": e, "s": w} for n, e, w in stage],
        "steps": len(brain.walls), "ms_per_step": 1e3 * statistics.median(brain.walls),
        "step_walls_ms": [1e3 * w for w in brain.walls],
        "loader_ms_per_batch": 1e3 * statistics.median(train.draws),
        "loader_share_of_train": sum(train.draws) / sum(train_walls),
        "peak_gib": peak / 2**30, "added_gib": (peak - resident) / 2**30,
        "stage_losses": brain.stage_losses, "test_stats": brain.test_stats}


def _anonymizer_checkpoints(ckpt_dir: str) -> dict:
    """Three full-width ConvAutoencoder checkpoints in the JAX package's
    format (the port's Checkpointer) with frontier metas; -> the
    ``valid_frontier`` pick's (epoch 2) state."""
    model = ConvAutoencoder(generator=torch.Generator().manual_seed(SEED + 9), device=DEVICE)
    ckptr = Checkpointer(ckpt_dir, {
        "model": PytreeRecoverable(lambda: anonymizer_variables(model)["params"], lambda _: None),
        "model_state": PytreeRecoverable(lambda: recipe.model_state_tree(model), lambda _: None)})
    picked = {}
    for epoch, acc, util in ((1, 0.9, 0.99), (2, 0.55, 0.9), (3, 0.5, 0.4)):
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.01)
        ckptr.save_checkpoint({"epoch": epoch, "ACC_external": acc, "Utility_Retention": util})
        if epoch == 2:
            picked = {k: v.detach().clone() for k, v in model.state_dict().items()}
    return picked


def _gender_checks(brain_cls, argv: list[str], out: Path, train_batch, test_batch) -> dict:
    """After the plain run: its files; K1 against its plain version on a train
    batch's frames, with its time, bound and yardsticks at those rows; a fresh
    GenderBrain recovering the kept checkpoint bit-equal; the anonymizer's
    external evaluator (``FeatureClassifier.from_checkpoint``) on that
    directory scoring a test batch as the recovered brain does."""
    missing = [f for f in ("train_log.txt", "hyperparams.yaml", "env.log", "save/label_encoder.txt")
               if not (out / f).is_file()]
    ckpt_dir = str(out / "save" / "ckpts")
    ckpts = Checkpointer(ckpt_dir).list_checkpoints()
    if missing or len(ckpts) != 1 or "error" not in ckpts[0].meta:
        raise AssertionError(f"gender main(): missing {missing}, checkpoints {[c.meta for c in ckpts]}")
    config, _, overrides = parse_arguments(argv)
    fresh = brain_cls(load_config(config, overrides, device=DEVICE), Checkpointer(ckpt_dir), device=DEVICE)
    _, k1 = k1_measure(frame_signal(torch.as_tensor(train_batch.sig[0], device=DEVICE)).contiguous(),
                       fresh.fbank)
    if not k1["allclose"]:
        raise AssertionError(f"K1 disagrees with its plain twin at the gender train batch: {k1}")
    fresh.init_state()
    fresh.checkpointer.recover_if_possible(min_key="error")
    for name in ("embedding_model", "classifier"):
        saved = indexed_state_dict({"params": read_tree(str(Path(ckpts[0].path) / f"{name}.ckpt"))})
        got = dict(getattr(fresh, name).named_parameters())
        differ = [k for k, v in saved.items() if not torch.equal(got[k].cpu(), torch.from_numpy(v))]
        if differ:
            raise AssertionError(f"the recovered {name} differs from the checkpoint: {differ[:6]}")
    wavs, lens = (torch.as_tensor(x, device=DEVICE) for x in test_batch.sig)
    labels = torch.as_tensor(np.asarray(test_batch.gender_encoded), device=DEVICE)
    _, _, want = fresh.eval_step((wavs, lens, labels))
    ext = FeatureClassifier.from_checkpoint(ckpt_dir, emb_dim=128, device=DEVICE)
    with torch.no_grad():
        feats, _ = fresh.normalizer(fresh.state.norm_state, fresh.fbank(wavs), lens, training=False)
    got, _, _ = ext.classify_feats(feats, lens)
    gap = float((got - want).abs().max())
    if not gap <= EVALUATOR_ATOL:
        raise AssertionError(f"the external evaluator differs from the recovered brain by {gap}")
    return {"k1_at_gender_rows": k1, "kept_checkpoint": ckpts[0].meta, "evaluator_max_abs_gap": gap,
            "evaluator_atol": EVALUATOR_ATOL}


def _gender_augmented_step(brain_cls, argv: list[str], batch, counters: dict) -> dict:
    """One ``fit_batch`` with EnvCorrupt + TimeDomainSpecAugment at the plain
    run's settings: the batch doubles, the loss is finite; and the two
    augmentations on the card equal to their CPU cores on the same draws."""
    config, _, overrides = parse_arguments(argv)
    hp = load_config(config, overrides, device=DEVICE)
    hp["env_corrupt"] = augment.EnvCorrupt(noise_snr_low=0.0, noise_snr_high=15.0)
    hp["augmentation"] = augment.TimeDomainSpecAugment(speeds=[95, 100, 105])
    brain = brain_cls(hp, device=DEVICE)
    wavs, lens = (torch.as_tensor(x, device=DEVICE) for x in batch.sig)
    rows = []
    brain.classifier.register_forward_hook(lambda m, i, o: rows.append(o.shape[0]))
    draws = brain.draw(wavs.shape)
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = float(brain.fit_batch(batch, 1, draws))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    if not np.isfinite(loss) or rows != [2 * wavs.shape[0]] or launches["fused_fbank"] != 1:
        raise AssertionError(f"augmented fit_batch: loss {loss}, classifier rows {rows}, launches {launches}")

    def both(on):
        w, ln = wavs.to(on), lens.to(on)
        noisy = brain.env_corrupt(w, ln, draws.env)
        return noisy, *brain.augmentation(torch.cat([w, noisy]), torch.cat([ln, ln]), draws.aug)

    card, cpu = both(DEVICE), both("cpu")
    gaps = [float((a.cpu() - b).abs().max()) for a, b in zip(card, cpu)]
    if not max(gaps) <= GENDER_AUG_ATOL:
        raise AssertionError(f"the augmentations differ on the card from the CPU by {gaps}")
    aug_ms = cuda_ms(lambda: both(DEVICE), iters=5, warmup=1)
    return {"loss": loss, "classifier_rows": rows[0], "wall_s": wall, "launches": launches,
            "augment_ms": aug_ms, "card_vs_cpu_max_abs": {"env_corrupt": gaps[0], "augmented": gaps[1],
                                                          "lens": gaps[2]}, "atol": GENDER_AUG_ATOL}


def phase_gender(card: str) -> dict:
    """The gender recipes through their entry points on the card, at
    configs/gender_classifier.yaml's full width (Xvector 512 x 4 + 1500 ->
    128, 3.2 M parameters, its XvectorClassifier, batch 32, fp32, TF32 off),
    over a corpus on disk (build_corpus: 8 + 4 speakers of each sex, 4
    utterances each, ~3.3 s; 64 train, 32 test, the test split as valid too):
    (a) ``gender_classifier.main`` for GENDER_EPOCHS epochs (4 steps), then
    the test stage; (b) one ``fit_batch`` with EnvCorrupt +
    TimeDomainSpecAugment (64 rows); (c) the recon variant
    (gender_classifier_recon.yaml, 1 epoch) on ConvAutoencoder checkpoints
    written here, ``valid_frontier``; (d) ``gender_classifier_pitch_norm.main``
    on a corpus of 16 + 8 utterances of ~2.1 s, batch 8, 2 epochs. Checks:
    K1 launched once a batch in every run, K2-K7 never; finite losses; (a)'s
    files and checks (``_gender_checks``); (b) ``_gender_augmented_step``;
    (c) the pick loaded and unchanged by the run; (d) the native vocoder
    serving every pitch call and the WAV cache every later read. Reports each
    run's walls, steps, loader share, peak memory and launches. Returns the
    launches by kernel over the four runs."""
    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="gender_"))
    counters = {c.__name__: c for c in (fused_fbank, beam_gather, attention_step, attention_step_chunked,
                                        attention_step_paged, attention_step_paged_chunked, lm_megastep)}
    make_loaders, brain_cls = gender.make_loaders, gender.GenderBrain
    loaders: list = []

    def timed_loaders(*args):
        train, valid, test = make_loaders(*args)
        loaders.append((TimedLoader(train), TimedLoader(test)))
        return loaders[-1][0], valid, loaders[-1][1]

    try:
        root, proot = work / "LibriSpeech", work / "PitchSpeech"
        t0 = time.perf_counter()
        _, audio_s = build_corpus(str(root), n_train_spk=GENDER_SPEAKERS[0], n_test_spk=GENDER_SPEAKERS[1],
                                  utts=GENDER_UTTS, words_per_utt=GENDER_WORDS, seed=SEED + 5)
        _, pitch_audio_s = build_corpus(str(proot), n_train_spk=PITCH_SPEAKERS[0], n_test_spk=PITCH_SPEAKERS[1],
                                        utts=PITCH_UTTS, words_per_utt=PITCH_WORDS, seed=SEED + 6)
        corpus_s = time.perf_counter() - t0
        anon_dir = str(work / "anonymizer" / "ckpts")
        picked = _anonymizer_checkpoints(anon_dir)
        gender.make_loaders, gender.GenderBrain = timed_loaders, TimedGenderBrain
        runs, total = {}, {k: 0 for k in counters}

        argv = _gender_argv("gender_classifier.yaml", root, work / "out", number_of_epochs=GENDER_EPOCHS)
        brain, runs["plain"] = _gender_run(gender, argv, counters, loaders)
        if len(brain.walls) != GENDER_EPOCHS * len(loaders[0][0]):
            raise AssertionError(f"gender main() took {len(brain.walls)} steps")
        train_batch, test_batch = loaders[0][0].first, loaders[0][1].first
        del brain
        runs["augmented_step"] = _gender_augmented_step(brain_cls, argv, train_batch, counters)

        argv = _gender_argv("gender_classifier_recon.yaml", root, work / "recon", number_of_epochs=1,
                            trained_recon_model_dir=anon_dir, recon_model_type="convae",
                            recon_ckpt_select="valid_frontier")
        brain, runs["recon"] = _gender_run(gender, argv, counters, loaders)
        differ = [k for k, v in brain.recon_model.state_dict().items() if not torch.equal(v, picked[k])]
        if not isinstance(brain.recon_model, ConvAutoencoder) or differ:
            raise AssertionError(f"the recon run's frozen anonymizer differs from the pick: {differ[:6]}")
        del brain

        served = dict(pitch.SERVED)
        t0 = time.perf_counter()
        argv = _gender_argv("gender_classifier_pitch_norm.yaml", proot, work / "pitch", batch_size=PITCH_BATCH,
                            number_of_epochs=GENDER_EPOCHS)
        brain, runs["pitch_norm"] = _gender_run(gender_pitch, argv, counters, loaders)
        n_files = 2 * (PITCH_SPEAKERS[0] + PITCH_SPEAKERS[1]) * PITCH_UTTS
        calls = {k: pitch.SERVED[k] - served[k] for k in served}
        cached = len(list((work / "pitch" / "save" / "pitch_cache").glob("*.wav")))
        if calls != {"native": n_files, "numpy": 0} or cached != n_files:
            raise AssertionError(f"pitch normalization: {calls} calls for {n_files} files, {cached} cached")
        runs["pitch_norm"]["pitch_calls"] = calls
        del brain
        for name in ("plain", "augmented_step", "recon", "pitch_norm"):
            for k in counters:
                total[k] += runs[name]["launches"][k]
        gender.make_loaders, gender.GenderBrain = make_loaders, brain_cls
        checks = _gender_checks(brain_cls, _gender_argv("gender_classifier.yaml", root, work / "out",
                                                   number_of_epochs=GENDER_EPOCHS),
                                work / "out", train_batch, test_batch)
        emit({"phase": "gender", "card": card, "config": "configs/gender_classifier.yaml",
              "corpus": {"train_utterances": 2 * GENDER_SPEAKERS[0] * GENDER_UTTS,
                         "test_utterances": 2 * GENDER_SPEAKERS[1] * GENDER_UTTS, "audio_s": audio_s,
                         "pitch_utterances": n_files, "pitch_audio_s": pitch_audio_s, "build_s": corpus_s},
              "runs": runs, **checks, "launches": total, "seconds": time.perf_counter() - t_phase})
        return total
    finally:
        gender.make_loaders, gender.GenderBrain = make_loaders, brain_cls
        shutil.rmtree(work, ignore_errors=True)


ASR_LM_SPEAKERS = (4, 1)  # of each sex, train and test: 40 and 10 utterances at ASR_LM_UTTS
ASR_LM_UTTS = 5
ASR_LM_WORDS = 24  # ~10 s an utterance
ASR_LM_EPOCHS = 2
ASR_LM_ARGS: dict = {}  # extra overrides of both runs (a CPU rehearsal shrinks the widths here)
LM_SENTENCES = (256, 64)  # train, valid
LM_WORDS = ((1, 13), (14, 29), (30, 60), (61, 120))  # words a sentence: one range per bucket
ASR_CAPTURE_STEP = 125  # the test decode's step whose K2 and K4 (or K3) inputs are checked
ASR_LOAD_ATOL = 1e-5
LM_LOAD_ATOL = 1e-5
LM_DROPOUT = 0.1


class TimedASRBrain(Timed, asr_train.ASRBrain):
    """The ASR recipe's brain with the smoke's clocks and each decode's wall."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.decodes = []

    def _decode(self, wavs, lens, epoch, beam_size, length_normalization):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = super()._decode(wavs, lens, epoch, beam_size, length_normalization)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        self.decodes.append({"beam": beam_size, "rows": wavs.shape[0] * beam_size, "steps": out[0].shape[1],
                             "wall_s": wall, "ms_per_step": 1e3 * wall / out[0].shape[1]})
        return out


class TimedLMBrain(Timed, lm_train.LMBrain):
    """The LM recipe's brain with the smoke's clocks."""


class Capture:
    """Wraps ``module.name``: the first call whose arguments ``want`` accepts
    is recorded by ``keep`` (copies of its inputs), then the call goes on."""

    def __init__(self, module, name: str, want, keep):
        self.module, self.name, self.fn = module, name, getattr(module, name)
        self.want, self.keep, self.args = want, keep, None

    def __enter__(self):
        def wrapped(*args):
            if self.args is None and self.want(*args):
                self.args = self.keep(*args)
            return self.fn(*args)

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def _keep_attention(q, kh, vh, mask, k, v, step, layer, nhead, *_):
    """Copies of a ``cached_attention_step`` call's inputs: layer ``layer``'s cache slice."""
    return (q.clone(), kh.clone(), vh.clone(), mask.clone(), k[layer:layer + 1].clone(),
            v[layer:layer + 1].clone(), step, nhead)


def _keep_gather(a, src, step, out):
    """Copies of a ``beam_gather`` call's inputs: layer 0's cache slice."""
    return a[:1].clone(), src.clone(), step


def _asr_decode_captures(rows: int):
    """Captures of the decode's K4 (or K3) and K2 inputs at ASR_CAPTURE_STEP of
    a decode of ``rows`` rows: one layer's cache slice each."""
    attn = Capture(transformer, "cached_attention_step",
                   lambda q, kh, vh, mask, k, v, step, layer, nhead, *_: (
                       q.shape[0] == rows and step == ASR_CAPTURE_STEP and layer == 0),
                   _keep_attention)
    gather = Capture(transformer, "beam_gather",
                     lambda a, src, step, out: a.shape[1] == rows and step == ASR_CAPTURE_STEP,
                     _keep_gather)
    return attn, gather


def _check_captured_attention(captured) -> dict:
    """K4 (or K3, by the JAX rule) against attention_step_plain on the test
    decode's own inputs: the output (ATTN_RTOL, ATTN_ATOL) and the cache
    written at the step; timed beside the plain version."""
    q, kh, vh, mask, ck, cv, step, nhead = captured
    ck2, cv2 = ck.clone(), cv.clone()
    got = cached_attention_step(q, kh, vh, mask, ck, cv, step, 0, nhead)
    want = attention_step_plain(q, kh, vh, mask, ck2, cv2, step, 0, nhead)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=ATTN_RTOL, atol=ATTN_ATOL))
    written = torch.equal(ck[:, :, step], ck2[:, :, step]) and torch.equal(cv[:, :, step], cv2[:, :, step])
    name = "attention_step_chunked" if uses_chunked(ck.shape[2], ck.shape[3], ck.dtype) else "attention_step"
    report = {"kernel": name, "cache": list(ck.shape), "step": step, "max_abs_err": err, "allclose": ok,
              "written_equal": written, "rtol": ATTN_RTOL, "atol": ATTN_ATOL}
    if not (ok and written):
        raise AssertionError(f"{name} disagrees with its plain twin on the ASR test decode's inputs: {report}")
    report["ms"] = cuda_ms(lambda: cached_attention_step(q, kh, vh, mask, ck, cv, step, 0, nhead))
    report["plain_ms"] = cuda_ms(lambda: attention_step_plain(q, kh, vh, mask, ck2, cv2, step, 0, nhead))
    return report


def _kept_mean(ckpt_dir: str) -> dict:
    """The mean of the ``model`` trees of the top-5 ACC checkpoints, summed in
    their order and divided in f32 (``average_checkpoints``' arithmetic), as
    the ASRModel's parameters."""
    ckpts = Checkpointer(ckpt_dir).find_checkpoints(max_key="ACC", n=5)
    trees = [asr_state_dict({"params": read_tree(str(Path(c.path) / "model.ckpt"))}) for c in ckpts]
    total = {k: functools.reduce(lambda a, b: a + b, [t[k] for t in trees]) for k in trees[0]}
    return {k: v / np.float32(len(trees)) for k, v in total.items()}


def _main_run(entry, argv: list[str], counters: dict) -> tuple:
    """One ``entry.main(argv)``, the launch counts set to 0 right before and
    read right after. -> (brain, wall s, launches, peak GiB, GiB added)."""
    for c in counters.values():
        c.launches = 0
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    brain = entry.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    return brain, wall, {k: c.launches for k, c in counters.items()}, peak / 2**30, (peak - resident) / 2**30


def _stage_walls(brain) -> list:
    m = brain.marks
    return [{"stage": m[i][0], "epoch": m[i][1], "s": m[i + 1][2] - m[i][2]} for i in range(0, len(m), 2)]


def _run_report(brain, wall, launches, peak, added, loader) -> dict:
    stages = _stage_walls(brain)
    train_s = sum(x["s"] for x in stages if x["stage"] == "TRAIN")
    walls = brain.walls
    k = getattr(brain, "grad_accum", 1)  # micro-batches an update
    updates = [sum(walls[i:i + k]) for i in range(0, len(walls) - k + 1, k)]
    return {"wall_s": wall, "launches": launches, "peak_gib": peak, "added_gib": added,
            "stage_walls_s": stages, "micro_batches": len(walls),
            "ms_per_micro_batch": 1e3 * statistics.median(walls[1:]) if len(walls) > 1 else None,
            "micro_batch_walls_ms": [1e3 * w for w in walls],
            "ms_per_update": 1e3 * statistics.median(updates[1:]) if len(updates) > 1 else None,
            "update_walls_ms": [1e3 * w for w in updates],
            "loader_ms_per_batch": 1e3 * statistics.median(loader.draws) if loader and loader.draws else None,
            "loader_share_of_train": sum(loader.draws) / train_s if loader and loader.draws and train_s else None,
            "save_ms": [ms for ms, _ in brain.saves], "stage_losses": brain.stage_losses,
            "test_stats": getattr(brain, "test_stats", None)}


def _lm_csvs(root: Path, words: list[str]) -> tuple[Path, Path]:
    """The LM's train and valid CSVs (ID, wrd): sentences of the corpus's
    words, a quarter in each bucket's range of lengths (LM_WORDS)."""
    rng = np.random.default_rng(SEED + 14)
    paths = []
    for name, n in zip(("lm_train", "lm_valid"), LM_SENTENCES):
        path = root / f"{name}.csv"
        lines = ["ID,wrd"]
        for i in range(n):
            lo, hi = LM_WORDS[i % len(LM_WORDS)]
            lines.append(f"{name}-{i}," + " ".join(rng.choice(words, int(rng.integers(lo, hi + 1)))))
        path.write_text("\n".join(lines) + "\n")
        paths.append(path)
    return paths[0], paths[1]


def _asr_checks(first, second, out: Path, argv: list[str], loader) -> dict:
    """The ASR runs' files, stage switch, checkpoints, averages and
    ``load_asr_bundle``; K1 on a train batch's frames."""
    ckpt_dir = str(out / "save" / "ckpts")
    ckpts = Checkpointer(ckpt_dir).list_checkpoints()
    log = (out / "train_log.txt").read_text().splitlines()
    missing = [f for f in ("train_log.txt", "wer_test-clean.txt", "hyperparams.yaml", "env.log",
                           "save/tokenizer.json") if not (out / f).is_file()]
    if (missing or len(ckpts) != ASR_LM_EPOCHS or not all("ACC" in c.meta for c in ckpts)
            or not (Path(ckpts[-1].path) / "optimizer_name.ckpt").is_file()):
        raise AssertionError(f"asr main(): missing {missing}, checkpoints {[c.meta for c in ckpts]}")
    if first._optimizer_name != "SGD" or "optimizer: Adam" not in log[0] or "optimizer: SGD" not in log[1]:
        raise AssertionError(f"asr main(): no switch to SGD: {first._optimizer_name}, {log}")
    losses = [x for _, _, x in first.stage_losses + second.stage_losses]
    if not all(np.isfinite(losses)) or not all(np.isfinite(list(first.test_stats.values()))):
        raise AssertionError(f"asr main(): stage losses {losses}, test {first.test_stats}")
    mean = _kept_mean(ckpt_dir)
    for name, brain in (("fit", first), ("eval_only", second)):
        differ = [k for k, p in brain.model.named_parameters()
                  if not torch.equal(p.detach().cpu(), torch.from_numpy(np.ascontiguousarray(mean[k])))]
        if differ:
            raise AssertionError(f"asr main() {name}: the evaluated parameters differ from the kept trees' "
                                 f"mean: {differ[:6]}")
    # the same parameters scored again (cuDNN is not bit-reproducible run to run: the loss within rtol)
    if not np.isclose(second.test_stats["loss"], first.test_stats["loss"], rtol=1e-5, atol=0):
        raise AssertionError(f"the eval-only rerun scored {second.test_stats}, the first {first.test_stats}")
    # load_asr_bundle on the run's directory: the best checkpoint's tree
    config, _, overrides = parse_arguments(argv)
    hp = load_config(config, overrides, device=DEVICE)
    bundle = load_asr_bundle({**hp, "asr_checkpoint_dir": ckpt_dir}, first.tokenizer, DEVICE)
    best = Checkpointer(ckpt_dir).find_checkpoint(max_key="ACC")
    ref = ASRModel(input_feats=80, d_model=int(hp["d_model"]), nhead=int(hp["nhead"]),
                   num_encoder_layers=int(hp["num_encoder_layers"]),
                   num_decoder_layers=int(hp["num_decoder_layers"]), d_ffn=int(hp["d_ffn"]),
                   output_neurons=int(hp["output_neurons"]), device=DEVICE)
    load_numpy_state(ref, asr_state_dict({"params": read_tree(str(Path(best.path) / "model.ckpt"))}))
    batch = loader.first
    wavs, lens = (torch.as_tensor(x, device=DEVICE) for x in batch.sig)
    k1_err, frames = check_k1(wavs, first.fbank, "asr train")
    with torch.no_grad():
        feats, _ = first.normalizer(first.state.norm_state, first.fbank(wavs), lens, training=False)
        gap = float((bundle.model.encode(feats, lens) - ref.eval().encode(feats, lens)).abs().max())
    if not gap <= ASR_LOAD_ATOL:
        raise AssertionError(f"load_asr_bundle's encoder differs from the best checkpoint's by {gap}")
    return {"checkpoints": [c.meta for c in ckpts], "switched_to_sgd": True, "load_asr_bundle_gap": gap,
            "load_atol": ASR_LOAD_ATOL, "k1_check": {"rows": frames.shape[0] * frames.shape[1],
                                                      "max_abs_err": k1_err, "rtol": K1_RTOL, "atol": K1_ATOL}}


def _lm_checks(brain, out: Path, argv: list[str], loader, brain_cls) -> dict:
    """The LM run's checkpoints, ``load_lm`` against the least-loss tree, and
    one fit_batch at lm_dropout LM_DROPOUT on the longest train batch."""
    ckpt_dir = str(out / "save" / "ckpts")
    ckpts = Checkpointer(ckpt_dir).list_checkpoints()
    if len(ckpts) != ASR_LM_EPOCHS or not all("loss" in c.meta for c in ckpts):
        raise AssertionError(f"lm main(): checkpoints {[c.meta for c in ckpts]}")
    losses = [x for _, _, x in brain.stage_losses]
    if not all(np.isfinite(losses)) or not np.isfinite(brain.test_stats["loss"]):
        raise AssertionError(f"lm main(): stage losses {losses}, test {brain.test_stats}")
    config, _, overrides = parse_arguments(argv)
    hp = load_config(config, overrides, device=DEVICE)
    widths = dict(vocab=int(hp["output_neurons"]), d_model=int(hp["lm_d_model"]), nhead=int(hp["lm_nhead"]),
                  num_layers=int(hp["lm_num_layers"]), d_ffn=int(hp["lm_d_ffn"]))
    lm = load_lm({**hp, "lm_checkpoint_dir": ckpt_dir}, DEVICE)
    best = Checkpointer(ckpt_dir).find_checkpoint(min_key="loss")
    ref = load_numpy_state(TransformerLM(**widths, device=DEVICE),
                           lm_state_dict({"params": read_tree(str(Path(best.path) / "model.ckpt"))}))
    batches = list(loader.loader)
    longest = max(batches, key=lambda b: b[0].shape[1])
    tokens = torch.as_tensor(longest[0], dtype=torch.int64, device=DEVICE)
    with torch.no_grad():
        gap = float((lm(tokens) - ref(tokens)).abs().max())
    if not gap <= LM_LOAD_ATOL:
        raise AssertionError(f"load_lm's logits differ from the least-loss checkpoint's by {gap}")
    del lm, ref
    dropped = brain_cls({**hp, "lm_dropout": LM_DROPOUT}, brain.tokenizer, None, device=DEVICE)
    dropped.dropout_rng = DropoutRng(torch.Generator(device=DEVICE).manual_seed(SEED + 15), record=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = float(dropped.fit_batch(longest, 1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kept = sum(float(m.sum()) for m in dropped.dropout_rng.used) / sum(m.numel() for m in dropped.dropout_rng.used)
    if not np.isfinite(loss) or len(dropped.dropout_rng.used) != 2 * widths["num_layers"]:
        raise AssertionError(f"lm fit_batch at dropout {LM_DROPOUT}: loss {loss}, "
                             f"{len(dropped.dropout_rng.used)} masks")
    return {"checkpoints": [c.meta for c in ckpts], "load_lm_gap": gap, "load_atol": LM_LOAD_ATOL,
            "buckets": sorted({int(b[0].shape[1]) for b in batches}),
            "dropout_step": {"rate": LM_DROPOUT, "loss": loss, "kept_share": kept, "masks": len(dropped.dropout_rng.used),
                             "tokens": list(longest[0].shape), "wall_s": wall}}


def phase_asr_lm(card: str) -> dict:
    """The ASR and LM recipes' ``main(argv)`` on the card (the docstring at the
    top: ``asr_lm``). Returns the ASR runs' launches by kernel."""
    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="asr_lm_"))
    counters = {c.__name__: c for c in (fused_fbank, beam_gather, attention_step, attention_step_chunked,
                                        attention_step_paged, attention_step_paged_chunked, lm_megastep)}
    asr_loaders, lm_loaders = [], []
    saved = (asr_train.make_loaders, asr_train.ASRBrain, lm_train.TextBatchLoader, lm_train.LMBrain)

    def timed_asr_loaders(*args):
        train, valid, tests = saved[0](*args)
        asr_loaders.append(TimedLoader(train))
        return asr_loaders[-1], valid, tests

    def timed_text_loader(*args, **kwargs):
        loader = saved[2](*args, **kwargs)
        if kwargs.get("shuffle"):
            lm_loaders.append(TimedLoader(loader))
            return lm_loaders[-1]
        return loader

    try:
        root, asr_out, lm_out = work / "LibriSpeech", work / "asr", work / "lm"
        t0 = time.perf_counter()
        _, audio_s = build_corpus(str(root), n_train_spk=ASR_LM_SPEAKERS[0], n_test_spk=ASR_LM_SPEAKERS[1],
                                  utts=ASR_LM_UTTS, words_per_utt=ASR_LM_WORDS, seed=SEED + 13)
        corpus_s = time.perf_counter() - t0
        asr_argv = _recipe_argv("transformer.yaml", root, asr_out, f'["{root / "test-clean.csv"}"]',
                                number_of_epochs=ASR_LM_EPOCHS, stage_one_epochs=1, valid_search_interval=1,
                                **ASR_LM_ARGS)
        asr_train.make_loaders, asr_train.ASRBrain = timed_asr_loaders, TimedASRBrain
        lm_train.TextBatchLoader, lm_train.LMBrain = timed_text_loader, TimedLMBrain
        rows = 10 * 66  # batch_size x test_beam_size of transformer.yaml
        if ASR_LM_ARGS:
            rows = int(ASR_LM_ARGS.get("batch_size", 10)) * int(ASR_LM_ARGS.get("test_beam_size", 66))
        attn_cap, gather_cap = _asr_decode_captures(rows)
        with attn_cap, gather_cap:
            first, wall1, launches1, peak1, added1 = _main_run(asr_train, asr_argv, counters)
        fit_report = _run_report(first, wall1, launches1, peak1, added1, asr_loaders[0])
        fit_report["decodes"] = first.decodes
        fit_report["optimizer"] = first._optimizer_name
        second, wall2, launches2, peak2, added2 = _main_run(asr_train, asr_argv + ["--eval_only"], counters)
        eval_report = _run_report(second, wall2, launches2, peak2, added2, None)
        eval_report["decodes"] = second.decodes
        total = {k: launches1[k] + launches2[k] for k in counters}
        attn_name = "attention_step_chunked" if total["attention_step_chunked"] else "attention_step"
        off = [k for k in ("attention_step_paged", "attention_step_paged_chunked", "lm_megastep") if total[k]]
        if off or not (total["fused_fbank"] and total["beam_gather"] and total[attn_name]):
            raise AssertionError(f"asr main() launched {launches1}, then {launches2}")
        if attn_cap.args is None or gather_cap.args is None:
            raise AssertionError("the ASR test decode's kernel inputs were not captured")
        checks = _asr_checks(first, second, asr_out, asr_argv, asr_loaders[0])
        checks["attention_check"] = _check_captured_attention(attn_cap.args)
        a, src, step = gather_cap.args
        k2_checks: list = []
        k2_err = _check_k2(a, src, (step,), "asr test decode", k2_checks)
        checks["k2_check"] = {"cache": list(a.shape), "step": step, "max_abs_err": k2_err, "checks": k2_checks}
        tokenizer_path = asr_out / "save" / "tokenizer.json"
        attn_cap.args = gather_cap.args = None
        del first, second, a, src
        gc.collect()

        words = sorted({w for f in (root / "train-clean").rglob("*.trans.txt")
                        for ln in f.read_text().splitlines() for w in ln.split(" ")[1:]})
        train_csv, valid_csv = _lm_csvs(work, words)
        lm_argv = [str(Path(__file__).resolve().parent / "configs" / "lm.yaml")]
        for k, v in {"train_csv": str(train_csv), "valid_csv": str(valid_csv), "test_csv": f'["{valid_csv}"]',
                     "output_folder": str(lm_out), "save_folder": str(lm_out / "save"),
                     "train_log": str(lm_out / "train_log.txt"), "number_of_epochs": str(ASR_LM_EPOCHS),
                     "tokenizer_path": str(tokenizer_path),
                     **{k: str(v) for k, v in ASR_LM_ARGS.items() if k.startswith(("lm_", "output_"))},
                     "device": DEVICE}.items():
            lm_argv += [f"--{k}", v]
        lm_brain, wall3, launches3, peak3, added3 = _main_run(lm_train, lm_argv, counters)
        if any(launches3.values()):
            raise AssertionError(f"lm main() launched {launches3}")
        lm_report = _run_report(lm_brain, wall3, launches3, peak3, added3, lm_loaders[0])
        lm_report.update(_lm_checks(lm_brain, lm_out, lm_argv, lm_loaders[0], saved[3]))
        del lm_brain
        emit({"phase": "asr_lm", "card": card,
              "asr": {"config": "configs/transformer.yaml", "corpus": {
                  "train_utterances": 2 * ASR_LM_SPEAKERS[0] * ASR_LM_UTTS,
                  "test_utterances": 2 * ASR_LM_SPEAKERS[1] * ASR_LM_UTTS, "audio_s": audio_s,
                  "words_per_utt": ASR_LM_WORDS, "build_s": corpus_s},
                  "fit": fit_report, "eval_only": eval_report, **checks},
              "lm": {"config": "configs/lm.yaml", "sentences": list(LM_SENTENCES), **lm_report},
              "seconds": time.perf_counter() - t_phase})
        return total
    finally:
        (asr_train.make_loaders, asr_train.ASRBrain, lm_train.TextBatchLoader, lm_train.LMBrain) = saved
        shutil.rmtree(work, ignore_errors=True)


REF_SEEDS = {"asr": SEED + 11, "lm": SEED + 12, "fcae": SEED + 13}
REF_SHAPE = "D2"  # the decode: 8 x 10.07 s, beam 66, the LM fused at 0.6, 252 steps
REF_CAPTURE_STEP = 125  # the decode step whose K7 and K6 inputs are checked
REF_PARITY = (2, 400, 16)  # card vs CPU: utterances, feature frames, teacher-forced tokens
REF_CACHED_STEPS = 4
REF_CACHED_ATOL = 2e-4  # decode_step_cached vs decode_one_step: the JAX package's own bound
REF_CKPT = "CKPT+2022-05-06+15-54-03+00"  # a reference save/ directory's checkpoint name
REF_NOAM = {"losses": [3.5, 2.25, 1.125], "n_steps": 31250, "normalize": 768 ** -0.5}
REF_COUNTER = 17


class KeyLog(dict):
    """A state dict that records which of its keys were read."""

    def __init__(self, *args):
        super().__init__(*args)
        self.read: set = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)

    def get(self, key, default=None):
        if key in self:
            self.read.add(key)
        return super().get(key, default)


def _reference_files(work: Path, stats: torch.Tensor) -> tuple[dict, dict]:
    """The reference's checkpoint files, seeded, in SpeechBrain's layout at
    full width (``tools/sb_layout.py``): asr.ckpt (transformer.yaml's ASR),
    lm.ckpt (its LM), an FC-AE with the HEAD sex classifier under
    ``save/CKPT+.../model.ckpt``, normalizer.ckpt (``stats``: (2, 80) mean
    and std), noam_scheduler.ckpt and counter.ckpt. -> (paths, state dicts)."""
    paths = {"asr": work / "asr.ckpt", "lm": work / "lm.ckpt", "fcae": work / "save" / REF_CKPT / "model.ckpt",
             "normalizer": work / "normalizer.ckpt", "noam": work / "noam_scheduler.ckpt",
             "counter": work / "counter.ckpt"}
    layouts = {"asr": sb_layout.asr_layout(), "lm": sb_layout.lm_layout(), "fcae": sb_layout.fcae_layout(True)}
    sds = {name: sb_layout.write_seeded(str(paths[name]), layout, REF_SEEDS[name])
           for name, layout in layouts.items()}
    torch.save({"count": 8, "glob_mean": stats[0].cpu(), "glob_std": stats[1].cpu(), "spk_dict_mean": {},
                "spk_dict_std": {}, "spk_dict_count": {}}, paths["normalizer"])
    torch.save(REF_NOAM, paths["noam"])
    paths["counter"].write_text(f"{REF_COUNTER}\n")
    return paths, sds


def _reference_load(name: str, path: Path, sd: dict, to_tree, loader) -> tuple[torch.nn.Module, dict]:
    """``loader`` on the card, timed; every key of the file read by the
    port's mapping (``to_tree`` on a ``KeyLog``) and the model's parameter
    count equal to the file's. Raises otherwise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = loader(str(path), device=DEVICE)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log = KeyLog(load_state_dict_ckpt(str(path)))
    to_tree(log)
    unread = sorted(set(log) - log.read)
    n_file = sum(v.numel() for v in sd.values())
    n_model = sum(p.numel() for p in model.parameters())
    on_card = all(p.device.type == torch.device(DEVICE).type for p in model.parameters())
    if unread or n_file != n_model or not on_card:
        raise AssertionError(f"{name}: keys not read {unread[:6]}, {n_file} file vs {n_model} model "
                             f"parameters, on the card {on_card}")
    return model, {"load_s": load_s, "keys": len(log), "parameters": n_model,
                   "file_mb": path.stat().st_size / 1e6}


def _reference_states(paths: dict, stats: torch.Tensor) -> tuple[NormalizerState, dict]:
    """normalizer.ckpt (on the card), noam_scheduler.ckpt and counter.ckpt
    through the port's readers, each equal to what was written."""
    state = load_normalizer_ckpt(str(paths["normalizer"]), device=DEVICE)
    sched = NoamScheduler()
    load_noam_ckpt(str(paths["noam"]), sched)
    counter = load_counter_ckpt(str(paths["counter"]))
    ok = (float(state.count) == 8.0 and state.glob_mean.device.type == torch.device(DEVICE).type
          and torch.equal(state.glob_mean, stats[0]) and torch.equal(state.glob_std, stats[1])
          and sched.n_steps == REF_NOAM["n_steps"] and sched.losses == REF_NOAM["losses"]
          and sched.current_lr == sched.lr_at(REF_NOAM["n_steps"]) and counter == REF_COUNTER)
    if not ok:
        raise AssertionError(f"reference states: count {state.count}, noam {sched.n_steps} {sched.losses}, "
                             f"counter {counter}")
    return state, {"normalizer_count": float(state.count), "noam_n_steps": sched.n_steps,
                   "noam_lr": sched.current_lr, "counter": counter}


@torch.no_grad()
def _reference_model_checks(asr: ASRModel, feats: torch.Tensor) -> dict:
    """The loaded sb_compat ASR on the card: the encoder and a teacher-forced
    decoder pass against the same weights on the CPU (PARITY_ATOL), and
    ``decode_step_cached`` (physical cache: K3) against ``decode_one_step``
    for REF_CACHED_STEPS steps (REF_CACHED_ATOL)."""
    b, frames, u = REF_PARITY
    rng = np.random.default_rng(SEED + 15)
    toks = torch.from_numpy(rng.integers(3, 5000, (b, u)))
    toks[:, 0] = 1
    lens = torch.tensor([1.0, 0.8])
    x = feats[:b, :frames].contiguous()
    got = asr(x, toks.to(DEVICE), lens.to(DEVICE))
    want = copy.deepcopy(asr).cpu()(x.cpu(), toks, lens)
    gaps = {name: float((g.cpu() - w).abs().max()) for name, g, w in zip(("enc", "dec", "p_ctc", "p_seq"),
                                                                        got, want)}
    enc = got[0]
    cross = asr.cross_kv(enc)
    cache = make_kv_cache(b, u, asr.num_decoder_layers, asr.nhead, asr.d_model // asr.nhead, device=DEVICE)
    tk, ln = toks.to(DEVICE), lens.to(DEVICE)
    cached_gaps = []
    for step in range(REF_CACHED_STEPS):
        full = asr.decode_one_step(tk, enc, ln, step)
        cached, cache = asr.decode_step_cached(tk[:, step], enc, cache, step, ln, cross)
        cached_gaps.append(float((cached - full).abs().max()))
    report = {"card_vs_cpu_max_abs": gaps, "atol": PARITY_ATOL, "cached_vs_full_max_abs": cached_gaps,
              "cached_atol": REF_CACHED_ATOL, "shape": [b, frames, u]}
    if not (max(gaps.values()) <= PARITY_ATOL and max(cached_gaps) <= REF_CACHED_ATOL):
        raise AssertionError(f"the loaded sb_compat ASR on the card: {report}")
    return report


@torch.no_grad()
def _reference_k7(lm: TransformerLM, mega: tuple, captured) -> dict:
    """K7's exact-GELU build on the decode's own step inputs against its twin
    (``_k7_check``), then timed beside its twin, the tanh build and the
    per-layer path (cuBLAS f32 GEMMs + K6 x 12) on the same cache."""
    x0, mask, cache, step = captured
    wall, vecs = mega
    check = _k7_check(lm, wall, vecs, x0, mask, cache, step, True)

    def run(kernel, exact):
        return _k7_call(kernel, x0, mask, cache, step, wall, vecs, lm.nhead, exact)

    ms = cuda_ms(lambda: run(lm_megastep, True), iters=10)
    tanh_ms = cuda_ms(lambda: run(lm_megastep, False), iters=10)
    plain_ms = cuda_ms(lambda: run(lm_megastep_plain, True), iters=3, warmup=1)
    per_layer_ms = cuda_ms(lambda: lm.step_layers(x0, cache, mask, step), iters=10)
    flops, tc_flops, nbytes = _k7_work(lm, wall, vecs, x0, mask, cache, step)
    op_ms, bytes_ms = ops_ms(flops, tc_flops), 1e3 * nbytes / PEAK_BYTES_PER_S
    return {"check": check, "step": step, "cache": list(cache["kv"].shape),
            "distinct_parents": int(torch.unique(cache["act_src"]).numel()), "ms": ms, "tanh_ms": tanh_ms,
            "exact_over_tanh": ms / tanh_ms, "plain_ms": plain_ms, "per_layer_ms": per_layer_ms,
            "bound_ms": max(op_ms, bytes_ms), "bound_by": "operations" if op_ms >= bytes_ms else "bytes",
            "max_abs_err": check["max_abs_err"]}


@torch.no_grad()
def _reference_k6(captured) -> dict:
    """K6 on the decode's own step inputs (the ASR's first decoder layer)
    against its twin: out within ATTN_RTOL/ATTN_ATOL, every written page and
    slot equal; timed beside the twin."""
    q, kh, vh, mask, cache, step, nhead = captured
    twin = {k: v.clone() for k, v in cache.items()}
    got = attention_step_paged_chunked(q, kh, vh, mask, cache, step, 0, nhead)
    want = attention_step_paged_fused_plain(q, kh, vh, mask, twin, step, 0, nhead)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=ATTN_RTOL, atol=ATTN_ATOL)) and _equal_buffers(cache, twin)
    report = {"step": step, "cache": list(cache["kv"].shape), "max_abs_err": err, "ok": ok,
              "rtol": ATTN_RTOL, "atol": ATTN_ATOL}
    if not ok:
        raise AssertionError(f"attention_step_paged_chunked disagrees with its twin on the decode's inputs: {report}")
    report["ms"] = cuda_ms(lambda: attention_step_paged_chunked(q, kh, vh, mask, cache, step, 0, nhead))
    report["plain_ms"] = cuda_ms(lambda: attention_step_paged_fused_plain(q, kh, vh, mask, twin, step, 0, nhead))
    return report


def _reference_decode(asr: ASRModel, lm: TransformerLM, fbank: Fbank, wavs: torch.Tensor,
                      norm_state: NormalizerState, counters: dict) -> tuple[dict, dict, tuple, tuple]:
    """The published pair's test decode on the card: D2's waveforms -> K1 ->
    the loaded normalizer -> the sb_compat ASR, beam 66, CTC 0.4, the
    sb_compat LM fused at 0.6, the default paged layout (K6 x 6 and one K7
    exact-GELU launch a step). Counts reset right before and read right
    after (capturing K7's and K6's inputs at REF_CAPTURE_STEP); then two
    decodes timed. -> (report, launches, K7 capture, K6 capture)."""
    batch, n_samples, max_steps = DECODE_SHAPES[REF_SHAPE]
    steps = _decode_steps(REF_SHAPE)
    lens = torch.ones(batch, device=DEVICE)
    bundle = ASRBundle(asr, StubTokenizer(), {**DECODE_HPARAMS, "lm_weight": 0.6,
                                              "max_decode_steps": max_steps}, lm=lm)
    rows = batch * bundle.beam_size
    if bundle.lm_mega is None or not bundle.pages(rows, steps + 1, DEVICE):
        raise AssertionError("the reference decode must take the paged layout with K7")
    k7 = Capture(lm, "step_layers", lambda x, cache, mask, step, mega: step == REF_CAPTURE_STEP,
                 lambda x, cache, mask, step, mega: (x.clone(), mask.clone(),
                                                     {k: v.clone() for k, v in cache.items()}, step))
    k6 = Capture(transformer, "cached_attention_step_paged",
                 lambda q, kh, vh, mask, cache, step, layer, nhead: (
                     step == REF_CAPTURE_STEP and layer == 0 and nhead == asr.nhead),
                 lambda q, kh, vh, mask, cache, step, layer, nhead: (
                     q.clone(), kh.clone(), vh.clone(), mask.clone(),
                     {k: (v[:1] if k in ("kv", "kv_act") else v).clone() for k, v in cache.items()},
                     step, nhead))
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    lm_megastep.exact_launches = 0
    t0 = time.perf_counter()
    with k7, k6:
        feats, _ = InputNormalizer(dim=80)(norm_state, fbank(wavs), lens, training=False)
        toks, lengths, scores = bundle._decode_test(feats, lens)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    exact = lm_megastep.exact_launches
    expected = {"fused_fbank": 1, **_expected_launches(REF_SHAPE, "paged", True, True, "float32", steps)}
    if launches != expected or exact != steps or k7.args is None or k6.args is None:
        raise AssertionError(f"the reference decode launched {launches} (K7 exact-GELU {exact}), expected "
                             f"{expected} and {steps}")
    _finite("reference decode scores", scores, (batch,))
    if tuple(toks.shape) != (batch, steps) or not bool(((lengths >= 0) & (lengths <= steps)).all()):
        raise AssertionError(f"reference decode: tokens {tuple(toks.shape)}, lengths {lengths.tolist()}")
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()  # the models, and the captured inputs
    median_s = host_median_s(lambda: bundle._decode_test(feats, lens), iters=2, warmup=0)
    peak = torch.cuda.max_memory_allocated()
    audio_s = batch * n_samples / SAMPLE_RATE
    report = {"shape": REF_SHAPE, "batch": batch, "samples": n_samples, "beam": bundle.beam_size,
              "lm_weight": bundle.lm_weight, "steps": steps, "layout": "paged", "first_decode_s": first_s,
              "decode_median_s": median_s, "ms_per_step": 1e3 * median_s / steps, "audio_s": audio_s,
              "audio_s_per_wall_s": audio_s / median_s,
              "peak_mem_gib": peak / 2**30, "added_gib": (peak - resident) / 2**30,
              "k7_exact_gelu_launches": exact,
              "distinct_hypotheses": len({tuple(h) for h in hyps_to_lists(toks, lengths)}),
              "lengths": lengths.tolist(), "scores": scores.tolist()}
    return report, launches, k7.args, k6.args


def _reference_recon(work: Path, fcae_path: Path, counters: dict) -> tuple[dict, dict]:
    """gender_classifier's recon variant through ``main(argv)``
    (configs/gender_classifier_recon.yaml, 1 epoch, the gender phase's
    corpus) with ``trained_recon_model_dir`` the seeded reference ``save/``:
    K1 once a batch, nothing else (``_gender_run``); its frozen anonymizer's
    reconstruction of one batch equal (0.0) to ``load_reference_fcae``'s."""
    root = work / "LibriSpeech"
    build_corpus(str(root), n_train_spk=GENDER_SPEAKERS[0], n_test_spk=GENDER_SPEAKERS[1],
                 utts=GENDER_UTTS, words_per_utt=GENDER_WORDS, seed=SEED + 5)
    make_loaders, brain_cls = gender.make_loaders, gender.GenderBrain
    loaders: list = []

    def timed_loaders(*args):
        train, valid, test = make_loaders(*args)
        loaders.append((TimedLoader(train), TimedLoader(test)))
        return loaders[-1][0], valid, loaders[-1][1]

    gender.make_loaders, gender.GenderBrain = timed_loaders, TimedGenderBrain
    try:
        argv = _gender_argv("gender_classifier_recon.yaml", root, work / "recon", number_of_epochs=1,
                            trained_recon_model_dir=str(fcae_path.parents[1]), recon_model_type="fcae")
        brain, run = _gender_run(gender, argv, counters, loaders)
    finally:
        gender.make_loaders, gender.GenderBrain = make_loaders, brain_cls
    wavs, lens = (torch.as_tensor(x, device=DEVICE) for x in loaders[0][0].first.sig)
    with torch.no_grad():
        feats, _ = brain.normalizer(brain.state.norm_state, brain.fbank(wavs), lens, training=False)
        want = load_reference_fcae(str(fcae_path), device=DEVICE)[0].eval()(feats)[0]
        got = brain.recon_model(feats)[0]
    gap = float((got - want).abs().max())
    if not isinstance(brain.recon_model, FullyConnectedAutoencoder) or gap != 0.0:
        raise AssertionError(f"the recon run's frozen anonymizer is not the reference FC-AE: gap {gap}")
    run["recon_max_abs_gap"] = gap
    return run, run["launches"]


def phase_reference(fbank: Fbank, card: str) -> dict:
    """The reference's own checkpoints on the card, seeded in SpeechBrain's
    layout at full width: load the ASR and the LM (every key read, the
    parameter counts the files'), check the loaded ASR on the card against
    the CPU and its cached decode against ``decode_one_step``, decode D2 with
    the LM fused through K7's exact-GELU build (the path's launches counted),
    hold K7 (exact GELU) and K6 against their twins on that decode's own step
    inputs, and run gender_classifier's recon variant on the seeded FC-AE.
    Returns the launches by kernel of the decode and the recon run."""
    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="reference_"))
    counters = {c.__name__: c for c in (fused_fbank, beam_gather, attention_step, attention_step_chunked,
                                        attention_step_paged, attention_step_paged_chunked, lm_megastep)}
    try:
        batch, n_samples, _ = DECODE_SHAPES[REF_SHAPE]
        rng = np.random.default_rng(SEED + 14)
        wavs = torch.from_numpy((rng.standard_normal((batch, n_samples)) * 0.1).astype(np.float32)).to(DEVICE)
        with torch.no_grad():
            raw = fbank(wavs)
        stats = torch.stack([raw.mean((0, 1)), raw.std((0, 1))])
        t0 = time.perf_counter()
        paths, sds = _reference_files(work, stats)
        write_s = time.perf_counter() - t0
        asr, asr_load = _reference_load("asr.ckpt", paths["asr"], sds["asr"], port_sb_asr_state_dict,
                                        load_reference_asr)
        lm, lm_load = _reference_load("lm.ckpt", paths["lm"], sds["lm"], port_sb_lm_state_dict,
                                      load_reference_lm)
        del sds
        norm_state, states = _reference_states(paths, stats)
        with torch.no_grad():
            feats, _ = InputNormalizer(dim=80)(norm_state, raw, torch.ones(batch, device=DEVICE))
        model_checks = _reference_model_checks(asr, feats)
        del raw, feats
        decode, launches, k7_args, k6_args = _reference_decode(asr, lm, fbank, wavs, norm_state, counters)
        del wavs
        torch.cuda.empty_cache()
        bundle_mega = lm.prepare_megastep()
        k7 = _reference_k7(lm, bundle_mega, k7_args)
        del k7_args, bundle_mega
        torch.cuda.empty_cache()
        k6 = _reference_k6(k6_args)
        del k6_args, asr, lm
        torch.cuda.empty_cache()
        recon, recon_launches = _reference_recon(work, paths["fcae"], counters)
        total = {k: launches[k] + recon_launches[k] for k in counters}
        emit({"phase": "reference", "card": card, "files": {"write_s": write_s, "seeds": REF_SEEDS},
              "asr": asr_load, "lm": lm_load, "states": states, "model": model_checks, "decode": decode,
              "decode_launches": launches, "k7_exact_gelu": k7, "k6": k6, "recon": recon,
              "launches": total, "seconds": time.perf_counter() - t_phase})
        return total
    finally:
        shutil.rmtree(work, ignore_errors=True)


EXP_STAGES = dict(utts=3, n_train_spk=2, n_test_spk=1, gender_batch=4, gender_epochs=1, asr_epochs=1)
EXP_CONF_EPOCHS = 2
EXP_ATTACK = dict(epochs=1, batch_size=4)
EXP_CAPTURE_STEP = 1  # the first decode's early step whose K2 and K3 inputs are checked, beside its last
EXP_UTILITY_ATOL = 1e-3  # Utility_Retention, card against the CPU (PERF.md's decode rule)
EXP_SCORE_ATOL = 1e-3  # the decodes' scores, card against the CPU (tokens identical)


class FirstDecodeCapture(Capture):
    """A :class:`Capture` over the first decode that calls ``module.name``
    with arguments ``want`` accepts: ``keep``'s copies of the inputs at step
    ``first`` and at the decode's last step, in ``at["first"]`` and
    ``at["last"]``. A step below the last one seen begins another decode and
    ends the capture."""

    def __init__(self, module, name: str, want, keep, step_of, first: int):
        super().__init__(module, name, want, keep)
        self.step_of, self.first = step_of, first
        self.at: dict[str, tuple] = {}
        self.last_step, self.done = -1, False

    def __enter__(self):
        def wrapped(*args):
            if not self.done and self.want(*args):
                step = self.step_of(*args)
                if step < self.last_step:
                    self.done = True
                else:
                    self.last_step = step
                    self.at["first" if step == self.first else "last"] = self.keep(*args)
            return self.fn(*args)

        setattr(self.module, self.name, wrapped)
        return self


class _Predicted(AccuracyStats):
    """AccuracyStats that also keeps each utterance's predicted class."""

    def __init__(self):
        super().__init__()
        self.predicted: list[int] = []

    def append(self, log_probs, targets, lengths=None):
        self.predicted += np.asarray(log_probs).argmax(-1).reshape(-1).tolist()
        super().append(log_probs, targets, lengths)


class EvalRecord:
    """Wraps the anonymizer recipe's ``main`` and ``EvalMetrics`` and
    ``ASRBundle._decode_test``: ``runs`` holds, for every ``main`` in call
    order, its test stage's per-utterance results: the external classifier's
    predicted class on the clean and on the anonymized features, and each
    test decode's tokens and scores."""

    def __enter__(self):
        self.runs, self.decodes = [], []
        self.main, self.metrics, self.decode = recipe.main, recipe.EvalMetrics, ASRBundle._decode_test
        record = self

        class Metrics(record.metrics):
            def __init__(self):
                super().__init__()
                self.sex_acc_extern, self.sex_acc_extern_orig = _Predicted(), _Predicted()

        def decode(bundle, feats, lens):
            out = record.decode(bundle, feats, lens)
            record.decodes.append({"tokens": hyps_to_lists(out[0], out[1]),
                                   "scores": torch.as_tensor(out[2]).float().cpu().numpy().ravel()})
            return out

        def main(argv):
            record.decodes = []
            brain = record.main(argv)
            record.runs.append({"predicted_orig": brain.metrics.sex_acc_extern_orig.predicted,
                                "predicted_anon": brain.metrics.sex_acc_extern.predicted,
                                "decodes": record.decodes})
            return brain

        recipe.main, recipe.EvalMetrics, ASRBundle._decode_test = main, Metrics, decode
        return self

    def __exit__(self, *exc):
        recipe.main, recipe.EvalMetrics, ASRBundle._decode_test = self.main, self.metrics, self.decode


def _same_test_stage(card: dict, cpu: dict) -> dict:
    """Two runs' per-utterance test results: the predicted classes and the
    decodes' tokens equal, the scores within EXP_SCORE_ATOL."""
    tokens = [d["tokens"] for d in card["decodes"]]
    report = {"utterances": len(card["predicted_anon"]), "decodes": len(tokens),
              "decoded_tokens": sum(len(h) for hyps in tokens for h in hyps),
              "predictions_equal": all(card[k] == cpu[k] for k in ("predicted_orig", "predicted_anon")),
              "tokens_equal": tokens == [d["tokens"] for d in cpu["decodes"]],
              "max_score_gap": max((float(np.abs(a["scores"] - b["scores"]).max())
                                    for a, b in zip(card["decodes"], cpu["decodes"])), default=float("nan")),
              "score_atol": EXP_SCORE_ATOL}
    if not (report["utterances"] and report["decoded_tokens"] and report["predictions_equal"]
            and report["tokens_equal"] and report["max_score_gap"] <= EXP_SCORE_ATOL):
        raise AssertionError(f"experiments: the CPU's per-utterance test results differ from the card's: {report}")
    return report


def _exp_rows(work: Path, name: str) -> list[dict]:
    return [json.loads(line) for line in (work / name).read_text().splitlines()]


def _exp_checks(work: Path, archive: Path) -> dict:
    """The pipeline's rows, the warm run's resume and the rendered table."""
    rows, attacks = _exp_rows(work, "sweep_results.jsonl"), _exp_rows(work, "attack_results.jsonl")
    got = [(r["variant"], r["epochs"], r["warm_epochs"]) for r in rows]
    if got != [("conf", EXP_CONF_EPOCHS, 0), ("conf_frontier", EXP_CONF_EPOCHS, 0), ("e2e_warm", 1, 1)]:
        raise AssertionError(f"experiments: sweep rows {got}")
    for r in rows + attacks:
        bad = [k for k, v in r.items() if isinstance(v, float) and not np.isfinite(v)]
        if bad or r["device"] != DEVICE:
            raise AssertionError(f"experiments: row {r['variant']} not finite in {bad} or not on {DEVICE}")
    if "selected_epoch" not in rows[1] or attacks[0]["variant"] != "conf_frontier":
        raise AssertionError(f"experiments: frontier row {rows[1]}, attack rows {attacks}")
    ckpts = sorted(Checkpointer(str(work / "anon_e2e_warm_s0" / "save" / "ckpts")).list_checkpoints(),
                   key=lambda c: c.meta["epoch"])
    steps = [json.loads((Path(c.path) / "noam_scheduler.ckpt").read_text())["n_steps"] for c in ckpts]
    if [c.meta["epoch"] for c in ckpts] != [1, 2] or not steps[1] == 2 * steps[0] > 0:
        raise AssertionError(f"experiments: e2e_warm's checkpoints {[c.meta for c in ckpts]}, Noam steps {steps}")
    doc = (archive / "EXPERIMENTS.md").read_text()
    if f"| Ran on (card, power limit; device) | — | {rows[0]['card'] or 'no card'} ({DEVICE}) |" not in doc:
        raise AssertionError("experiments: the rendered table does not name the card")
    return {"rows": rows, "attack_rows": attacks, "e2e_warm_noam_steps": steps}


def _exp_eval_only_cpu(work: Path, row: dict, card_run: dict) -> dict:
    """``conf``'s checkpoints evaluated again, ``--eval_only`` on the CPU,
    against the card's row and its test stage (``card_run``, an
    :class:`EvalRecord` run): the accuracies and WERs equal, the utility
    within EXP_UTILITY_ATOL, and utterance by utterance the predicted classes
    and the decodes' tokens equal, the scores within EXP_SCORE_ATOL."""
    t0 = time.perf_counter()
    with EvalRecord() as record:
        cpu = repro.run_stage2(str(work), "anon_conf_s0", round4_sweep.VARIANTS["conf"]["schedule"],
                               epochs=EXP_CONF_EPOCHS, eval_only=True, device="cpu")
    wall = time.perf_counter() - t0
    equal = {k: cpu[k] == row[k] for k in ("acc_ext_anon", "acc_ext_orig", "wer_anon", "wer_orig")}
    gap = abs(cpu["utility"] - row["utility"])
    if not all(equal.values()) or not gap <= EXP_UTILITY_ATOL:
        raise AssertionError(f"experiments: the CPU's eval-only {cpu} against the card's row {row}")
    return {"cpu": cpu, "equal": equal, "utility_gap": gap, "utility_atol": EXP_UTILITY_ATOL,
            "per_utterance": _same_test_stage(card_run, record.runs[0]), "wall_s": wall}


def _exp_failure_exit(work: Path, archive: Path) -> dict:
    """round4_sweep.main with a variant whose run raises: a non-zero exit
    after the loop, and no row recorded for it."""
    def fault(*args, **kwargs):
        raise RuntimeError("injected fault")

    saved = repro.run_stage2
    repro.run_stage2 = fault
    try:
        round4_sweep.main(["baseline", "--device", DEVICE], work=str(work), archive_dir=str(archive),
                          stages=EXP_STAGES)
    except SystemExit as e:
        code = e.code
    else:
        code = 0
    finally:
        repro.run_stage2 = saved
    if code in (0, None) or any(r["variant"] == "baseline" for r in _exp_rows(work, "sweep_results.jsonl")):
        raise AssertionError(f"experiments: a failing variant ended the sweep with {code!r}")
    return {"exit": str(code).splitlines()[0]}


def phase_experiments(card: str) -> dict:
    """The research pipeline through its entry points on the card (the
    docstring at the top: ``experiments``). Returns its launches by kernel."""
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="experiments_"))
    work, archive = tmp / "work", tmp / "archive"
    kw = dict(work=str(work), archive_dir=str(archive))
    dev = ["--device", DEVICE]
    counters = {c.__name__: c for c in (fused_fbank, beam_gather, attention_step, attention_step_chunked,
                                        attention_step_paged, attention_step_paged_chunked, lm_megastep)}
    k1_cap = Capture(fbank_ops, "fused_fbank", lambda *a: True,
                     lambda frames, dft, mel, frag: (frames.clone(), dft, mel, frag))
    attn_cap = FirstDecodeCapture(transformer, "cached_attention_step", lambda *a: a[7] == 0, _keep_attention,
                                  lambda *a: a[6], EXP_CAPTURE_STEP)
    gather_cap = FirstDecodeCapture(transformer, "beam_gather", lambda *a: True, _keep_gather,
                                    lambda *a: a[2], EXP_CAPTURE_STEP)
    try:
        steps = {}
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        with k1_cap, attn_cap, gather_cap, EvalRecord() as record:
            for name, fn in (
                    ("conf", lambda: round4_sweep.main(["conf", *dev], stages=EXP_STAGES, epochs=EXP_CONF_EPOCHS,
                                                       **kw)),
                    ("reeval_frontier", lambda: reeval_frontier.main(["conf", *dev], **kw)),
                    ("e2e_warm", lambda: round4_sweep.main(["e2e_warm", *dev], stages=EXP_STAGES, epochs=1,
                                                           warm_epochs=1, **kw)),
                    ("attack", lambda: attack_retrain.main(["conf", "0", "frontier", *dev], **EXP_ATTACK, **kw)),
                    ("write_experiments", lambda: write_experiments.main([], **kw))):
                t0 = time.perf_counter()
                if fn() != 0:
                    raise AssertionError(f"experiments: {name} did not return 0")
                torch.cuda.synchronize()
                steps[name] = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        attn = "attention_step_chunked" if launches["attention_step_chunked"] else "attention_step"
        off = [k for k in ("attention_step_paged", "attention_step_paged_chunked", "lm_megastep") if launches[k]]
        if off or not (launches["fused_fbank"] and launches["beam_gather"] and launches["attention_step"]):
            raise AssertionError(f"experiments: the pipeline launched {launches}")
        if k1_cap.args is None or len(attn_cap.at) != 2 or len(gather_cap.at) != 2:
            raise AssertionError("experiments: the pipeline's kernel inputs were not captured")
        stage_walls = {stage: json.loads((work / stage / "repro_stats.json").read_text())["wall_s"]
                       for stage in ("gender", "asr")}
        checks = _exp_checks(work, archive)
        checks["failure_exit"] = _exp_failure_exit(work, archive)
        checks["eval_only_cpu"] = _exp_eval_only_cpu(work, checks["rows"][0], record.runs[0])
        frames, dft, mel, frag = k1_cap.args
        got, want = fused_fbank(frames, dft, mel, frag), mel_power_plain(frames, dft, mel)
        k1_err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=K1_RTOL, atol=K1_ATOL):
            raise AssertionError(f"experiments: K1 disagrees with its plain twin: max abs {k1_err}")
        checks["k1_check"] = {"rows": frames.numel() // frames.shape[-1], "max_abs_err": k1_err,
                              "rtol": K1_RTOL, "atol": K1_ATOL}
        checks["attention_checks"] = [_check_captured_attention(attn_cap.at[k]) for k in ("first", "last")]
        k2_checks: list = []
        k2_err = max(_check_k2(a, src, (step,), "experiments decode", k2_checks)
                     for a, src, step in (gather_cap.at[k] for k in ("first", "last")))
        checks["k2_check"] = {"cache": list(gather_cap.at["last"][0].shape), "max_abs_err": k2_err,
                              "checks": k2_checks}
        emit({"phase": "experiments", "card": card, "stages": EXP_STAGES, "step_walls_s": steps,
              "stage_walls_s": stage_walls, "attention_kernel": attn, **checks, "launches": launches,
              "seconds": time.perf_counter() - t_phase})
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    card = cuda_build.card_name()

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
    k8_entry = phase_k8()
    launches = phase_slice(wavs, lens, labels, fbank, normalizer, models, card)
    k8_entry["launches"] = launches["norm_silu"]
    k8_entry["launches_by_path"] = {"slice": launches["norm_silu"]}
    asr = seeded_init_(ASRModel(device=DEVICE), SEED + 3)
    train_launches = phase_train(asr, card)
    phase_train_parity()
    dist_launches = phase_distributed(asr, card)
    k1["launches"] = launches["fused_fbank"] + train_launches["fused_fbank"] + dist_launches["fused_fbank"]
    k1["launches_by_path"] = {"slice": launches["fused_fbank"], "train": train_launches["fused_fbank"],
                              "distributed": dist_launches["fused_fbank"]}
    phase_parity(wavs, lens, labels, fbank, normalizer, models)
    del wavs

    decode_launches, parity_feats = phase_decode(asr, lm, models[0], fbank, normalizer, card)
    phase_decode_parity(asr, lm, parity_feats)
    recipe_launches = phase_recipe(asr, lm, models[1], models[2], card)
    main_launches = phase_main(asr, lm, models[1], models[2], card)
    gender_launches = phase_gender(card)
    asr_launches = phase_asr_lm(card)
    ref_launches = phase_reference(fbank, card)
    exp_launches = phase_experiments(card)
    k1["launches"] += (recipe_launches["fused_fbank"] + main_launches["fused_fbank"]
                       + gender_launches["fused_fbank"])
    k1["launches_by_path"]["recipe"] = recipe_launches["fused_fbank"]
    k1["launches_by_path"]["main"] = main_launches["fused_fbank"]
    k1["launches_by_path"]["gender"] = gender_launches["fused_fbank"]
    k1["launches_by_path"]["asr_train"] = asr_launches["fused_fbank"]
    k1["launches"] += asr_launches["fused_fbank"]
    for entry in decode_kernels:
        entry["launches"] = decode_launches[entry["name"]]
        if entry["name"] in ("beam_gather", "attention_step"):  # the recipe's test decodes: f32, physical
            entry["launches_by_path"] = {"decode": entry["launches"],
                                         "recipe": recipe_launches[entry["name"]],
                                         "main": main_launches[entry["name"]]}
            entry["launches"] += recipe_launches[entry["name"]] + main_launches[entry["name"]]
        if entry["name"] in ("beam_gather", "attention_step", "attention_step_chunked"):  # the ASR recipe's
            entry.setdefault("launches_by_path", {"decode": entry["launches"]})["asr_train"] = \
                asr_launches[entry["name"]]
            entry["launches"] += asr_launches[entry["name"]]
    for entry in (k1, *decode_kernels):  # the reference checkpoints' decode and recon run; the pipeline
        for path, counts in (("reference", ref_launches), ("experiments", exp_launches)):
            if counts.get(entry["name"]):
                entry.setdefault("launches_by_path", {"decode": entry["launches"]})[path] = counts[entry["name"]]
                entry["launches"] += counts[entry["name"]]

    emit({"phase": "wall", "seconds": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"kernels": [k1, *decode_kernels, k8_entry]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
