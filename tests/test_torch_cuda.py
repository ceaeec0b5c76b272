"""The port on an NVIDIA card: K1 to K8 against their plain twins (K5 in its
four configurations with identity, single-owner and mixed tables; every
kernel on int8 caches too: K2, K3 and K5 whole-row, K4, K6 and K7 above the
whole-row bound; K8 on rows held by one block, split over clusters, and past
one cluster), the anonymization path on the card against the CPU (K8 seven
times a call, eight past one cluster, never in a training step), the
anonymization and decode slices (physical and
paged caches, f32, bf16 and int8, with and without the LM) on the card
against the CPU, the anonymizer's training step (one convae
accumulation cycle on the card against the CPU; K1 once a micro-batch), the
gender recipe's (one GenderBrain step, plain and augmented), the ASR and
LM recipes' (one ASRBrain step, ``ctc_loss`` on feasible and infeasible rows,
one LMBrain step at dropout 0.1 on given masks), and the reference's own
checkpoints (the ``sb_compat`` ASR on the card against the CPU, its decode
with the ``sb_compat`` LM through K7's exact-GELU build, the loaders on
seeded SpeechBrain-layout files).
Imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Every test skips without a CUDA device (decided at run time, in the fixture).
"""

import copy
import json

import numpy as np
import pytest
import torch

from speech_anonymization_tpu_torch.models import ASRModel, ConvAutoencoder, TransformerLM
from speech_anonymization_tpu_torch.ops.attention_step import (
    attend_int8_tiled,
    attention_step,
    attention_step_chunked,
    attention_step_plain,
    cached_attention_step,
    quantize_rows,
)
from speech_anonymization_tpu_torch.models.transformer import beam_reorder_cache, make_kv_cache
from speech_anonymization_tpu_torch.ops.attention_step_paged import (
    attention_step_paged,
    attention_step_paged_chunked,
    attention_step_paged_fused_plain,
    attention_step_paged_plain,
    page_views,
)
from speech_anonymization_tpu_torch.ops.beam_gather import (
    beam_gather,
    beam_gather_faults,
    beam_gather_plain,
)
from speech_anonymization_tpu_torch.ops.fbank import Fbank, frame_signal
from speech_anonymization_tpu_torch.ops import norm_silu as k8
from speech_anonymization_tpu_torch.ops.lm_megastep import lm_megastep, lm_megastep_plain
from speech_anonymization_tpu_torch.ops.fbank_kernel import fused_fbank, mel_power_plain
from speech_anonymization_tpu_torch.ops.normalization import InputNormalizer, NormalizerState
from speech_anonymization_tpu_torch.recipes import anonymizer as recipe
from speech_anonymization_tpu_torch.recipes.asr_bundle import ASRBundle
from speech_anonymization_tpu_torch.recipes.gender_classifier import GenderBrain
from speech_anonymization_tpu_torch.tools.train_parity import (MOMENT_RTOL, compare_cycle, compare_gender_step,
                                                              convae_hparams, gender_hparams, noise_floor,
                                                              step_gaps, tensor_gaps, train_batch)
from speech_anonymization_tpu_torch.tools import sb_layout
from speech_anonymization_tpu_torch.train.schedulers import NoamScheduler
from speech_anonymization_tpu_torch.utils.reference_ckpts import load_reference_asr, load_reference_lm
from speech_anonymization_tpu_torch.utils.seeded_init import seeded_init_

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _wavs(batch: int, n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((batch, n)) * 0.1).astype(np.float32))


@pytest.mark.parametrize("batch,n", [(1, 0), (1, 10079), (1, 10080), (1, 10240), (3, 32077),
                                     (1, 20160), (1, 20320), (1, 20480), (32, 161120), (32, 52800)])
def test_k1_matches_plain_twin(cuda, batch, n):
    """Row counts 1, 63, 64, 65, 603, 127, 128, 129, bench.py's 32,256 and
    the gender recipe's batch of 32 x 3.3 s (10,592): partial, whole and
    ragged 128-row blocks."""
    fb = Fbank(device=cuda)
    frames = frame_signal(_wavs(batch, n, seed=n).to(cuda)).contiguous()
    before = fused_fbank.launches
    got = fused_fbank(frames, fb.dft, fb.mel, fb.dft_frag)
    torch.cuda.synchronize()
    assert fused_fbank.launches == before + 1
    torch.testing.assert_close(got, mel_power_plain(frames, fb.dft, fb.mel), rtol=1e-4, atol=1e-4)


def test_k1_rejects_bad_operands(cuda):
    fb = Fbank(device=cuda)
    frames = torch.zeros(4, 400, device=cuda)
    frag = fb.dft_frag
    with pytest.raises(TypeError):
        fused_fbank(frames.double(), fb.dft, fb.mel, frag)
    with pytest.raises(ValueError):
        fused_fbank(torch.zeros(400, 4, device=cuda).t(), fb.dft, fb.mel, frag)
    with pytest.raises(ValueError):
        fused_fbank(frames[:, :384].contiguous(), fb.dft, fb.mel, frag)
    with pytest.raises(ValueError):
        fused_fbank(frames, fb.dft.cpu(), fb.mel, frag)
    with pytest.raises(ValueError):  # the fragments of another window
        fused_fbank(frames, fb.dft, fb.mel, frag[:-1].contiguous())
    with pytest.raises(ValueError):  # more than 80 mels
        fused_fbank(frames, fb.dft, torch.zeros(201, 96, device=cuda), frag)
    with pytest.raises(ValueError):  # frames off 16-byte alignment
        fused_fbank(torch.zeros(4 * 400 + 1, device=cuda)[1:].view(4, 400), fb.dft, fb.mel, frag)


def test_eval_step_on_card_matches_cpu(cuda):
    model = seeded_init_(ConvAutoencoder(device="cpu"), 0)
    wavs, lens = _wavs(2, 16000, seed=1), torch.tensor([1.0, 0.7])
    labels = torch.tensor([0, 1])
    normalizer = InputNormalizer(80)
    _, state = normalizer(normalizer.init_state("cpu"), Fbank(device="cpu")(wavs), lens, 0, training=True)

    def run(device, m):
        st = NormalizerState(*(x.to(device) for x in state))
        return recipe.eval_step(m, Fbank(device=device), normalizer, st, wavs.to(device),
                                lens.to(device), labels.to(device))

    fused_fbank.launches = 0
    on_card = run(cuda, copy.deepcopy(model).to(cuda))
    assert fused_fbank.launches == 1
    on_cpu = run("cpu", model)
    for got, want in zip(on_card, on_cpu):
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-3)


# K8 against its plain twin in float64 on the card: rtol 1e-5, and atol 1e-5
# for outputs near 0, where the SiLU's relative error follows the absolute
# error of its argument (fp32 mean and variance, __expf)
K8_RTOL = K8_ATOL = 1e-5


def _k8_operands(b, c, length, seed, device, norm=True):
    """Rows of one standard normal each scaled and shifted by its own amount
    (shifts to +-3, so the mean matters), a bias, and the norm's weight and shift."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, c, length)) * rng.uniform(0.2, 3.0, (b, c, 1)) + rng.uniform(-3, 3, (b, c, 1))
    vecs = [rng.standard_normal(c) * 0.5, 1.0 + 0.1 * rng.standard_normal(c), 0.1 * rng.standard_normal(c)]
    x, bias, weight, beta = (torch.from_numpy(np.asarray(a, np.float32)).to(device) for a in (x, *vecs))
    return (x, bias, weight, beta) if norm else (x, bias)


@pytest.mark.parametrize("norm", [True, False], ids=["norm", "bias_only"])
@pytest.mark.parametrize("length", [20160, 40320, 80640, 20161, 3, k8.CHUNK, k8.CHUNK + 1, 8 * k8.CHUNK + 4,
                                    k8.MAX_LENGTH, k8.MAX_LENGTH + 1, 2 * k8.MAX_LENGTH + 4])
def test_k8_matches_plain_twin(cuda, length, norm):
    """The anonymizer's rows (20,160 and 40,320 floats: one and two blocks;
    80,640: a cluster of three), odd rows (off 16-byte alignment from the
    second row on), the rows either side of one block's most (``CHUNK``), one
    past eight blocks' (the share widened to eight), the longest one cluster
    holds, and past it (the norm's two streaming launches; odd, and spanning
    many tiles)."""
    ops = _k8_operands(2, 8, length, length, cuda, norm)
    before = k8.norm_silu.launches
    got = k8.norm_silu(*ops)
    torch.cuda.synchronize()
    assert k8.norm_silu.launches == before + (2 if norm and length > k8.MAX_LENGTH else 1)
    want = k8.norm_silu_plain(*(a.double() for a in ops)).float()
    torch.testing.assert_close(got, want, rtol=K8_RTOL, atol=K8_ATOL)


def test_k8_rejects_bad_operands(cuda):
    x, bias, weight, beta = _k8_operands(2, 4, 64, 0, cuda)
    with pytest.raises(TypeError):
        k8.norm_silu(x.double(), bias, weight, beta)
    with pytest.raises(ValueError):  # not contiguous
        k8.norm_silu(x.transpose(1, 2).contiguous().transpose(1, 2), bias, weight, beta)
    with pytest.raises(ValueError):  # another channel count
        k8.norm_silu(x, bias[:3].contiguous(), weight, beta)
    with pytest.raises(ValueError):  # the weight without the shift
        k8.norm_silu(x, bias, weight)
    with pytest.raises(ValueError):
        k8.norm_silu(x, bias.cpu(), weight, beta)
    with pytest.raises(ValueError):  # off 16-byte alignment
        k8.norm_silu(torch.zeros(2 * 4 * 64 + 1, device=cuda)[1:].view(2, 4, 64), bias, weight, beta)


def test_anonymize_on_card_matches_cpu(cuda):
    """``anonymize`` (K1, the normalizer, the ConvAutoencoder with K8 in its
    seven blocks) on the card against the CPU, at the eval step's atol; each
    call launches K8 seven times."""
    model = seeded_init_(ConvAutoencoder(device="cpu"), 0)
    wavs, lens = _wavs(3, 24000, seed=2), torch.ones(3)
    normalizer = InputNormalizer(80)
    _, state = normalizer(normalizer.init_state("cpu"), Fbank(device="cpu")(wavs), lens, 0, training=True)

    def run(device, m):
        st = NormalizerState(*(x.to(device) for x in state))
        return recipe.anonymize(m, Fbank(device=device), normalizer, st, wavs.to(device), lens.to(device))

    on_card = copy.deepcopy(model).to(cuda)
    for _ in range(2):
        before = k8.norm_silu.launches
        got = run(cuda, on_card)
        torch.cuda.synchronize()
        assert k8.norm_silu.launches == before + 7
    torch.testing.assert_close(got.cpu(), run("cpu", model), rtol=0, atol=1e-3)


def test_anonymize_past_one_cluster_on_card_matches_cpu(cuda):
    """One 57.3 s utterance (T = 5,735 frames): dec_in2's rows of T * 80 =
    458,800 floats exceed ``MAX_LENGTH`` and take K8's two streaming launches,
    the other blocks one launch each (8 a call); on the card against the CPU."""
    n = 5734 * 160
    assert (1 + n // 160) * 80 > k8.MAX_LENGTH >= (1 + n // 160) * 40
    model = seeded_init_(ConvAutoencoder(device="cpu"), 1)
    wavs, lens = _wavs(1, n, seed=5), torch.ones(1)
    normalizer = InputNormalizer(80)
    _, state = normalizer(normalizer.init_state("cpu"), Fbank(device="cpu")(wavs), lens, 0, training=True)

    def run(device, m):
        st = NormalizerState(*(x.to(device) for x in state))
        return recipe.anonymize(m, Fbank(device=device), normalizer, st, wavs.to(device), lens.to(device))

    before = k8.norm_silu.launches
    got = run(cuda, copy.deepcopy(model).to(cuda))
    torch.cuda.synchronize()
    assert k8.norm_silu.launches == before + 8
    torch.testing.assert_close(got.cpu(), run("cpu", model), rtol=0, atol=1e-3)


def _cache(shape, dtype, seed, device, nan_from=None):
    """Seeded (L, N, U, M) cache; positions >= ``nan_from`` hold NaN and Inf."""
    rng = np.random.default_rng(seed)
    c = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if nan_from is not None:
        c[:, :, nan_from:] = float("nan")
        c[:, :, nan_from + 1:, ::3] = float("inf")
    return c.to(dtype).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("step", [0, 5, 15, None])
def test_k2_matches_plain_twin(cuda, dtype, step):
    """N = 7 rows (no block multiple), duplicate parents; step None is K2b."""
    a = _cache((2, 7, 16, 96), dtype, seed=3, device=cuda)
    src = torch.tensor([3, 3, 0, 6, 1, 1, 2], dtype=torch.int32, device=cuda)
    out = torch.full_like(a, float("nan"))
    before = beam_gather.launches
    got = beam_gather(a, src, step, out)
    torch.cuda.synchronize()
    assert got is out and beam_gather.launches == before + 1
    want = beam_gather_plain(a.cpu(), src.cpu(), step, torch.full_like(a.cpu(), float("nan")))
    p = 16 if step is None else step + 1
    assert torch.equal(got[:, :, :p].cpu(), want[:, :, :p])
    assert torch.equal(got[:, :, :p].cpu(), a[:, src.long(), :p].cpu())
    assert got[:, :, p:].isnan().all()  # later positions untouched


@pytest.mark.parametrize("step", [0, 31, None])
def test_k2_int8_matches_plain_twin(cuda, step):
    """int8 codes (every value -128..127) at D1's row width, M 768 bytes:
    the byte copy equals the twin exactly; positions after the step untouched."""
    g = torch.Generator(device=cuda).manual_seed(5)
    a = torch.randint(-128, 128, (2, 7, 72, 768), generator=g, device=cuda, dtype=torch.int8)
    src = torch.tensor([3, 3, 0, 6, 1, 1, 2], dtype=torch.int32, device=cuda)
    out = torch.full_like(a, 99)
    before = beam_gather.launches
    beam_gather(a, src, step, out)
    torch.cuda.synchronize()
    assert beam_gather.launches == before + 1
    want = beam_gather_plain(a.cpu(), src.cpu(), step, torch.full_like(a.cpu(), 99))
    assert torch.equal(out.cpu(), want)


def test_k2_rejects_bad_operands(cuda):
    a = torch.zeros(2, 8, 16, 96, device=cuda)
    src = torch.arange(8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        beam_gather(a.to(torch.int16), src, 3, torch.empty_like(a, dtype=torch.int16))
    with pytest.raises(TypeError):
        beam_gather(a.double(), src, 3, torch.empty_like(a, dtype=torch.float64))
    with pytest.raises(ValueError):
        beam_gather(a, src.long(), 3, torch.empty_like(a))
    with pytest.raises(ValueError):
        beam_gather(a, src, 3, a)  # output aliases the input
    with pytest.raises(ValueError):
        beam_gather(a, src.cpu(), 3, torch.empty_like(a))
    with pytest.raises(ValueError):
        beam_gather(a.transpose(2, 3).contiguous().transpose(2, 3), src, 3, torch.empty_like(a))
    with pytest.raises(ValueError):
        beam_gather(a, src, 16, torch.empty_like(a))


@pytest.mark.parametrize("bad", [-1, 7])
def test_k2_counts_out_of_range_parents(cuda, bad):
    """The twin raises; the kernel leaves the row unwritten and counts it per layer."""
    a = _cache((2, 7, 16, 96), torch.float32, seed=4, device=cuda)
    src = torch.tensor([3, bad, 0, 6, 1, 1, 2], dtype=torch.int32, device=cuda)
    with pytest.raises((IndexError, RuntimeError)):
        beam_gather_plain(a.cpu(), src.cpu(), 5, torch.empty_like(a.cpu()))
    beam_gather_faults(cuda)
    out = torch.full_like(a, float("nan"))
    beam_gather(a, src, 5, out)
    assert beam_gather_faults(cuda) == 2
    assert out[:, 1].isnan().all()
    good = torch.tensor([0, 2, 4, 6, 1, 3, 5], dtype=torch.int32, device=cuda)
    assert torch.equal(beam_gather(a, good, 5, out)[:, :, :6], a[:, good.long(), :6])
    assert beam_gather_faults(cuda) == 0


def _attention_inputs(n, u, m, dtype, step, seed, device, masked_fresh=False):
    rng = np.random.default_rng(seed)
    q, kh, vh = (torch.from_numpy(rng.standard_normal((n, m)).astype(np.float32)).to(device)
                 for _ in range(3))
    mask = torch.from_numpy(rng.random((n, u)) > 0.2).to(device)
    mask[:, 0] = True
    mask[:, step] = not masked_fresh
    ck = _cache((2, n, u, m), dtype, seed + 1, device, nan_from=step)
    cv = _cache((2, n, u, m), dtype, seed + 2, device, nan_from=step)
    return q, kh, vh, mask, ck, cv


@pytest.mark.parametrize("dtype,u", [(torch.float32, 208), (torch.float32, 213),
                                     (torch.float32, 256), (torch.bfloat16, 424),
                                     (torch.bfloat16, 426), (torch.bfloat16, 448)])
@pytest.mark.parametrize("kernel", [attention_step, attention_step_chunked])
@pytest.mark.parametrize("step_at,masked_fresh", [(0, False), (63, False), (-1, False), (64, True)])
@pytest.mark.parametrize("n", [5, 198])
def test_k3_k4_match_plain_twin(cuda, dtype, u, kernel, step_at, masked_fresh, n):
    """Both kernels at U just below, at and above the K3/K4 boundary (213 for
    f32, 426 for bf16 at M = 768; at U - 1 K3's ring holds its last chunk
    and the most shared memory), N = 5 rows and 198 (convae.yaml's 3
    utterances x beam 66), NaN/Inf beyond the step, masked keys."""
    m, nhead = 768, 8
    step = step_at % u
    q, kh, vh, mask, ck, cv = _attention_inputs(n, u, m, dtype, step, seed=u + step, device=cuda,
                                                masked_fresh=masked_fresh)
    ck_cpu, cv_cpu = ck.cpu(), cv.cpu()
    before = kernel.launches
    got = kernel(q, kh, vh, mask, ck, cv, step, 1, nhead)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = attention_step_plain(q.cpu(), kh.cpu(), vh.cpu(), mask.cpu(), ck_cpu, cv_cpu, step, 1,
                                nhead)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    # the fresh k/v landed at (layer 1, :, step); nothing else moved
    torch.testing.assert_close(ck.cpu(), ck_cpu, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(cv.cpu(), cv_cpu, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("dtype,u,chunked", [(torch.float32, 208, False), (torch.float32, 216, True),
                                             (torch.bfloat16, 424, False),
                                             (torch.bfloat16, 432, True)])
def test_dispatch_follows_the_jax_rule(cuda, dtype, u, chunked):
    q, kh, vh, mask, ck, cv = _attention_inputs(8, u, 768, dtype, 3, seed=7, device=cuda)
    counts = (attention_step.launches, attention_step_chunked.launches)
    cached_attention_step(q, kh, vh, mask, ck, cv, 3, 0, 8)
    torch.cuda.synchronize()
    assert (attention_step.launches - counts[0], attention_step_chunked.launches - counts[1]) == (
        int(not chunked), int(chunked))


def _int8_attention_inputs(n, u, m, step, seed, device):
    """Seeded f32 q/kh/vh, int8 codes and (2, n, u) scales; code -128 (never
    written by the quantizer) and NaN scales from the step on and at masked
    positions, where no read may reach."""
    q, kh, vh, mask, _, _ = _attention_inputs(n, u, m, torch.float32, step, seed, device)
    g = torch.Generator(device=device).manual_seed(seed)
    codes = [torch.randint(-127, 128, (2, n, u, m), generator=g, device=device, dtype=torch.int8)
             for _ in range(2)]
    scales = [torch.rand(2, n, u, generator=g, device=device) * 0.05 + 1e-3 for _ in range(2)]
    hidden = ~mask
    hidden[:, step:] = True  # the step's own position holds stale bytes too
    for c, s in zip(codes, scales):
        c[:, hidden] = -128
        s[:, hidden] = float("nan")
    return q, kh, vh, mask, *codes, *scales


@pytest.mark.parametrize("u,step_at", [(72, 0), (72, 31), (72, 71), (256, 125), (256, 255),
                                       (424, 423), (426, 425)])
@pytest.mark.parametrize("nhead", [8, 12])
@pytest.mark.parametrize("n", [9, 198])
def test_k3_int8_matches_plain_twin(cuda, u, step_at, nhead, n):
    """K3 on int8 caches at D1's U 72, D2's U 256 and the int8 whole-row
    bound (U 424 and 426, at U - 1: the ring's last chunk and the most shared
    memory), at the ASR's 8 x 96 heads and the LM's 12 x 64, N 9 and 198:
    out within 1e-5 of the twin's, every code and scale equal."""
    m = 768
    q, kh, vh, mask, ck, cv, ks, vs = _int8_attention_inputs(n, u, m, step_at, u + step_at, cuda)
    twin = [x.clone() for x in (ck, cv, ks, vs)]
    before = attention_step.launches
    got = attention_step(q, kh, vh, mask, ck, cv, step_at, 1, nhead, ks, vs)
    want = attention_step_plain(q, kh, vh, mask, *twin[:2], step_at, 1, nhead, *twin[2:])
    torch.cuda.synchronize()
    assert attention_step.launches == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for a, b in zip((ck, cv, ks, vs), twin):
        assert _same(a, b)


def test_k3_k4_reject_bad_operands(cuda):
    q, kh, vh, mask, ck, cv = _attention_inputs(8, 16, 768, torch.float32, 3, seed=9, device=cuda)
    scales = torch.zeros(2, 8, 16, device=cuda)
    # K4 takes int8 codes with their scales, as its twin does
    i8 = [c.nan_to_num(0.0).clamp(-127, 127).to(torch.int8) for c in (ck, cv)] + [
        scales + 0.01, scales + 0.02]
    twin = [x.clone() for x in i8]
    got = attention_step_chunked(q, kh, vh, mask, *i8[:2], 3, 0, 8, *i8[2:])
    want = attention_step_plain(q, kh, vh, mask, *twin[:2], 3, 0, 8, *twin[2:])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(i8, twin))
    with pytest.raises(ValueError):  # scales of another shape
        attention_step(q, kh, vh, mask, ck.to(torch.int8), cv.to(torch.int8), 3, 0, 8,
                       scales[:, :, :8], scales[:, :, :8])
    for kernel in (attention_step, attention_step_chunked):
        with pytest.raises(TypeError):  # int8 codes without their scales
            kernel(q, kh, vh, mask, ck.to(torch.int8), cv.to(torch.int8), 3, 0, 8)
        with pytest.raises(TypeError):
            kernel(q, kh, vh, mask, ck.double(), cv.double(), 3, 0, 8)
        with pytest.raises(ValueError):
            kernel(q.double(), kh, vh, mask, ck, cv, 3, 0, 8)
        with pytest.raises(ValueError):
            kernel(q.cpu(), kh, vh, mask, ck, cv, 3, 0, 8)
        with pytest.raises(ValueError):
            kernel(q, kh, vh, mask.t().contiguous().t(), ck, cv, 3, 0, 8)
        with pytest.raises(ValueError):
            kernel(q, kh, vh, mask, ck, cv, 16, 0, 8)
        with pytest.raises(ValueError):
            kernel(q, kh, vh, mask, ck, cv, 3, 2, 8)
        with pytest.raises(ValueError):
            kernel(q, kh, vh, mask, ck, cv, 3, 0, 2)  # d_head 384: more than one warp of vectors


class _Tok:
    def decode_ids(self, ids):
        return " ".join(str(i) for i in ids)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8"])
def test_decode_on_card_matches_cpu(cuda, cache_dtype):
    """A small ASR decode (beam 4, CTC 0.4) through K2 and K3 on the card and
    through the plain paths on the CPU: the same hypotheses."""
    small = dict(d_model=64, nhead=4, num_encoder_layers=1, num_decoder_layers=2, d_ffn=128,
                 output_neurons=40)
    model = seeded_init_(ASRModel(**small, device="cpu"), 0)
    feats = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 48, 80)).astype(np.float32))
    lens = torch.tensor([1.0, 0.75, 0.9])
    hp = {"test_beam_size": 4, "ctc_weight_decode": 0.4, "temperature": 1.15,
          "decode_cache_dtype": cache_dtype}
    beam_gather.launches = attention_step.launches = 0
    on_card = ASRBundle(copy.deepcopy(model).to(cuda), _Tok(), hp)._decode_test(feats.to(cuda),
                                                                                 lens.to(cuda))
    torch.cuda.synchronize()
    assert beam_gather.launches == 2 * 12 and attention_step.launches == 2 * 12
    on_cpu = ASRBundle(model, _Tok(), hp)._decode_test(feats, lens)
    assert torch.equal(on_card[0].cpu(), on_cpu[0]) and torch.equal(on_card[1].cpu(), on_cpu[1])
    torch.testing.assert_close(on_card[2].cpu(), on_cpu[2], rtol=0, atol=1e-3)


def _nan_paged_cache(u_max, fused, dtype, device):
    """A paged cache (8 rows, 2 layers, M 768) in the f32 layout of ``u_max``,
    cast to ``dtype``, whose every k/v byte starts as NaN: a kernel that
    reads a position the step may not read poisons its output."""
    cache = make_kv_cache(8, u_max, 2, 8, 96, device=device, paged=True, fused=fused)
    cache = {k: v.to(dtype) if v.is_floating_point() else v for k, v in cache.items()}
    for key in ("k", "v", "kv", "k_act", "v_act", "kv_act"):
        if key in cache:
            cache[key].fill_(float("nan"))
    return cache


def _same(x, y):
    return bool(((x == y) | (x.isnan() & y.isnan())).all())


# name: (kernel, u_max, page, fused): K5 at page 32 (U 96); K6 at page 64 (U 256), split and fused
PAGED = {"k5_split": (attention_step_paged, 80, 32, False),
         "k6_split": (attention_step_paged_chunked, 250, 64, False),
         "k6_fused": (attention_step_paged_chunked, 250, 64, True)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(PAGED))
def test_k5_k6_protocol_match_plain_twin(cuda, name, dtype):
    """Steps 0 .. 75 with a random beam reorder after each: page completions
    at 31 and 63 (page 32) or 63 (page 64), masked keys and fresh tokens.
    Outputs within 1e-5 of the twin's; every page, slot, table and act_src
    equal after every step (NaN where never written)."""
    kernel, u_max, page, fused = PAGED[name]
    cache = _nan_paged_cache(u_max, fused, dtype, cuda)
    assert ("kv" in cache) == fused and cache["table"].shape[1] * page == cache["tokens"].shape[1]
    twin_cache = {k: v.clone() for k, v in cache.items()}
    twin = attention_step_paged_fused_plain if fused else attention_step_paged_plain
    rng = np.random.default_rng(len(name) + dtype.itemsize)
    n, u = cache["tokens"].shape
    mask = torch.from_numpy(rng.random((n, u)) > 0.2).to(cuda)
    mask[:, 0] = True
    before = kernel.launches
    steps = 76
    for step in range(steps):
        for layer in range(2):
            q, kh, vh = (torch.from_numpy(rng.standard_normal((n, 768)).astype(np.float32)).to(cuda)
                         for _ in range(3))
            got = kernel(q, kh, vh, mask, cache, step, layer, 8)
            want = twin(q, kh, vh, mask, twin_cache, step, layer, 8)
            assert torch.isfinite(got).all(), (step, layer)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        for key in cache:
            assert _same(cache[key], twin_cache[key]), (step, key)
        parent = torch.from_numpy(rng.integers(0, 4, (n // 4, 4))).to(cuda)
        cache = beam_reorder_cache(cache, parent, step)
        twin_cache = beam_reorder_cache(twin_cache, parent, step)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2 * steps


@pytest.mark.parametrize("nhead", [8, 12])
@pytest.mark.parametrize("u_max", [80, 250])
def test_k5_int8_protocol_matches_plain_twin(cuda, u_max, nhead):
    """K5 on int8 caches (page 32: U 96 as D1's, U 256 as D2's) over 76
    steps with a random beam reorder after each (pages complete at 31 and
    63), at 8 x 96 and 12 x 64, from caches whose codes are all -128 and
    scales NaN: out within 1e-5 of the twin's, finite, and every page, slot,
    scale, table and act_src equal after every step."""
    n = 8
    cache = make_kv_cache(n, u_max, 2, nhead, 768 // nhead, torch.int8, device=cuda, paged=True)
    for key in cache:
        if key in ("k", "v", "k_act", "v_act"):
            cache[key].fill_(-128)
        elif key in ("k_scale", "v_scale"):
            cache[key].fill_(float("nan"))
    twin_cache = {k: v.clone() for k, v in cache.items()}
    rng = np.random.default_rng(u_max + nhead)
    u = cache["tokens"].shape[1]
    assert u == (96 if u_max == 80 else 256) and cache["table"].shape[1] * 32 == u
    mask = torch.from_numpy(rng.random((n, u)) > 0.2).to(cuda)
    mask[:, 0] = True
    before = attention_step_paged.launches
    for step in range(76):
        for layer in range(2):
            q, kh, vh = (torch.from_numpy(rng.standard_normal((n, 768)).astype(np.float32)).to(cuda)
                         for _ in range(3))
            got = attention_step_paged(q, kh, vh, mask, cache, step, layer, nhead)
            want = attention_step_paged_plain(q, kh, vh, mask, twin_cache, step, layer, nhead)
            assert torch.isfinite(got).all(), (step, layer)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        for key in cache:
            assert _same(cache[key], twin_cache[key]), (step, key)
        parent = torch.from_numpy(rng.integers(0, 4, (n // 4, 4))).to(cuda)
        cache = beam_reorder_cache(cache, parent, step)
        twin_cache = beam_reorder_cache(twin_cache, parent, step)
    torch.cuda.synchronize()
    assert attention_step_paged.launches == before + 2 * 76


def test_paged_kernels_reject_bad_operands(cuda):
    cache = make_kv_cache(8, 80, 2, 8, 96, device=cuda, paged=True)
    q = torch.zeros(8, 768, device=cuda)
    mask = torch.ones(8, 96, dtype=torch.bool, device=cuda)
    # K6 takes an int8 cache with its scales, as its twin does
    g = torch.Generator(device=cuda).manual_seed(3)
    int8 = make_kv_cache(8, 80, 2, 8, 96, torch.int8, device=cuda, paged=True)
    for key in ("k", "v", "k_act", "v_act"):
        int8[key].random_(-127, 128, generator=g)
    for key in ("k_scale", "v_scale"):
        int8[key].uniform_(1e-3, 0.05, generator=g)
    twin = {k: v.clone() for k, v in int8.items()}
    qr = torch.randn(8, 768, generator=g, device=cuda)
    got = attention_step_paged_chunked(qr, qr, qr, mask, int8, 40, 0, 8)
    want = attention_step_paged_plain(qr, qr, qr, mask, twin, 40, 0, 8)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert all(_same(int8[k], twin[k]) for k in int8)
    for kernel in (attention_step_paged, attention_step_paged_chunked):
        with pytest.raises(TypeError):  # int8 codes without their scales
            kernel(q, q, q, mask, {k: v.to(torch.int8) if v.is_floating_point() else v
                                   for k, v in cache.items()}, 3, 0, 8)
        with pytest.raises(ValueError):  # a table without its row stride
            kernel(q, q, q, mask, {**cache, "table": cache["table"].t().contiguous().t()}, 3, 0, 8)
        with pytest.raises(ValueError):
            kernel(q, q, q, mask, {**cache, "table": cache["table"].long()}, 3, 0, 8)
        with pytest.raises(ValueError):
            kernel(q, q, q, mask, {**cache, "act_src": cache["act_src"].cpu()}, 3, 0, 8)
        with pytest.raises(ValueError):
            kernel(q, q, q, mask, {**cache, "k_act": cache["k_act"][:, :, :1]}, 3, 0, 8)
        for step in (-1, 96):
            with pytest.raises(ValueError):
                kernel(q, q, q, mask, cache, step, 0, 8)
        with pytest.raises(ValueError):
            kernel(q, q, q, mask, cache, 3, 2, 8)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("regime", ["page32", "page64_fused"])
def test_paged_decode_on_card_matches_cpu(cuda, regime, cache_dtype):
    """A small ASR decode (beam 4 over 2 utterances: N = 8) that pages on the
    card (d_model % 128 == 0) and not on the CPU: the same hypotheses, scores
    within 1e-3; and the card's physical decode equal to its paged one.
    page32: d_model 128, 44 steps (a page completes at step 31); page64_fused:
    d_model 768, 220 steps (U 256: fused K6 for f32, K5 at page 32 for bf16
    and int8)."""
    widths, frames, steps = ((dict(d_model=128, nhead=4, num_decoder_layers=2), 176, None)
                             if regime == "page32" else
                             (dict(d_model=768, nhead=8, num_decoder_layers=1), 900, 220))
    model = seeded_init_(ASRModel(**widths, num_encoder_layers=1, d_ffn=128, output_neurons=40,
                                  device="cpu"), 0)
    feats = torch.from_numpy(np.random.default_rng(2).standard_normal((2, frames, 80)).astype(np.float32))
    lens = torch.tensor([1.0, 0.85])
    hp = {"test_beam_size": 4, "ctc_weight_decode": 0.4, "temperature": 1.15,
          "decode_cache_dtype": cache_dtype, "max_decode_steps": steps}
    card_model = copy.deepcopy(model).to(cuda)
    paged = ASRBundle(card_model, _Tok(), hp)
    n_steps = steps or 44
    chunked = regime == "page64_fused" and cache_dtype == "float32"
    kernel = attention_step_paged_chunked if chunked else attention_step_paged
    assert "table" in paged.make_cache(8, n_steps + 1, cuda)
    counts = (beam_gather.launches, attention_step.launches, attention_step_chunked.launches)
    before = kernel.launches
    on_card = paged._decode_test(feats.to(cuda), lens.to(cuda))
    torch.cuda.synchronize()
    assert kernel.launches - before == widths["num_decoder_layers"] * n_steps
    assert (beam_gather.launches, attention_step.launches, attention_step_chunked.launches) == counts
    on_cpu = ASRBundle(model, _Tok(), hp)._decode_test(feats, lens)
    assert torch.equal(on_card[0].cpu(), on_cpu[0]) and torch.equal(on_card[1].cpu(), on_cpu[1])
    torch.testing.assert_close(on_card[2].cpu(), on_cpu[2], rtol=0, atol=1e-3)
    physical = ASRBundle(card_model, _Tok(), {**hp, "decode_paged_kv": False})._decode_test(
        feats.to(cuda), lens.to(cuda))
    assert torch.equal(physical[0], on_card[0]) and torch.equal(physical[1], on_card[1])
    torch.testing.assert_close(physical[2], on_card[2], rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(PAGED))
def test_k5_k6_at_lm_head_width(cuda, name, dtype):
    """The LM's heads, 12 x 64 (the ASR's are 8 x 96), over 66 steps with a
    random reorder after each (pages complete at 31 and 63, or 63)."""
    kernel, u_max, page, fused = PAGED[name]
    cache = _nan_paged_cache(u_max, fused, dtype, cuda)
    twin_cache = {k: v.clone() for k, v in cache.items()}
    twin = attention_step_paged_fused_plain if fused else attention_step_paged_plain
    rng = np.random.default_rng(12 + len(name))
    n, u = cache["tokens"].shape
    mask = torch.from_numpy(rng.random((n, u)) > 0.2).to(cuda)
    mask[:, 0] = True
    for step in range(66):
        q, kh, vh = (torch.from_numpy(rng.standard_normal((n, 768)).astype(np.float32)).to(cuda)
                     for _ in range(3))
        got = kernel(q, kh, vh, mask, cache, step, 1, 12)
        want = twin(q, kh, vh, mask, twin_cache, step, 1, 12)
        assert torch.isfinite(got).all(), step
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        for key in cache:
            assert _same(cache[key], twin_cache[key]), (step, key)
        parent = torch.from_numpy(rng.integers(0, 4, (n // 4, 4))).to(cuda)
        cache = beam_reorder_cache(cache, parent, step)
        twin_cache = beam_reorder_cache(twin_cache, parent, step)


def _fused_history(n, u, step, dtype, device, rng, layers=2, m=768):
    """A fused page-64 cache after ``step`` random beam reorders (beams of
    4), its pages and slots filled with seeded content, in ``dtype``."""
    cache = _fused_nan_cache(layers, n, u, m, dtype, device)
    for t in range(step):
        cache = beam_reorder_cache(cache, torch.from_numpy(rng.integers(0, 4, (n // 4, 4))).to(device), t)
    for key in ("kv", "kv_act"):
        cache[key].copy_(torch.from_numpy(rng.standard_normal(cache[key].shape).astype(np.float32)))
    return cache


def _physical_of(cache, step, stale=float("nan")):
    """The (L, N, U, M) physical k and v caches holding the fused paged
    cache's logical content at positions < step (the parent's slot for the
    active page), ``stale`` (NaN; int8: code -128) at and beyond the step."""
    k_pages, v_pages, k_act, v_act = page_views(cache)
    layers, n, up, page, m = k_pages.shape
    p_act, o = divmod(step, page)
    owners, parent = cache["table"].long(), cache["act_src"].long()
    cols = torch.arange(up, device=owners.device)
    out = []
    for pages, act in ((k_pages, k_act), (v_pages, v_act)):
        c = pages[:, owners, cols].reshape(layers, n, up * page, m).clone()
        c[:, :, p_act * page:p_act * page + o] = act[:, parent, (step + 1) % 2, :o]
        c[:, :, step:] = stale
        out.append(c.contiguous())
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nhead", [8, 12])
@pytest.mark.parametrize("step", [0, 63, 64, 127])
def test_k4_k6_bit_identical(cuda, step, nhead, dtype):
    """K4 (physical) and K6 (fused paged) run one body with other addresses:
    on the same logical content (a beam history's pages and the parent's
    active page, as a physical cache) their outputs are equal bit for bit, at
    the ASR's 8 x 96 heads and the LM's 12 x 64, at steps before, on and
    after a page completion (U 192: a completed and an active page)."""
    rng = np.random.default_rng(step + nhead + dtype.itemsize)
    n, u, layer = 16, 192, 1
    cache = _fused_history(n, u, step, dtype, cuda, rng)
    ck, cv = _physical_of(cache, step)
    mask = torch.from_numpy(rng.random((n, u)) > 0.2).to(cuda)
    mask[:, 0] = True
    mask[::3, step] = False
    q, kh, vh = (torch.from_numpy(rng.standard_normal((n, 768)).astype(np.float32)).to(cuda)
                 for _ in range(3))
    paged = attention_step_paged_chunked(q, kh, vh, mask, cache, step, layer, nhead)
    physical = attention_step_chunked(q, kh, vh, mask, ck, cv, step, layer, nhead)
    torch.cuda.synchronize()
    assert torch.isfinite(paged).all()
    assert torch.equal(paged, physical), float((paged - physical).abs().max())


def _split_history(n, u, step, dtype, device, rng, g, nhead, layers=2, m=768):
    """A split page-32 cache after ``step`` random beam reorders (beams of 4),
    its pages and slots then filled with seeded content (int8: codes and
    scales, as _int8_fill)."""
    cache = make_kv_cache(n, u, layers, nhead, m // nhead, dtype, device=device, paged=True)
    assert "k" in cache and cache["table"].shape[1] * 32 == u
    for t in range(step):
        cache = beam_reorder_cache(cache, torch.from_numpy(rng.integers(0, 4, (n // 4, 4))).to(device), t)
    if dtype == torch.int8:
        _int8_fill(cache, g)
    else:
        for key in ("k", "v", "k_act", "v_act"):
            cache[key].copy_(torch.from_numpy(rng.standard_normal(cache[key].shape).astype(np.float32)))
    return cache


def _k3_k5_same_bits(cuda, step, nhead, dtype, n, u, seed):
    """K5 on a split page-32 cache after a beam history and K3 on its
    logical content: outputs and the written fresh k/v (int8: codes and
    scales) alike, one launch of each counted."""
    rng = np.random.default_rng(seed + dtype.itemsize)
    g = torch.Generator(device=cuda).manual_seed(seed)
    layer = 1
    int8 = dtype == torch.int8
    cache = _split_history(n, u, step, dtype, cuda, rng, g, nhead)
    ck, cv = _physical_of(cache, step, stale=-128 if int8 else float("nan"))
    scales = (cache["k_scale"].clone(), cache["v_scale"].clone()) if int8 else ()
    mask = torch.from_numpy(rng.random((n, u)) > 0.2).to(cuda)
    mask[:, 0] = True
    mask[::3, step] = False
    q, kh, vh = (torch.from_numpy(rng.standard_normal((n, 768)).astype(np.float32)).to(cuda)
                 for _ in range(3))
    before = (attention_step.launches, attention_step_paged.launches)
    paged = attention_step_paged(q, kh, vh, mask, cache, step, layer, nhead)
    physical = attention_step(q, kh, vh, mask, ck, cv, step, layer, nhead, *scales)
    torch.cuda.synchronize()
    assert (attention_step.launches, attention_step_paged.launches) == (before[0] + 1, before[1] + 1)
    assert torch.isfinite(paged).all()
    assert torch.equal(paged, physical), float((paged - physical).abs().max())
    k_pages, v_pages, k_act, v_act = page_views(cache)
    p_act, o = divmod(step, 32)
    for written, pages, act in ((ck, k_pages, k_act), (cv, v_pages, v_act)):
        merged = pages[layer, :, p_act] if o == 31 else act[layer, :, step % 2]
        assert torch.equal(written[layer, :, step], merged[:, o])
    if int8:
        assert _same(scales[0], cache["k_scale"]) and _same(scales[1], cache["v_scale"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("nhead", [8, 12])
@pytest.mark.parametrize("step", [0, 31, 32, 95])
def test_k3_k5_bit_identical(cuda, step, nhead, dtype):
    """K3 (physical) and K5 (split page 32) on the same logical content (a
    beam history's pages and the parent's active slot, as a physical cache;
    int8 the same own-row scales), U 96, pad keys and every third row's fresh
    token masked: outputs equal bit for bit at the ASR's 8 x 96 heads and the
    LM's 12 x 64, before, on and after a page completion, and the fresh k/v
    (int8: codes and scales) written alike."""
    _k3_k5_same_bits(cuda, step, nhead, dtype, 16, 96, step + nhead)


@pytest.mark.parametrize("n", [16, 528])
@pytest.mark.parametrize("nhead", [8, 12])
@pytest.mark.parametrize("step", [0, 31, 32, 95, 125, 255])
def test_k3_k5_int8_bit_identical_at_d2(cuda, step, nhead, n):
    """int8 K5 and K3 as above on D2's caches (U 256), from its first step
    to its last, at 16 rows and at the decode's 528 (8 utterances x beam
    66: more items than blocks, so each block walks several rows' pages)."""
    _k3_k5_same_bits(cuda, step, nhead, torch.int8, n, 256, step + nhead + n)


@pytest.mark.parametrize("nhead", [8, 12])
@pytest.mark.parametrize("step", [31, 63, 32, 50])
def test_k5_int8_writes_the_fresh_codes_once(cuda, step, nhead):
    """int8 K5 at N 528 (U 96), on a merged page whose every byte starts as
    code -128 and scales NaN: the merged page (main page step // 32 when the
    step completes it: 31, 63; else slot step % 2: 32, 50) holds the
    parent's codes below the step, the plain quantizer's codes of kh/vh at
    the step (bit for bit), and -128 after it; the scales at the step are the
    quantizer's, every other scale as it was; every other page and slot, of
    both layers, is untouched."""
    n, u, layer = 528, 96, 1
    g = torch.Generator(device=cuda).manual_seed(step + nhead)
    rng = np.random.default_rng(step + nhead)
    cache = _split_history(n, u, step, torch.int8, cuda, rng, g, nhead)
    k_pages, v_pages, k_act, v_act = page_views(cache)
    p_act, o = divmod(step, 32)
    for pages, act in ((k_pages, k_act), (v_pages, v_act)):
        (pages[:, :, p_act] if o == 31 else act[:, :, step % 2]).fill_(-128)
    for key in ("k_scale", "v_scale"):
        cache[key][:, :, step] = float("nan")
    before = {k: v.clone() for k, v in cache.items()}
    mask = torch.ones(n, u, dtype=torch.bool, device=cuda)
    q, kh, vh = (torch.randn(n, 768, generator=g, device=cuda) for _ in range(3))
    attention_step_paged(q, kh, vh, mask, cache, step, layer, nhead)
    torch.cuda.synchronize()
    parent = before["act_src"].long()
    old = page_views(before)
    for i, (key, fresh) in enumerate((("k", kh), ("v", vh))):
        codes, scale = quantize_rows(fresh)
        pages, act = old[i].clone(), old[2 + i].clone()  # what the launch should leave
        merged = pages[layer, :, p_act] if o == 31 else act[layer, :, step % 2]
        merged[:, :o] = old[2 + i][layer, parent, (step + 1) % 2, :o]
        merged[:, o] = codes
        assert torch.equal(page_views(cache)[i], pages) and torch.equal(page_views(cache)[2 + i], act)
        want = before[f"{key}_scale"].clone()
        want[layer, :, step] = scale
        assert torch.equal(cache[f"{key}_scale"][layer], want[layer])
        assert _same(cache[f"{key}_scale"], want)


@pytest.mark.parametrize("nhead", [8, 12])
@pytest.mark.parametrize("step", [31, 32, 125])
def test_k5_int8_bos_only_rows_and_foreign_parents(cuda, step, nhead):
    """int8 K5 at U 256 on mixed owner tables where every row's active page
    comes from another row (act_src = row + 1 mod N), rows 1 and 6 with bos
    as their only valid key (the fresh token masked too), NaN scales at
    every masked position and from the step on: out within 1e-5 of the
    twin's (bos-only rows: the bos value exactly weighted 1), every page,
    slot and scale equal, and K3 on the same logical content equal bit for
    bit."""
    n, u, layer = 16, 256, 1
    g = torch.Generator(device=cuda).manual_seed(step + 3 * nhead)
    rng = np.random.default_rng(step + 3 * nhead)
    cache = make_kv_cache(n, u, 2, nhead, 768 // nhead, torch.int8, device=cuda, paged=True)
    _int8_fill(cache, g)
    cache["table"] = torch.from_numpy(rng.integers(0, n, (n, u // 32)).astype(np.int32)).to(cuda)
    cache["act_src"] = ((torch.arange(n, device=cuda) + 1) % n).to(torch.int32)
    mask = torch.from_numpy(rng.random((n, u)) > 0.2).to(cuda)
    mask[:, 0] = True
    mask[[1, 6], 1:] = False
    hidden = ~mask
    hidden[:, step:] = True
    for key in ("k_scale", "v_scale"):
        cache[key][:, hidden] = float("nan")
    ck, cv = _physical_of(cache, step, stale=-128)
    scales = (cache["k_scale"].clone(), cache["v_scale"].clone())
    twin_cache = {k: v.clone() for k, v in cache.items()}
    q, kh, vh = (torch.randn(n, 768, generator=g, device=cuda) for _ in range(3))
    got = attention_step_paged(q, kh, vh, mask, cache, step, layer, nhead)
    want = attention_step_paged_plain(q, kh, vh, mask, twin_cache, step, layer, nhead)
    physical = attention_step(q, kh, vh, mask, ck, cv, step, layer, nhead, *scales)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for row in (1, 6):  # the bos value, code times scale, weighted 1
        assert torch.equal(got[row], cv[layer, row, 0].float() * scales[1][layer, row, 0])
    for key in cache:
        assert _same(cache[key], twin_cache[key]), key
    assert torch.equal(got, physical), float((got - physical).abs().max())


# K5's four configurations: (cache dtype, heads, U) of the f32 decodes (D1's U
# 96) and of the bf16 serving decode (D2's U 256 at page 32), the ASR's 8 x 96
# heads and the LM's 12 x 64
K5_CONFIGS = {"f32_8x96": (torch.float32, 8, 96), "f32_12x64": (torch.float32, 12, 96),
              "bf16_8x96": (torch.bfloat16, 8, 256), "bf16_12x64": (torch.bfloat16, 12, 256)}
# positions every row has masked, NaN in every row's pages
K5_MASKED = [3, 17, 40, 70, 100, 150, 200]


def _k5_case(config, step, table_kind, device, n=16, layers=2, m=768, page=32):
    """A split page-32 cache mid-decode: ``table_kind`` identity (every row
    owns its pages: no sharing), single (row 0 owns every page and active
    slot: full sharing) or mixed (owners drawn at random). Rows 1 and 6 have
    bos as their only valid key (the fresh token masked too); K5_MASKED
    positions are masked in every row and NaN in every page; positions past
    the step, the slot the step writes and the parent slot past its content
    hold NaN or Inf."""
    dtype, nhead, u = K5_CONFIGS[config]
    rng = np.random.default_rng(step + 7 * len(table_kind) + u)
    up = u // page
    p_act, o = divmod(step, page)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)

    cache = {"k": rand(layers, n, u, m), "v": rand(layers, n, u, m),
             "k_act": rand(layers, n, 2, page, m), "v_act": rand(layers, n, 2, page, m),
             "tokens": torch.zeros(n, u, dtype=torch.long)}
    if table_kind == "identity":
        table, src = np.repeat(np.arange(n)[:, None], up, 1), np.arange(n)
    elif table_kind == "single":
        table, src = np.zeros((n, up)), np.zeros(n)
    else:
        table, src = rng.integers(0, n, (n, up)), rng.integers(0, n, n)
    cache["table"] = torch.from_numpy(table.astype(np.int32))
    cache["act_src"] = torch.from_numpy(src.astype(np.int32))
    mask = torch.from_numpy(rng.random((n, u)) > 0.2)
    mask[:, 0] = True
    masked = [p for p in K5_MASKED if p < u]
    mask[:, masked] = False
    mask[[1, 6], 1:] = False
    for key in ("k", "v"):
        cache[key][:, :, masked] = float("nan")
        cache[key][:, :, p_act * page:] = float("nan")  # the active and later pages
        cache[key][:, :, p_act * page + 1::5] = float("inf")
        act = cache[f"{key}_act"]
        act[:, :, step % 2] = float("nan")
        act[:, :, (step + 1) % 2, o:] = float("nan")
    q, kh, vh = (torch.from_numpy(rng.standard_normal((n, m)).astype(np.float32))
                 for _ in range(3))
    to = lambda x: x.to(device)  # noqa: E731
    return (to(q), to(kh), to(vh), to(mask), {k: to(v) for k, v in cache.items()}, nhead)


@pytest.mark.parametrize("table_kind", ["identity", "single", "mixed"])
@pytest.mark.parametrize("step_at", [0, 31, 32, 125, -1])
@pytest.mark.parametrize("config", list(K5_CONFIGS))
def test_k5_matches_plain_twin(cuda, config, step_at, table_kind):
    """K5 in each configuration at steps 0, 31 (completes page 0), 32,
    125 (95 at U 96) and U - 1: out within 1e-5 of the twin's, finite, and
    every page and slot equal (NaN where NaN); one launch counted."""
    u = K5_CONFIGS[config][2]
    step = min(step_at, u - 1) % u
    q, kh, vh, mask, cache, nhead = _k5_case(config, step, table_kind, cuda)
    twin_cache = {k: v.clone() for k, v in cache.items()}
    before = attention_step_paged.launches
    got = attention_step_paged(q, kh, vh, mask, cache, step, 1, nhead)
    want = attention_step_paged_plain(q, kh, vh, mask, twin_cache, step, 1, nhead)
    torch.cuda.synchronize()
    assert attention_step_paged.launches == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for key in cache:
        assert _same(cache[key], twin_cache[key]), key


# K7 vs its twin: both round at the same points, but the products sum in other
# orders, so a bf16 rounding of q/k/v, the context or the hidden can flip by
# one ulp and carry into later layers
K7_ATOL = 5e-2
LM_SMALL = dict(vocab=40, d_model=256, nhead=4, num_layers=2, d_ffn=512)


def bf16_ulps(a, b, slack=1e-5):
    """Per element (|a - b| - slack)+ in bf16 ulps of the larger magnitude; 0
    where equal or both NaN. The slack: two f32 sums in other orders differ by
    ~1e-6 near zero, where a bf16 ulp is far smaller."""
    a, b = a.float(), b.float()
    big = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    ulps = ((a - b).abs() - slack).clamp_min(0.0) / torch.exp2(torch.floor(torch.log2(big)) - 7)
    return torch.where((a == b) | (a.isnan() & b.isnan()), torch.zeros_like(ulps), ulps)


def _fused_nan_cache(layers, n, u, m, dtype, device):
    """A fused page-64 cache whose every k/v byte starts as NaN."""
    return {"kv": torch.full((layers, n, 2 * u, m), float("nan"), dtype=dtype, device=device),
            "kv_act": torch.full((layers, n, 2, 128, m), float("nan"), dtype=dtype, device=device),
            "table": torch.arange(n, dtype=torch.int32, device=device)[:, None].repeat(1, u // 64),
            "act_src": torch.arange(n, dtype=torch.int32, device=device),
            "tokens": torch.zeros(n, u, dtype=torch.long, device=device)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k7_protocol_matches_plain_twin(cuda, dtype):
    """Steps 0 .. 75 with a random reorder after each (page 0 completes at 63)
    on a cache that starts as NaN: x_out within K7_ATOL of the twin's from
    the same state; the first layer's written pages and slots within one
    bf16 ulp, up to 1e-5 absolute (the same x0, products summed in other
    orders), every layer's within K7_ATOL (later layers' k/v carry the x
    gap); one launch a step. The run goes on from the kernel's state."""
    lm = seeded_init_(TransformerLM(**LM_SMALL, device=cuda), 0)
    wall, vecs = lm.prepare_megastep()
    n, u, m = 8, 128, LM_SMALL["d_model"]
    cache = _fused_nan_cache(LM_SMALL["num_layers"], n, u, m, dtype, cuda)
    rng = np.random.default_rng(int(dtype.itemsize))
    mask = torch.from_numpy(rng.random((n, u)) > 0.2).to(cuda)
    mask[:, 0] = True
    worst = worst_ulps = 0.0
    for step in range(76):
        x0 = torch.from_numpy(rng.standard_normal((n, m)).astype(np.float32)).to(cuda)
        twin = {k: v.clone() for k, v in cache.items()}
        args = (x0, mask, cache["kv"], cache["kv_act"], cache["table"], cache["act_src"], step,
                wall, vecs, LM_SMALL["nhead"])
        before = lm_megastep.launches
        got, kv, act = lm_megastep(*args)
        torch.cuda.synchronize()
        assert lm_megastep.launches == before + 1 and kv is cache["kv"] and act is cache["kv_act"]
        want, _, _ = lm_megastep_plain(x0, mask, twin["kv"], twin["kv_act"], twin["table"],
                                       twin["act_src"], step, wall, vecs, LM_SMALL["nhead"])
        assert torch.isfinite(got).all(), step
        worst = max(worst, float((got - want).abs().max()))
        torch.testing.assert_close(got, want, rtol=0, atol=K7_ATOL)
        for key in ("kv", "kv_act"):
            ulps = bf16_ulps(cache[key], twin[key])
            assert float(ulps[0].max()) <= 1, (step, key)
            worst_ulps = max(worst_ulps, float(ulps.max()))
            torch.testing.assert_close(cache[key].float(), twin[key].float(), rtol=0,
                                       atol=K7_ATOL, equal_nan=True)
        parent = torch.from_numpy(rng.integers(0, 4, (n // 4, 4))).to(cuda)
        cache = beam_reorder_cache(cache, parent, step)
    print(f"K7 vs twin, {dtype}: max |x_out gap| {worst}, pages and slots {worst_ulps} ulps")


@pytest.mark.parametrize("exact_gelu", [False, True])
@pytest.mark.parametrize("step", [0, 63, 64, 127])
def test_k7_ragged_rows(cuda, step, exact_gelu):
    """N = 72 rows (one full 64-row product tile and a ragged one of 8) over
    a seeded content cache (f32, U 192), at steps before, on and after a page
    completion, tanh and erf GELU: x_out within K7_ATOL of the twin's from
    the same state, the first layer's written pages and slots within one bf16
    ulp, every layer's within K7_ATOL."""
    lm = seeded_init_(TransformerLM(**LM_SMALL, device=cuda), 2)
    wall, vecs = lm.prepare_megastep()
    rng = np.random.default_rng(step + 2 * exact_gelu)
    n, u, m = 72, 192, LM_SMALL["d_model"]
    cache = _fused_history(n, u, step, torch.float32, cuda, rng, LM_SMALL["num_layers"], m)
    twin = {k: v.clone() for k, v in cache.items()}
    mask = torch.from_numpy(rng.random((n, u)) > 0.2).to(cuda)
    mask[:, 0] = True
    x0 = torch.from_numpy(rng.standard_normal((n, m)).astype(np.float32)).to(cuda)
    args = (x0, mask, cache["kv"], cache["kv_act"], cache["table"], cache["act_src"], step, wall,
            vecs, LM_SMALL["nhead"])
    got = lm_megastep(*args, exact_gelu=exact_gelu)[0]
    want = lm_megastep_plain(x0, mask, twin["kv"], twin["kv_act"], twin["table"], twin["act_src"],
                             step, wall, vecs, LM_SMALL["nhead"], exact_gelu=exact_gelu)[0]
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=K7_ATOL)
    for key in ("kv", "kv_act"):
        assert float(bf16_ulps(cache[key], twin[key])[0].max()) <= 1, key
        torch.testing.assert_close(cache[key], twin[key], rtol=0, atol=K7_ATOL, equal_nan=True)


def test_k7_stamped_build_equals_k7(cuda, capsys):
    """tools/profile_lm_megastep.py's stamped build (a timer read after every
    grid barrier) computes what K7 computes: the tool exits non-zero unless
    its x_out equals K7's bit for bit, and reports every phase."""
    from speech_anonymization_tpu_torch.tools import profile_lm_megastep as prof

    assert prof.main(["63"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line["us_per_layer"]) == set(prof.PHASES) and line["barrier_us"] > 0


def test_k7_refuses_bad_operands(cuda):
    lm = seeded_init_(TransformerLM(**LM_SMALL, device=cuda), 0)
    wall, vecs = lm.prepare_megastep()
    n, u, m = 8, 128, LM_SMALL["d_model"]
    c = _fused_nan_cache(2, n, u, m, torch.float32, cuda)
    x0 = torch.zeros(n, m, device=cuda)
    mask = torch.ones(n, u, dtype=torch.bool, device=cuda)
    ok = (x0, mask, c["kv"], c["kv_act"], c["table"], c["act_src"], 3, wall, vecs, 4)

    def bad(**kw):
        names = ("x0", "mask", "kv", "act", "table", "src", "step", "wall", "vecs", "nhead")
        return tuple(kw.get(k, v) for k, v in zip(names, ok))

    with pytest.raises(TypeError, match="k_scale"):  # int8 codes without their scales
        lm_megastep(*bad(kv=c["kv"].to(torch.int8), act=c["kv_act"].to(torch.int8)))
    # with their scales, int8 is taken and held to the twin
    g = torch.Generator(device=cuda).manual_seed(4)
    i8 = _int8_fused_cache(2, n, u, m, cuda, g)
    _int8_fill(i8, g)
    twin = {k: v.clone() for k, v in i8.items()}
    x0 = torch.randn(n, m, generator=g, device=cuda)
    got = lm_megastep(*_k7_args(x0, mask, i8, 3, wall, vecs, 4))[0]
    want = lm_megastep_plain(*_k7_args(x0, mask, twin, 3, wall, vecs, 4))[0]
    _k7_int8_close(got, want, i8, twin, 3)
    with pytest.raises(ValueError):  # the split layout: k cache and k slots
        lm_megastep(*bad(kv=c["kv"][:, :, :u].contiguous(), act=c["kv_act"][:, :, :, :64].contiguous()))
    with pytest.raises(ValueError):  # page 32
        lm_megastep(*bad(table=c["table"].repeat_interleave(2, dim=1).contiguous()))
    with pytest.raises(ValueError):  # CPU and CUDA mixed
        lm_megastep(*bad(table=c["table"].cpu()))
    with pytest.raises(ValueError):
        lm_megastep(*bad(x0=x0.t().contiguous().t()))
    with pytest.raises(ValueError):
        lm_megastep(*bad(step=u))


def test_lm_fused_decode_on_card(cuda):
    """A small ASR (page 32, K5) fused with a d_model 768 LM whose cache takes
    the fused page-64 layout (220 steps: U 256): one K7 launch per step, and
    with ``decode_lm_megastep: false`` K6 per layer instead. Tokens are
    reported, not compared: K7 computes in bf16, the per-layer path in f32."""
    model = seeded_init_(ASRModel(d_model=128, nhead=4, num_encoder_layers=1, num_decoder_layers=1,
                                  d_ffn=128, output_neurons=40, device=cuda), 0)
    lm = seeded_init_(TransformerLM(vocab=40, d_model=768, nhead=12, num_layers=2, d_ffn=1536,
                                    device=cuda), 1)
    feats = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 900, 80)).astype(
        np.float32)).to(cuda)
    lens = torch.tensor([1.0, 0.85], device=cuda)
    hp = {"test_beam_size": 4, "ctc_weight_decode": 0.4, "temperature": 1.15,
          "max_decode_steps": 220}
    outs = {}
    for mega in (True, False):
        bundle = ASRBundle(model, _Tok(), {**hp, "decode_lm_megastep": mega}, lm=lm)
        assert (bundle.lm_mega is not None) == mega
        assert "kv" in bundle.make_lm_cache(8, 221, cuda)
        counts = (lm_megastep.launches, attention_step_paged_chunked.launches)
        outs[mega] = bundle._decode_test(feats, lens)
        torch.cuda.synchronize()
        k7 = lm_megastep.launches - counts[0]
        k6 = attention_step_paged_chunked.launches - counts[1]
        assert (k7, k6) == ((220, 0) if mega else (0, 2 * 220))
        assert torch.isfinite(outs[mega][2]).all()
    same = torch.equal(outs[True][0], outs[False][0])
    print(f"K7 vs per-layer LM decode: tokens identical {same}, score gap "
          f"{float((outs[True][2] - outs[False][2]).abs().max())}")


# int8 caches above the whole-row bound (U > 426 at M 768): K4, K6 (fused and
# split) and K7 against their twins, with code -128 (never written by the
# quantizer) and NaN scales wherever a step may not read


def _int8_fill(cache, g):
    """Seeded codes in every k/v buffer of ``cache``, scales in [1e-3, 0.05]."""
    for key in ("k", "v", "kv", "k_act", "v_act", "kv_act"):
        if key in cache:
            cache[key].random_(-127, 128, generator=g)
    for key in ("k_scale", "v_scale"):
        cache[key].uniform_(1e-3, 0.05, generator=g)


def _int8_fused_cache(layers, n, u, m, device, g):
    """A fused page-64 int8 cache (any U) whose codes are all -128 and scales NaN."""
    cache = _fused_nan_cache(layers, n, u, m, torch.float32, device)
    cache["kv"] = torch.full(cache["kv"].shape, -128, dtype=torch.int8, device=device)
    cache["kv_act"] = torch.full(cache["kv_act"].shape, -128, dtype=torch.int8, device=device)
    for key in ("k_scale", "v_scale"):
        cache[key] = torch.full((layers, n, u), float("nan"), device=device)
    return cache


@pytest.mark.parametrize("u,step_at", [(448, 0), (448, 447), (512, 63), (512, 64), (512, 300)])
@pytest.mark.parametrize("nhead", [8, 12])
def test_k4_int8_matches_plain_twin(cuda, u, step_at, nhead):
    """K4 on int8 caches above the whole-row bound (U 448 and 512 > 426), at
    the ASR's 8 x 96 heads and the LM's 12 x 64: out within 1e-5 of the
    twin's, every code and scale equal; one launch counted."""
    n, m = 9, 768
    q, kh, vh, mask, ck, cv, ks, vs = _int8_attention_inputs(n, u, m, step_at, u + step_at, cuda)
    twin = [x.clone() for x in (ck, cv, ks, vs)]
    before = attention_step_chunked.launches
    got = attention_step_chunked(q, kh, vh, mask, ck, cv, step_at, 1, nhead, ks, vs)
    want = attention_step_plain(q, kh, vh, mask, *twin[:2], step_at, 1, nhead, *twin[2:])
    torch.cuda.synchronize()
    assert attention_step_chunked.launches == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for a, b in zip((ck, cv, ks, vs), twin):
        assert _same(a, b)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("nhead", [8, 12])
def test_k6_int8_protocol_matches_plain_twin(cuda, nhead, fused):
    """K6 on int8 caches above the whole-row bound (u_max 449: U 512, page
    64), fused and split, over 70 steps with a random beam reorder after each
    (page 0 completes at 63), at 8 x 96 and 12 x 64, from caches whose codes
    are all -128 and scales NaN: out within 1e-5 of the twin's, finite, and
    every page, slot, scale, table and act_src equal after every step."""
    n = 8
    cache = make_kv_cache(n, 449, 2, nhead, 768 // nhead, torch.int8, device=cuda, paged=True,
                          fused=fused)
    assert ("kv" in cache) == fused and cache["tokens"].shape[1] == 512
    assert cache["table"].shape[1] * 64 == 512 and cache["k_scale"].shape == (2, n, 512)
    for key in cache:
        if key in ("k", "v", "kv", "k_act", "v_act", "kv_act"):
            cache[key].fill_(-128)
        elif key in ("k_scale", "v_scale"):
            cache[key].fill_(float("nan"))
    twin_cache = {k: v.clone() for k, v in cache.items()}
    twin = attention_step_paged_fused_plain if fused else attention_step_paged_plain
    rng = np.random.default_rng(nhead + fused)
    mask = torch.from_numpy(rng.random((n, 512)) > 0.2).to(cuda)
    mask[:, 0] = True
    before = attention_step_paged_chunked.launches
    steps = 70
    for step in range(steps):
        for layer in range(2):
            q, kh, vh = (torch.from_numpy(rng.standard_normal((n, 768)).astype(np.float32)).to(cuda)
                         for _ in range(3))
            got = attention_step_paged_chunked(q, kh, vh, mask, cache, step, layer, nhead)
            want = twin(q, kh, vh, mask, twin_cache, step, layer, nhead)
            assert torch.isfinite(got).all(), (step, layer)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        for key in cache:
            assert _same(cache[key], twin_cache[key]), (step, key)
        parent = torch.from_numpy(rng.integers(0, 4, (n // 4, 4))).to(cuda)
        cache = beam_reorder_cache(cache, parent, step)
        twin_cache = beam_reorder_cache(twin_cache, parent, step)
    torch.cuda.synchronize()
    assert attention_step_paged_chunked.launches == before + 2 * steps


@pytest.mark.parametrize("nhead", [8, 12])
@pytest.mark.parametrize("step", [0, 63, 64, 127])
def test_k4_k6_int8_bit_identical(cuda, step, nhead):
    """int8 K4 (physical) and K6 (fused paged) on the same logical content
    (codes of a beam history's pages and the parent's active page, the same
    own-row scales) give equal outputs bit for bit, and write equal scales."""
    rng = np.random.default_rng(step + nhead)
    g = torch.Generator(device=cuda).manual_seed(step + nhead)
    n, u, layer = 16, 192, 1
    cache = _int8_fused_cache(2, n, u, 768, cuda, g)
    for t in range(step):
        cache = beam_reorder_cache(cache, torch.from_numpy(rng.integers(0, 4, (n // 4, 4))).to(cuda), t)
    _int8_fill(cache, g)
    ck, cv = _physical_of(cache, step, stale=-128)
    ks, vs = cache["k_scale"].clone(), cache["v_scale"].clone()
    mask = torch.from_numpy(rng.random((n, u)) > 0.2).to(cuda)
    mask[:, 0] = True
    mask[::3, step] = False
    q, kh, vh = (torch.from_numpy(rng.standard_normal((n, 768)).astype(np.float32)).to(cuda)
                 for _ in range(3))
    paged = attention_step_paged_chunked(q, kh, vh, mask, cache, step, layer, nhead)
    physical = attention_step_chunked(q, kh, vh, mask, ck, cv, step, layer, nhead, ks, vs)
    torch.cuda.synchronize()
    assert torch.isfinite(paged).all()
    assert torch.equal(paged, physical), float((paged - physical).abs().max())
    assert torch.equal(cache["k_scale"], ks) and torch.equal(cache["v_scale"], vs)


@pytest.mark.parametrize("step_at", [0, 15, 16, 63, 64, 223, 447])
@pytest.mark.parametrize("nhead", [8, 12])
def test_k4_int8_matches_emulation(cuda, step_at, nhead):
    """K4 on int8 caches (U 512) against ``attend_int8_tiled``, the plain
    form of its arithmetic (scales factored out of the products, q and the
    weights as f16 terms, tiles of 16 in the warps' order), and against the
    twin, both within 1e-5; code -128 and NaN scales at masked positions and
    from the step on, pad keys, odd rows' fresh token masked; the fresh codes
    and scales equal the twin's."""
    n, u, m = 9, 512, 768
    q, kh, vh, mask, ck, cv, ks, vs = _int8_attention_inputs(n, u, m, step_at, 3 * u + step_at,
                                                             cuda)
    p = step_at + 1
    emulated = attend_int8_tiled(q, kh, vh, mask, ck[1, :, :p], cv[1, :, :p], step_at, nhead,
                                 ks[1, :, :p], vs[1, :, :p])
    twin = [x.clone() for x in (ck, cv, ks, vs)]
    got = attention_step_chunked(q, kh, vh, mask, ck, cv, step_at, 1, nhead, ks, vs)
    want = attention_step_plain(q, kh, vh, mask, *twin[:2], step_at, 1, nhead, *twin[2:])
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, emulated, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for a, b in zip((ck, cv, ks, vs), twin):
        assert _same(a, b)


@pytest.mark.parametrize("nhead", [8, 12])
@pytest.mark.parametrize("step", [0, 63, 64, 127])
def test_k4_k6_int8_split_bit_identical(cuda, step, nhead):
    """int8 K4 (physical) and K6 on the split page-64 layout, on the same
    logical content, give equal outputs bit for bit and write equal scales
    (``test_k4_k6_int8_bit_identical`` holds the fused layout to K4)."""
    rng = np.random.default_rng(step + nhead + 1)
    g = torch.Generator(device=cuda).manual_seed(step + nhead + 1)
    n, u, layer = 16, 449, 1
    cache = make_kv_cache(n, u, 2, nhead, 768 // nhead, torch.int8, device=cuda, paged=True,
                          fused=False)
    assert "k" in cache and cache["table"].shape[1] * 64 == cache["k"].shape[2]
    for t in range(step):
        cache = beam_reorder_cache(cache, torch.from_numpy(rng.integers(0, 4, (n // 4, 4))).to(cuda), t)
    _int8_fill(cache, g)
    u = cache["k"].shape[2]
    ck, cv = _physical_of(cache, step, stale=-128)
    ks, vs = cache["k_scale"].clone(), cache["v_scale"].clone()
    mask = torch.from_numpy(rng.random((n, u)) > 0.2).to(cuda)
    mask[:, 0] = True
    mask[::3, step] = False
    q, kh, vh = (torch.from_numpy(rng.standard_normal((n, 768)).astype(np.float32)).to(cuda)
                 for _ in range(3))
    paged = attention_step_paged_chunked(q, kh, vh, mask, cache, step, layer, nhead)
    physical = attention_step_chunked(q, kh, vh, mask, ck, cv, step, layer, nhead, ks, vs)
    torch.cuda.synchronize()
    assert torch.isfinite(paged).all()
    assert torch.equal(paged, physical), float((paged - physical).abs().max())
    assert torch.equal(cache["k_scale"], ks) and torch.equal(cache["v_scale"], vs)


def test_int8_chunked_kernels_refuse_other_head_widths(cuda):
    """The int8 chunked body takes heads of 32, 64, 96 or 128: K4, K6 and K7
    raise on others (here 48) on the card, where the twins take any width."""
    n, u, m = 8, 512, 768
    q, kh, vh, mask, ck, cv, ks, vs = _int8_attention_inputs(n, u, m, 5, 1, cuda)
    with pytest.raises(ValueError, match="head widths"):
        attention_step_chunked(q, kh, vh, mask, ck, cv, 5, 0, 16, ks, vs)
    cache = make_kv_cache(n, 449, 2, 16, 48, torch.int8, device=cuda, paged=True)
    with pytest.raises(ValueError, match="head widths"):
        attention_step_paged_chunked(q, kh, vh, mask, cache, 5, 0, 16)


def _k7_args(x0, mask, cache, step, wall, vecs, nhead):
    return (x0, mask, cache["kv"], cache["kv_act"], cache["table"], cache["act_src"], step, wall,
            vecs, nhead, False, cache["k_scale"], cache["v_scale"])


# K7 int8 against its twin: both quantize bf16-valued k/v from products summed
# in other orders, so a k/v element, and with it the row's amax, can differ by
# one bf16 ulp: the first layer's codes within 1, its scales within 2^-7
# relative; later layers carry the x gap (scales within 5e-2 relative)
K7_INT8_SCALE_RTOL = 2.0 ** -7


def _k7_int8_close(got, want, cache, twin, step):
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=K7_ATOL)
    for key in ("kv", "kv_act"):
        assert int((cache[key][0].int() - twin[key][0].int()).abs().max()) <= 1, key
    for key in ("k_scale", "v_scale"):
        a, b = cache[key][:, :, step], twin[key][:, :, step]
        torch.testing.assert_close(a[0], b[0], rtol=K7_INT8_SCALE_RTOL, atol=0)
        torch.testing.assert_close(a, b, rtol=5e-2, atol=0)
        assert _same(cache[key][:, :, :step], twin[key][:, :, :step])


def test_k7_int8_protocol_matches_plain_twin(cuda):
    """K7 on a fused page-64 int8 cache over 76 steps with a random reorder
    after each (page 0 completes at 63), from codes -128 and NaN scales: x_out
    within K7_ATOL of the twin's from the same state, the written codes and
    scales as ``_k7_int8_close`` states; one launch a step. The run goes on
    from the kernel's state."""
    lm = seeded_init_(TransformerLM(**LM_SMALL, device=cuda), 0)
    wall, vecs = lm.prepare_megastep()
    n, u, m = 8, 128, LM_SMALL["d_model"]
    g = torch.Generator(device=cuda).manual_seed(8)
    cache = _int8_fused_cache(LM_SMALL["num_layers"], n, u, m, cuda, g)
    rng = np.random.default_rng(8)
    mask = torch.from_numpy(rng.random((n, u)) > 0.2).to(cuda)
    mask[:, 0] = True
    for step in range(76):
        x0 = torch.from_numpy(rng.standard_normal((n, m)).astype(np.float32)).to(cuda)
        twin = {k: v.clone() for k, v in cache.items()}
        before = lm_megastep.launches
        got = lm_megastep(*_k7_args(x0, mask, cache, step, wall, vecs, LM_SMALL["nhead"]))[0]
        torch.cuda.synchronize()
        assert lm_megastep.launches == before + 1
        want = lm_megastep_plain(*_k7_args(x0, mask, twin, step, wall, vecs, LM_SMALL["nhead"]))[0]
        _k7_int8_close(got, want, cache, twin, step)
        parent = torch.from_numpy(rng.integers(0, 4, (n // 4, 4))).to(cuda)
        cache = beam_reorder_cache(cache, parent, step)


# K7 a layer at a time, both fed the kernel's x: chip_smoke.py's K7_LAYER_ATOL
K7_LAYER_ATOL = 0.02


@pytest.mark.parametrize("step", [63, 64, 200])
def test_k7_int8_layer_at_a_time(cuda, step):
    """K7 on a fused int8 cache (U 256, a beam history, seeded codes and
    scales; code -128 and NaN scales where the step may not read) against its
    twin a layer at a time, both fed the kernel's x: x within K7_LAYER_ATOL,
    the written codes within one of the twin's, the step's scales within
    K7_INT8_SCALE_RTOL, every other code and scale equal."""
    lm = seeded_init_(TransformerLM(**LM_SMALL, device=cuda), 3)
    wall, vecs = lm.prepare_megastep()
    layers, m, nhead = LM_SMALL["num_layers"], LM_SMALL["d_model"], LM_SMALL["nhead"]
    nb = wall.shape[0] // layers
    rng = np.random.default_rng(step)
    g = torch.Generator(device=cuda).manual_seed(step)
    n, u = 16, 256
    cache = _int8_fused_cache(layers, n, u, m, cuda, g)
    for t in range(step):
        cache = beam_reorder_cache(cache, torch.from_numpy(rng.integers(0, 4, (n // 4, 4))).to(cuda), t)
    _int8_fill(cache, g)
    mask = torch.from_numpy(rng.random((n, u)) > 0.2).to(cuda)
    mask[:, 0] = True
    hidden = ~mask
    hidden[:, step:] = True
    for key in ("k_scale", "v_scale"):
        cache[key][:, hidden] = float("nan")
    twin = {k: v.clone() for k, v in cache.items()}
    x = torch.from_numpy(rng.standard_normal((n, m)).astype(np.float32)).to(cuda)
    for layer in range(layers):
        lw, lv = wall[layer * nb:(layer + 1) * nb], vecs[layer:layer + 1]

        def layer_of(c):
            return {key: c[key][layer:layer + 1] for key in ("kv", "kv_act", "k_scale", "v_scale")
                    } | {"table": c["table"], "act_src": c["act_src"]}

        got = lm_megastep(*_k7_args(x, mask, layer_of(cache), step, lw, lv, nhead))[0]
        want = lm_megastep_plain(*_k7_args(x, mask, layer_of(twin), step, lw, lv, nhead))[0]
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), layer
        torch.testing.assert_close(got, want, rtol=0, atol=K7_LAYER_ATOL)
        for key in ("kv", "kv_act"):
            assert int((cache[key][layer].int() - twin[key][layer].int()).abs().max()) <= 1, key
        for key in ("k_scale", "v_scale"):
            a, b = cache[key][layer], twin[key][layer]
            torch.testing.assert_close(a[:, step], b[:, step], rtol=K7_INT8_SCALE_RTOL, atol=0)
            assert _same(a[:, :step], b[:, :step]) and _same(a[:, step + 1:], b[:, step + 1:])
        x = got


TRAIN_ASR = dict(d_model=64, nhead=4, num_encoder_layers=2, num_decoder_layers=2, d_ffn=128,
                 output_neurons=100)


def _trainer_factory(schedule, seed=0):
    """-> make(device): a trainer at convae.yaml's training (SpecAugment from
    its seeded generator) with Noam at lr 1e-3 and a small seeded ASR's
    utility term, its weights from ``seed``."""
    asr = {d: seeded_init_(ASRModel(**TRAIN_ASR, device=d), 5) for d in ("cuda", "cpu")}

    def make(device):
        hp = convae_hparams(device, schedule, NoamScheduler(1e-3, 1, 1))
        tr = recipe.AnonymizerTrainer(hp, asr_bundle=ASRBundle(asr[device], _Tok(), {}), device=device)
        seeded_init_(tr.model, seed)
        return tr

    return make


def _train_batches(n, b=4, samples=32_000, seed=0):
    """Speech-like utterances: over near-equal ones (white noise), or a batch
    of two, the sex head's pooled BatchNorm leaves the f32 gradients of the
    sex term far apart on any two devices."""
    return [train_batch(b, samples, seed + i, vocab=TRAIN_ASR["output_neurons"], tokens=12)
            for i in range(n)]


@pytest.mark.parametrize("phase", ["generator", "sex_classifier", "recon_utility"])
def test_convae_update_on_card_matches_cpu(cuda, phase):
    """One accumulation cycle (3 micro-batches of 4 x 2 s) on the card and on
    the CPU from the same weights, batches and draws: the loss terms, the
    accumulated gradients, BatchNorm and normalizer state, the Adam state and
    the updated parameters at ``tools/train_parity.py``'s tolerances."""
    schedule = {"generator": recipe.DEFAULT_SCHEDULE, "sex_classifier": recipe.DEFAULT_SCHEDULE[::-1],
                "recon_utility": [{"weights": {"recon": 1.0, "utility": 1.0}, "train": "all"}]}[phase]
    report = compare_cycle(_trainer_factory(schedule), _train_batches(3), 0)
    assert report["sign_only"] <= 0.01 * report["params"], report


@pytest.mark.parametrize("augment", [False, True])
def test_gender_step_on_card_matches_cpu(cuda, augment):
    """One GenderBrain micro-batch at gender_classifier.yaml's full width
    (8 x 2 s; with EnvCorrupt + TimeDomainSpecAugment the batch doubles) on
    the card and on the CPU from the same weights and draws, at
    ``tools/train_parity.py``'s tolerances; K1 launched once."""
    batch = train_batch(8, 32_000, 21)[:3]
    fused_fbank.launches = 0
    report = compare_gender_step(lambda d: GenderBrain(gender_hparams(d, augment), device=d), batch)
    assert fused_fbank.launches == 1
    assert report["sign_only"] <= 0.01 * report["params"], report


def test_train_step_launches_k1_once_per_micro_batch(cuda):
    tr = _trainer_factory(recipe.DEFAULT_SCHEDULE)("cuda")
    batches = _train_batches(4, seed=1)
    fused_fbank.launches = 0
    losses = [tr.fit_batch(b, 0) for b in batches]
    torch.cuda.synchronize()
    assert fused_fbank.launches == len(batches)
    assert all(bool(torch.isfinite(x)) for x in losses)
    assert tr.state.opt_state["gen"].count == 1 and tr.state.accum_count == 1


def test_train_step_launches_no_k8(cuda):
    """The training step runs the ConvAutoencoder under autograd: no K8."""
    tr = _trainer_factory(recipe.DEFAULT_SCHEDULE)("cuda")
    before = k8.norm_silu.launches
    for b in _train_batches(2, seed=3):
        tr.fit_batch(b, 0)
        assert k8.norm_silu.launches == before
    torch.cuda.synchronize()


# -- the ASR and LM recipes -----------------------------------------------------

ASR_TRAIN = dict(d_model=64, nhead=4, num_encoder_layers=2, num_decoder_layers=1, d_ffn=128, output_neurons=100)
# card against CPU: losses within 1e-5 relative, measured; the moments and
# parameters as tools/train_parity.py holds the anonymizer's (cuDNN and cuBLAS
# sum in other orders, and CTC's CUDA backward accumulates in its own)
RECIPE_LOSS_RTOL = 1e-5
CTC_GRAD_ATOL = 1e-5
CTC_INFEASIBLE_GRAD_ATOL = 2e-3  # the ~1e5 loss's f32 limit (tests/test_torch_seq_losses.py)


def _recipe_hparams(device, tmp, **extra) -> dict:
    from speech_anonymization_tpu_torch.train.epoch_loop import EpochCounter
    from speech_anonymization_tpu_torch.train.logger import FileTrainLogger

    return {"seed": 3, "gradient_clipping": 5.0, "noam_annealing": NoamScheduler(1.0, 10, 64),
            "compute_features": Fbank(device=device), "normalize": InputNormalizer(dim=80),
            "train_logger": FileTrainLogger(str(tmp / device / "log.txt")), "epoch_counter": EpochCounter(2),
            **extra}


def _asr_batch(b=4, samples=32_000, seed=30):
    from types import SimpleNamespace

    wavs, lens, _, tokens = train_batch(b, samples, seed, vocab=ASR_TRAIN["output_neurons"], tokens=12)
    rng = np.random.default_rng(seed)
    n = rng.integers(6, 12, b)
    toks = np.where(np.arange(12)[None] < n[:, None], tokens.numpy()[:, :12], 0)
    bos = np.concatenate([np.ones((b, 1), np.int64), toks], 1)
    eos = np.zeros_like(bos)
    for i, k in enumerate(n):
        eos[i, : k + 1] = [*toks[i, :k], 2]
    return SimpleNamespace(sig=(wavs.numpy(), lens.numpy()), tokens_bos=(bos, (n + 1) / 13.0),
                           tokens_eos=(eos, ((n + 1) / 13.0).astype(np.float32)),
                           tokens=(toks, (n / 12.0).astype(np.float32)), id=[str(i) for i in range(b)],
                           wrd=["a"] * b)


def _opt_and_param_gaps(card_opt, cpu_opt, card_params, cpu_params, start, lr) -> dict:
    host = lambda d: {k: v.detach().cpu().numpy() for k, v in d.items()}  # noqa: E731
    mu, nu, cmu, cnu = host(card_opt.mu), host(card_opt.nu), host(cpu_opt.mu), host(cpu_opt.nu)
    assert card_opt.count == cpu_opt.count == 1
    failures = []
    tensor_gaps(mu, cmu, MOMENT_RTOL, "mu", failures)
    tensor_gaps(nu, cnu, MOMENT_RTOL, "nu", failures)
    got, want = host(card_params), host(cpu_params)
    sign_only = sum(step_gaps(k, got[k], want[k], start[k], (mu[k], cmu[k]), (nu[k], cnu[k]), 1, lr,
                              noise_floor(cmu), failures)[0] for k in want)
    assert not failures, failures
    return {"sign_only": sign_only, "params": sum(v.size for v in want.values())}


def test_asr_train_step_on_card_matches_cpu(cuda, tmp_path):
    """One ASRBrain micro-batch at accumulation 1 (4 x 2 s, CTC + KLdiv) on the
    card and on the CPU from the same seeded weights: loss, normalizer, Adam's
    moments and the updated parameters; K1 launched once."""
    from speech_anonymization_tpu_torch.recipes.asr_train import ASRBrain

    brains = {d: ASRBrain(_recipe_hparams(d, tmp_path, **ASR_TRAIN), None, device=d) for d in ("cuda", "cpu")}
    start = {k: v.detach().numpy().copy() for k, v in brains["cpu"].params.items()}
    batch = _asr_batch()
    fused_fbank.launches = 0
    losses = {d: float(b.fit_batch(batch, 1)) for d, b in brains.items()}
    assert fused_fbank.launches == 1
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=RECIPE_LOSS_RTOL)
    for k in NormalizerState._fields:
        np.testing.assert_allclose(getattr(brains["cuda"].state.norm_state, k).cpu().numpy(),
                                   getattr(brains["cpu"].state.norm_state, k).numpy(), rtol=1e-4, atol=1e-4)
    report = _opt_and_param_gaps(brains["cuda"].state.opt_state["opt"], brains["cpu"].state.opt_state["opt"],
                                 brains["cuda"].params, brains["cpu"].params, start,
                                 brains["cpu"].noam.current_lr)
    assert report["sign_only"] <= 0.01 * report["params"], report


@pytest.mark.parametrize("feasible", [True, False])
def test_ctc_loss_on_card_matches_cpu(cuda, feasible):
    """F.ctc_loss's CUDA kernels on the rows an alignment fits, the plain
    recursion on the one none fits (5 repeated labels over 3 frames): value
    and gradient w.r.t. the logits, card against CPU."""
    from speech_anonymization_tpu_torch.losses.basic import ctc_feasible, ctc_loss

    rng = np.random.default_rng(40)
    logits = (2.0 * rng.standard_normal((4, 12, 7))).astype(np.float32)
    targets = rng.integers(1, 7, (4, 5))
    lens = np.array([1.0, 0.75, 0.5, 0.9 if feasible else 0.25], np.float32)
    if not feasible:
        targets[3] = 3
    tg_lens = np.array([1.0, 0.6, 0.4, 1.0], np.float32)
    assert ctc_feasible(targets, lens, 12, tg_lens)[3] == feasible
    out = {}
    for d in ("cuda", "cpu"):
        x = torch.tensor(logits, device=d, requires_grad=True)
        loss = ctc_loss(torch.log_softmax(x, -1), torch.tensor(targets, device=d), torch.tensor(lens, device=d),
                        torch.tensor(tg_lens, device=d), reduction="sum", host=(targets, lens, tg_lens))
        (grad,) = torch.autograd.grad(loss, x)
        out[d] = (float(loss.detach()), grad.cpu().numpy())
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=RECIPE_LOSS_RTOL)
    np.testing.assert_allclose(out["cuda"][1][:3], out["cpu"][1][:3], atol=CTC_GRAD_ATOL)
    np.testing.assert_allclose(out["cuda"][1][3], out["cpu"][1][3],
                               atol=CTC_GRAD_ATOL if feasible else CTC_INFEASIBLE_GRAD_ATOL)
    assert feasible or out["cpu"][0] > 1e5


def test_lm_dropout_step_on_card_matches_cpu(cuda, tmp_path):
    """One LMBrain step at lm_dropout 0.1 (batch 6 x 16 tokens) on the card and
    on the CPU from the same seeded weights and the same given masks."""
    from speech_anonymization_tpu_torch.models.transformer import DropoutRng
    from speech_anonymization_tpu_torch.recipes.lm_train import LMBrain

    widths = {"output_neurons": 100, "lm_d_model": 64, "lm_nhead": 4, "lm_num_layers": 2, "lm_d_ffn": 128}
    brains = {d: LMBrain(_recipe_hparams(d, tmp_path, **widths, lm_dropout=0.1, lm_label_smoothing=0.1), None,
                         device=d) for d in ("cuda", "cpu")}
    rng = np.random.default_rng(50)
    bos = rng.integers(3, 100, (6, 16)).astype(np.int32)
    bos[:, 0] = 1
    bos[3, 9:] = 0
    eos = np.roll(bos, -1, 1)
    eos[:, -1] = 2
    batch = (bos, eos, np.full(6, 1.0, np.float32))
    g = torch.Generator().manual_seed(51)
    shapes = [(6, 4, 16, 16), (6, 16, 128)] * 2  # a layer's attention weights, then its FFN's hidden
    masks = [torch.rand(s, generator=g) < 0.9 for s in shapes]
    start = {k: v.detach().numpy().copy() for k, v in brains["cpu"].params.items()}
    losses = {}
    for d, b in brains.items():
        b.dropout_rng = DropoutRng(masks=list(masks))
        losses[d] = float(b.fit_batch(batch, 1))
        assert not b.dropout_rng.masks
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=RECIPE_LOSS_RTOL)
    report = _opt_and_param_gaps(brains["cuda"].opt_state, brains["cpu"].opt_state, brains["cuda"].params,
                                 brains["cpu"].params, start, brains["cpu"].noam.current_lr)
    assert report["sign_only"] <= 0.01 * report["params"], report


# the reference's own checkpoints: the sb_compat ASR and LM

SB_ASR = dict(d_model=256, nhead=4, num_encoder_layers=2, num_decoder_layers=2, d_ffn=512,
              output_neurons=64)


@torch.no_grad()
def test_sb_compat_asr_on_card_matches_cpu(cuda):
    """``ASRModel(sb_compat=True)`` (SpeechBrain's front end, exact GELU, final
    norms) from flax's initialisers on one seed: the full forward on the card
    against the CPU (1e-3, the card-vs-CPU recon bound), and the card's cached
    decode (K3) against its ``decode_one_step`` (2e-4)."""
    models = {d: ASRModel(**SB_ASR, sb_compat=True, generator=torch.Generator().manual_seed(3), device=d).eval()
              for d in ("cpu", "cuda")}
    rng = np.random.default_rng(4)
    feats = torch.from_numpy(rng.standard_normal((2, 250, 80)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(3, 64, (2, 8)))
    toks[:, 0] = 1
    lens = torch.tensor([1.0, 0.8])
    want = models["cpu"](feats, toks, lens)
    got = models["cuda"](feats.to(cuda), toks.to(cuda), lens.to(cuda))
    for name, g, w in zip(("enc", "dec", "p_ctc", "p_seq"), got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), atol=1e-3, rtol=0, err_msg=name)
    m = models["cuda"]
    enc, tk, ln = got[0], toks.to(cuda), lens.to(cuda)
    cache = make_kv_cache(2, 8, 2, 4, 64, device=cuda)
    cross = m.cross_kv(enc)
    counts = attention_step.launches
    for step in range(8):
        full = m.decode_one_step(tk, enc, ln, step)
        cached, cache = m.decode_step_cached(tk[:, step], enc, cache, step, ln, cross)
        np.testing.assert_allclose(cached.cpu().numpy(), full.cpu().numpy(), atol=2e-4, rtol=0,
                                   err_msg=str(step))
    assert attention_step.launches - counts == 2 * 8


def test_sb_compat_lm_fused_decode_runs_exact_gelu_k7(cuda):
    """A small sb_compat ASR with a d_model 768 sb_compat LM whose cache takes
    the fused page-64 layout (220 steps: U 256): every LM step is one K7
    launch of the exact-GELU build."""
    model = ASRModel(d_model=128, nhead=4, num_encoder_layers=1, num_decoder_layers=1, d_ffn=128,
                     output_neurons=40, sb_compat=True, generator=torch.Generator().manual_seed(0),
                     device=cuda).eval()
    lm = TransformerLM(vocab=40, d_model=768, nhead=12, num_layers=2, d_ffn=1536, sb_compat=True,
                       generator=torch.Generator().manual_seed(1), device=cuda).eval()
    feats = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 900, 80)).astype(
        np.float32)).to(cuda)
    lens = torch.tensor([1.0, 0.85], device=cuda)
    bundle = ASRBundle(model, _Tok(), {"test_beam_size": 4, "ctc_weight_decode": 0.4, "temperature": 1.15,
                                       "max_decode_steps": 220}, lm=lm)
    assert bundle.lm_mega is not None and bundle.lm_weight == 0.6
    counts = (lm_megastep.launches, lm_megastep.exact_launches)
    toks, lengths, scores = bundle._decode_test(feats, lens)
    torch.cuda.synchronize()
    assert (lm_megastep.launches - counts[0], lm_megastep.exact_launches - counts[1]) == (220, 220)
    assert torch.isfinite(scores).all() and toks.shape == (2, 220)


@torch.no_grad()
def test_reference_loaders_on_card(cuda, tmp_path):
    """``load_reference_asr`` / ``load_reference_lm`` on cuda from seeded
    SpeechBrain-layout files: every parameter on the card and from the file
    (a strict load; the counts equal), and the same outputs as the CPU load."""
    asr_w = dict(d_model=256, num_encoder_layers=2, num_decoder_layers=2, d_ffn=512)
    lm_w = dict(d_model=256, num_layers=2, d_ffn=512)
    files = {"asr": sb_layout.write_seeded(str(tmp_path / "asr.ckpt"), sb_layout.asr_layout(**asr_w, vocab=64), 0),
             "lm": sb_layout.write_seeded(str(tmp_path / "lm.ckpt"), sb_layout.lm_layout(**lm_w, vocab=64), 1)}
    asr = {d: load_reference_asr(str(tmp_path / "asr.ckpt"), nhead=4, output_neurons=64, device=d, **asr_w)
           for d in ("cpu", "cuda")}
    lm = {d: load_reference_lm(str(tmp_path / "lm.ckpt"), nhead=4, vocab=64, device=d, **lm_w)
          for d in ("cpu", "cuda")}
    for name, models in (("asr", asr), ("lm", lm)):
        params = list(models["cuda"].parameters())
        assert all(p.is_cuda for p in params)
        assert sum(p.numel() for p in params) == sum(v.numel() for v in files[name].values())
    rng = np.random.default_rng(5)
    feats = torch.from_numpy(rng.standard_normal((2, 120, 80)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(3, 64, (2, 6)))
    toks[:, 0] = 1
    lens = torch.ones(2)
    want = asr["cpu"](feats, toks, lens)
    got = asr["cuda"](feats.to(cuda), toks.to(cuda), lens.to(cuda))
    for name, g, w in zip(("enc", "dec", "p_ctc", "p_seq"), got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), atol=1e-3, rtol=0, err_msg=name)
    np.testing.assert_allclose(lm["cuda"](toks.to(cuda)).cpu().numpy(), lm["cpu"](toks).numpy(), atol=1e-3,
                               rtol=0)


def test_one_rank_nccl_mesh_on_card(cuda, tmp_path):
    """``initialize_distributed`` over NCCL at world size 1 (a file store):
    the barrier and ``run_on_main`` complete, the mesh lives on the card with
    one rank, and ``psum``/``pmax``/``all_gather_rows`` hand back their
    input, launching nothing; the group is torn down after."""
    from speech_anonymization_tpu_torch.parallel import (all_gather_rows, global_barrier, initialize_distributed,
                                                         is_main_process, make_mesh, pmax, psum, run_on_main,
                                                         shutdown_distributed)

    assert initialize_distributed(f"file://{tmp_path / 'store'}", 1, 0, backend="nccl")
    try:
        assert torch.distributed.get_backend() == "nccl" and is_main_process()
        global_barrier()
        assert run_on_main(lambda a, b: a * b, 6, b=7) == 42
        mesh = make_mesh()
        assert mesh.device.type == "cuda" and (mesh.size("data"), mesh.group("data")) == (1, None)
        x = torch.arange(6.0, device=cuda).reshape(2, 3)
        assert psum(x, mesh) is x and pmax(x, mesh) is x and all_gather_rows(x, mesh) is x
    finally:
        shutdown_distributed()
    assert not torch.distributed.is_initialized()
