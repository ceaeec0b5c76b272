"""The port on an NVIDIA card: K1, K2, K3 and K4 against their plain twins, and
the anonymization and decode slices on the card against the CPU. Imports no
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Every test skips without a CUDA device (decided at run time, in the fixture).
"""

import copy

import numpy as np
import pytest
import torch

from speech_anonymization_tpu_torch.models import ASRModel, ConvAutoencoder
from speech_anonymization_tpu_torch.ops.attention_step import (
    attention_step,
    attention_step_chunked,
    attention_step_plain,
    cached_attention_step,
)
from speech_anonymization_tpu_torch.ops.beam_gather import (
    beam_gather,
    beam_gather_faults,
    beam_gather_plain,
)
from speech_anonymization_tpu_torch.ops.fbank import Fbank, frame_signal
from speech_anonymization_tpu_torch.ops.fbank_kernel import fused_fbank, mel_power_plain
from speech_anonymization_tpu_torch.ops.normalization import InputNormalizer, NormalizerState
from speech_anonymization_tpu_torch.recipes import anonymizer as recipe
from speech_anonymization_tpu_torch.recipes.asr_bundle import ASRBundle
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


@pytest.mark.parametrize("batch,n", [(1, 0), (1, 10079), (1, 10080), (1, 10240), (3, 32077)])
def test_k1_matches_plain_twin(cuda, batch, n):
    """Row counts 1, 63, 64, 65 and 603: partial, whole and ragged 64-row blocks."""
    fb = Fbank(device=cuda)
    frames = frame_signal(_wavs(batch, n, seed=n).to(cuda)).contiguous()
    before = fused_fbank.launches
    got = fused_fbank(frames, fb.dft, fb.mel)
    torch.cuda.synchronize()
    assert fused_fbank.launches == before + 1
    torch.testing.assert_close(got, mel_power_plain(frames, fb.dft, fb.mel), rtol=1e-4, atol=1e-4)


def test_k1_rejects_bad_operands(cuda):
    fb = Fbank(device=cuda)
    frames = torch.zeros(4, 400, device=cuda)
    with pytest.raises(TypeError):
        fused_fbank(frames.double(), fb.dft, fb.mel)
    with pytest.raises(ValueError):
        fused_fbank(torch.zeros(400, 4, device=cuda).t(), fb.dft, fb.mel)
    with pytest.raises(ValueError):
        fused_fbank(frames[:, :384].contiguous(), fb.dft, fb.mel)
    with pytest.raises(ValueError):
        fused_fbank(frames, fb.dft.cpu(), fb.mel)


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


def test_k2_rejects_bad_operands(cuda):
    a = torch.zeros(2, 8, 16, 96, device=cuda)
    src = torch.arange(8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        beam_gather(a.to(torch.int8), src, 3, torch.empty_like(a, dtype=torch.int8))
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


@pytest.mark.parametrize("dtype,u", [(torch.float32, 208), (torch.float32, 256),
                                     (torch.bfloat16, 424), (torch.bfloat16, 448)])
@pytest.mark.parametrize("kernel", [attention_step, attention_step_chunked])
@pytest.mark.parametrize("step_at,masked_fresh", [(0, False), (63, False), (-1, False), (64, True)])
def test_k3_k4_match_plain_twin(cuda, dtype, u, kernel, step_at, masked_fresh):
    """Both kernels at U just below and above the K3/K4 boundary (213 for f32,
    426 for bf16 at M = 768), N = 5 rows, NaN/Inf beyond the step, masked keys."""
    n, m, nhead = 5, 768, 8
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


def test_k3_k4_reject_bad_operands(cuda):
    q, kh, vh, mask, ck, cv = _attention_inputs(8, 16, 768, torch.float32, 3, seed=9, device=cuda)
    for kernel in (attention_step, attention_step_chunked):
        with pytest.raises(TypeError):
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


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
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
