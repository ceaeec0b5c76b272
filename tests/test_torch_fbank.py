"""The port's log-mel frontend and K1's plain twin against the JAX package (CPU)."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_anonymization_tpu.ops.fbank import Fbank as JaxFbank
from speech_anonymization_tpu.ops.fbank import dft_matrices as jax_dft_matrices
from speech_anonymization_tpu.ops.fbank import frame_signal as jax_frame_signal
from speech_anonymization_tpu.ops.fbank import mel_filterbank_matrix as jax_mel_matrix
from speech_anonymization_tpu.ops.pallas.fbank_kernel import fused_fbank as jax_fused_fbank
from speech_anonymization_tpu.ops.pallas.fbank_kernel import prepare_operands
from speech_anonymization_tpu_torch.ops import fbank as port_fbank
from speech_anonymization_tpu_torch.ops.fbank import Fbank, FbankConfig, frame_signal, num_frames
from speech_anonymization_tpu_torch.ops.fbank_kernel import fused_fbank, mel_power_plain
from tests.golden import golden_fbank
from tests.torch_port_helpers import rand_wav, t


def test_matrices_equal_jax():
    cos_j, sin_j = jax_dft_matrices()
    cos_p, sin_p = port_fbank.dft_matrices()
    np.testing.assert_array_equal(cos_p, cos_j)
    np.testing.assert_array_equal(sin_p, sin_j)
    np.testing.assert_array_equal(port_fbank.mel_filterbank_matrix(), jax_mel_matrix())


@pytest.mark.parametrize("n", [400, 4321, 16000, 16159])
@pytest.mark.parametrize("center", [True, False])
def test_framing_equals_jax(n, center):
    wav = rand_wav(2, n, seed=n)
    want = np.asarray(jax_frame_signal(jnp.asarray(wav), center=center))
    got = frame_signal(t(wav), center=center).numpy()
    assert got.shape[1] == num_frames(n, center=center)
    np.testing.assert_array_equal(got, want)


def test_mel_power_plain_matches_jax_xla_and_k1_interpret():
    wav = rand_wav(2, 16000 + 321, seed=7)
    frames_j = jax_frame_signal(jnp.asarray(wav))
    jfb = JaxFbank(use_pallas=False)
    xla = np.asarray(jfb._mel_power(frames_j))
    cos_m, sin_m = jax_dft_matrices()
    dft = np.concatenate([cos_m, sin_m], axis=1)
    dft_p, mel_p = prepare_operands(dft, jax_mel_matrix())
    k1 = np.asarray(jax_fused_fbank(frames_j, dft_p, mel_p, 80, interpret=True))

    fb = Fbank(device="cpu")
    got = mel_power_plain(frame_signal(t(wav)).contiguous(), fb.dft, fb.mel).numpy()
    np.testing.assert_allclose(got, xla, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, k1, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [16000, 35999])
def test_logmel_matches_jax_and_golden(n):
    wav = rand_wav(2, n, seed=3)
    got = Fbank(device="cpu")(t(wav)).numpy()
    want = np.asarray(JaxFbank(use_pallas=False)(jnp.asarray(wav)))
    assert got.shape == want.shape == (2, num_frames(n), 80)
    assert np.abs(got - want).mean() <= 1e-4
    assert np.abs(got - golden_fbank(wav)).mean() <= 1e-3


def test_logmel_without_floor_and_single_waveform():
    wav = rand_wav(1, 8000, seed=5)
    cfg = FbankConfig(top_db_mode="none")
    from speech_anonymization_tpu.ops.fbank import FbankConfig as JaxFbankConfig

    want = np.asarray(JaxFbank(JaxFbankConfig(top_db_mode="none"), use_pallas=False)(jnp.asarray(wav[0])))
    got = Fbank(cfg, device="cpu")(t(wav[0])).numpy()
    assert got.shape == want.shape == (51, 80)
    assert np.abs(got - want).mean() <= 1e-4


def test_cpu_tensor_takes_plain_twin_without_counting():
    fused_fbank.launches = 0
    fb = Fbank(device="cpu")
    frames = frame_signal(t(rand_wav(1, 4000, seed=1))).contiguous()
    got = fused_fbank(frames, fb.dft, fb.mel, fb.dft_frag)
    np.testing.assert_array_equal(got.numpy(), mel_power_plain(frames, fb.dft, fb.mel).numpy())
    assert fused_fbank.launches == 0


def test_non_cuda_device_raises():
    fb = Fbank(device="cpu")
    frames = frame_signal(t(rand_wav(1, 4000, seed=1))).contiguous().to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_fbank(frames, fb.dft.to("meta"), fb.mel.to("meta"), fb.dft_frag.to("meta"))


def test_fbank_defaults_to_cuda():
    assert inspect.signature(Fbank).parameters["device"].default == "cuda"


def _rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 to nearest, ties away (cvt.rna.tf32.f32)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _trunc(x: torch.Tensor) -> torch.Tensor:
    """x as the tensor core reads a TF32 operand: its low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def test_k1_three_pass_tf32_emulated_at_bench_length():
    """K1's arithmetic emulated on the CPU at one utterance of bench.py's
    length (161,120 samples, 1,008 frames): the DFT's TF32 halves read back
    from the kernel's fragment-ordered operand (TF32 values whose sum
    rebuilds the interleaved DFT to within 2^-21), the frames split as the
    kernel splits them (hi rounded, lo = x - hi read by the tensor core),
    three fp32 products (lo*hi + hi*lo + hi*hi) summed in fp32, then the
    fp32 power and mel product. Held to the fp32 twin at K1's rtol/atol 1e-4
    and to the JAX log-mel at 1e-3."""
    wav = rand_wav(1, 161_120, seed=9)
    fb = Fbank(device="cpu")
    win, n_bins = fb.dft.shape[0], fb.mel.shape[0]
    kt, n8 = fb.dft_frag.shape[:2]
    assert fb.dft_frag.shape == (win // 8, 51, 32, 4)
    # fragment order [kt][nt][g][t][hi/lo][i] -> (hi, lo) B, k = 8 kt + 4 i + t, n = 8 nt + g
    halves = fb.dft_frag.view(kt, n8, 8, 4, 2, 2).permute(4, 0, 5, 3, 1, 2).reshape(2, win, 8 * n8)
    hi_b, lo_b = halves
    assert torch.equal(halves, _trunc(halves))  # TF32 values
    inter = torch.zeros(win, 8 * n8)
    inter[:, 0:2 * n_bins:2], inter[:, 1:2 * n_bins:2] = fb.dft[:, :n_bins], fb.dft[:, n_bins:]
    torch.testing.assert_close(hi_b + lo_b, inter, rtol=2.0 ** -21, atol=1e-12)

    frames = frame_signal(t(wav)).contiguous()[0]
    hi_a = _rna(frames)
    lo_a = _trunc(frames - hi_a)
    spec = lo_a @ hi_b + hi_a @ lo_b + hi_a @ hi_b
    power = spec[:, 0:2 * n_bins:2] ** 2 + spec[:, 1:2 * n_bins:2] ** 2
    mel = power @ fb.mel
    np.testing.assert_allclose(mel.numpy(), mel_power_plain(frames, fb.dft, fb.mel).numpy(),
                               rtol=1e-4, atol=1e-4)
    x_db = 10.0 * torch.log10(torch.clamp(mel, min=1e-10))
    x_db = torch.maximum(x_db, x_db.max() - 80.0)
    want = np.asarray(JaxFbank(use_pallas=False)(jnp.asarray(wav)))[0]
    assert np.abs(x_db.numpy() - want).max() <= 1e-3
