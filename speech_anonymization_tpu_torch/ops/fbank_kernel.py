"""K1: the fused frames -> mel-power kernel and its plain PyTorch twin.

Counterpart of ``speech_anonymization_tpu/ops/pallas/fbank_kernel.py``
(``fused_fbank`` -> ``_fbank_kernel``). The CUDA kernel is
``csrc/fbank.cu``; its header states the bound and the design (the DFT
product on the TF32 tensor cores in three passes). The wrapper
:func:`fused_fbank` launches it for CUDA tensors and uses
:func:`mel_power_plain` only for tensors on the CPU.

Operands are unpadded: ``dft`` is (win, 2*n_bins) = [W*cos | -W*sin] and
``mel`` is (n_bins, n_mels). The kernel reads the DFT as :func:`prepare_dft`
lays it out once (its TF32 halves in mma-fragment order), as the JAX
package's ``prepare_operands`` pads once. The TPU kernel's lane padding
(201 -> 256 bins, 80 -> 128 mels) has no counterpart here.
"""

from __future__ import annotations

import ctypes

import torch

_CHUNK = 16  # window samples per pipeline stage of the kernel
_MAX_MELS = 80


def mel_power_plain(frames: torch.Tensor, dft: torch.Tensor, mel: torch.Tensor) -> torch.Tensor:
    """(..., win) frames -> (..., n_mels) mel power: two fp32 matmuls.

    Counterpart of ``Fbank._mel_power`` (JAX ``ops/fbank.py:207-226``).
    """
    n_bins = mel.shape[0]
    spec = torch.matmul(frames, dft)
    real = spec[..., :n_bins]
    imag = spec[..., n_bins:]
    return torch.matmul(real * real + imag * imag, mel)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties away
    from zero (add half an ulp of the 10-bit mantissa to the magnitude's bits,
    drop the low 13)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def prepare_dft(dft: torch.Tensor) -> torch.Tensor:
    """(win, 2*n_bins) [cos | -sin] -> the kernel's DFT operand, (win / 8, n8,
    32, 4) fp32 with n8 = ceil(2 * n_bins / 8): B interleaves the bins' cos
    and -sin columns (zero past the last bin), split into TF32 halves hi =
    tf32(B), lo = tf32(B - hi); for k8 tile kt, n8 tile nt and lane (g, t) =
    divmod(lane, 4) the float4 is {hi b0, hi b1, lo b0, lo b1}, b0 = B[8 kt +
    t, 8 nt + g], b1 = B[8 kt + t + 4, 8 nt + g] (the B fragment of
    ``mma.sync.m16n8k8`` TF32)."""
    win, two_bins = dft.shape
    n_bins = two_bins // 2
    if win % 8:
        raise ValueError(f"win {win} is not a multiple of 8")
    n8 = -(-two_bins // 8)
    b = dft.new_zeros(win, 8 * n8)
    b[:, 0:two_bins:2] = dft[:, :n_bins]
    b[:, 1:two_bins:2] = dft[:, n_bins:]
    hi = _tf32_rna(b)
    halves = torch.stack([hi, _tf32_rna(b - hi)])  # (2, win, 8 n8)
    # k = 8 kt + 4 i + t, n = 8 nt + g  ->  [kt][nt][g][t][hi/lo][i]
    frag = halves.view(2, win // 8, 2, 4, n8, 8).permute(1, 4, 5, 3, 0, 2)
    return frag.reshape(win // 8, n8, 32, 4).contiguous()


def _check(frames: torch.Tensor, dft: torch.Tensor, mel: torch.Tensor, frag: torch.Tensor) -> None:
    for name, t in (("frames", frames), ("dft", dft), ("mel", mel), ("frag", frag)):
        if t.device != frames.device:
            raise ValueError(f"{name} is on {t.device}, frames on {frames.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    win = frames.shape[-1]
    n_bins, n_mels = mel.shape
    if dft.shape != (win, 2 * n_bins):
        raise ValueError(f"dft shape {tuple(dft.shape)} does not match win {win}, {n_bins} bins")
    if win % _CHUNK or n_mels > _MAX_MELS:
        raise ValueError(f"unsupported fbank shape: win {win}, {n_bins} bins, {n_mels} mels")
    if frag.shape != (win // 8, -(-2 * n_bins // 8), 32, 4):
        raise ValueError(f"frag shape {tuple(frag.shape)} is not prepare_dft's for win {win}, "
                         f"{n_bins} bins")
    if frames.data_ptr() % 16 or frag.data_ptr() % 16:
        raise ValueError("frames and frag must be 16-byte aligned")


def fused_fbank(frames: torch.Tensor, dft: torch.Tensor, mel: torch.Tensor,
                frag: torch.Tensor) -> torch.Tensor:
    """(..., win) fp32 frames -> (..., n_mels) mel power.

    A CUDA tensor launches the kernel of ``csrc/fbank.cu`` (and counts one in
    ``fused_fbank.launches``) on ``frag``, ``prepare_dft(dft)`` made once by
    the caller (``Fbank.dft_frag``); a CPU tensor takes
    :func:`mel_power_plain`. Anything else raises.
    """
    if frames.device.type == "cpu":
        return mel_power_plain(frames, dft, mel)
    if frames.device.type != "cuda":
        raise ValueError(f"fused_fbank runs on cuda or cpu, not {frames.device}")
    _check(frames, dft, mel, frag)
    from ..utils import cuda_build

    lib = cuda_build.load("fbank")
    lib.sa_fbank.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.sa_fbank.restype = ctypes.c_int
    win = frames.shape[-1]
    n_bins, n_mels = mel.shape
    n_rows = frames.numel() // win
    out = torch.empty(*frames.shape[:-1], n_mels, dtype=torch.float32, device=frames.device)
    stream = torch.cuda.current_stream(frames.device).cuda_stream
    err = lib.sa_fbank(frames.data_ptr(), frag.data_ptr(), mel.data_ptr(), out.data_ptr(),
                       n_rows, win, n_bins, n_mels, frames.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"fbank kernel launch failed: CUDA error {err}")
    fused_fbank.launches += 1
    return out


fused_fbank.launches = 0
