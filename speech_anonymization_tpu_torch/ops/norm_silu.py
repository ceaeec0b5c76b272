"""K8: a convolution's bias, InstanceNorm and SiLU in one pass, and its plain twin.

No TPU kernel counterpart: the JAX package leaves the ConvAutoencoder's block
epilogue, ``glu(instance_norm(conv(x) + b))``, to XLA. The port's inference
path (``models/autoencoders.py`` without autograd) runs each convolution
without its bias and hands the output to :func:`norm_silu`, which adds the
bias as it loads each element, normalises each (item, channel) row over time
and applies the SiLU, reading and writing the tensor once. The CUDA kernel
is ``csrc/norm_silu.cu``; its header states the bound and the design.
:func:`norm_silu` launches it for CUDA tensors and takes
:func:`norm_silu_plain` for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# floats of a row one block holds, at most: two blocks share an SM (on an H100,
# 13% less time than one block an SM, at 57,344, on rows of 40,320 and 80,640)
CHUNK = 27_000
MAX_CHUNK = 57_344    # the most one block can hold (224 KB of shared memory)
MAX_CLUSTER = 8       # blocks a row is split over, at most
# the longest row one cluster holds (5,734 frames of 80 mels); longer rows
# take the kernel's two streaming launches, which read the row twice
MAX_LENGTH = MAX_CLUSTER * MAX_CHUNK
STREAM_TILE = 8192    # floats a block of the streaming launches takes (csrc kStreamTile)


def norm_silu_plain(x: torch.Tensor, bias: torch.Tensor, weight: torch.Tensor | None = None,
                    beta: torch.Tensor | None = None, eps: float = 1e-5) -> torch.Tensor:
    """(B, C, L) -> ``glu(instance_norm(x + bias))`` with the affine ``weight``
    and ``beta`` (biased variance), or ``glu(x + bias)`` without them; ``glu``
    is the reference's SiLU, ``y * sigmoid(y)``."""
    y = x + bias[:, None]
    if weight is not None:
        y = F.instance_norm(y, weight=weight, bias=beta, eps=eps)
    return y * torch.sigmoid(y)


def _check(x: torch.Tensor, bias: torch.Tensor, weight, beta) -> None:
    if x.dim() != 3:
        raise ValueError(f"x must be (B, C, L), got shape {tuple(x.shape)}")
    c = x.shape[1]
    for name, t in (("x", x), ("bias", bias), ("weight", weight), ("beta", beta)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t is not x and t.shape != (c,):
            raise ValueError(f"{name} must be ({c},), got {tuple(t.shape)}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")


def norm_silu(x: torch.Tensor, bias: torch.Tensor, weight: torch.Tensor | None = None,
              beta: torch.Tensor | None = None, eps: float = 1e-5) -> torch.Tensor:
    """(B, C, L) fp32 -> :func:`norm_silu_plain` of the same operands.

    A CUDA tensor launches the kernels of ``csrc/norm_silu.cu`` and counts
    them in ``norm_silu.launches``: one, with rows longer than ``CHUNK``
    floats split over a cluster of ceil(L / CHUNK) blocks, or of 8 where that
    is more; two (the streaming launches) for the norm on rows longer than
    ``MAX_LENGTH``. A CPU tensor takes :func:`norm_silu_plain`. Anything else
    raises.
    """
    if (weight is None) != (beta is None):
        raise ValueError("weight and beta come together")
    if x.device.type == "cpu":
        return norm_silu_plain(x, bias, weight, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"norm_silu runs on cuda or cpu, not {x.device}")
    _check(x, bias, weight, beta)
    from ..utils import cuda_build

    lib = cuda_build.load("norm_silu")
    b, c, length = x.shape
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    device = x.device.index or 0
    vecs = (bias.data_ptr(), None if weight is None else weight.data_ptr(),
            None if beta is None else beta.data_ptr())
    if weight is not None and length > MAX_LENGTH:
        ws = torch.empty(2 * b * c * -(-length // STREAM_TILE), dtype=torch.float32, device=x.device)
        lib.sa_norm_silu_long.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                                          + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.sa_norm_silu_long.restype = ctypes.c_int
        err = lib.sa_norm_silu_long(x.data_ptr(), out.data_ptr(), *vecs, ws.data_ptr(), ws.numel(),
                                    b * c, c, length, eps, device, stream)
        launched = 2
    else:
        lib.sa_norm_silu.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.sa_norm_silu.restype = ctypes.c_int
        # eight blocks' equal shares where eight of CHUNK fall short
        chunk = max(CHUNK, 4 * -(-length // (4 * MAX_CLUSTER)))
        err = lib.sa_norm_silu(x.data_ptr(), out.data_ptr(), *vecs, b * c, c, length, chunk, eps, device, stream)
        launched = 1
    if err != 0:
        raise RuntimeError(f"norm_silu kernel launch failed: CUDA error {err}")
    _COUNTED.launches += launched
    return out


norm_silu.launches = 0
# the counter's function object, held apart from the module's name, which a
# profiler may replace with a recording wrapper (port_bench/trace.py)
_COUNTED = norm_silu
