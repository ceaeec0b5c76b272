"""K2: the beam-search KV-cache reorder, a row gather of the live positions.

Counterpart of ``speech_anonymization_tpu/ops/pallas/beam_gather.py``
``beam_gather_rows`` and its two TPU kernels, ``_dma_kernel`` (K2a, positions
<= step) and ``_copy_kernel`` (K2b, whole rows). One CUDA kernel,
``csrc/beam_gather.cu``, serves both: whole rows are the case
``step = U - 1``. Its header states the bound and the design. It is a byte
copy, so the int8 caches' codes move exactly as f32 or bf16 elements do (their
(L, N, U) scales are gathered by ``beam_reorder_cache``). The wrapper
:func:`beam_gather` launches it for CUDA tensors and uses
:func:`beam_gather_plain` only for tensors on the CPU.

The gather cannot write in place (a row may be read by several beams after
another beam's row was overwritten), so the caller passes the output buffer:
decode keeps two caches and swaps them every step
(``models.transformer.beam_reorder_cache``).

A source row outside ``[0, N)`` makes the plain twin raise. The kernel cannot
raise without a synchronise, so it leaves that row unwritten and counts it on
the device; :func:`beam_gather_faults` reads and clears the count.
"""

from __future__ import annotations

import ctypes

import torch

_DTYPES = (torch.float32, torch.bfloat16, torch.int8)  # a byte copy: any element type
_MAX_PIECES = 65535  # grid y: 16 KB pieces of one row's live span
_fn = None  # the bound C entry point, set on first launch
_faults: dict[torch.device, torch.Tensor] = {}  # per-device count of out-of-range sources


def _entry():
    """``sa_beam_gather`` with its argument types, bound once."""
    global _fn
    if _fn is None:
        from ..utils import cuda_build

        fn = cuda_build.load("beam_gather").sa_beam_gather
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 2 + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _fault_counter(device: torch.device) -> torch.Tensor:
    counter = _faults.get(device)
    if counter is None:
        counter = _faults[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return counter


def beam_gather_faults(device) -> int:
    """(layer, row) pairs the kernel left unwritten on ``device`` for an
    out-of-range source since the last call; clears the count (synchronises)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    counter = _faults.get(device)
    if counter is None:
        return 0
    n = int(counter.item())
    counter.zero_()
    return n


def _span(a: torch.Tensor, step: int | None) -> int:
    """Number of leading positions to copy: step + 1, or every position."""
    u = a.shape[2]
    if step is None:
        return u
    if not 0 <= step < u:
        raise ValueError(f"step {step} outside the cache's {u} positions")
    return step + 1


def beam_gather_plain(a: torch.Tensor, src: torch.Tensor, step: int | None,
                      out: torch.Tensor) -> torch.Tensor:
    """``out[:, n, :step+1] = a[:, src[n], :step+1]``; the rest of ``out`` is kept."""
    p = _span(a, step)
    out[:, :, :p] = torch.index_select(a[:, :, :p], 1, src.long())
    return out


def _check(a: torch.Tensor, src: torch.Tensor, out: torch.Tensor) -> None:
    if a.ndim != 4:
        raise ValueError(f"expected an (L, N, U, M) cache, got shape {tuple(a.shape)}")
    if a.dtype not in _DTYPES:
        raise TypeError(f"beam_gather takes float32, bfloat16 or int8 caches, got {a.dtype}")
    if out.shape != a.shape or out.dtype != a.dtype:
        raise ValueError("out must have the cache's shape and dtype")
    if src.dtype != torch.int32 or src.shape != (a.shape[1],):
        raise ValueError(f"src must be ({a.shape[1]},) int32, got {tuple(src.shape)} {src.dtype}")
    for name, t in (("a", a), ("src", src), ("out", out)):
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, the cache on {a.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    row_bytes = a.shape[3] * a.element_size()
    if row_bytes % 16 or a.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("cache rows and buffers must be 16-byte aligned")
    a_end = a.data_ptr() + a.numel() * a.element_size()
    out_end = out.data_ptr() + out.numel() * out.element_size()
    if a.data_ptr() < out_end and out.data_ptr() < a_end:
        raise ValueError("out must not overlap the cache it gathers from")


def beam_gather(a: torch.Tensor, src: torch.Tensor, step: int | None,
                out: torch.Tensor) -> torch.Tensor:
    """Gather rows ``src`` of an (L, N, U, M) cache into ``out``, positions <= ``step``.

    ``step=None`` copies whole rows. A CUDA tensor launches the kernel of
    ``csrc/beam_gather.cu`` (and counts one in ``beam_gather.launches``); a CPU
    tensor takes :func:`beam_gather_plain`. Anything else raises. A source
    row out of range is counted in :func:`beam_gather_faults`, not raised.
    """
    if a.device.type == "cpu":
        return beam_gather_plain(a, src, step, out)
    if a.device.type != "cuda":
        raise ValueError(f"beam_gather runs on cuda or cpu, not {a.device}")
    _check(a, src, out)
    layers, n, u, m = a.shape
    row_bytes = u * m * a.element_size()
    span_bytes = _span(a, step) * m * a.element_size()
    if span_bytes // (16 * 1024) >= _MAX_PIECES:
        raise ValueError(f"a row span of {span_bytes} bytes exceeds the kernel's grid")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _entry()(a.data_ptr(), out.data_ptr(), src.data_ptr(), layers, n, row_bytes, span_bytes,
                   _fault_counter(a.device).data_ptr(), a.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"beam_gather kernel launch failed: CUDA error {err}")
    beam_gather.launches += 1
    return out


beam_gather.launches = 0
