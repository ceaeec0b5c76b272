"""Pitch analysis and normalization: host-side preprocessing of the
pitch-norm gender recipe.

Counterpart of ``speech_anonymization_tpu/data/pitch.py``, a copy (the port
imports nothing of the JAX package). It replaces the reference's pyworld use
(gender_classifier_train_pitch_norm.py:253-258): decompose, shift the voiced
F0 contour so its mean hits ``target_f0`` (500 Hz there), resynthesize.
Backed by the repo's native C++ vocoder in ``native/libsatpu_audio.so``
(``native/world_vocoder.cc``: a WORLD-class analysis and minimum-phase
resynthesis; ``method="psola"``: the TD-PSOLA resynthesis of
``native/world_lite.cc``), through ctypes and the port's ``data/audio.py``
loader. Without the library the pure-numpy tracker and PSOLA serve; as in
the JAX package, a native call that fails (returns no samples) falls
through to numpy PSOLA too. :data:`SERVED` counts which path served each
:func:`pitch_normalize` and :func:`track_f0` call.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .audio import _native_lib

_PITCH_BOUND = False

# calls served by the native library and by the numpy fallback
SERVED = {"native": 0, "numpy": 0}


def _bind_pitch(lib):
    global _PITCH_BOUND
    if not _PITCH_BOUND:
        lib.satpu_pitch_normalize.restype = ctypes.c_longlong
        lib.satpu_pitch_normalize.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong,
            ctypes.c_int,
            ctypes.c_double,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ]
        lib.satpu_track_f0.restype = ctypes.c_longlong
        lib.satpu_track_f0.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.satpu_world_pitch_normalize.restype = ctypes.c_longlong
        lib.satpu_world_pitch_normalize.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong,
            ctypes.c_int,
            ctypes.c_double,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ]
        lib.satpu_world_fft_size.restype = ctypes.c_int
        lib.satpu_world_fft_size.argtypes = [ctypes.c_int]
        lib.satpu_world_analyze.restype = ctypes.c_longlong
        lib.satpu_world_analyze.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.satpu_world_synthesize.restype = ctypes.c_longlong
        lib.satpu_world_synthesize.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_longlong,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_float),
        ]
        _PITCH_BOUND = True


def track_f0(wav: np.ndarray, sr: int = 16000):
    """F0 contour (Hz; 0 = unvoiced) at 5 ms hop. Returns (f0, hop)."""
    lib = _native_lib()
    x = np.ascontiguousarray(wav, np.float32)
    if lib:
        _bind_pitch(lib)
        max_frames = len(x) // int(sr * 0.005) + 2
        f0 = np.zeros(max_frames, np.float64)
        hop = ctypes.c_int(0)
        m = lib.satpu_track_f0(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(x),
            sr,
            f0.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            max_frames,
            ctypes.byref(hop),
        )
        SERVED["native"] += 1
        return f0[: max(m, 0)], hop.value
    SERVED["numpy"] += 1
    return _track_f0_numpy(x, sr)


def pitch_normalize(
    wav: np.ndarray, sr: int = 16000, target_f0: float = 500.0,
    method: str = "world",
) -> np.ndarray:
    """Shift voiced F0 mean to target_f0, preserving the envelope.

    ``method="world"`` (default) runs the full WORLD-class vocoder
    (analyze -> shift contour -> minimum-phase resynthesis, matching the
    reference's pw.wav2world/pw.synthesize character, including re-rendered
    unvoiced/aperiodic content); ``method="psola"`` uses the TD-PSOLA
    grain resynthesis (unvoiced regions pass through unchanged).
    """
    lib = _native_lib()
    x = np.ascontiguousarray(wav, np.float32)
    if lib:
        _bind_pitch(lib)
        entry = (
            lib.satpu_world_pitch_normalize if method == "world"
            else lib.satpu_pitch_normalize
        )
        out = ctypes.POINTER(ctypes.c_float)()
        n = entry(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(x),
            sr,
            float(target_f0),
            ctypes.byref(out),
        )
        if n > 0:
            res = np.ctypeslib.as_array(out, shape=(n,)).copy()
            lib.satpu_free(out)
            SERVED["native"] += 1
            return res
    SERVED["numpy"] += 1
    return _pitch_normalize_numpy(x, sr, target_f0)


def world_analyze(wav: np.ndarray, sr: int = 16000):
    """WORLD-class decomposition (native only): returns (f0, sp, ap, hop).

    sp/ap are (n_frames, nfft/2+1): CheapTrick-class squared-harmonic-
    amplitude envelope and per-band HNR aperiodicity in [0.001, 0.999].
    Raises RuntimeError when the native library is unavailable.
    """
    lib = _native_lib()
    if not lib:
        raise RuntimeError("world_analyze requires the native library")
    _bind_pitch(lib)
    x = np.ascontiguousarray(wav, np.float32)
    bins_guess = lib.satpu_world_fft_size(sr) // 2 + 1
    max_frames = len(x) // max(int(sr * 0.005), 1) + 2
    f0 = np.zeros(max_frames, np.float64)
    sp = np.zeros((max_frames, bins_guess), np.float64)
    ap = np.zeros((max_frames, bins_guess), np.float64)
    hop = ctypes.c_int(0)
    bins = ctypes.c_int(0)
    m = lib.satpu_world_analyze(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(x), sr,
        f0.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        sp.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ap.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        max_frames, ctypes.byref(hop), ctypes.byref(bins),
    )
    if m <= 0:
        raise ValueError("audio too short for WORLD analysis")
    assert bins.value == bins_guess
    return f0[:m], sp[:m], ap[:m], hop.value


def world_synthesize(
    f0: np.ndarray, sp: np.ndarray, ap: np.ndarray, hop: int,
    sr: int = 16000, n_out: int | None = None,
) -> np.ndarray:
    """Resynthesize from (possibly modified) WORLD parameters (native only)."""
    lib = _native_lib()
    if not lib:
        raise RuntimeError("world_synthesize requires the native library")
    _bind_pitch(lib)
    f0 = np.ascontiguousarray(f0, np.float64)
    sp = np.ascontiguousarray(sp, np.float64)
    ap = np.ascontiguousarray(ap, np.float64)
    if n_out is None:
        n_out = (len(f0) - 1) * hop + int(sr * 0.005)
    out = np.zeros(n_out, np.float32)
    n = lib.satpu_world_synthesize(
        f0.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        sp.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ap.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(f0), sp.shape[1], int(hop), sr, n_out,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if n <= 0:
        raise ValueError("world_synthesize failed (bad shapes?)")
    return out


# -- numpy fallback (same algorithm) -------------------------------------------


def _track_f0_numpy(x: np.ndarray, sr: int, f0_min=70.0, f0_max=400.0, thresh=0.45):
    hop = int(sr * 0.005)
    win = int(sr * 0.040)
    lag_min, lag_max = int(sr / f0_max), int(sr / f0_min)
    n_frames = max((len(x) - win) // hop + 1, 0)
    f0 = np.zeros(n_frames)
    for fi in range(n_frames):
        seg = x[fi * hop : fi * hop + win].astype(np.float64)
        seg = seg - seg.mean()
        if (seg ** 2).sum() < 1e-8:
            continue
        ac = np.correlate(seg, seg, "full")[win - 1 :]
        norm0 = ac[0] + 1e-12
        lags = np.arange(lag_min, min(lag_max + 1, win))
        # normalized by energy of both windows (approx via ac[0])
        r = ac[lags] / norm0
        r_max = r.max()
        if r_max > thresh:
            # smallest lag within 90% of the max avoids octave errors
            best = int(np.argmax(r >= 0.9 * r_max))
            f0[fi] = sr / lags[best]
    # median-3
    if n_frames >= 3:
        sm = f0.copy()
        sm[1:-1] = np.median(np.stack([f0[:-2], f0[1:-1], f0[2:]]), axis=0)
        f0 = sm
    return f0, hop


def _pitch_normalize_numpy(x: np.ndarray, sr: int, target_f0: float) -> np.ndarray:
    f0, hop = _track_f0_numpy(x, sr)
    voiced = f0[f0 > 0]
    if voiced.size == 0:
        return x.copy()
    shift = target_f0 - voiced.mean()
    n = len(x)

    def f0_at(pos):
        fi = min(int(pos / hop), len(f0) - 1)
        return f0[fi]

    out = np.zeros(n, np.float64)
    norm = np.zeros(n, np.float64)
    syn_pos = 0.0
    src_pos = 0.0
    while syn_pos < n:
        cur = f0_at(src_pos)
        voiced_here = cur > 0
        src_period = sr / cur if voiced_here else hop
        tgt = max(1.0, cur + shift) if voiced_here else 0.0
        syn_period = sr / tgt if voiced_here and tgt > 0 else src_period
        grain = int(2 * src_period)
        center = int(src_pos)
        i = np.arange(grain)
        w = 0.5 - 0.5 * np.cos(2 * np.pi * i / max(grain - 1, 1))
        src_idx = center - grain // 2 + i
        dst_idx = int(syn_pos) - grain // 2 + i
        ok = (src_idx >= 0) & (src_idx < n) & (dst_idx >= 0) & (dst_idx < n)
        np.add.at(out, dst_idx[ok], x[src_idx[ok]] * w[ok])
        np.add.at(norm, dst_idx[ok], w[ok])
        syn_pos += syn_period
        while src_pos + src_period <= syn_pos:
            src_pos += src_period
    mask = norm > 1e-3
    out[mask] /= norm[mask]
    return out.astype(np.float32)
