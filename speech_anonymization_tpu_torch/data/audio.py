"""Audio IO for the host-side input pipeline.

Counterpart of ``speech_anonymization_tpu/data/audio.py`` (the reference's
soundfile and ``sb.dataio.dataio.read_audio``), a copy: the port imports
nothing of the JAX package.

The repo's native C++ loader (``native/libsatpu_audio.so``, from
``native/audio_io.cc``) is used through ctypes when it is present: it decodes
WAV (PCM16/24/32/float) and FLAC (LibriSpeech's format) without any external
library. Without it, or for a file it cannot decode, a pure-numpy WAV reader
serves.
"""

from __future__ import annotations

import ctypes
import os
import struct

import numpy as np

_NATIVE = None


def _native_lib():
    global _NATIVE
    if _NATIVE is None:
        path = os.path.join(os.path.dirname(__file__), "..", "..", "native", "libsatpu_audio.so")
        path = os.path.abspath(path)
        if os.path.exists(path):
            lib = ctypes.CDLL(path)
            lib.satpu_read_audio.restype = ctypes.c_longlong
            lib.satpu_read_audio.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.satpu_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
            _NATIVE = lib
        else:
            _NATIVE = False
    return _NATIVE


def read_audio(path: str, return_sr: bool = False):
    """Read a mono waveform as float32 in [-1, 1]."""
    lib = _native_lib()
    if lib:
        buf = ctypes.POINTER(ctypes.c_float)()
        sr = ctypes.c_int(0)
        ch = ctypes.c_int(0)
        n = lib.satpu_read_audio(path.encode(), ctypes.byref(buf), ctypes.byref(sr), ctypes.byref(ch))
        if n > 0:
            data = np.ctypeslib.as_array(buf, shape=(n,)).copy()
            lib.satpu_free(buf)
            if ch.value > 1:
                data = data.reshape(-1, ch.value).mean(axis=1)
            return (data, sr.value) if return_sr else data
        # n <= 0: fall through to python reader (unsupported format)
    wav, sr = _read_wav_numpy(path)
    return (wav, sr) if return_sr else wav


def _read_wav_numpy(path: str) -> tuple[np.ndarray, int]:
    """Minimal RIFF/WAVE reader: PCM 16/24/32-bit and IEEE float."""
    with open(path, "rb") as f:
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"not a WAV file: {path}")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            payload = f.read(size + (size & 1))
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", payload[:16])
            elif cid == b"data":
                data = payload[:size]
        if fmt is None or data is None:
            raise ValueError(f"malformed WAV: {path}")
        audio_fmt, channels, sr, _, _, bits = fmt
        if audio_fmt == 3 and bits == 32:
            x = np.frombuffer(data, "<f4").astype(np.float32)
        elif audio_fmt == 1 and bits == 16:
            x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
        elif audio_fmt == 1 and bits == 32:
            x = np.frombuffer(data, "<i4").astype(np.float32) / 2147483648.0
        elif audio_fmt == 1 and bits == 24:
            raw = np.frombuffer(data, np.uint8).reshape(-1, 3)
            x = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"unsupported WAV format {audio_fmt}/{bits}bit: {path}")
        if channels > 1:
            x = x.reshape(-1, channels).mean(axis=1)
        return x, sr


def write_wav(path: str, wav: np.ndarray, sample_rate: int = 16000):
    """Write mono float waveform as PCM16 WAV."""
    x = np.clip(np.asarray(wav, np.float64), -1.0, 1.0)
    pcm = (x * 32767.0).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(pcm)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(pcm)))
        f.write(pcm)


def audio_duration(path: str) -> float:
    """Duration in seconds without decoding the whole file (WAV header or
    native FLAC probe)."""
    try:
        wav, sr = read_audio(path, return_sr=True)
        return len(wav) / sr
    except Exception:
        return 0.0
