"""ctypes loader for the port's native host audio library (port of
parakeet_tpu/native.py).

The windowed-sinc Kaiser resampler (an O(N·32) inner loop), the channel
downmix, int16 → float conversion and preemphasis run in C++
(parakeet_tpu_torch/csrc/parakeet_native.cpp, the reference's
audio_io.cpp numerics); `flac_decode` goes through the FLAC decoder
(csrc/flac_decoder.cpp) that audio/codecs.py loads. The libraries build
with g++ on first use through ops/_build.py `build_host` into
build/parakeet_tpu_torch/, named by a hash of the source and the flags.
Each entry point returns None when the library is unavailable (no g++, or
PARAKEET_NO_NATIVE set), and audio/io.py then runs its numpy form.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("PARAKEET_NO_NATIVE"):
            return None
        from parakeet_tpu_torch.ops._build import build_host

        try:
            lib = ctypes.CDLL(str(build_host("parakeet_native")))
        except (OSError, RuntimeError):
            return None
        c_float_p = ctypes.POINTER(ctypes.c_float)
        c_int16_p = ctypes.POINTER(ctypes.c_int16)
        lib.pk_resample_out_len.restype = ctypes.c_int64
        lib.pk_resample_out_len.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        lib.pk_sinc_resample.restype = None
        lib.pk_sinc_resample.argtypes = [c_float_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, c_float_p]
        lib.pk_downmix_to_mono.restype = None
        lib.pk_downmix_to_mono.argtypes = [c_float_p, ctypes.c_int64, ctypes.c_int, c_float_p]
        lib.pk_int16_to_float.restype = None
        lib.pk_int16_to_float.argtypes = [c_int16_p, ctypes.c_int64, c_float_p]
        lib.pk_preemphasis.restype = ctypes.c_float
        lib.pk_preemphasis.argtypes = [c_float_p, ctypes.c_int64, ctypes.c_float, ctypes.c_float, c_float_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def sinc_resample(x: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    n_out = lib.pk_resample_out_len(len(x), src_rate, dst_rate)
    out = np.empty(n_out, np.float32)
    lib.pk_sinc_resample(_fptr(x), len(x), src_rate, dst_rate, _fptr(out))
    return out


def downmix_to_mono(interleaved: np.ndarray, channels: int) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(interleaved, np.float32)
    frames = len(x) // channels
    out = np.empty(frames, np.float32)
    lib.pk_downmix_to_mono(_fptr(x), frames, channels, _fptr(out))
    return out


def int16_to_float(pcm: np.ndarray) -> np.ndarray | None:
    """int16 PCM → float32 scaled by 1/32768."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(pcm, np.int16)
    out = np.empty(len(x), np.float32)
    lib.pk_int16_to_float(x.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), len(x), _fptr(out))
    return out


def preemphasis(x: np.ndarray, coeff: float = 0.97, prev: float = 0.0):
    """y[i] = x[i] − coeff·x[i−1] with x[−1] = `prev` → (y, the last raw
    sample, the next call's `prev`)."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty_like(x)
    new_prev = lib.pk_preemphasis(_fptr(x), len(x), coeff, prev, _fptr(out))
    return out, float(new_prev)


def flac_decode(data: bytes):
    """FLAC bytes → (interleaved float32, sample_rate, channels), or None
    without the native libraries; ValueError on bytes that do not decode."""
    from parakeet_tpu_torch.audio import codecs

    if _load() is None or not codecs.flac_available():
        return None
    return codecs.flac_decode(data)


__all__ = ["available", "sinc_resample", "downmix_to_mono", "int16_to_float", "preemphasis", "flac_decode"]
