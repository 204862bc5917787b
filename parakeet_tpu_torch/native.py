"""ctypes loader for the repository's native host audio library (port of
parakeet_tpu/native.py, the part the port calls).

The windowed-sinc Kaiser resampler (an O(N·32) inner loop) and the channel
downmix run in C++ (csrc/parakeet_native.cpp at the repository root, the
reference's audio_io.cpp numerics). The library builds with g++ on first
use through ops/_build.py `build_host` into build/parakeet_tpu_torch/,
named by a hash of the source and the flags. Each entry point returns None
when the library is unavailable (no g++, or PARAKEET_NO_NATIVE set), and
audio/io.py then runs its numpy form.
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
        lib.pk_resample_out_len.restype = ctypes.c_int64
        lib.pk_resample_out_len.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        lib.pk_sinc_resample.restype = None
        lib.pk_sinc_resample.argtypes = [c_float_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, c_float_p]
        lib.pk_downmix_to_mono.restype = None
        lib.pk_downmix_to_mono.argtypes = [c_float_p, ctypes.c_int64, ctypes.c_int, c_float_p]
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


__all__ = ["available", "sinc_resample", "downmix_to_mono"]
