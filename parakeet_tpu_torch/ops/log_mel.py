"""Fused log-mel spectrogram of one clip: K3.

Replaces the TPU kernel parakeet_tpu/ops/pallas_frontend.py::fused_log_mel
(body _frontend_kernel), the kernel of the reference's
audio/frontend.py::preprocess_audio_fused. On preemphasized, reflect-padded
samples (N,):

    frames x[t·hop : t·hop + n_fft] for t < (N − n_fft)//hop + 1 →
    × window·cos and window·sin of the DFT (f32 matrices built as the
    reference builds them) → re² + im² → × Slaney mel filterbank →
    log(x + 2⁻²⁴)

`fused_log_mel` dispatches on the tensor's device: CUDA tensors run the
hand-written kernel in csrc/log_mel.cu (or raise), CPU tensors run
`fused_log_mel_reference`, the plain torch version. Both are IEEE f32 (the
reference runs Precision.HIGHEST). What the kernel drops from the TPU
kernel: the 128-frame tiles built from overlapping hop rows and the four
shifted hop-block matmuls; it reads the frames straight from the waveform.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from parakeet_tpu_torch.audio.frontend import LOG_GUARD, _hann_symmetric, mel_filterbank
from parakeet_tpu_torch.ops._build import check_rc, load, ptr, stream

_F32 = torch.float32


def _check(n_fft: int, hop: int) -> None:
    if n_fft > 4 * hop:
        raise ValueError("fused_log_mel requires n_fft <= 4*hop")


@functools.lru_cache(maxsize=4)
def window_dft_matrices(n_fft: int, win_length: int) -> tuple[np.ndarray, np.ndarray]:
    """(n_fft, n_fft//2+1) f32 window·cos and window·sin of the real DFT,
    built as the reference builds them: f64 angles −2π·n·f/n_fft → f32 cos
    and sin, then an f32 product with the symmetric Hann window centred in
    the n_fft frame (zero outside it)."""
    n = np.arange(n_fft)[:, None]
    f = np.arange(n_fft // 2 + 1)[None, :]
    ang = -2.0 * math.pi * n * f / n_fft
    cos_m, sin_m = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    window = np.zeros(n_fft, np.float32)
    lpad = (n_fft - win_length) // 2
    window[lpad: lpad + win_length] = _hann_symmetric(win_length)
    return window[:, None] * cos_m, window[:, None] * sin_m


def _filterbank(n_fft, n_mels, sample_rate, f_min, f_max) -> np.ndarray:
    fmax = f_max if f_max else sample_rate / 2.0
    return mel_filterbank(n_fft // 2 + 1, n_mels, float(sample_rate), f_min, fmax)


def fused_log_mel_reference(
    x: torch.Tensor,
    *,
    n_fft: int = 512,
    hop: int = 160,
    win_length: int = 400,
    n_mels: int = 80,
    sample_rate: float = 16000.0,
    f_min: float = 0.0,
    f_max: float | None = None,
) -> torch.Tensor:
    """Plain torch version of the kernel: (N,) f32 → ((N − n_fft)//hop + 1,
    n_mels) f32, the same matrices and order of operations."""
    _check(n_fft, hop)
    wcos, wsin = (torch.from_numpy(m).to(x.device) for m in window_dft_matrices(n_fft, win_length))
    fb = torch.from_numpy(_filterbank(n_fft, n_mels, sample_rate, f_min, f_max)).to(x.device)
    frames = x.to(_F32).unfold(0, n_fft, hop)  # (T, n_fft), a view
    re, im = frames @ wcos, frames @ wsin
    return torch.log((re * re + im * im) @ fb + LOG_GUARD)


@functools.lru_cache(maxsize=8)
def _device_mats(n_fft, win_length, n_mels, sample_rate, f_min, f_max, device):
    """The kernel's operands in its layouts: window·cos and window·sin
    transposed (n_freqs, n_fft), the filterbank transposed (n_mels, n_freqs)."""
    wcos, wsin = window_dft_matrices(n_fft, win_length)
    fb = _filterbank(n_fft, n_mels, sample_rate, f_min, f_max)
    return tuple(torch.from_numpy(np.ascontiguousarray(m.T)).to(device) for m in (wcos, wsin, fb))


def _lib() -> ctypes.CDLL:
    lib = load("log_mel")
    fn = lib.pk_log_mel
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [i] * 5 + [p]
        fn.restype = i
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _lib()


def _launch(x, n_fft, hop, win_length, n_mels, sample_rate, f_min, f_max):
    if x.dtype != _F32 or x.dim() != 1:
        raise TypeError(f"fused_log_mel kernel takes (N,) float32 samples, got {tuple(x.shape)} {x.dtype}")
    if x.shape[0] < n_fft:
        raise ValueError(f"fused_log_mel: {x.shape[0]} samples give no frame of {n_fft}")
    x = x.contiguous()
    t = (x.shape[0] - n_fft) // hop + 1
    n_freqs = n_fft // 2 + 1
    wcos_t, wsin_t, fb_t = _device_mats(n_fft, win_length, n_mels, float(sample_rate), f_min, f_max, x.device)
    power = torch.empty((t, n_freqs), dtype=_F32, device=x.device)
    out = torch.empty((t, n_mels), dtype=_F32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.pk_log_mel(ptr(x), ptr(wcos_t), ptr(wsin_t), ptr(fb_t), ptr(power), ptr(out),
                            t, hop, n_fft, n_freqs, n_mels, stream(x.device))
    check_rc(rc, "fused_log_mel")
    fused_log_mel.launches += 1
    return out


def fused_log_mel(
    x: torch.Tensor,
    *,
    n_fft: int = 512,
    hop: int = 160,
    win_length: int = 400,
    n_mels: int = 80,
    sample_rate: float = 16000.0,
    f_min: float = 0.0,
    f_max: float | None = None,
) -> torch.Tensor:
    """Preemphasized, center-padded samples (N,) → log-mel ((N − n_fft)//hop
    + 1, n_mels) f32; requires n_fft ≤ 4·hop, as the reference does.

    On a CUDA tensor this launches the hand-written kernel or raises; on a
    CPU tensor it runs `fused_log_mel_reference`. Each kernel launch adds
    one to `fused_log_mel.launches`."""
    _check(n_fft, hop)
    kw = dict(n_fft=n_fft, hop=hop, win_length=win_length, n_mels=n_mels,
              sample_rate=sample_rate, f_min=f_min, f_max=f_max)
    if x.device.type == "cuda":
        return _launch(x, **kw)
    if x.device.type == "cpu":
        return fused_log_mel_reference(x, **kw)
    raise ValueError(f"fused_log_mel: no implementation for device {x.device}")


fused_log_mel.launches = 0

__all__ = ["window_dft_matrices", "fused_log_mel", "fused_log_mel_reference", "build"]
