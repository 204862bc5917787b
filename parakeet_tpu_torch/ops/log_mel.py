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
reference runs Precision.HIGHEST). The DFT runs on the shared tiled GEMM
(csrc/ffn_gemm.cuh) with the rows and k slices of
ops/gemm_plan.py::dft_plan; a closing pass forms the power (and the
Nyquist bin), the mel product over each filter's band of nonzero weights
(`filterbank_bands`) and the log. What the kernel drops from the
TPU kernel: the 128-frame tiles built from overlapping hop rows and the
four shifted hop-block matmuls; it reads the frames straight from the
waveform. Like the reference's, it takes one clip per call.

On a mesh K3 runs per clip on each rank (`preprocess_audio_fused`); the
frontend is not split.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from parakeet_tpu_torch.audio.frontend import LOG_GUARD, _hann_symmetric, mel_filterbank
from parakeet_tpu_torch.ops._build import check_rc, load, ptr, refuse_grad, stream
from parakeet_tpu_torch.ops.gemm_plan import GEMM_COLS, dft_cols, dft_plan

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


def dft_tile_matrix(n_fft: int, win_length: int) -> np.ndarray:
    """The DFT GEMM's W (dft_cols(n_fft), n_fft): for bins 0 .. n_fft/2 − 1,
    64 a tile, the tile's 64 window·cos rows and then their 64 window·sin
    rows, so that the GEMM's power epilogue finds re and im of a bin in one
    thread; zero rows past the last bin."""
    wcos, wsin = window_dft_matrices(n_fft, win_length)
    half, bins = GEMM_COLS // 2, n_fft // 2
    w = np.zeros((dft_cols(n_fft), n_fft), np.float32)
    f = np.arange(bins)
    rows = (f // half) * GEMM_COLS + f % half
    w[rows] = wcos[:, :bins].T
    w[rows + half] = wsin[:, :bins].T
    return w


def filterbank_bands(fb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The filterbank (n_freqs, n_mels) as one band per mel filter, from its
    first to its last nonzero weight: (weights (nnz,) f32, first bin
    (n_mels,) int32, offsets (n_mels + 1,) int32). Every weight outside a
    band is 0, so a band's sum in bin order equals the dense column's."""
    lo = np.zeros(fb.shape[1], np.int32)
    off = np.zeros(fb.shape[1] + 1, np.int32)
    weights = []
    for m in range(fb.shape[1]):
        nz = np.flatnonzero(fb[:, m])
        if nz.size:
            lo[m] = nz[0]
            weights.append(fb[nz[0]: nz[-1] + 1, m])
        off[m + 1] = off[m] + (nz[-1] - nz[0] + 1 if nz.size else 0)
    w = np.concatenate(weights).astype(np.float32) if weights else np.zeros(0, np.float32)
    return w, lo, off


@functools.lru_cache(maxsize=8)
def _device_mats(n_fft, win_length, n_mels, sample_rate, f_min, f_max, device):
    """The kernel's operands: the DFT GEMM's W in its tile layout, the
    Nyquist bin's window·cos and window·sin rows (2, n_fft) and the
    filterbank's bands (weights, first bins, offsets)."""
    wcos, wsin = window_dft_matrices(n_fft, win_length)
    nyq = np.stack([wcos[:, n_fft // 2], wsin[:, n_fft // 2]])
    bands = filterbank_bands(_filterbank(n_fft, n_mels, sample_rate, f_min, f_max))
    return tuple(torch.from_numpy(np.ascontiguousarray(m)).to(device)
                 for m in (dft_tile_matrix(n_fft, win_length), nyq, *bands))


def _lib() -> ctypes.CDLL:
    lib = load("log_mel")
    fn = lib.pk_log_mel
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 6 + [i] + [p] * 2 + [i] * 6 + [p]
        fn.restype = i
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _lib()


def _launch(x, n_fft, hop, win_length, n_mels, sample_rate, f_min, f_max):
    refuse_grad("fused_log_mel", x)
    if x.dtype != _F32 or x.dim() != 1:
        raise TypeError(f"fused_log_mel kernel takes (N,) float32 samples, got {tuple(x.shape)} {x.dtype}")
    if x.shape[0] < n_fft:
        raise ValueError(f"fused_log_mel: {x.shape[0]} samples give no frame of {n_fft}")
    if n_fft % 2:
        raise ValueError(f"fused_log_mel kernel takes an even n_fft, got {n_fft}")
    x = x.contiguous()
    if x.data_ptr() % 16:  # the GEMM's 16-byte loads read frames straight from x
        x = x.clone()
    t = (x.shape[0] - n_fft) // hop + 1
    wdft, nyq, band_w, band_lo, band_off = _device_mats(
        n_fft, win_length, n_mels, float(sample_rate), f_min, f_max, x.device)
    plan = dft_plan(t, n_fft)
    spec = (t, n_fft // 2) if plan.splits == 1 else (plan.splits, t, dft_cols(n_fft))
    spec = torch.empty(spec, dtype=_F32, device=x.device)
    out = torch.empty((t, n_mels), dtype=_F32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.pk_log_mel(ptr(x), ptr(wdft), ptr(nyq), ptr(band_w), ptr(band_lo), ptr(band_off),
                            band_w.numel(), ptr(spec), ptr(out), t, hop, n_fft, n_mels, plan.rows,
                            plan.splits, stream(x.device))
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

__all__ = ["window_dft_matrices", "dft_tile_matrix", "filterbank_bands", "fused_log_mel",
           "fused_log_mel_reference", "build"]
