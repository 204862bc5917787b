"""Plain log-mel features, written from the NeMo preprocessor's definition
(the JAX package's audio/frontend.py was the pattern): preemphasis 0.97,
reflect pad n_fft/2 on each side (torch.stft center=True), a symmetric
Hann window of win_length centred in each n_fft frame, |DFT|², a Slaney
mel filterbank built in float64, log(x + 2⁻²⁴), and per-feature
normalisation over the clip's frames with the N−1 variance and std + 1e-5.

The reference computes in float64. `tf32_dft=True` rounds the DFT's operands
to TF32 (10 mantissa bits) and sums in float32: the benchmark's control,
the precision below the frontend's stated float32 with TF32 off.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LOG_GUARD = 2.0 ** -24


def _hz_to_mel(f: float) -> float:
    return f / (200.0 / 3.0) if f < 1000.0 else 15.0 + math.log(f / 1000.0) / (math.log(6.4) / 27.0)


def _mel_to_hz(m: float) -> float:
    return m * (200.0 / 3.0) if m < 15.0 else 1000.0 * math.exp((m - 15.0) * (math.log(6.4) / 27.0))


def slaney_filterbank(n_freqs: int, n_mels: int, sample_rate: float, f_min: float, f_max: float) -> np.ndarray:
    """(n_freqs, n_mels) triangles on the Slaney mel scale, area-normalised
    (2 / (right − left)), float64."""
    m_lo, m_hi = _hz_to_mel(f_min), _hz_to_mel(f_max)
    hz = np.array([_mel_to_hz(m_lo + i * (m_hi - m_lo) / (n_mels + 1)) for i in range(n_mels + 2)])
    f = np.arange(n_freqs, dtype=np.float64) * (sample_rate / (2.0 * (n_freqs - 1)))
    fb = np.zeros((n_freqs, n_mels))
    for m in range(n_mels):
        lo, mid, hi = hz[m], hz[m + 1], hz[m + 2]
        up = np.where((f >= lo) & (f <= mid), (f - lo) / (mid - lo), 0.0)
        down = np.where((f > mid) & (f <= hi), (hi - f) / (hi - mid), 0.0)
        fb[:, m] = (up + down) * (2.0 / (hi - lo))
    return fb


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x with its mantissa rounded to TF32's 10 bits (to nearest)."""
    bits = x.to(torch.float32).view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class LogMel:
    """The reference frontend for one audio configuration, on `device`."""

    def __init__(self, audio: dict, n_mels: int, device="cpu"):
        self.n_fft, self.hop, self.win = audio["n_fft"], audio["hop_length"], audio["win_length"]
        sr = float(audio["sample_rate"])
        f_max = audio["f_max"] if audio["f_max"] > 0 else sr / 2.0
        n_freqs = self.n_fft // 2 + 1
        self.fb = torch.from_numpy(slaney_filterbank(n_freqs, n_mels, sr, audio["f_min"], f_max)).to(device)
        n = np.arange(self.win, dtype=np.float64)
        window = np.zeros(self.n_fft)
        lpad = (self.n_fft - self.win) // 2
        window[lpad: lpad + self.win] = 0.5 * (1.0 - np.cos(2.0 * math.pi * n / (self.win - 1)))
        ang = 2.0 * math.pi * np.outer(np.arange(self.n_fft), np.arange(n_freqs)) / self.n_fft
        dft = np.concatenate([np.cos(ang), -np.sin(ang)], axis=1) * window[:, None]  # (n_fft, 2F)
        self.dft = torch.from_numpy(dft).to(device)
        self.preemph, self.normalize, self.device = audio["preemph"], audio["normalize"], device

    def __call__(self, samples, tf32_dft: bool = False) -> torch.Tensor:
        """(n,) float32 samples → (n // hop + 1, n_mels) float64 features."""
        x = torch.as_tensor(np.asarray(samples), device=self.device).to(torch.float64)
        x = torch.cat([x[:1], x[1:] - self.preemph * x[:-1]])
        half = self.n_fft // 2
        x = torch.nn.functional.pad(x[None, None], (half, half), mode="reflect")[0, 0]
        n = len(samples) // self.hop + 1
        fr = x.unfold(0, self.n_fft, self.hop)[:n]  # (T, n_fft)
        if tf32_dft:
            spec = (tf32(fr) @ tf32(self.dft)).to(torch.float64)
        else:
            spec = fr @ self.dft
        f = spec.shape[1] // 2
        power = spec[:, :f] ** 2 + spec[:, f:] ** 2
        feats = torch.log(power @ self.fb + LOG_GUARD)
        if self.normalize:
            mean = feats.mean(dim=0, keepdim=True)
            std = torch.sqrt(((feats - mean) ** 2).sum(dim=0, keepdim=True) / (n - 1))
            feats = (feats - mean) / (std + 1e-5)
        return feats
