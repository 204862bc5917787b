"""NeMo-compatible mel-spectrogram frontend (port of parakeet_tpu/audio/frontend.py).

preemphasis(0.97) → STFT(n_fft 512, hop 160, win 400, symmetric Hann,
center=True, reflect pad) → |X|² → Slaney mel filterbank (f64 construction)
→ log(x + 2⁻²⁴) → per-feature normalization (mean / unbiased N−1 std over
each clip's valid frames, eps 1e-5).

Preemphasis and reflect padding run per clip on the host (numpy); the rest
is plain torch on the target device. The windowed DFT is the reference's
hop-block GEMM form: every frame starts on a hop boundary of the padded
buffer, so the windowed DFT is a sum of ⌈(lpad+win)/hop⌉ GEMMs over
contiguous hop blocks, with the all-zero sin columns dropped for even n_fft.
`preprocess_audio_fused` is the one-clip form whose log-mel runs the fused
kernel (ops/log_mel.py: the CUDA kernel on the card, its plain version on
the CPU).

Streaming (`StreamingAudioPreprocessor`, `streaming_log_mel_batch`): the
same hop-block GEMMs framed without a centre pad (center=False), the mel
and the log, no normalisation; the preemphasis carries the previous raw
sample across pushes.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from parakeet_tpu_torch import trace
from parakeet_tpu_torch.config import AudioConfig
from parakeet_tpu_torch.device import DEFAULT_DEVICE, resolve_device

# NeMo's log guard: 2^-24 (audio.cpp:134-135).
LOG_GUARD = 5.96046448e-8

_MEL_BREAK_FREQ = 1000.0
_MEL_BREAK_MEL = 15.0  # 1000 / (200/3)
_MEL_LINEAR_SCALE = 200.0 / 3.0
_MEL_LOG_STEP = math.log(6.4) / 27.0


def _hz_to_mel_slaney(freq: float) -> float:
    if freq < _MEL_BREAK_FREQ:
        return freq / _MEL_LINEAR_SCALE
    return _MEL_BREAK_MEL + math.log(freq / _MEL_BREAK_FREQ) / _MEL_LOG_STEP


def _mel_to_hz_slaney(mel: float) -> float:
    if mel < _MEL_BREAK_MEL:
        return mel * _MEL_LINEAR_SCALE
    return _MEL_BREAK_FREQ * math.exp((mel - _MEL_BREAK_MEL) * _MEL_LOG_STEP)


@functools.lru_cache(maxsize=16)
def mel_filterbank(
    n_freqs: int, n_mels: int, sample_rate: float, f_min: float, f_max: float
) -> np.ndarray:
    """Slaney-scale, Slaney-normalized mel filterbank, (n_freqs, n_mels) f32,
    built in float64 (audio.cpp:40-94)."""
    mel_min = _hz_to_mel_slaney(f_min)
    mel_max = _hz_to_mel_slaney(f_max)
    mel_pts = mel_min + np.arange(n_mels + 2, dtype=np.float64) * (
        (mel_max - mel_min) / (n_mels + 1)
    )
    hz_pts = np.array([_mel_to_hz_slaney(m) for m in mel_pts], dtype=np.float64)
    fft_freqs = np.arange(n_freqs, dtype=np.float64) * (sample_rate / (2.0 * (n_freqs - 1)))

    fb = np.zeros((n_freqs, n_mels), dtype=np.float64)
    for m in range(n_mels):
        left, center, right = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        enorm = 2.0 / (right - left)
        f = fft_freqs
        up = (f - left) / (center - left) if center > left else np.zeros_like(f)
        down = (right - f) / (right - center) if right > center else np.zeros_like(f)
        tri = np.where((f >= left) & (f <= center), up, 0.0) + np.where(
            (f > center) & (f <= right), down, 0.0
        )
        fb[:, m] = tri * enorm
    return fb.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _hann_symmetric(win_length: int) -> np.ndarray:
    """Symmetric (periodic=False) Hann window, f64→f32 (matches torch)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * math.pi * n / (win_length - 1)))).astype(np.float32)


def _fb_for(cfg: AudioConfig) -> np.ndarray:
    f_max = cfg.f_max if cfg.f_max > 0 else cfg.sample_rate / 2.0
    return mel_filterbank(cfg.n_fft // 2 + 1, cfg.n_mels, float(cfg.sample_rate), cfg.f_min, f_max)


@functools.lru_cache(maxsize=8)
def _hop_block_weights(cfg: AudioConfig, lpad: int) -> tuple[np.ndarray, bool]:
    """(nblk, hop, F + nim) windowed cos|sin DFT weights, the window at
    offset lpad of the n_fft frame (zero rows above it), split into hop
    blocks; and whether the zero sin columns (k = 0, n_fft/2) were dropped."""
    n_fft, hop, win = cfg.n_fft, cfg.hop_length, cfg.win_length
    f = n_fft // 2 + 1
    k = np.arange(f, dtype=np.float64)
    n = np.arange(n_fft, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft
    cos_m, sin_m = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    trim = n_fft % 2 == 0
    sin_cols = sin_m[:, 1 : f - 1] if trim else sin_m
    window = _hann_symmetric(win)
    wmat = np.concatenate(
        [cos_m[lpad : lpad + win], sin_cols[lpad : lpad + win]], axis=1
    ) * window[:, None]
    nblk = -(-(lpad + win) // hop)
    wfull = np.zeros((nblk * hop, wmat.shape[1]), np.float32)
    wfull[lpad : lpad + win] = wmat
    return wfull.reshape(nblk, hop, -1), trim


def _stft_power_gemm(
    padded: torch.Tensor, cfg: AudioConfig, n_frames: int, center: bool = True
) -> torch.Tensor:
    """(B, L) preemphasized waveforms → (B, n_frames, F) power. center: the
    buffer is reflect-padded and each n_fft frame holds the window at its
    centre (torch.stft center=True); otherwise frames of win_length start
    every hop at sample 0, the streaming grid (pad placement only shifts
    phase, so the power is the same as the window zero-padded to n_fft)."""
    lpad = (cfg.n_fft - cfg.win_length) // 2 if center else 0
    wj_np, trim = _hop_block_weights(cfg, lpad)
    wj = torch.from_numpy(wj_np).to(padded.device)
    nblk, hop = wj.shape[0], cfg.hop_length
    f = cfg.n_fft // 2 + 1
    need = (n_frames - 1 + nblk) * hop
    y = torch.nn.functional.pad(padded, (0, max(0, need - padded.shape[1])))[:, :need]
    blocks = y.reshape(y.shape[0], n_frames - 1 + nblk, hop)
    spec = None
    for j in range(nblk):
        term = blocks[:, j : j + n_frames] @ wj[j]  # (B, T, F + nim)
        spec = term if spec is None else spec + term
    re, im = spec[..., :f], spec[..., f:]
    p = re * re
    if trim:
        return torch.cat([p[..., :1], p[..., 1 : f - 1] + im * im, p[..., f - 1 :]], dim=-1)
    return p + im * im


def _log_mel_batch(
    padded: torch.Tensor, n_frames: list[int], cfg: AudioConfig, t_max: int
) -> torch.Tensor:
    power = _stft_power_gemm(padded, cfg, t_max)
    fb = torch.from_numpy(_fb_for(cfg)).to(padded.device)
    log_mel = torch.log(power @ fb + LOG_GUARD)
    if cfg.normalize:
        # masked per-feature normalization over each clip's valid frames
        nf = torch.as_tensor(n_frames, dtype=torch.float32, device=padded.device)
        valid = torch.arange(t_max, device=padded.device)[None, :] < nf[:, None]
        vmask = valid.to(torch.float32)[:, :, None]
        n = nf[:, None, None]
        mean = torch.sum(log_mel * vmask, dim=1, keepdim=True) / n
        centered = (log_mel - mean) * vmask
        var = torch.sum(centered * centered, dim=1, keepdim=True) / (n - 1)
        log_mel = centered / (torch.sqrt(var) + 1e-5)
    return log_mel


def _preemphasize_and_pad(w, cfg: AudioConfig) -> np.ndarray:
    x = np.asarray(w, np.float32).reshape(-1)
    if x.shape[0] < 1:
        raise ValueError("empty waveform")
    pre = x.copy()
    pre[1:] -= 0.97 * x[:-1]
    return np.pad(pre, (cfg.n_fft // 2, cfg.n_fft // 2), mode="reflect")


def preprocess_audio_batch(
    waves, config: AudioConfig = AudioConfig(), device: str | torch.device = DEFAULT_DEVICE
) -> tuple[torch.Tensor, list[int]]:
    """List of waveforms → ((B, T_max, n_mels) f32 on `device`, frame counts).

    n_frames = len // hop + 1 per clip. Every valid frame equals the clip's
    own preprocess_audio; normalized pad frames are exactly 0. `device` is
    the card unless given ("cpu" for the CPU); with no card it raises."""
    device = resolve_device(device)
    cfg = config
    with trace.span("frontend.host"):
        pres = [_preemphasize_and_pad(w, cfg) for w in waves]
        n_frames = [(len(p) - 2 * (cfg.n_fft // 2)) // cfg.hop_length + 1 for p in pres]
        t_max = max(n_frames)
        need = (t_max - 1) * cfg.hop_length + cfg.n_fft
        padded = np.zeros((len(pres), need), np.float32)
        for i, pre in enumerate(pres):
            padded[i, : len(pre)] = pre[:need]
    with trace.span("frontend.copy"):  # pageable: the host waits for it
        padded_t = torch.from_numpy(padded).to(device)
    return _log_mel_batch(padded_t, n_frames, cfg, t_max), n_frames


def preprocess_audio(
    samples, config: AudioConfig = AudioConfig(), device: str | torch.device = DEFAULT_DEVICE
) -> torch.Tensor:
    """Waveform (num_samples,) → features (1, n_frames, n_mels),
    n_frames = num_samples // hop + 1 (torch.stft center=True), on `device`
    (the card unless given)."""
    x = np.asarray(samples, np.float32)
    if x.ndim != 1:
        raise ValueError(f"expected 1D waveform, got shape {x.shape}")
    feats, _ = preprocess_audio_batch([x], config, device)
    return feats


def preprocess_audio_fused(
    samples, config: AudioConfig = AudioConfig(), device: str | torch.device = DEFAULT_DEVICE
) -> torch.Tensor:
    """preprocess_audio through the fused log-mel kernel (the reference's
    audio/frontend.py::preprocess_audio_fused): host preemphasis and
    reflect pad, the kernel's log-mel for every frame, then the clip's
    unmasked per-feature normalisation (N−1 variance, std + 1e-5). One
    clip; (1, n_frames, n_mels) f32 on `device` (the card unless given)."""
    from parakeet_tpu_torch.ops.log_mel import fused_log_mel

    device = resolve_device(device)
    cfg = config
    x = np.asarray(samples, np.float32)
    if x.ndim != 1:
        raise ValueError(f"expected 1D waveform, got shape {x.shape}")
    f_max = cfg.f_max if cfg.f_max > 0 else cfg.sample_rate / 2.0
    padded = torch.from_numpy(_preemphasize_and_pad(x, cfg)).to(device)
    log_mel = fused_log_mel(
        padded, n_fft=cfg.n_fft, hop=cfg.hop_length, win_length=cfg.win_length,
        n_mels=cfg.n_mels, sample_rate=float(cfg.sample_rate), f_min=cfg.f_min, f_max=f_max,
    )
    if cfg.normalize:
        n_frames = log_mel.shape[0]
        centered = log_mel - log_mel.mean(dim=0, keepdim=True)
        var = torch.sum(centered * centered, dim=0, keepdim=True) / (n_frames - 1)
        log_mel = centered / (torch.sqrt(var) + 1e-5)
    return log_mel[None]


# ─── Streaming ───────────────────────────────────────────────────────────────


def _streaming_log_mel(pre: torch.Tensor, cfg: AudioConfig, n_frames: int) -> torch.Tensor:
    """(B, S) preemphasized samples → (B, n_frames, n_mels): center=False
    power, the Slaney filterbank, log(x + 2⁻²⁴), no normalisation. The
    per-push and the batched streaming frontends both run this."""
    power = _stft_power_gemm(pre, cfg, n_frames, center=False)
    fb = torch.from_numpy(_fb_for(cfg)).to(pre.device)
    return torch.log(power @ fb + LOG_GUARD)


def streaming_log_mel_batch(
    x: torch.Tensor, prev: torch.Tensor, cfg: AudioConfig, n_frames: int
) -> torch.Tensor:
    """Batched streaming mel: (B, S) raw f32 samples and the (B,)
    preemphasis carry-in (each row's previous raw sample) → (B, n_frames,
    n_mels) unnormalised log-mel, center=False, on x's device. S must be
    (n_frames-1)·hop + win: a step consumes exactly n_frames windows, the
    grid restarting at the consumed samples as in StreamingAudioPreprocessor
    fed S-sample pushes."""
    need = (n_frames - 1) * cfg.hop_length + cfg.win_length
    if x.shape[1] != need:
        raise ValueError(
            f"streaming_log_mel_batch needs exactly (n_frames-1)*hop + win "
            f"= {need} samples per row, got {x.shape[1]}"
        )
    shifted = torch.cat([prev.to(x.dtype)[:, None], x[:, :-1]], dim=1)
    return _streaming_log_mel(x - 0.97 * shifted, cfg, n_frames)


class StreamingAudioPreprocessor:
    """Stateful chunk-wise mel frontend (reference: audio.cpp:171-259).

    State, on the host: the last raw sample for preemphasis continuity and
    an overlap buffer of already-preemphasized samples shorter than one
    window. process_chunk returns unnormalised log-mel (1, n_frames,
    n_mels) on `device` (the card unless given), or None while fewer than
    win_length samples are buffered."""

    def __init__(self, config: AudioConfig = AudioConfig(), device: str | torch.device = DEFAULT_DEVICE):
        self.config = config
        self.device = resolve_device(device)
        self.reset()

    def reset(self) -> None:
        self._preemph_last = 0.0
        self._overlap = np.zeros(0, dtype=np.float32)

    def process_chunk(self, samples) -> torch.Tensor | None:
        cfg = self.config
        x = np.asarray(samples, dtype=np.float32).reshape(-1)
        if x.size:
            pre = x.copy()
            pre[0] -= 0.97 * self._preemph_last
            pre[1:] -= 0.97 * x[:-1]
            self._preemph_last = float(x[-1])
            buf = np.concatenate([self._overlap, pre])
        else:
            buf = self._overlap

        total = buf.shape[0]
        if total < cfg.win_length:
            self._overlap = buf
            return None
        n_frames = (total - cfg.win_length) // cfg.hop_length + 1
        consumed = (n_frames - 1) * cfg.hop_length + cfg.win_length
        self._overlap = buf[consumed:].copy()
        pre_t = torch.from_numpy(np.ascontiguousarray(buf[:consumed])).to(self.device)
        return _streaming_log_mel(pre_t[None], cfg, n_frames)


__all__ = ["LOG_GUARD", "mel_filterbank", "preprocess_audio", "preprocess_audio_batch",
           "preprocess_audio_fused", "streaming_log_mel_batch", "StreamingAudioPreprocessor"]
