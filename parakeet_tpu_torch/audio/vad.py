"""Energy-based voice activity detection (port of parakeet_tpu/audio/vad.py;
numpy, copied, not imported).

Host-side: it gates what reaches the device, so it belongs with the audio
loaders, not in a device program.

Frame RMS energy in dB against an adaptive threshold (noise floor
percentile + margin), then hangover smoothing: short silence gaps inside
speech are bridged, too-short speech islands are dropped, and kept
segments get symmetric padding so word onsets aren't clipped.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class VadConfig:
    frame_ms: float = 30.0  # analysis frame length
    hop_ms: float = 10.0  # analysis hop
    margin_db: float = 12.0  # speech threshold above the noise floor
    floor_percentile: float = 10.0  # frame-energy percentile taken as noise floor
    min_speech_ms: float = 120.0  # drop shorter speech islands
    max_gap_ms: float = 300.0  # bridge shorter silence gaps
    pad_ms: float = 120.0  # padding added around kept segments
    abs_floor_db: float = -50.0  # never call speech below this absolute level


def vad_segments(
    samples: np.ndarray, sample_rate: int = 16000, config: VadConfig | None = None
) -> list[tuple[int, int]]:
    """Detect speech spans; returns [(start_sample, end_sample), ...] sorted,
    non-overlapping. Empty list = no speech found."""
    cfg = config or VadConfig()
    x = np.asarray(samples, np.float32).reshape(-1)
    if x.size == 0:
        return []
    frame = max(1, int(cfg.frame_ms * sample_rate / 1000))
    hop = max(1, int(cfg.hop_ms * sample_rate / 1000))
    n_frames = max(0, (x.size - frame) // hop + 1)
    if n_frames == 0:
        # shorter than one frame: all-or-nothing on overall energy
        rms = float(np.sqrt(np.mean(x**2) + 1e-12))
        db = 20.0 * np.log10(rms + 1e-12)
        return [(0, x.size)] if db > cfg.abs_floor_db else []

    # O(n) via a squared-sample cumsum: a materialized (n_frames, frame)
    # fancy-index gather is ~GBs on the hour-long inputs VAD targets
    csum = np.concatenate([[0.0], np.cumsum(x.astype(np.float64) ** 2)])
    starts = np.arange(n_frames) * hop
    energy = np.sqrt((csum[starts + frame] - csum[starts]) / frame + 1e-12)
    db = 20.0 * np.log10(energy + 1e-12)

    floor = np.percentile(db, cfg.floor_percentile)
    peak = float(db.max())
    if peak - floor < cfg.margin_db:
        # uniform energy (all speech or all silence): the absolute floor
        # decides — an adaptive threshold has no dynamic range to work with
        threshold = cfg.abs_floor_db
    else:
        threshold = max(floor + cfg.margin_db, cfg.abs_floor_db)
    speech = db > threshold

    # frame flags → sample spans
    spans: list[list[int]] = []
    for i, s in enumerate(speech):
        if not s:
            continue
        lo, hi = i * hop, i * hop + frame
        if spans and lo <= spans[-1][1]:
            spans[-1][1] = hi
        else:
            spans.append([lo, hi])

    # hangover: bridge short gaps, then drop short islands, then pad
    gap = int(cfg.max_gap_ms * sample_rate / 1000)
    merged: list[list[int]] = []
    for lo, hi in spans:
        if merged and lo - merged[-1][1] <= gap:
            merged[-1][1] = hi
        else:
            merged.append([lo, hi])
    min_len = int(cfg.min_speech_ms * sample_rate / 1000)
    pad = int(cfg.pad_ms * sample_rate / 1000)
    out: list[tuple[int, int]] = []
    for lo, hi in merged:
        if hi - lo < min_len:
            continue
        lo, hi = max(0, lo - pad), min(x.size, hi + pad)
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def speech_ratio(samples: np.ndarray, sample_rate: int = 16000, config=None) -> float:
    """Fraction of samples inside detected speech (observability helper)."""
    segs = vad_segments(samples, sample_rate, config)
    n = np.asarray(samples).size
    return sum(hi - lo for lo, hi in segs) / n if n else 0.0


__all__ = ["VadConfig", "vad_segments", "speech_ratio"]
