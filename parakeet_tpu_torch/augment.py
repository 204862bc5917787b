"""SpecAugment (Park et al. 2019) for training batches (port of
parakeet_tpu/augment.py, the same numpy code, so the same seed masks the
same cells).

The NeMo recipe the Parakeet checkpoints were trained with: a few
frequency masks of bounded width plus several time masks whose width
adapts to each utterance's length. Applied on the host in the data
loader's prefetch thread.

Reference defaults (NeMo SpectrogramAugmentation for FastConformer):
freq_masks=2 × width≤27 mel bins; time_masks=10 × width≤5% of the
utterance. Masked cells are zeroed (post-normalization zeros ≈ mean).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SpecAugmentConfig:
    freq_masks: int = 2
    freq_width: int = 27
    time_masks: int = 10
    time_width: float = 0.05  # fraction of the utterance's valid frames


def spec_augment(
    rng: np.random.RandomState,
    features: np.ndarray,
    mel_lengths: np.ndarray,
    cfg: SpecAugmentConfig = SpecAugmentConfig(),
) -> np.ndarray:
    """(B, T, F) mel batch → augmented copy. Masks only land inside each
    clip's valid frames (padding stays untouched — it is already masked by
    the model). Width draws follow NeMo: uniform over [0, max_width]."""
    feats = np.array(features)  # copy; the loader may reuse the buffer
    b, t, f = feats.shape
    for i in range(b):
        valid = int(min(mel_lengths[i], t))
        if valid <= 0:
            continue
        for _ in range(cfg.freq_masks):
            w = rng.randint(0, cfg.freq_width + 1)
            if w == 0 or w >= f:
                continue
            start = rng.randint(0, f - w + 1)
            feats[i, :valid, start:start + w] = 0.0
        max_tw = max(1, int(cfg.time_width * valid))
        for _ in range(cfg.time_masks):
            w = rng.randint(0, max_tw + 1)
            if w == 0 or w >= valid:
                continue
            start = rng.randint(0, valid - w + 1)
            feats[i, start:start + w, :] = 0.0
    return feats


__all__ = ["SpecAugmentConfig", "spec_augment"]
