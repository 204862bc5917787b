"""Torch port mel frontend against the JAX reference (same waveforms)."""

import numpy as np
import pytest

from parakeet_tpu.audio import frontend as RF
from parakeet_tpu.config import AudioConfig as RAudioConfig
from parakeet_tpu_torch.audio import frontend as TF
from parakeet_tpu_torch.config import AudioConfig as TAudioConfig

RTOL, ATOL = 1e-4, 1e-5  # tests/test_frontend.py's frontend tolerance


def _waves(seed, lengths):
    rng = np.random.RandomState(seed)
    return [(rng.randn(n) * 0.2).astype(np.float32) for n in lengths]


def test_mel_filterbank_identical():
    args = (257, 80, 16000.0, 0.0, 8000.0)
    np.testing.assert_array_equal(TF.mel_filterbank(*args), RF.mel_filterbank(*args))


@pytest.mark.parametrize("n", [16000, 12345, 1601])
def test_preprocess_audio_matches_reference(n):
    (w,) = _waves(n, [n])
    ref = np.asarray(RF.preprocess_audio(w))
    got = TF.preprocess_audio(w, device="cpu").numpy()
    assert got.shape == ref.shape == (1, n // 160 + 1, 80)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("normalize", [True, False])
def test_preprocess_audio_batch_matches_reference(normalize):
    waves = _waves(3, [16000, 9600, 12345, 4001])
    ref, ref_n = RF.preprocess_audio_batch(waves, RAudioConfig(normalize=normalize))
    got, got_n = TF.preprocess_audio_batch(waves, TAudioConfig(normalize=normalize), "cpu")
    assert got_n == list(ref_n)
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape
    for i, n in enumerate(got_n):
        np.testing.assert_allclose(got[i, :n], ref[i, :n], rtol=RTOL, atol=ATOL, err_msg=f"clip {i}")
        if normalize:
            np.testing.assert_array_equal(got[i, n:], 0.0)  # normalized pad frames are exactly 0


def test_batch_equals_per_clip():
    waves = _waves(5, [8000, 6400, 11111])
    batched, n_frames = TF.preprocess_audio_batch(waves, device="cpu")
    for i, w in enumerate(waves):
        solo = TF.preprocess_audio(w, device="cpu").numpy()[0]
        np.testing.assert_allclose(batched.numpy()[i, : n_frames[i]], solo, rtol=RTOL, atol=ATOL)


def test_odd_fft_and_128_mels_match_reference():
    """The hop-block STFT keeps the sin columns when n_fft is odd; 128 mels
    is the 600m presets' frontend."""
    waves = _waves(11, [7000, 5000])
    for kw in (dict(n_fft=511), dict(n_mels=128)):
        ref, _ = RF.preprocess_audio_batch(waves, RAudioConfig(**kw))
        got, n = TF.preprocess_audio_batch(waves, TAudioConfig(**kw), "cpu")
        for i in range(2):
            np.testing.assert_allclose(got.numpy()[i, : n[i]], np.asarray(ref)[i, : n[i]],
                                       rtol=RTOL, atol=ATOL, err_msg=str(kw))


def test_empty_waveform_rejected():
    with pytest.raises(ValueError, match="empty"):
        TF.preprocess_audio(np.zeros(0, np.float32), device="cpu")


@pytest.mark.parametrize("entry", ["preprocess_audio", "preprocess_audio_batch", "preprocess_audio_fused"])
def test_entry_points_default_to_the_card_and_raise_without_one(entry, monkeypatch):
    """No silent CPU fallback: the default device is the card, and without
    one the call says to pass device="cpu"."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (w,) = _waves(1, [4000])
    arg = [w] if entry == "preprocess_audio_batch" else w
    with pytest.raises(RuntimeError, match='device="cpu"'):
        getattr(TF, entry)(arg)
    assert getattr(TF, entry)(arg, device="cpu") is not None
