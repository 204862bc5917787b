"""The port's native host audio library (parakeet_tpu_torch/native.py, a g++
build of csrc/parakeet_native.cpp into build/parakeet_tpu_torch/) and its
numpy fallback, against the JAX package's native library and numpy path:
resampling, downmix and read_audio bit for bit."""

import wave

import numpy as np
import pytest

from parakeet_tpu import native as RN
from parakeet_tpu.audio import io as RIO
from parakeet_tpu_torch import native as TN
from parakeet_tpu_torch.audio import io as TIO
from parakeet_tpu_torch.ops import _build

pytestmark = pytest.mark.skipif(not RN.available(), reason="native lib not built (no g++?)")

RATES = [(44100, 16000), (8000, 16000), (48000, 16000)]


def _noise(n, seed):
    return (0.3 * np.random.RandomState(seed).randn(n)).astype(np.float32)


def _fallback(monkeypatch, native_mod, fn):
    """Force the numpy path of an audio.io function."""
    monkeypatch.setattr(native_mod, "sinc_resample", lambda *a, **k: None)
    monkeypatch.setattr(native_mod, "downmix_to_mono", lambda *a, **k: None)
    return fn


def test_port_library_builds_beside_the_package():
    assert TN.available()
    lib = _build.host_library_path("parakeet_native")
    assert lib.parent == _build.BUILD_DIR and lib.is_file()


@pytest.mark.parametrize("src,dst", RATES)
def test_native_resample_matches_reference(src, dst):
    x = _noise(src // 3 + 17, src)
    np.testing.assert_array_equal(TN.sinc_resample(x, src, dst), RN.sinc_resample(x, src, dst))
    np.testing.assert_array_equal(TIO.resample(x, src, dst), RIO.resample(x, src, dst))


@pytest.mark.parametrize("src,dst", RATES)
def test_chunked_fallback_matches_both(monkeypatch, src, dst):
    """Lengths that cross several chunk boundaries of the fallback (chunk
    shrunk to 1000 output samples), against the reference's numpy path and
    both native libraries."""
    x = _noise(3 * src // 8 + 5, src + 1)
    native = RN.sinc_resample(x, src, dst)
    monkeypatch.setattr(TIO, "RESAMPLE_CHUNK", 1000)
    port = _fallback(monkeypatch, TN, TIO.resample)(x, src, dst)
    ref = _fallback(monkeypatch, RN, RIO.resample)(x, src, dst)
    assert len(port) > 3 * 1000
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(port, native)


def test_no_native_env_selects_fallback(monkeypatch):
    monkeypatch.setenv("PARAKEET_NO_NATIVE", "1")
    monkeypatch.setattr(TN, "_tried", False)
    monkeypatch.setattr(TN, "_lib", None)
    assert not TN.available() and TN.sinc_resample(_noise(100, 0), 8000, 16000) is None
    x = _noise(5000, 3)
    np.testing.assert_array_equal(TIO.resample(x, 44100, 16000), RN.sinc_resample(x, 44100, 16000))


@pytest.mark.parametrize("channels", [2, 4])
def test_downmix_matches_reference(monkeypatch, channels):
    inter = _noise(channels * 1001, channels)
    ref = RIO.downmix_to_mono(inter, channels)
    np.testing.assert_array_equal(TN.downmix_to_mono(inter, channels), ref)
    np.testing.assert_array_equal(TIO.downmix_to_mono(inter, channels), ref)
    fallback = _fallback(monkeypatch, TN, TIO.downmix_to_mono)(inter, channels)
    np.testing.assert_allclose(fallback, ref, atol=1e-7)


def test_read_audio_stereo_44k_matches_reference(tmp_path):
    path = tmp_path / "stereo.wav"
    stereo = (0.2 * np.random.RandomState(5).randn(44100 // 2, 2) * 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(44100)
        w.writeframes(stereo.tobytes())  # (frames, 2) row-major = interleaved
    ref, port = RIO.read_audio(path), TIO.read_audio(path)
    np.testing.assert_array_equal(port.samples, ref.samples)
    assert (port.num_channels, port.original_sample_rate, port.num_samples) == (2, 44100, ref.num_samples)
