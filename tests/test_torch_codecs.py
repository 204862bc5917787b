"""The port's FLAC, MP3 and OGG decoding against the JAX reference's: the
same decoded samples (FLAC through the repository's decoder, built by the
port with g++; MP3 and OGG through the system libmpg123 and libvorbisfile)
and the same header durations. Skips where a system library is absent."""

import ctypes
import shutil

import numpy as np
import pytest

from parakeet_tpu.audio import codecs as RCOD
from parakeet_tpu.audio import io as RIO
from parakeet_tpu_torch.audio import codecs as TCOD
from parakeet_tpu_torch.audio import io as TIO
from parakeet_tpu_torch.ops import _build
from tests.helpers.flac_writer import encode_flac
from tests.helpers.ogg_writer import encode_ogg, ogg_encoder_available
from tests.test_torch_reference_build import reference_native

SR = 16000


def _tone(seconds=0.7, sr=SR, channels=1, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = np.stack([0.4 * np.sin(2 * np.pi * (300 + 200 * c) * t) + 0.02 * rng.randn(t.size)
                  for c in range(channels)], axis=1)
    return x[:, 0].astype(np.float32) if channels == 1 else x.astype(np.float32)


def _reference_flac(data):
    return reference_native().flac_decode(data)


needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ not present to build the FLAC decoder")


@needs_gxx
@pytest.mark.parametrize("mode, channels, left_side, bps", [
    ("verbatim", 1, False, 16), ("fixed1", 1, False, 16), ("fixed2", 2, False, 16),
    ("fixed2", 2, True, 16), ("verbatim", 1, False, 24), ("constant", 1, False, 16),
])
def test_flac_samples_identical_to_reference(mode, channels, left_side, bps):
    scale = 2 ** (bps - 1) - 1
    x = _tone(channels=channels)
    pcm = np.zeros_like(x, dtype=np.int64) if mode == "constant" else np.round(x * scale).astype(np.int64)
    data = encode_flac(pcm, SR, block_size=1024, subframe_mode=mode, left_side=left_side, bps=bps)
    got, want = TCOD.flac_decode(data), _reference_flac(data)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] == (SR, channels)
    np.testing.assert_array_equal(got[0], (pcm.reshape(-1) / 2 ** (bps - 1)).astype(np.float32))


@needs_gxx
def test_flac_library_is_built_into_the_port_build_dir():
    lib = _build.build_host("flac_decoder")
    assert lib.parent == _build.BUILD_DIR and lib.name.startswith("libflac_decoder-")
    assert lib == _build.host_library_path("flac_decoder") and lib.is_file()
    assert "_native" not in str(lib)


@needs_gxx
def test_flac_read_audio_and_duration_identical(tmp_path):
    reference_native()  # the reference decodes FLAC only through its native library
    pcm = np.round(_tone(1.3, sr=22050, channels=2) * 32767).astype(np.int64)
    path = tmp_path / "clip.flac"
    path.write_bytes(encode_flac(pcm, 22050, block_size=4096, subframe_mode="fixed2"))
    got, want = TIO.read_audio(path), RIO.read_audio(path)
    assert got.format == want.format == "flac"
    assert (got.original_sample_rate, got.num_channels, got.num_samples) == (
        want.original_sample_rate, want.num_channels, want.num_samples)
    # the reference downmixes and resamples in its native library, the
    # port in numpy: the same arithmetic to f32 rounding
    np.testing.assert_allclose(got.samples, want.samples, atol=2e-6)
    assert TIO.get_audio_duration(path) == RIO.get_audio_duration(path) == pytest.approx(1.3, abs=1e-4)


@needs_gxx
def test_flac_garbage_raises_as_the_reference():
    for decode in (TCOD.flac_decode, _reference_flac):
        with pytest.raises(ValueError, match="FLAC decode failed"):
            decode(b"fLaC" + bytes(64))


def _lame():
    for name in ("libmp3lame.so.0", "libmp3lame.so"):
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    return None


def _encode_mp3(samples, sr=SR):
    """MP3 bytes from the system libmp3lame (mono)."""
    lame = _lame()
    if lame is None or not TCOD.mp3_available():
        pytest.skip("libmp3lame or libmpg123 not present")
    lame.lame_init.restype = ctypes.c_void_p
    gfp = ctypes.c_void_p(lame.lame_init())
    lame.lame_set_in_samplerate(gfp, sr)
    lame.lame_set_num_channels(gfp, 1)
    lame.lame_set_mode(gfp, 3)  # MONO
    lame.lame_init_params(gfp)
    pcm = np.clip(samples * 32767, -32768, 32767).astype(np.int16)
    out = (ctypes.c_char * (len(pcm) * 2 + 7200))()
    n = lame.lame_encode_buffer(gfp, pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_short)), None, len(pcm), out,
                                len(out))
    data = bytes(out[:n])
    n2 = lame.lame_encode_flush(gfp, out, len(out))
    data += bytes(out[:n2])
    lame.lame_close(gfp)
    return data


def test_mp3_samples_and_duration_identical(tmp_path):
    data = _encode_mp3(_tone(1.0))
    got, want = TCOD.mp3_decode(data), RCOD.mp3_decode(data)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] == (SR, 1) and got[0].size > SR // 2
    path = tmp_path / "clip.mp3"
    path.write_bytes(data)
    np.testing.assert_array_equal(TIO.read_audio(path).samples, RIO.read_audio(path).samples)
    assert TIO.read_audio(path).format == "mp3"
    assert TIO.get_audio_duration(path) == RIO.get_audio_duration(path)
    with pytest.raises(Exception):
        TCOD.mp3_decode(b"definitely not an mp3 stream" * 10)


def _encode_ogg(x):
    if not (TCOD.ogg_available() and ogg_encoder_available()):
        pytest.skip("system vorbis libs not present")
    return encode_ogg(x, SR)


def test_ogg_samples_and_duration_identical(tmp_path):
    data = _encode_ogg(_tone(1.0))
    got, want = TCOD.ogg_decode(data), RCOD.ogg_decode(data)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:] == (SR, 1) and got[0].size > SR // 2
    path = tmp_path / "clip.ogg"
    path.write_bytes(data)
    np.testing.assert_array_equal(TIO.read_audio(path).samples, RIO.read_audio(path).samples)
    assert TIO.get_audio_duration(path) == RIO.get_audio_duration(path)
    for decode in (TCOD.ogg_decode, RCOD.ogg_decode):
        with pytest.raises(ValueError):
            decode(b"OggS" + b"\x00" * 64)


def test_wav_duration_and_write_wav_identical(tmp_path):
    x = _tone(0.9)
    paths = [tmp_path / "port.wav", tmp_path / "ref.wav"]
    TIO.write_wav(paths[0], x, SR)
    RIO.write_wav(paths[1], x, SR)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert TIO.get_audio_duration(paths[0]) == RIO.get_audio_duration(paths[0]) == pytest.approx(0.9)


@pytest.mark.parametrize("fmt", ["mp3", "ogg", "flac"])
def test_absent_library_raises_as_the_reference(fmt, monkeypatch):
    """With the codec library absent (and no soundfile or librosa), the
    decode chain raises a RuntimeError that names the format."""
    loader = {"mp3": "_load_mpg123", "ogg": "_load_vorbisfile", "flac": "_load_flac"}[fmt]
    monkeypatch.setattr(TCOD, loader, lambda: None)
    for name in ("soundfile", "librosa"):
        monkeypatch.setitem(__import__("sys").modules, name, None)
    magic = {"mp3": b"ID3" + bytes(64), "ogg": b"OggS" + bytes(64), "flac": b"fLaC" + bytes(64)}[fmt]
    with pytest.raises(RuntimeError, match=fmt):
        TIO.read_audio(magic)
    decode = getattr(TCOD, f"{fmt}_decode")
    with pytest.raises(RuntimeError, match="not available|could not be built"):
        decode(magic)
