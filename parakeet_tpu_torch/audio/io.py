"""Audio file I/O: WAV and raw PCM decode, mono downmix, resampling
(port of parakeet_tpu/audio/io.py).

WAV is decoded natively (RIFF parser: PCM 8/16/24/32, IEEE float, G.711
A-law/µ-law); FLAC, MP3 and OGG through audio/codecs.py (the repository's
FLAC decoder, libmpg123, libvorbisfile), then the optional soundfile and
librosa backends, as in the reference's decode chain. Downmix is
the mean over channels (audio_io.cpp:198-214); the resampler is the
reference's windowed-sinc Kaiser filter (β=7.857, half-width 16 taps,
cutoff min(1, dst/src), per-output normalization by the weight sum).
Downmix and resampler run in the repository's native C++ library
(native.py), with numpy forms as the fallback, as in the reference.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from parakeet_tpu_torch import native

# output samples per pass of the numpy resampler: its (rows, 32) float64
# temporaries stay near 8 MB each
RESAMPLE_CHUNK = 1 << 15


@dataclass
class AudioData:
    """Decoded audio (audio_io.hpp:12-20)."""

    samples: np.ndarray  # float32 mono, resampled
    sample_rate: int
    original_sample_rate: int
    num_channels: int
    num_samples: int
    duration: float  # seconds (at original rate)
    format: str  # "wav" | "flac" | "mp3" | "ogg" | "raw"


class AudioFormat:
    WAV = "wav"
    FLAC = "flac"
    MP3 = "mp3"
    OGG = "ogg"
    UNKNOWN = "unknown"


# ─── Format detection (audio_io.cpp:37-94) ───────────────────────────────────

_EXT_MAP = {
    ".wav": AudioFormat.WAV,
    ".wave": AudioFormat.WAV,
    ".flac": AudioFormat.FLAC,
    ".mp3": AudioFormat.MP3,
    ".ogg": AudioFormat.OGG,
    ".oga": AudioFormat.OGG,
}


def detect_format_by_extension(path: str | Path) -> str:
    return _EXT_MAP.get(Path(path).suffix.lower(), AudioFormat.UNKNOWN)


def detect_format_by_magic(data: bytes) -> str:
    if len(data) >= 12 and data[:4] == b"RIFF" and data[8:12] == b"WAVE":
        return AudioFormat.WAV
    if data[:4] == b"fLaC":
        return AudioFormat.FLAC
    if data[:4] == b"OggS":
        return AudioFormat.OGG
    if data[:3] == b"ID3":
        return AudioFormat.MP3
    if len(data) >= 2 and data[0] == 0xFF and (data[1] & 0xE0) == 0xE0:
        return AudioFormat.MP3  # MPEG frame sync
    return AudioFormat.UNKNOWN


# ─── WAV decode (native RIFF parser) ─────────────────────────────────────────


def _g711_tables() -> tuple[np.ndarray, np.ndarray]:
    """256-entry (alaw, mulaw) → int16 decode tables per ITU-T G.711
    (the CCITT/Sun reference expansion; same numerics dr_wav uses for WAV
    format tags 6/7, audio_io.cpp via drwav — reference README.md:503)."""
    codes = np.arange(256, dtype=np.int32)

    # A-law: toggle even bits, then segment/mantissa expansion
    a = codes ^ 0x55
    mant = (a & 0x0F) << 4
    seg = (a & 0x70) >> 4
    t = np.where(seg == 0, mant + 8, (mant + 0x108) << np.maximum(seg - 1, 0))
    alaw = np.where(a & 0x80, t, -t).astype(np.int16)

    # µ-law: complement, biased mantissa, segment shift
    u = (~codes) & 0xFF
    t = (((u & 0x0F) << 3) + 0x84) << ((u & 0x70) >> 4)
    mulaw = np.where(u & 0x80, 0x84 - t, t - 0x84).astype(np.int16)
    return alaw, mulaw


_ALAW_TABLE, _MULAW_TABLE = _g711_tables()


def _parse_wav(data: bytes):
    """→ (interleaved float32 (N*ch,), sample_rate, channels)."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("Not a RIFF/WAVE file")
    pos = 12
    fmt = None
    fmt_body = b""
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            if len(body) < 16:
                raise ValueError("WAV fmt chunk too short")
            fmt = struct.unpack("<HHIIHH", body[:16])
            fmt_body = body
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or raw is None:
        raise ValueError("WAV missing fmt/data chunk")
    audio_fmt, channels, sample_rate, _, _, bits = fmt
    if sample_rate == 0 or channels == 0:
        raise ValueError("WAV header has zero sample rate or channel count")
    if audio_fmt == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE: real tag leads SubFormat GUID
        if len(fmt_body) >= 26:
            (audio_fmt,) = struct.unpack("<H", fmt_body[24:26])
        else:
            raise ValueError("WAVE_FORMAT_EXTENSIBLE fmt chunk too short")

    if audio_fmt == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif bits == 8:
            x = (np.frombuffer(raw, "u1").astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            b = np.frombuffer(raw, "u1").reshape(-1, 3)
            x = (
                (b[:, 0].astype(np.int32))
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
        elif bits == 32:
            x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"Unsupported WAV PCM bit depth: {bits}")
    elif audio_fmt == 3:  # IEEE float
        if bits == 32:
            x = np.frombuffer(raw, "<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(raw, "<f8").astype(np.float32)
        else:
            raise ValueError(f"Unsupported WAV float bit depth: {bits}")
    elif audio_fmt in (6, 7):  # G.711 A-law / µ-law (8-bit codes)
        if bits not in (0, 8):
            raise ValueError(f"G.711 WAV must be 8-bit, got {bits}")
        table = _ALAW_TABLE if audio_fmt == 6 else _MULAW_TABLE
        x = table[np.frombuffer(raw, "u1")].astype(np.float32) / 32768.0
    else:
        raise ValueError(f"Unsupported WAV format tag: {audio_fmt}")
    return x, sample_rate, channels


def _decode_with_backend(data: bytes, fmt: str):
    """FLAC via the repository's decoder (csrc/flac_decoder.cpp), MP3 and
    OGG via the system libraries; all three also via optional python
    backends."""
    import io as _io

    # Native/system decoders first; on failure fall through to the python
    # backends below, which may handle streams these decoders can't. The
    # native failure is preserved and chained so a corrupt file surfaces its
    # real cause, not just "no decoder available".
    native_err: Exception | None = None
    try:
        if fmt == AudioFormat.FLAC:
            from parakeet_tpu_torch.audio.codecs import flac_available, flac_decode

            if flac_available():
                return flac_decode(data)
        if fmt == AudioFormat.MP3:
            from parakeet_tpu_torch.audio.codecs import mp3_available, mp3_decode

            if mp3_available():
                return mp3_decode(data)
        if fmt == AudioFormat.OGG:
            from parakeet_tpu_torch.audio.codecs import ogg_available, ogg_decode

            if ogg_available():
                return ogg_decode(data)
    except (ValueError, RuntimeError) as e:
        native_err = e

    try:
        import soundfile  # type: ignore

        x, sr = soundfile.read(_io.BytesIO(data), dtype="float32", always_2d=True)
        return x.reshape(-1), sr, x.shape[1]
    except ImportError:
        pass
    except Exception as e:  # noqa: BLE001 — a failing backend must not
        # preempt the next one (e.g. libsndfile without MP3 support raises
        # LibsndfileError while librosa could still decode the stream)
        native_err = native_err or e
    try:
        import librosa  # type: ignore

        x, sr = librosa.load(_io.BytesIO(data), sr=None, mono=False)
        if x.ndim == 1:
            return x.astype(np.float32), int(sr), 1
        return x.T.reshape(-1).astype(np.float32), int(sr), x.shape[0]
    except ImportError:
        pass
    except Exception as e:  # noqa: BLE001 — keep the first real failure
        native_err = native_err or e
    if native_err is not None:
        raise RuntimeError(
            f"Decoding {fmt} failed: {native_err} (no python fallback backend available)"
        ) from native_err
    raise RuntimeError(
        f"No decoder available for {fmt} (install soundfile or librosa); "
        "WAV decoding is always available"
    )


# ─── Downmix + resample ──────────────────────────────────────────────────────


def downmix_to_mono(interleaved: np.ndarray, channels: int) -> np.ndarray:
    """Mean across channels (audio_io.cpp:198-214). Native C++ when built."""
    if channels == 1:
        return interleaved.astype(np.float32)
    out = native.downmix_to_mono(np.asarray(interleaved, np.float32), channels)
    if out is not None:
        return out
    n = len(interleaved) // channels
    return interleaved[: n * channels].reshape(n, channels).mean(axis=1).astype(np.float32)


def _kaiser(x: np.ndarray, n: float, beta: float) -> np.ndarray:
    """Kaiser window at positions x ∈ [0, N] (audio_io.cpp:114-124)."""
    arg = 2.0 * x / n - 1.0
    val = np.maximum(1.0 - arg * arg, 0.0)
    return np.i0(beta * np.sqrt(val)) / np.i0(beta)


def resample(samples: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Windowed-sinc resampler, numerics per audio_io.cpp:123-195.

    Uses the native C++ implementation (native.py) when available; the
    numpy path below is the fallback, computed RESAMPLE_CHUNK output
    samples at a time (each output's 32-tap window is independent of the
    others, so chunking changes no value) to bound its float64
    temporaries."""
    x = np.asarray(samples, np.float32).reshape(-1)
    if src_rate == dst_rate:
        return x.copy()
    out = native.sinc_resample(x, src_rate, dst_rate)
    if out is not None:
        return out
    g = math.gcd(src_rate, dst_rate)
    up, down = dst_rate // g, src_rate // g
    n_out = (len(x) * up + down - 1) // down
    out = np.empty(n_out, np.float32)
    for lo in range(0, n_out, RESAMPLE_CHUNK):
        hi = min(lo + RESAMPLE_CHUNK, n_out)
        out[lo:hi] = _resample_rows(x, src_rate, dst_rate, lo, hi)
    return out


def _resample_rows(x: np.ndarray, src_rate: int, dst_rate: int, lo: int, hi: int) -> np.ndarray:
    """Output samples [lo, hi) of the numpy resampler."""
    n_in = len(x)
    half_width = 16
    beta = 7.857
    ratio = src_rate / dst_rate
    cutoff = min(1.0, 1.0 / max(ratio, 1.0))
    width_factor = max(1.0, ratio)
    sample_ratio = dst_rate / src_rate

    i = np.arange(lo, hi, dtype=np.float64)
    src_pos = i / sample_ratio  # (hi - lo,)
    center = np.floor(src_pos).astype(np.int64)
    offs = np.arange(-half_width + 1, half_width + 1)  # 32 taps
    j = center[:, None] + offs[None, :]  # (hi - lo, 32)
    valid = (j >= 0) & (j < n_in)
    dist = src_pos[:, None] - j
    window_pos = dist / width_factor
    w = np.where(np.abs(window_pos) <= half_width,
                 _kaiser(window_pos + half_width, 2.0 * half_width, beta), 0.0)
    xs = dist * cutoff * math.pi
    sinc = np.where(np.abs(xs) < 1e-10, 1.0, np.sin(xs) / np.where(xs == 0, 1, xs))
    weight = sinc * w * cutoff * valid
    vals = x[np.clip(j, 0, n_in - 1)] * weight
    wsum = weight.sum(axis=1)
    out = np.where(wsum > 1e-10, vals.sum(axis=1) / np.where(wsum == 0, 1, wsum), 0.0)
    return out.astype(np.float32)


# ─── read_audio (audio_io.cpp:266-523) ───────────────────────────────────────


def _decode_bytes(data: bytes, fmt_hint: str = AudioFormat.UNKNOWN):
    fmt = fmt_hint
    if fmt == AudioFormat.UNKNOWN:
        fmt = detect_format_by_magic(data)
    if fmt == AudioFormat.UNKNOWN:
        raise ValueError("Unknown audio format (magic bytes not recognized)")
    if fmt == AudioFormat.WAV:
        inter, sr, ch = _parse_wav(data)
    else:
        inter, sr, ch = _decode_with_backend(data, fmt)
    return inter, sr, ch, fmt


def read_audio(
    source,
    target_sample_rate: int = 16000,
    *,
    sample_rate: int | None = None,
    format_hint: str = AudioFormat.UNKNOWN,
) -> AudioData:
    """Load audio from a path, a bytes buffer, or raw PCM arrays.

    Raw PCM: pass a float32/float64 array (with `sample_rate=`) or an int16
    array (scaled by 1/32768, matching the reference's int16 overload).
    """
    if isinstance(source, (str, Path)):
        path = Path(source)
        if not path.is_file():
            raise FileNotFoundError(f"Audio file not found: {path}")
        data = path.read_bytes()
        hint = detect_format_by_extension(path)
        inter, sr, ch, fmt = _decode_bytes(data, hint)
    elif isinstance(source, (bytes, bytearray, memoryview)):
        inter, sr, ch, fmt = _decode_bytes(bytes(source), format_hint)
    else:
        arr = np.asarray(source)
        if sample_rate is None:
            raise ValueError("sample_rate= required for raw PCM input")
        if arr.ndim == 2:
            ch = arr.shape[1]  # (frames, channels) → interleave for downmix
            arr = arr.reshape(-1)
        elif arr.ndim == 1:
            ch = 1
        else:
            raise ValueError(f"raw PCM input must be 1D or (frames, channels), got shape {arr.shape}")
        if arr.dtype == np.int16:
            inter = arr.astype(np.float32) / 32768.0
        else:
            inter = arr.astype(np.float32)
        sr, fmt = int(sample_rate), "raw"

    mono = downmix_to_mono(inter, ch)
    n_orig = len(mono)
    out = resample(mono, sr, target_sample_rate) if sr != target_sample_rate else mono
    return AudioData(
        samples=out,
        sample_rate=target_sample_rate,
        original_sample_rate=sr,
        num_channels=ch,
        num_samples=len(out),
        duration=n_orig / sr if sr else 0.0,
        format=fmt,
    )


def _flac_streaminfo_duration(data: bytes) -> float | None:
    """Duration from the FLAC STREAMINFO metadata block (no decode).

    Mirrors the reference's drflac header path (audio_io.cpp:553-562):
    totalPCMFrameCount / sampleRate, both read from STREAMINFO. Returns None
    when the header is unparsable or the total-samples field is 0
    ("unknown" per the FLAC spec) — caller falls back to full decode."""
    if len(data) < 4 or data[:4] != b"fLaC":
        return None
    pos = 4
    while pos + 4 <= len(data):
        hdr = data[pos]
        btype = hdr & 0x7F
        (length,) = struct.unpack(">I", b"\x00" + data[pos + 1 : pos + 4])
        body = data[pos + 4 : pos + 4 + length]
        if btype == 0:  # STREAMINFO
            if len(body) < 18:
                return None
            sr = (body[10] << 12) | (body[11] << 4) | (body[12] >> 4)
            total = (
                ((body[13] & 0x0F) << 32)
                | (body[14] << 24)
                | (body[15] << 16)
                | (body[16] << 8)
                | body[17]
            )
            if sr == 0 or total == 0:
                return None
            return total / sr
        if hdr & 0x80:  # last-metadata-block flag
            break
        pos += 4 + length
    return None


def _ogg_granule_duration(data: bytes) -> float | None:
    """Duration from OGG page headers (no decode): sample rate from the
    Vorbis identification header, total samples from the last page's
    granule position — the stb_vorbis stream_length_in_samples approach the
    reference uses (audio_io.cpp:568-582)."""
    if len(data) < 27 or data[:4] != b"OggS":
        return None
    # Vorbis id header packet: \x01vorbis | version u32 | channels u8 | rate u32
    ident = data.find(b"\x01vorbis", 0, 4096)
    if ident < 0 or ident + 16 > len(data):
        return None
    (sr,) = struct.unpack("<I", data[ident + 12 : ident + 16])
    if sr == 0:
        return None
    # Last page with a valid granulepos (bytes 6..14 of the page header).
    # 'OggS' is not escaped inside page payloads, so a raw byte match can be
    # a false sync — validate the stream-structure version byte (must be 0)
    # and the header-type flags (only bits 0..2 defined) before trusting it.
    pos = len(data)
    while True:
        pos = data.rfind(b"OggS", 0, pos)
        if pos < 0:
            return None
        if pos + 27 <= len(data) and data[pos + 4] == 0 and data[pos + 5] <= 0x07:
            (granule,) = struct.unpack("<q", data[pos + 6 : pos + 14])
            if granule >= 0:
                return granule / sr


def get_audio_duration(path: str | Path) -> float:
    """Header-only duration for WAV/FLAC/OGG; full decode fallback for MP3
    and unparsable headers (audio_io.cpp:527-586)."""
    path = Path(path)
    data = path.read_bytes()
    fmt = detect_format_by_extension(path)
    if fmt == AudioFormat.UNKNOWN:
        fmt = detect_format_by_magic(data)
    if fmt == AudioFormat.WAV:
        x, sr, ch = _parse_wav(data)
        return len(x) / ch / sr
    if fmt == AudioFormat.FLAC:
        d = _flac_streaminfo_duration(data)
        if d is not None:
            return d
    elif fmt == AudioFormat.OGG:
        d = _ogg_granule_duration(data)
        if d is not None:
            return d
    # full-decode fallback (MP3 etc.): duration needs only the decoded
    # sample count at the ORIGINAL rate — skip the resampler entirely
    # (materializing a resample of an hour-long file just to discard it)
    inter, sr, ch, _ = _decode_bytes(data, fmt)
    return len(inter) / ch / sr if sr else 0.0


def write_wav(path: str | Path, samples: np.ndarray, sample_rate: int = 16000) -> None:
    """Write mono float32 samples as 16-bit PCM WAV (test/tooling helper)."""
    import wave

    x = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
    pcm = (x * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


__all__ = [
    "AudioData",
    "AudioFormat",
    "detect_format_by_extension",
    "detect_format_by_magic",
    "downmix_to_mono",
    "resample",
    "read_audio",
    "get_audio_duration",
    "write_wav",
]
