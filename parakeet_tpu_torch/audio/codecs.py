"""FLAC, MP3 and OGG decoding (port of parakeet_tpu/audio/codecs.py; the
MP3 and OGG loaders are copied, not imported).

  * FLAC: the repository's standalone decoder csrc/flac_decoder.cpp
    (`pk_flac_decode`, `pk_free`), built with g++ by ops/_build.py
    `build_host` into build/parakeet_tpu_torch/ on first use, named by a
    hash of the source. Output f32.
  * MP3: libmpg123 feed API — works from memory buffers. Output f32.
  * OGG: libvorbisfile via ov_fopen (memory buffers go through a temp
    file — the ov_callbacks by-value struct does not marshal reliably
    through ctypes here). OggVorbis_File is treated as opaque (oversized
    buffer, library-initialized); the only layout relied on is the head of
    `vorbis_info` (version/channels/rate), frozen for 20+ years.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_MPG123_OK = 0
_MPG123_NEED_MORE = -10
_MPG123_NEW_FORMAT = -11
_MPG123_DONE = -12
_ENC_SIGNED_16 = 0xD0
_ENC_FLOAT_32 = 0x200

_lock = threading.Lock()
_mpg123: ctypes.CDLL | None = None
_tried = False


# ─── FLAC via the repository's decoder (csrc/flac_decoder.cpp) ───────────────

_flac: ctypes.CDLL | None = None
_flac_tried = False


def _load_flac() -> ctypes.CDLL | None:
    """Build (g++) and load the FLAC decoder once; None without a compiler."""
    global _flac, _flac_tried
    with _lock:
        if _flac_tried:
            return _flac
        _flac_tried = True
        from parakeet_tpu_torch.ops._build import build_host

        try:
            lib = ctypes.CDLL(str(build_host("flac_decoder")))
        except (OSError, RuntimeError):
            return None
        c_float_p = ctypes.POINTER(ctypes.c_float)
        lib.pk_flac_decode.restype = ctypes.c_int
        lib.pk_flac_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
            ctypes.POINTER(c_float_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.pk_free.restype = None
        lib.pk_free.argtypes = [ctypes.c_void_p]
        _flac = lib
        return _flac


def flac_available() -> bool:
    return _load_flac() is not None


def flac_decode(data: bytes):
    """FLAC bytes → (interleaved float32, sample_rate, channels)."""
    lib = _load_flac()
    if lib is None:
        raise RuntimeError("the FLAC decoder library could not be built (g++ missing?)")
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    out_p = ctypes.POINTER(ctypes.c_float)()
    frames = ctypes.c_int64()
    channels = ctypes.c_int()
    rate = ctypes.c_int()
    rc = lib.pk_flac_decode(buf, len(data), ctypes.byref(out_p),
                            ctypes.byref(frames), ctypes.byref(channels), ctypes.byref(rate))
    if rc != 0:
        raise ValueError(f"FLAC decode failed (error {rc})")
    try:
        n = frames.value * channels.value
        arr = np.ctypeslib.as_array(out_p, shape=(n,)).copy()
    finally:
        lib.pk_free(out_p)
    return arr, rate.value, channels.value


# ─── MP3 via libmpg123 ───────────────────────────────────────────────────────


def _load_mpg123() -> ctypes.CDLL | None:
    global _mpg123, _tried
    with _lock:
        if _tried:
            return _mpg123
        _tried = True
        for name in ("libmpg123.so.0", "libmpg123.so"):
            try:
                lib = ctypes.CDLL(name)
                break
            except OSError:
                lib = None
        if lib is None:
            return None
        lib.mpg123_init.restype = ctypes.c_int
        lib.mpg123_new.restype = ctypes.c_void_p
        lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_open_feed.restype = ctypes.c_int
        lib.mpg123_open_feed.argtypes = [ctypes.c_void_p]
        lib.mpg123_feed.restype = ctypes.c_int
        lib.mpg123_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
        lib.mpg123_read.restype = ctypes.c_int
        lib.mpg123_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                                    ctypes.POINTER(ctypes.c_size_t)]
        lib.mpg123_getformat.restype = ctypes.c_int
        lib.mpg123_getformat.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
                                         ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_format_none.restype = ctypes.c_int
        lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
        lib.mpg123_format.restype = ctypes.c_int
        lib.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int, ctypes.c_int]
        lib.mpg123_close.argtypes = [ctypes.c_void_p]
        lib.mpg123_delete.argtypes = [ctypes.c_void_p]
        lib.mpg123_init()
        _mpg123 = lib
        return _mpg123


def mp3_available() -> bool:
    return _load_mpg123() is not None


def mp3_decode(data: bytes):
    """MP3 bytes → (interleaved float32, sample_rate, channels)."""
    lib = _load_mpg123()
    if lib is None:
        raise RuntimeError("libmpg123 not available for MP3 decoding")
    err = ctypes.c_int()
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise RuntimeError(f"mpg123_new failed ({err.value})")
    try:
        if lib.mpg123_open_feed(h) != _MPG123_OK:
            raise RuntimeError("mpg123_open_feed failed")
        if lib.mpg123_feed(h, data, len(data)) != _MPG123_OK:
            raise ValueError("mpg123_feed rejected data (not MP3?)")

        rate = ctypes.c_long()
        channels = ctypes.c_int()
        enc = ctypes.c_int()
        chunks: list[bytes] = []
        buf = (ctypes.c_char * 65536)()
        done = ctypes.c_size_t()
        sample_rate = 0
        n_ch = 0
        use_float = False

        while True:
            rc = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(bytes(buf[: done.value]))
            if rc == _MPG123_NEW_FORMAT:
                if chunks:
                    # PCM from two formats must not be concatenated under
                    # one (rate, channels) label — wrong-speed audio
                    raise ValueError("MP3 stream changes format mid-stream")
                lib.mpg123_getformat(h, ctypes.byref(rate), ctypes.byref(channels), ctypes.byref(enc))
                sample_rate, n_ch = int(rate.value), int(channels.value)
                use_float = bool(enc.value & _ENC_FLOAT_32)
                if not use_float and enc.value != _ENC_SIGNED_16:
                    # anything else would be silently misparsed as s16le
                    raise ValueError(
                        f"unsupported mpg123 output encoding 0x{enc.value:x} "
                        "(expected float32 or signed 16-bit)"
                    )
            elif rc in (_MPG123_OK,):
                continue
            elif rc in (_MPG123_NEED_MORE, _MPG123_DONE):
                break  # fed everything already → stream exhausted
            else:
                raise ValueError(f"mpg123_read error {rc}")

        if not chunks or sample_rate == 0:
            raise ValueError("no audio decoded from MP3 data")
        raw = b"".join(chunks)
        if use_float:
            samples = np.frombuffer(raw, "<f4").astype(np.float32)
        else:
            samples = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        return samples, sample_rate, n_ch
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)


# ─── OGG Vorbis via libvorbisfile ────────────────────────────────────────────


class _VorbisInfoHead(ctypes.Structure):
    # head of vorbis_info (codec.h): int version; int channels; long rate;
    _fields_ = [("version", ctypes.c_int), ("channels", ctypes.c_int),
                ("rate", ctypes.c_long)]


_vorbisfile: ctypes.CDLL | None = None
_vf_tried = False


def _load_vorbisfile() -> ctypes.CDLL | None:
    global _vorbisfile, _vf_tried
    with _lock:
        if _vf_tried:
            return _vorbisfile
        _vf_tried = True
        for name in ("libvorbisfile.so.3", "libvorbisfile.so"):
            try:
                lib = ctypes.CDLL(name)
                break
            except OSError:
                lib = None
        if lib is None:
            return None
        lib.ov_fopen.restype = ctypes.c_int
        lib.ov_fopen.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        lib.ov_open.restype = ctypes.c_int
        lib.ov_open.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_char_p, ctypes.c_long]
        lib.ov_read.restype = ctypes.c_long
        lib.ov_read.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_int)]
        lib.ov_info.restype = ctypes.POINTER(_VorbisInfoHead)
        lib.ov_info.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ov_clear.restype = ctypes.c_int
        lib.ov_clear.argtypes = [ctypes.c_void_p]
        _vorbisfile = lib
        return _vorbisfile


def ogg_available() -> bool:
    return _load_vorbisfile() is not None


def _ov_read_all(lib, vf):
    """Drain an opened OggVorbis_File → (interleaved f32, rate, channels)."""
    info = lib.ov_info(vf, -1)
    if not info:
        raise ValueError("ov_info failed")
    channels, rate = info.contents.channels, int(info.contents.rate)
    chunks: list[bytes] = []
    buf = ctypes.create_string_buffer(65536)
    bitstream = ctypes.c_int(0)
    while True:
        n = lib.ov_read(vf, buf, len(buf), 0, 2, 1, ctypes.byref(bitstream))
        if n == 0:
            break
        if n < 0:
            raise ValueError(f"ov_read error {n}")
        chunks.append(buf.raw[:n])
    raw = b"".join(chunks)
    samples = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    return samples, rate, channels


def _libc():
    libc = ctypes.CDLL(None)
    libc.fmemopen.restype = ctypes.c_void_p
    libc.fmemopen.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p]
    libc.fclose.argtypes = [ctypes.c_void_p]
    return libc


def ogg_decode(data: bytes):
    """OGG Vorbis bytes → (interleaved float32, sample_rate, channels).

    In-memory path: glibc `fmemopen` wraps the buffer as a FILE* that
    `ov_open` consumes directly — no filesystem traffic on serving paths.
    On a successful ov_open the FILE* is owned by vorbisfile (ov_clear
    closes it); on failure we fclose it ourselves. The temp-file ov_fopen
    path remains as fallback for libcs without fmemopen."""
    lib = _load_vorbisfile()
    if lib is None:
        raise RuntimeError("libvorbisfile not available for OGG decoding")

    vf = ctypes.create_string_buffer(8192)  # OggVorbis_File, treated opaque
    try:
        libc = _libc()
    except (OSError, AttributeError):
        libc = None
    if libc is not None and getattr(libc, "fmemopen", None):
        # buf must outlive the whole decode: fmemopen reads from it lazily
        buf = ctypes.create_string_buffer(data, len(data))
        fp = libc.fmemopen(buf, len(data), b"rb")
        if fp:
            rc = lib.ov_open(fp, vf, None, 0)
            if rc != 0:
                libc.fclose(fp)
                raise ValueError(f"not an OGG Vorbis stream (ov_open={rc})")
            try:
                return _ov_read_all(lib, vf)
            finally:
                lib.ov_clear(vf)  # closes the fmemopen FILE*
                del buf

    import os
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".ogg", delete=False) as f:
        f.write(data)
        tmp_path = f.name
    rc = lib.ov_fopen(tmp_path.encode(), vf)
    if rc != 0:
        os.unlink(tmp_path)
        raise ValueError(f"not an OGG Vorbis stream (ov_fopen={rc})")
    try:
        return _ov_read_all(lib, vf)
    finally:
        lib.ov_clear(vf)
        os.unlink(tmp_path)


__all__ = ["flac_available", "flac_decode", "mp3_available", "mp3_decode", "ogg_available", "ogg_decode"]
