"""The port's flat C API (parakeet_tpu_torch/csrc/parakeet_capi.cpp and
parakeet.h over parakeet_tpu_torch/capi.py, built by ops/_build.py
build_capi) on the CPU: the cases of tests/test_capi.py through the port's
library, results equal to the JAX package's C API on the same tiny models.

Two integration levels, as there: ctypes loads both libraries into this
Python process (each attaches to the running interpreter), and a C program
compiled here links the port's library and runs as its own process (the
library boots CPython itself)."""

import ctypes
import json
import os
import subprocess
import sys
import sysconfig
import wave
from pathlib import Path

import numpy as np
import pytest

from parakeet_tpu_torch.ops._build import _CSRC, build_capi

pytestmark = pytest.mark.skipif(
    sysconfig.get_config_var("Py_ENABLE_SHARED") != 1,
    reason="no shared libpython (embed config unavailable)",
)

REPO = Path(__file__).resolve().parent.parent
PIECES = ["<unk>", "▁a", "▁b", "a", "b"]
CPU = b'"device": "cpu"'


def _bind(path):
    lib = ctypes.CDLL(str(path))
    f_p, s_p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int16)
    for name, res, args in (
        ("parakeet_create", ctypes.c_int64, [ctypes.c_char_p] * 4),
        ("parakeet_transcribe", ctypes.c_void_p, [ctypes.c_int64, ctypes.c_char_p]),
        ("parakeet_transcribe_pcm", ctypes.c_void_p, [ctypes.c_int64, f_p, ctypes.c_int64, ctypes.c_int32]),
        ("parakeet_transcribe_pcm_s16", ctypes.c_void_p, [ctypes.c_int64, s_p, ctypes.c_int64, ctypes.c_int32]),
        ("parakeet_align", ctypes.c_void_p, [ctypes.c_int64, ctypes.c_char_p, ctypes.c_char_p]),
        ("parakeet_diarize_create", ctypes.c_int64, [ctypes.c_char_p] * 5),
        ("parakeet_diarize", ctypes.c_void_p, [ctypes.c_int64, ctypes.c_char_p]),
        ("parakeet_stream_create", ctypes.c_int64, [ctypes.c_char_p] * 4),
        ("parakeet_stream_feed", ctypes.c_void_p, [ctypes.c_int64, f_p, ctypes.c_int64]),
        ("parakeet_stream_text", ctypes.c_void_p, [ctypes.c_int64]),
        ("parakeet_stream_reset", None, [ctypes.c_int64]),
        ("parakeet_destroy", None, [ctypes.c_int64]),
        ("parakeet_last_error", ctypes.c_char_p, []),
        ("parakeet_version", ctypes.c_void_p, []),
        ("parakeet_free_string", None, [ctypes.c_void_p]),
    ):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


@pytest.fixture(scope="module")
def capi():
    path = build_capi()
    if path is None:
        pytest.skip("C API build unavailable")
    return _bind(path)


@pytest.fixture(scope="module")
def ref_capi():
    from parakeet_tpu.native import build_capi as ref_build

    path = ref_build()
    if path is None:
        pytest.skip("the JAX package's C API build failed (no toolchain)")
    return _bind(path)


def _take(lib, ptr) -> str:
    assert ptr, f"C API error: {lib.parakeet_last_error().decode()}"
    try:
        return ctypes.string_at(ptr).decode()
    finally:
        lib.parakeet_free_string(ptr)


def _opts(extra: bytes, device: bool) -> bytes:
    """An options object, with "device": "cpu" for the port (the JAX
    package's process is already pinned to the CPU by conftest)."""
    items = [x for x in (CPU if device else b"", extra) if x]
    return b"{" + b", ".join(items) + b"}"


@pytest.fixture(scope="module")
def handles(capi, ref_capi):
    """(port, reference) handles of test-tiny, CTC decode with timestamps."""
    made = []
    for lib, dev in ((capi, True), (ref_capi, False)):
        h = lib.parakeet_create(b"test-tiny", None, None, _opts(b'"decoder": "ctc", "timestamps": true', dev))
        assert h > 0, lib.parakeet_last_error().decode()
        made.append(h)
    yield made
    capi.parakeet_destroy(made[0])
    ref_capi.parakeet_destroy(made[1])


def _sine(n=12000, hz=440.0, sr=16000):
    t = np.arange(n) / sr
    return (0.4 * np.sin(2 * np.pi * hz * t)).astype(np.float32)


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _wav(path, pcm):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((pcm * 32767).astype("<i2").tobytes())
    return str(path).encode()


def _same(got: dict, ref: dict):
    """Equal results; word confidences to f32 rounding (rtol 1e-4)."""
    strip = lambda r: {k: ([{**w, "confidence": None} for w in v] if k == "words" else v) for k, v in r.items()}
    assert strip(got) == strip(ref)
    np.testing.assert_allclose([w["confidence"] for w in got.get("words", [])],
                               [w["confidence"] for w in ref.get("words", [])], rtol=1e-4)


def _both(capi, ref_capi, handles, call, *args):
    got = json.loads(_take(capi, getattr(capi, call)(handles[0], *args)))
    ref = json.loads(_take(ref_capi, getattr(ref_capi, call)(handles[1], *args)))
    _same(got, ref)
    return got


@pytest.mark.parametrize("model,options,message", [
    (b"no-such-model", None, b"no-such-model"),
    (b"test-tiny", b"[1,2]", b"JSON object"),
    (b"test-tiny", b'{"device": "cpu", "cpu_devices": 8}', b"NotImplementedError"),
    (b"test-tiny", b'{"device": "cpu", "kernels": false}', b"kernels=False"),
])
def test_create_rejects(capi, model, options, message):
    assert capi.parakeet_create(model, None, None, options) == 0
    assert message in capi.parakeet_last_error()


def test_create_defaults_to_the_card(capi):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    assert capi.parakeet_create(b"test-tiny", None, None, None) == 0
    assert b'device="cpu"' in capi.parakeet_last_error()


def test_transcribe_pcm_roundtrip(capi, ref_capi, handles):
    pcm = _sine()
    res = _both(capi, ref_capi, handles, "parakeet_transcribe_pcm", _fptr(pcm), len(pcm), 16000)
    assert set(res) == {"text", "token_ids", "words"}
    assert res["token_ids"]
    for w in res["words"]:
        assert set(w) == {"word", "start", "end", "confidence"}


def test_transcribe_pcm_s16_matches_f32(capi, ref_capi, handles):
    pcm = _sine()
    s16 = (pcm * 32768.0).clip(-32768, 32767).astype(np.int16)
    f32_wire = s16.astype(np.float32) / 32768.0
    r_f = _both(capi, ref_capi, handles, "parakeet_transcribe_pcm", _fptr(f32_wire), len(pcm), 16000)
    r_s = _both(capi, ref_capi, handles, "parakeet_transcribe_pcm_s16",
                s16.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), len(s16), 16000)
    assert r_f["token_ids"] == r_s["token_ids"]


@pytest.mark.parametrize("rate", [8000, 44100])
def test_transcribe_pcm_resamples(capi, ref_capi, handles, rate):
    pcm = _sine(rate * 3 // 4, sr=rate)
    res = _both(capi, ref_capi, handles, "parakeet_transcribe_pcm", _fptr(pcm), len(pcm), rate)
    assert res["token_ids"]


def test_transcribe_file(capi, ref_capi, handles, tmp_path):
    res = _both(capi, ref_capi, handles, "parakeet_transcribe", _wav(tmp_path / "clip.wav", _sine()))
    assert isinstance(res["token_ids"], list)


def test_transcribe_file_missing_errors(capi, handles):
    assert capi.parakeet_transcribe(handles[0], b"/nope/missing.wav") is None
    assert b"missing.wav" in capi.parakeet_last_error()


def test_invalid_handle_errors(capi):
    pcm = _sine(1600)
    assert capi.parakeet_transcribe_pcm(999999, _fptr(pcm), len(pcm), 16000) is None
    assert b"999999" in capi.parakeet_last_error()


def test_version(capi, ref_capi):
    assert _take(capi, capi.parakeet_version()) == _take(ref_capi, ref_capi.parakeet_version())


def test_align_over_c_api(capi, ref_capi, tmp_path):
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(PIECES) + "\n")
    hs = [lib.parakeet_create(b"test-tiny", None, str(vocab).encode(), _opts(b"", dev))
          for lib, dev in ((capi, True), (ref_capi, False))]
    assert min(hs) > 0
    path = _wav(tmp_path / "clip.wav", _sine(24000))
    res = _both(capi, ref_capi, hs, "parakeet_align", path, b"a b ab")
    assert len(res["words"]) == 3
    assert [w["start"] for w in res["words"]] == sorted(w["start"] for w in res["words"])
    assert capi.parakeet_align(hs[0], path, b"a b " * 200) is None  # too short a clip
    assert b"frames" in capi.parakeet_last_error()
    capi.parakeet_destroy(hs[0])
    ref_capi.parakeet_destroy(hs[1])


def test_diarize_over_c_api(capi, ref_capi, tmp_path):
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(PIECES) + "\n")
    hs = [lib.parakeet_diarize_create(b"test-tiny-diarized", None, None, str(vocab).encode(), _opts(b"", dev))
          for lib, dev in ((capi, True), (ref_capi, False))]
    assert min(hs) > 0, capi.parakeet_last_error().decode()
    path = _wav(tmp_path / "clip.wav", _sine(12000))
    got = json.loads(_take(capi, capi.parakeet_diarize(hs[0], path)))
    ref = json.loads(_take(ref_capi, ref_capi.parakeet_diarize(hs[1], path)))
    assert set(got) == {"text", "words", "segments"}
    assert got["segments"] == ref["segments"]
    assert [(w["word"], w["speaker"]) for w in got["words"]] == [(w["word"], w["speaker"]) for w in ref["words"]]
    assert capi.parakeet_transcribe(hs[0], path) is None  # kind mismatch
    assert b"diarized" in capi.parakeet_last_error()
    capi.parakeet_destroy(hs[0])
    ref_capi.parakeet_destroy(hs[1])
    assert capi.parakeet_diarize_create(b"bogus", None, None, None, None) == 0
    assert b"bogus" in capi.parakeet_last_error()


def test_streaming_matches_facade_and_reference(capi, ref_capi):
    """Token-identical to the port's facade fed the same chunks with the
    same seed, and to the JAX C API; reset + refeed is deterministic."""
    from parakeet_tpu_torch.capi import _tiny_stream_config
    from parakeet_tpu_torch.streaming import StreamingTranscriber

    hs = [lib.parakeet_stream_create(b"test-tiny-stream", None, None, _opts(b'"seed": 31', dev))
          for lib, dev in ((capi, True), (ref_capi, False))]
    assert min(hs) > 0, capi.parakeet_last_error().decode()
    facade = StreamingTranscriber(None, None, _tiny_stream_config(), seed=31, device="cpu")
    audio = (0.3 * np.random.RandomState(7).randn(16000)).astype(np.float32)

    def feed_all(lib, h):
        for off in range(0, len(audio), 3200):
            chunk = audio[off:off + 3200]
            _take(lib, lib.parakeet_stream_feed(h, _fptr(chunk), len(chunk)))
        return json.loads(_take(lib, lib.parakeet_stream_text(h)))

    for off in range(0, len(audio), 3200):
        facade.transcribe_chunk(audio[off:off + 3200])
    got = feed_all(capi, hs[0])
    assert got["token_ids"] == list(facade.get_tokens()) and got["token_ids"]
    assert got == feed_all(ref_capi, hs[1])
    capi.parakeet_stream_reset(hs[0])
    assert feed_all(capi, hs[0]) == got
    capi.parakeet_destroy(hs[0])
    ref_capi.parakeet_destroy(hs[1])


def test_stream_handle_kind_mismatch(capi, handles):
    pcm = _sine(3200)
    assert capi.parakeet_stream_feed(handles[0], _fptr(pcm), len(pcm)) is None
    assert b"offline" in capi.parakeet_last_error()
    h = capi.parakeet_stream_create(b"test-tiny-stream", None, None, b"{" + CPU + b"}")
    assert h > 0
    assert capi.parakeet_transcribe_pcm(h, _fptr(pcm), len(pcm), 16000) is None
    assert b"stream" in capi.parakeet_last_error()
    capi.parakeet_destroy(h)
    assert capi.parakeet_stream_create(b"bogus-stream", None, None, None) == 0
    assert b"bogus-stream" in capi.parakeet_last_error()


# a non-Python host of the port's library (its own copy of the JAX
# package's tests/helpers/capi_host.c, with every handle on the CPU)
C_HOST = r"""
#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "parakeet.h"

int main(void) {
  int64_t h = parakeet_create("test-tiny", NULL, NULL,
      "{\"device\":\"cpu\",\"decoder\":\"ctc\",\"timestamps\":true}");
  if (h == 0) { fprintf(stderr, "create failed: %s\n", parakeet_last_error()); return 1; }
  if (parakeet_create("no-such-model", NULL, NULL, NULL) != 0 ||
      strstr(parakeet_last_error(), "no-such-model") == NULL) {
    fprintf(stderr, "error path broken: %s\n", parakeet_last_error()); return 1;
  }
  enum { N = 12000 };
  float pcm[N];
  int16_t pcm16[N];
  for (int i = 0; i < N; i++) {
    pcm[i] = 0.4f * (float)sin(2.0 * 3.14159265358979 * 440.0 * i / 16000.0);
    pcm16[i] = (int16_t)(pcm[i] * 32767.0f);
  }
  char *res = parakeet_transcribe_pcm(h, pcm, N, 16000);
  if (res == NULL) { fprintf(stderr, "transcribe_pcm failed: %s\n", parakeet_last_error()); return 1; }
  printf("RESULT %s\n", res);
  parakeet_free_string(res);
  char *res16 = parakeet_transcribe_pcm_s16(h, pcm16, N, 16000);
  if (res16 == NULL) { fprintf(stderr, "transcribe_pcm_s16 failed: %s\n", parakeet_last_error()); return 1; }
  printf("RESULT16 %s\n", res16);
  parakeet_free_string(res16);
  int64_t sh = parakeet_stream_create("test-tiny-stream", NULL, NULL, "{\"device\":\"cpu\",\"seed\":3}");
  if (sh == 0) { fprintf(stderr, "stream_create failed: %s\n", parakeet_last_error()); return 1; }
  for (int c = 0; c < 2; c++) {
    char *s = parakeet_stream_feed(sh, pcm + c * 3200, 3200);
    if (s == NULL) { fprintf(stderr, "stream_feed failed: %s\n", parakeet_last_error()); return 1; }
    parakeet_free_string(s);
  }
  char *st = parakeet_stream_text(sh);
  if (st == NULL) { fprintf(stderr, "stream_text failed: %s\n", parakeet_last_error()); return 1; }
  printf("STREAM %s\n", st);
  parakeet_free_string(st);
  parakeet_stream_reset(sh);
  parakeet_destroy(sh);
  parakeet_destroy(h);
  char *v = parakeet_version();
  if (v == NULL) { fprintf(stderr, "version failed: %s\n", parakeet_last_error()); return 1; }
  parakeet_free_string(v);
  printf("OK\n");
  return 0;
}
"""


def test_standalone_c_host(capi, handles, tmp_path):
    """A C program linked against the port's library boots CPython itself
    and round-trips PCM → JSON; its result equals this process's."""
    lib = build_capi()
    src = tmp_path / "capi_host.c"
    src.write_text(C_HOST)
    exe = tmp_path / "capi_host"
    libdir = sysconfig.get_config_var("LIBDIR")
    pylib = f"python{sysconfig.get_config_var('VERSION')}{sys.abiflags}"
    subprocess.run(["gcc", "-O1", str(src), f"-I{_CSRC}", str(lib), f"-L{libdir}", f"-l{pylib}",
                    f"-Wl,-rpath,{lib.parent}", f"-Wl,-rpath,{libdir}", "-lm", "-o", str(exe)],
                   check=True, capture_output=True, timeout=120)
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([str(exe)], capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    lines = proc.stdout.splitlines()
    assert lines[-1] == "OK"
    res = json.loads(next(l for l in lines if l.startswith("RESULT ")).removeprefix("RESULT "))
    pcm = (0.4 * np.sin(2 * np.pi * 440.0 * np.arange(12000) / 16000.0)).astype(np.float32)
    here = json.loads(_take(capi, capi.parakeet_transcribe_pcm(handles[0], _fptr(pcm), len(pcm), 16000)))
    assert res["token_ids"] == here["token_ids"]
    sres = json.loads(next(l for l in lines if l.startswith("STREAM ")).removeprefix("STREAM "))
    assert set(sres) == {"text", "token_ids"}
