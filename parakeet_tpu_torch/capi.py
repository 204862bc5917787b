"""Python side of the port's flat C API (port of parakeet_tpu/capi.py).

The C shared library (parakeet_tpu_torch/csrc/parakeet_capi.cpp, header
csrc/parakeet.h, built by ops/_build.py `build_capi` into
build/parakeet_tpu_torch/libparakeet_c-<hash>.so) embeds — or attaches
to — CPython and funnels every call through this module, so the C side
stays a dumb string pipe: integer handles in, JSON out. The ABI is the
reference's; new knobs ride the `options_json` argument.

Handle lifecycle: `create` builds a facade and returns a positive int64
handle; `transcribe`/`transcribe_pcm` run inference; `destroy` drops the
facade. All errors raise — the C wrapper formats the exception into
`parakeet_last_error()`.

Options (JSON object, all optional):
    device          "cpu" | "cuda"  where the facade runs (default: the
                                    CUDA card; without one, create raises)
    cpu_devices     int             1 only: multi-device runs are not
                                    ported (NotImplementedError)
    decoder         "tdt" | "ctc"   decode head (tdt-ctc models)
    timestamps      bool            include word timestamps in results
    timestamp_mode  "words" | "sentences"
    beam_size       int             0 = greedy
    compute_dtype   "float32" | "bfloat16"
    quantize        "int8" | "int4" weight-only quantized inference
    kernels         bool | str      encoder kernels, as the facades'
                                    kernels= (transcribe.fused_layers_for;
                                    false raises)
    seed            int             random-init seed when weights_path
                                    is NULL (pipeline smoke tests)
"""

from __future__ import annotations

import json
import threading

_handles: dict[int, tuple] = {}
_lock = threading.Lock()
_next_handle = 1

#: models the C API can instantiate; "test-tiny" is a random-weight
#: smoke-test config (compiles in seconds, used by the C API tests)
MODELS = ("tdt-ctc-110m", "tdt-600m", "rnnt-600m", "test-tiny")


def _tiny_config():
    from parakeet_tpu_torch import config as C

    return C.TDTCTCConfig(
        encoder=C.EncoderConfig(mel_bins=80, subsampling_channels=16,
                                hidden_size=32, num_layers=2, num_heads=4,
                                ffn_intermediate=64),
        prediction=C.PredictionConfig(vocab_size=21, pred_hidden=16,
                                      num_lstm_layers=1),
        joint=C.JointConfig(encoder_hidden=32, pred_hidden=16,
                            joint_hidden=16, vocab_size=21),
        ctc_vocab_size=21,
    )


def _parse_options(options_json: str | None, facade_keys: tuple[str, ...]):
    """Shared option handling for every create path: JSON validation, the
    device, and the facade-constructor kwarg subset."""
    opts = json.loads(options_json) if options_json else {}
    if not isinstance(opts, dict):
        raise ValueError("options_json must be a JSON object")
    if int(opts.get("cpu_devices", 1)) > 1:
        raise NotImplementedError("cpu_devices > 1 (multi-device inference) is not ported yet")
    kw = {k: opts[k] for k in facade_keys if k in opts}
    if opts.get("device"):
        kw["device"] = opts["device"]
    return opts, kw


def _pcm_from(data, fmt: str):
    """C buffer (memoryview) → numpy PCM; fmt 'f32' or 's16' (int16 is
    scaled inside read_audio/transcribe_chunk, the reference's overload)."""
    import numpy as np

    if fmt == "f32":
        return np.frombuffer(data, dtype=np.float32)
    if fmt == "s16":
        return np.frombuffer(data, dtype=np.int16)
    raise ValueError(f"unknown PCM format {fmt!r} (want 'f32' or 's16')")


def create(model: str, weights_path: str | None, vocab_path: str | None,
           options_json: str | None) -> int:
    """Build a transcriber facade; returns a positive handle."""
    opts, kw = _parse_options(
        options_json, ("compute_dtype", "quantize", "seed", "kernels"))

    from parakeet_tpu_torch.transcribe import RNNTTranscriber, TDTTranscriber, Transcriber

    if model == "tdt-ctc-110m":
        tr = Transcriber(weights_path, vocab_path, **kw)
    elif model == "tdt-600m":
        tr = TDTTranscriber(weights_path, vocab_path, **kw)
    elif model == "rnnt-600m":
        tr = RNNTTranscriber(weights_path, vocab_path, **kw)
    elif model == "test-tiny":
        tr = Transcriber(weights_path, vocab_path, _tiny_config(), **kw)
    else:
        raise ValueError(f"unknown model {model!r} (want one of {', '.join(MODELS)})")

    return _register(tr, opts, "offline")


def _register(obj, opts: dict, kind: str) -> int:
    global _next_handle
    with _lock:
        h = _next_handle
        _next_handle += 1
        _handles[h] = (obj, opts, kind)
    return h


def _get(h: int, kind: str):
    with _lock:
        entry = _handles.get(h)
    if entry is None:
        raise KeyError(f"invalid parakeet handle {h}")
    if entry[2] != kind:
        raise TypeError(
            f"handle {h} is a {entry[2]} transcriber; this call needs {kind}")
    return entry[0], entry[1]


def _decode_opts(opts: dict):
    from parakeet_tpu_torch.decode.timestamp import TimestampMode
    from parakeet_tpu_torch.transcribe import Decoder

    return dict(
        decoder=Decoder.CTC if opts.get("decoder") == "ctc" else Decoder.TDT,
        timestamps=bool(opts.get("timestamps", False)),
        timestamp_mode=TimestampMode(opts.get("timestamp_mode", "words")),
        beam_size=int(opts.get("beam_size", 0)),
    )


def _result_json(res) -> str:
    return json.dumps({
        "text": res.text,
        "token_ids": list(res.token_ids),
        "words": [
            {"word": w.word, "start": w.start, "end": w.end,
             "confidence": w.confidence}
            for w in res.word_timestamps
        ],
    })


def transcribe(h: int, audio_path: str) -> str:
    """Transcribe an audio file (wav/flac/mp3/ogg); returns result JSON."""
    tr, opts = _get(h, "offline")
    return _result_json(tr.transcribe(audio_path, **_decode_opts(opts)))


def transcribe_pcm(h: int, data, sample_rate: int, fmt: str) -> str:
    """Transcribe a raw PCM buffer (C pointer marshaled as a memoryview).

    fmt: "f32" (native-endian float32) or "s16" (int16, scaled 1/32768 —
    the reference's int16 overload)."""
    tr, opts = _get(h, "offline")
    pcm = _pcm_from(data, fmt)

    from parakeet_tpu_torch.audio.io import read_audio

    # resample to the HANDLE's model rate (16 kHz for all shipped configs,
    # but custom AudioConfigs must not get silently resampled to 16 kHz)
    audio = read_audio(pcm, tr._audio_cfg.sample_rate, sample_rate=int(sample_rate))
    return _result_json(tr.transcribe(audio.samples, **_decode_opts(opts)))


def align(h: int, audio_path: str, text: str) -> str:
    """Forced alignment (Transcriber.align): word timings for a KNOWN
    transcript; same result JSON as transcribe. Needs a CTC-head model
    created with a vocab."""
    from parakeet_tpu_torch.decode.timestamp import TimestampMode

    tr, opts = _get(h, "offline")
    mode = TimestampMode(opts.get("timestamp_mode", "words"))
    return _result_json(tr.align(audio_path, text, timestamp_mode=mode))


#: streaming models the C API can instantiate; "test-tiny-stream" is the
#: random-weight smoke config used by the C API tests
STREAM_MODELS = ("eou-120m", "nemotron-600m", "test-tiny-stream")


def _tiny_stream_config():
    from parakeet_tpu_torch import config as C

    return C.EOUConfig(
        encoder=C.StreamingEncoderConfig(
            mel_bins=80, subsampling_channels=8, hidden_size=16, num_layers=1,
            num_heads=2, ffn_intermediate=32, conv_kernel_size=9,
            att_context_left=4, att_context_right=0, chunk_size=2,
        ),
        prediction=C.PredictionConfig(vocab_size=13, pred_hidden=8,
                                      num_lstm_layers=1),
        joint=C.JointConfig(encoder_hidden=16, pred_hidden=8, joint_hidden=8,
                            vocab_size=13),
        ctc_vocab_size=13,
    )


def stream_create(model: str, weights_path: str | None,
                  vocab_path: str | None, options_json: str | None) -> int:
    """Build a streaming transcriber (mic-buffer FFI: feed raw PCM chunks
    at the model rate, 16 kHz — the streaming path never resamples, same
    contract as the reference's StreamingTranscriber). Extra option:
    `latency` (nemotron right-context frames: 0|1|6|13)."""
    opts, kw = _parse_options(options_json, ("compute_dtype", "seed", "quantize"))

    from parakeet_tpu_torch.streaming import NemotronTranscriber, StreamingTranscriber

    if model == "eou-120m":
        st = StreamingTranscriber(weights_path, vocab_path, **kw)
    elif model == "nemotron-600m":
        from parakeet_tpu_torch.config import make_nemotron_600m_config

        cfg = make_nemotron_600m_config(latency_frames=int(opts.get("latency", 0)))
        st = NemotronTranscriber(weights_path, vocab_path, cfg, **kw)
    elif model == "test-tiny-stream":
        st = StreamingTranscriber(weights_path, vocab_path,
                                  _tiny_stream_config(), **kw)
    else:
        raise ValueError(
            f"unknown streaming model {model!r} (want one of {', '.join(STREAM_MODELS)})")

    return _register(st, opts, "stream")


def stream_feed(h: int, data, fmt: str) -> str:
    """Feed one raw PCM chunk; returns {"delta": new text this chunk,
    "text": full transcript so far}."""
    st, _ = _get(h, "stream")
    delta = st.transcribe_chunk(_pcm_from(data, fmt))
    return json.dumps({"delta": delta, "text": st.get_text()})


def stream_text(h: int) -> str:
    """Current accumulated result: {"text", "token_ids"}."""
    st, _ = _get(h, "stream")
    return json.dumps({"text": st.get_text(), "token_ids": list(st.get_tokens())})


def stream_reset(h: int) -> None:
    st, _ = _get(h, "stream")
    st.reset()


#: diarized models the C API can instantiate; "test-tiny-diarized" is the
#: random-weight smoke pair used by the C API tests
DIARIZE_MODELS = ("diarized", "test-tiny-diarized")


def _tiny_diarized_configs():
    from parakeet_tpu_torch import config as C

    sf = C.SortformerConfig(
        nest_encoder=C.StreamingEncoderConfig(
            mel_bins=128, subsampling_channels=8, hidden_size=24, num_layers=2,
            num_heads=2, ffn_intermediate=32, conv_kernel_size=5,
            att_context_left=6, att_context_right=0,
            subsampling_activation="relu", xscaling=True,
        ),
        encoder_hidden=24,
        transformer_hidden=12,
        transformer=C.TransformerConfig(
            hidden_size=12, num_layers=2, num_heads=2, ffn_intermediate=24,
            pre_ln=False, has_final_norm=False,
        ),
        max_speakers=4,
    )
    return _tiny_config(), sf


def diarize_create(model: str, asr_weights: str | None,
                   sortformer_weights: str | None, vocab_path: str | None,
                   options_json: str | None) -> int:
    """Build a speaker-attributed transcriber (DiarizedTranscriber: ASR +
    Sortformer fusion). "diarized" = 110m ASR + sortformer-117m presets."""
    opts, kw = _parse_options(options_json, ("compute_dtype",))
    if model == "diarized":
        dt_cfg = sf_cfg = None
    elif model == "test-tiny-diarized":
        dt_cfg, sf_cfg = _tiny_diarized_configs()
    else:
        raise ValueError(
            f"unknown diarized model {model!r} (want one of {', '.join(DIARIZE_MODELS)})")

    from parakeet_tpu_torch.diarize import DiarizedTranscriber

    dt = DiarizedTranscriber(asr_weights, sortformer_weights, vocab_path,
                             dt_cfg, sf_cfg, **kw)
    return _register(dt, opts, "diarized")


def diarize(h: int, audio_path: str) -> str:
    """Speaker-attributed transcription of an audio file; returns
    {"text", "words": [{word,start,end,confidence,speaker}],
     "segments": [{speaker,start,end}]}."""
    from parakeet_tpu_torch.transcribe import Decoder

    dt, opts = _get(h, "diarized")
    res = dt.transcribe(audio_path,
                        Decoder.CTC if opts.get("decoder") == "ctc" else Decoder.TDT)
    return json.dumps({
        "text": res.text,
        "words": [
            {"word": w.word, "start": w.start, "end": w.end,
             "confidence": w.confidence, "speaker": w.speaker_id}
            for w in res.words
        ],
        "segments": [
            {"speaker": s.speaker_id, "start": s.start, "end": s.end}
            for s in res.segments
        ],
    })


def destroy(h: int) -> None:
    with _lock:
        _handles.pop(h, None)


def version() -> str:
    import parakeet_tpu_torch

    return parakeet_tpu_torch.__version__
