"""Offline transcription API (port of parakeet_tpu/transcribe.py, greedy slice).

`Transcriber` runs tdt-ctc models: read → mel frontend → encoder (+CTC
head) → greedy TDT or CTC decode → detokenize → word grouping. Batches are
padded and length-masked. On a CUDA device each conformer block's attention
runs the hand-written kernel; on the CPU it runs the plain torch version.
`fused=FusedLayers(...)` sends the FFNs, the conv modules and the front of
the subsampling through their kernels as well.

Not in this slice, and rejected with NotImplementedError rather than
ignored: beam search, LM fusion, phrase boosting, meshes, quantized
weights, and clips longer than `long_threshold_s` (the reference windows
those; the port has no windowed decode yet).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from parakeet_tpu_torch import params as P
from parakeet_tpu_torch.audio.frontend import preprocess_audio_batch
from parakeet_tpu_torch.audio.io import read_audio
from parakeet_tpu_torch.config import AudioConfig, TDTCTCConfig, make_110m_config
from parakeet_tpu_torch.decode.timestamp import (
    TimestampedToken,
    TimestampMode,
    WordTimestamp,
    group_timestamps,
)
from parakeet_tpu_torch.decode.transducer import transducer_greedy_decode
from parakeet_tpu_torch.models.ctc import (
    ctc_greedy_decode,
    ctc_greedy_decode_with_timestamps,
    ctc_log_probs,
)
from parakeet_tpu_torch.models.encoder import FusedLayers, encoded_lengths, fastconformer_encode
from parakeet_tpu_torch.ops.layers import require_ieee_f32
from parakeet_tpu_torch.params import Params
from parakeet_tpu_torch.text.tokenizer import Tokenizer

DEFAULT_BOOST_SCORE = 5.0  # the reference's decode/phrase_boost.py default

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Decoder(enum.Enum):
    CTC = "ctc"
    TDT = "tdt"


@dataclass
class TranscribeResult:
    text: str = ""
    token_ids: list[int] = field(default_factory=list)
    timestamped_tokens: list[TimestampedToken] = field(default_factory=list)
    word_timestamps: list[WordTimestamp] = field(default_factory=list)


@dataclass
class TranscribeOptions:
    decoder: Decoder = Decoder.TDT
    timestamps: bool = False
    boost_phrases: list[str] = field(default_factory=list)
    boost_score: float = DEFAULT_BOOST_SCORE
    timestamp_mode: TimestampMode = TimestampMode.WORDS
    beam_size: int = 0
    lm: object | None = None
    lm_weight: float = 0.0
    # on_progress(stage, done, total) at "load", "preprocess" and "decode"
    on_progress: object | None = None


def _emit_progress(opts: TranscribeOptions, stage: str, done: int, total: int) -> None:
    if opts.on_progress is not None:
        opts.on_progress(stage, done, total)


def _check_options(opts: TranscribeOptions) -> None:
    if opts.beam_size > 0:
        raise NotImplementedError("beam search (beam_size > 0) is not ported yet; use beam_size=0")
    if opts.lm is not None:
        raise NotImplementedError("LM fusion is not ported yet; pass lm=None")
    if opts.boost_phrases:
        raise NotImplementedError("phrase boosting is not ported yet; pass no boost_phrases")


class Transcriber:
    """Offline TDT-CTC transcriber (transcribe.hpp:55-190); default 110m."""

    joint_prefix = "tdt_joint_"

    def __init__(
        self,
        weights_path: str | None = None,
        vocab_path: str | None = None,
        config: TDTCTCConfig | None = None,
        *,
        params: dict | None = None,
        compute_dtype: str = "float32",
        seed: int = 0,
        device: str | torch.device | None = None,
        mesh=None,
        quantize: str | None = None,
        long_threshold_s: float = 40.0,
        fused: FusedLayers = FusedLayers(),
    ):
        """params: a flat {name: array} dict (numpy or CPU tensors) used
        instead of weights_path. device: defaults to "cuda" when a card is
        present, else "cpu". Clips longer than long_threshold_s raise.
        fused: the encoder sublayers that run their fused kernels (all off
        by default; attention always runs its kernel)."""
        if mesh is not None:
            raise NotImplementedError("mesh (multi-device) inference is not ported yet")
        if quantize:
            raise NotImplementedError(f"quantize={quantize!r}: quantized inference is not ported yet")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {compute_dtype!r}")
        self.config = config or make_110m_config()
        self.compute_dtype = compute_dtype
        self.device = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))
        if self.device.type == "cuda":
            require_ieee_f32()
        self.long_threshold_s = long_threshold_s
        self.fused = fused
        if params is None:
            params = P.load_params_numpy(
                P.tdt_ctc_spec(self.config), weights_path, seed=seed,
                warn=lambda m: print(f"[parakeet] {m}"),
            )
        self.params = P.params_from_numpy(params, self.device, _DTYPES[compute_dtype])
        self.tokenizer = Tokenizer(vocab_path) if vocab_path else Tokenizer()
        self._audio_cfg = AudioConfig(n_mels=self.config.encoder.mel_bins)
        self._blank_id = self.config.joint.vocab_size - 1

    # ── Model stages ─────────────────────────────────────────────────────

    @torch.inference_mode()
    def encode(self, feats: torch.Tensor, lengths) -> torch.Tensor:
        """(B, T, mel) features + per-item mel lengths → (B, T', d_model)."""
        x = feats.to(device=self.device, dtype=_DTYPES[self.compute_dtype])
        lengths = torch.as_tensor(lengths, dtype=torch.int64, device=self.device)
        return fastconformer_encode(
            Params(self.params).sub("encoder_"), self.config.encoder, x, lengths, self.fused)

    @torch.inference_mode()
    def ctc_log_probs(self, enc: torch.Tensor) -> torch.Tensor:
        return ctc_log_probs(Params(self.params).sub("ctc_decoder_"), enc)

    # ── Input handling ───────────────────────────────────────────────────

    def _to_samples(self, source) -> np.ndarray:
        sr = self._audio_cfg.sample_rate
        if isinstance(source, (str, Path, bytes, bytearray)):
            return read_audio(source, sr).samples
        arr = np.asarray(source)
        if arr.dtype == np.int16 or arr.ndim > 1:
            return read_audio(arr, sample_rate=sr).samples
        return arr.astype(np.float32).reshape(-1)

    # ── Public API ───────────────────────────────────────────────────────

    def transcribe(
        self,
        source,
        decoder: Decoder = Decoder.TDT,
        timestamps: bool = False,
        *,
        boost_phrases: list[str] | None = None,
        boost_score: float = DEFAULT_BOOST_SCORE,
        timestamp_mode: TimestampMode = TimestampMode.WORDS,
        beam_size: int = 0,
        lm=None,
        lm_weight: float = 0.0,
    ) -> TranscribeResult:
        opts = TranscribeOptions(
            decoder, timestamps, list(boost_phrases or []), boost_score,
            timestamp_mode, beam_size, lm, lm_weight,
        )
        return self.transcribe_batch([source], opts)[0]

    def transcribe_batch(
        self, sources: list, opts: TranscribeOptions | None = None, *, pad_to_multiple: int | None = None
    ) -> list[TranscribeResult]:
        """Batched inference: exactly decode_prepared(prepare_batch(...))."""
        return self.decode_prepared(self.prepare_batch(sources, opts, pad_to_multiple=pad_to_multiple))

    def prepare_batch(
        self, sources: list, opts: TranscribeOptions | None = None, *, pad_to_multiple: int | None = None
    ):
        """Stage 1: load audio and run the mel frontend on the device.
        Returns an opaque handle for `decode_prepared`."""
        opts = opts or TranscribeOptions()
        _check_options(opts)
        if not sources:
            return ("empty", opts, pad_to_multiple, None, None)
        waves = []
        for i, s in enumerate(sources):
            waves.append(self._to_samples(s))
            _emit_progress(opts, "load", i + 1, len(sources))
        limit = int(self.long_threshold_s * self._audio_cfg.sample_rate)
        too_long = [i for i, w in enumerate(waves) if len(w) > limit]
        if too_long:
            raise NotImplementedError(
                f"clips {too_long} are longer than long_threshold_s={self.long_threshold_s} s; "
                "windowed long-audio decode is not ported yet (raise long_threshold_s to decode densely)"
            )
        feats, n_frames = preprocess_audio_batch(waves, self._audio_cfg, self.device)
        _emit_progress(opts, "preprocess", 1, 1)
        return ("padded", opts, pad_to_multiple, feats, n_frames)

    def decode_prepared(self, prepared) -> list[TranscribeResult]:
        """Stage 2: encoder + decode + result assembly."""
        kind, opts, pad_to_multiple, feats, n_frames = prepared
        if kind == "empty":
            return []
        results = self._decode_padded(feats, n_frames, opts, pad_to_multiple)
        _emit_progress(opts, "decode", 1, 1)
        return results

    def transcribe_features(self, features, opts: TranscribeOptions | None = None):
        """Decode precomputed mel features, (T, mel) or (B, T, mel); returns
        one result for 2-D / batch-1 input, else a list."""
        opts = opts or TranscribeOptions()
        _check_options(opts)
        f = np.asarray(features, np.float32)
        if f.ndim == 2:
            f = f[None]
        if f.ndim != 3:
            raise ValueError(f"expected (T, mel) or (B, T, mel) features, got {f.shape}")
        results = self._decode_padded(torch.from_numpy(f), [f.shape[1]] * f.shape[0], opts, None)
        return results[0] if len(results) == 1 else results

    def _decode_padded(self, batch, mel_lens: list[int], opts: TranscribeOptions, pad_to_multiple):
        t_max = batch.shape[1]
        if pad_to_multiple:
            pad_t = -(-t_max // pad_to_multiple) * pad_to_multiple - t_max
            batch = torch.nn.functional.pad(batch, (0, 0, 0, pad_t))
        enc_lens = encoded_lengths(torch.as_tensor(mel_lens)).tolist()
        enc = self.encode(batch, mel_lens)

        if opts.decoder == Decoder.CTC:
            log_probs = self.ctc_log_probs(enc)
            if opts.timestamps:
                ts = ctc_greedy_decode_with_timestamps(log_probs, self._blank_id, enc_lens)
                return [self._result_from_ts(t, opts.timestamp_mode) for t in ts]
            toks = ctc_greedy_decode(log_probs, self._blank_id, enc_lens)
            return [self._result_from_tokens(t) for t in toks]

        with torch.inference_mode():
            res = transducer_greedy_decode(
                self.params,
                enc,
                pred_hidden=self.config.prediction.pred_hidden,
                num_lstm_layers=self.config.prediction.num_lstm_layers,
                durations=tuple(self.config.durations),
                blank_id=self._blank_id,
                joint_prefix=self.joint_prefix,
                enc_lengths=enc_lens,
            )
        if opts.timestamps:
            return [self._result_from_ts(t, opts.timestamp_mode) for t in res.timestamped]
        return [self._result_from_tokens(t) for t in res.tokens]

    def _result_from_tokens(self, token_ids: list[int]) -> TranscribeResult:
        r = TranscribeResult(token_ids=token_ids)
        if self.tokenizer.loaded:
            r.text = self.tokenizer.decode(token_ids)
        return r

    def _result_from_ts(
        self, ts: list[TimestampedToken], mode: TimestampMode = TimestampMode.WORDS
    ) -> TranscribeResult:
        r = TranscribeResult(token_ids=[t.token_id for t in ts], timestamped_tokens=ts)
        if self.tokenizer.loaded:
            r.text = self.tokenizer.decode(r.token_ids)
            r.word_timestamps = group_timestamps(ts, self.tokenizer.pieces, mode)
        return r


__all__ = ["Decoder", "TranscribeOptions", "TranscribeResult", "Transcriber"]
