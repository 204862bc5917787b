"""Offline transcription API (port of parakeet_tpu/transcribe.py).

Three facades share one pipeline, `_TranscriberBase`: read → mel frontend →
encoder (+CTC head) → TDT/RNNT or CTC decode → detokenize → word grouping.
  * `Transcriber`: tdt-ctc (default tdt-ctc-110m), TDT or CTC decode;
  * `TDTTranscriber`: TDT-only (default tdt-600m), joint under "joint_";
  * `RNNTTranscriber`: RNNT (default rnnt-600m), decoded as TDT with
    durations (0,).
Batches are padded and length-masked. On a CUDA device each conformer
block's attention runs the hand-written kernel; on the CPU it runs the plain
torch version. `fused=FusedLayers(...)` (or the reference's `kernels=`
mode names) sends the FFNs, the conv modules and the front of the
subsampling through their kernels as well. Every facade runs on the card
unless `device="cpu"` is given; without a card it raises.

Clips longer than `long_threshold_s` decode through overlapping windows
batched across clips (`long_audio="window"`, the default) or in one dense
call (`long_audio="dense"`). `align*` force-aligns a known transcript with
the CTC head; `transcribe_vad` decodes only the speech that the energy VAD
finds.

Decode options, as in the reference: `boost_phrases` (a token trie whose
reachable tokens get `boost_score` in the greedy TDT/RNNT loop and the
greedy CTC decode, decode/phrase_boost.py); `beam_size` > 0 (the batched
transducer beam, decode/beam_transducer.py, or the host CTC prefix beam,
decode/ctc_beam.py); `lm` with `lm_weight` (an n-gram or neural LM:
shallow fusion in the CTC beam, n-best rescoring of the transducer beam;
ignored by greedy decodes). Beam × boost raises ValueError. Beam and LM
calls always decode densely. `quantize="int8"|"int4"` quantizes the
weights after the compute-dtype cast (quantize.py); the sublayers with
quantized weights then run plain, the attention through K2
(models/encoder.py).

`mesh=` (parallel/mesh.py make_mesh) runs the facade SPMD over
torch.distributed: every rank makes the same facade and the same calls on
the same inputs, and gets the whole result list. The batch is padded to a
multiple of the 'data' axis with one-frame empty items and split over it;
a 'model' axis splits the weights by the reference's tensor-parallel rules
(the attention through K1's head-sharded mode; the other kernels on the
whole weights, gathered once here); a 'seq' axis splits the encoder's
frames and needs the plain attention path (kernels=False, accepted on
such a mesh only). The results are gathered over 'data'.
"""

from __future__ import annotations

import enum
from collections import deque
from dataclasses import dataclass, field, replace
from pathlib import Path

import numpy as np
import torch

from parakeet_tpu_torch import params as P
from parakeet_tpu_torch import trace
from parakeet_tpu_torch.audio.frontend import preprocess_audio_batch
from parakeet_tpu_torch.audio.io import read_audio
from parakeet_tpu_torch.config import (
    AudioConfig,
    RNNTConfig,
    TDTConfig,
    TDTCTCConfig,
    make_110m_config,
    make_rnnt_600m_config,
    make_tdt_600m_config,
)
from parakeet_tpu_torch.decode.phrase_boost import (
    DEFAULT_BOOST_SCORE,
    ContextTrie,
    ctc_greedy_decode_boosted,
    ctc_greedy_decode_with_timestamps_boosted,
)
from parakeet_tpu_torch.decode.timestamp import (
    FRAME_DURATION_S,
    TimestampedToken,
    TimestampMode,
    WordTimestamp,
    group_timestamps,
    group_token_words,
)
from parakeet_tpu_torch.decode.transducer import transducer_greedy_decode
from parakeet_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from parakeet_tpu_torch.models.ctc import (
    ctc_greedy_decode,
    ctc_greedy_decode_with_timestamps,
    ctc_log_probs,
)
from parakeet_tpu_torch.models.encoder import EncoderSplit, FusedLayers, encoded_lengths, fastconformer_encode
from parakeet_tpu_torch.ops.layers import require_ieee_f32
from parakeet_tpu_torch.params import Params
from parakeet_tpu_torch.text.tokenizer import Tokenizer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the reference's kernels= attention modes (models/encoder.py
# set_fused_attention) → FusedLayers.attention: every block-kernel variant
# (batch packing "blockN"/"bdN", head pairs "hp") is K1's function
_BLOCK_MODES = ("block", "block2", "block4", "block8", "bd2", "bd4", "bd8",
                "blockhp", "block2hp", "block4hp", "block8hp")


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
    # on_progress(stage, done, total) at "load", "preprocess", "decode" and,
    # in windowed long-audio decode, "window"
    on_progress: object | None = None


def _emit_progress(opts: TranscribeOptions, stage: str, done: int, total: int) -> None:
    if opts.on_progress is not None:
        opts.on_progress(stage, done, total)


class _Prepared(tuple):
    """prepare_batch's handle: (kind, opts, pad_to_multiple, feats,
    n_frames), and `trace`, the call's open record (trace.CallTrace; None
    for an empty batch)."""

    def __new__(cls, entries, call=None):
        self = super().__new__(cls, entries)
        self.trace = call
        return self


def fused_layers_for(kernels, fused: FusedLayers | None) -> FusedLayers:
    """The encoder configuration of a facade from the reference's `kernels=`
    and the port's `fused=`. kernels None or True, and every "block*"/"bd*"
    mode, is the attention block kernel K1; "mega" and "v1" are those
    modes. False and "off" raise: on the card the port has no path without
    kernels. A kernels= that disagrees with an explicit fused= raises."""
    if kernels is None or kernels is True:
        attention = None if kernels is None else "block"
    elif kernels is False or kernels == "off":
        raise ValueError(f"kernels={kernels!r}: the port has no kernel-free path on the card; "
                         "its CPU path is the plain version (device=\"cpu\")")
    elif kernels in _BLOCK_MODES:
        attention = "block"
    elif kernels in ("mega", "v1"):
        attention = kernels
    else:
        raise ValueError(f"unknown kernels mode {kernels!r}")
    if fused is None:
        return FusedLayers(attention=attention or "block")
    if attention is not None and fused.attention != attention:
        raise ValueError(f"kernels={kernels!r} selects attention {attention!r}, "
                         f"but fused= has attention {fused.attention!r}")
    return fused


class _TranscriberBase:
    """Shared pipeline of the TDT-CTC, TDT-only and RNNT facades."""

    has_ctc = False
    joint_prefix = "tdt_joint_"
    is_tdt = True

    def __init__(
        self,
        weights_path: str | None = None,
        vocab_path: str | None = None,
        config=None,
        *,
        params: dict | None = None,
        compute_dtype: str = "float32",
        seed: int = 0,
        device: str | torch.device = DEFAULT_DEVICE,
        mesh=None,
        kernels: str | bool | None = None,
        quantize: str | None = None,
        long_audio: str = "window",
        long_threshold_s: float = 40.0,
        long_window_s: float = 10.0,
        long_overlap_s: float = 2.0,
        fused: FusedLayers | None = None,
    ):
        """params: a flat {name: array} dict (numpy or CPU tensors) used
        instead of weights_path. device: the card unless given; "cpu" runs
        the plain versions on the CPU. fused / kernels: the encoder
        sublayers that run their fused kernels (`fused_layers_for`).
        long_audio: "window" decodes clips longer than long_threshold_s
        through windows of long_window_s overlapping by long_overlap_s,
        batched across clips (always with timestamps); "dense" decodes any
        length in one call. quantize: "int8" or "int4" weight-only
        quantization (quantize.py), after the compute-dtype cast.

        mesh: a parallel.mesh.Mesh; the facade then runs on this rank's
        device of it (device= must name the same kind of device), SPMD
        (module note). A mesh with a 'seq' axis takes only kernels=False,
        the plain path; quantize takes a data mesh only (the scales
        replicate under the 'model' rules, quantize.py, and the 'seq'
        attention takes float weights)."""
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {compute_dtype!r}")
        if long_audio not in ("window", "dense"):
            raise ValueError(f"long_audio must be 'window' or 'dense', got {long_audio!r}")
        if not 0 <= long_overlap_s < long_window_s:
            raise ValueError(
                f"long_overlap_s ({long_overlap_s}) must be >= 0 and < long_window_s ({long_window_s})"
            )
        self.mesh = mesh
        self.traces: deque = deque(maxlen=trace.KEEP)  # the newest calls' records (trace.py)
        seq_mesh = False
        if mesh is not None:
            from parakeet_tpu_torch.parallel.mesh import activation_sharding, mesh_device

            device = mesh_device(mesh, device)
            if mesh.shape.get("pipe", 1) > 1:
                raise ValueError("a ('data', 'pipe') mesh is the pipeline trainer's; inference takes data, seq and model")
            seq_mesh = activation_sharding(mesh) is not None
            if seq_mesh and (kernels is not False or fused is not None):
                raise ValueError(
                    "sequence-parallel mesh requires the plain attention path (the reference's XLA attention "
                    "path); pass kernels=False (the kernels are per-device programs)"
                )
            if quantize and mesh.shape.get("model", 1) > 1:
                raise ValueError("quantize with a 'model' axis > 1: the scales replicate under the tensor-parallel "
                                 "rules (quantize.py); quantize on a data mesh")
            if quantize and seq_mesh:
                raise ValueError("quantize with a 'seq' axis: the sequence-parallel attention is K1's plain version, "
                                 "which takes float weights; quantize on a data mesh")
        self.fused = FusedLayers() if seq_mesh else fused_layers_for(kernels, fused)
        self.config = config
        self.compute_dtype = compute_dtype
        self.long_audio = long_audio
        self.long_threshold_s = long_threshold_s
        self.long_window_s = long_window_s
        self.long_overlap_s = long_overlap_s
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            require_ieee_f32()
        if params is None:
            params = P.load_params_numpy(
                self._spec(), weights_path, seed=seed, warn=lambda m: print(f"[parakeet] {m}"),
            )
        self._split = self._model = None
        if mesh is not None:
            from parakeet_tpu_torch.parallel.mesh import param_sharding_rules, shard_params

            tp = mesh.shape.get("model", 1)
            whole = [k for k in params if k.startswith("encoder_") and (dim := param_sharding_rules(k, mesh)) is not None
                     and np.shape(params[k])[dim] % tp]
            if whole:  # the split encoder sublayers need every rule to split
                raise ValueError(f"model_parallel={tp} does not divide {whole[0]} {tuple(np.shape(params[whole[0]]))}")
            params = shard_params(params, mesh)
        self.params = P.device_params(params, self.device, _DTYPES[compute_dtype], quantize)
        if mesh is not None and (mesh.shape.get("model", 1) > 1 or seq_mesh):
            model = mesh.axis("model")
            full = None
            if model.split and self.fused != FusedLayers():
                from parakeet_tpu_torch.parallel.collectives import gather_params

                # the kernels other than K1 take whole weights: gathered once
                enc = [k for k in self.params if k.startswith("encoder_")]
                full = Params(gather_params(self.params, mesh, enc)).sub("encoder_")
            self._split = EncoderSplit(model, mesh.axis("seq"), full)
            self._model = model if model.split else None
        self.tokenizer = Tokenizer(vocab_path) if vocab_path else Tokenizer()
        self._audio_cfg = AudioConfig(n_mels=config.encoder.mel_bins)
        self._blank_id = config.joint.vocab_size - 1

    def _spec(self):
        raise NotImplementedError

    def to_gpu(self) -> None:
        """API-compatibility no-op (the reference C++ API moves weights to
        its GPU here); the facade already holds its weights on `device`."""

    # ── Model stages ─────────────────────────────────────────────────────

    @torch.inference_mode()
    @trace.spanned("encoder")
    def encode(self, feats: torch.Tensor, lengths) -> torch.Tensor:
        """(B, T, mel) features + per-item mel lengths → (B, T', d_model)."""
        x = feats.to(device=self.device, dtype=_DTYPES[self.compute_dtype])
        lengths = torch.as_tensor(lengths, dtype=torch.int64, device=self.device)
        return fastconformer_encode(
            Params(self.params).sub("encoder_"), self.config.encoder, x, lengths, self.fused, split=self._split)

    @torch.inference_mode()
    @trace.spanned("ctc_head")
    def ctc_log_probs(self, enc: torch.Tensor) -> torch.Tensor:
        """(B, T', V) f32 CTC log-probs; on a 'model' axis the vocab-split
        logits gathered, the padded lanes cut after the softmax."""
        vocab = getattr(self.config, "ctc_vocab_size", None) if self._model is not None else None
        return ctc_log_probs(Params(self.params).sub("ctc_decoder_"), enc, model=self._model, vocab=vocab)

    def _check_options(self, opts: TranscribeOptions) -> None:
        """Option errors, raised before any device work."""
        if opts.decoder == Decoder.CTC and not self.has_ctc:
            raise ValueError("this model has no CTC head; use Decoder.TDT")
        if opts.beam_size > 0 and opts.boost_phrases:
            raise ValueError(
                "phrase boosting composes with greedy decode only; "
                "use beam_size=0 with boost_phrases"
            )

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
        """Batched inference. Under long_audio="window", clips longer than
        long_threshold_s go through `transcribe_long_batch`; the short clips
        of the batch still decode densely together, and the result order
        is kept. Each clip is loaded once. Beam and LM calls always decode
        densely, as in the reference."""
        opts = opts or TranscribeOptions()
        if self.long_audio == "window" and sources and opts.beam_size == 0 and opts.lm is None:
            thr = int(self.long_threshold_s * self._audio_cfg.sample_rate)
            waves = [self._to_samples(s) for s in sources]
            long_ix = {i for i, w in enumerate(waves) if len(w) > thr}
            if long_ix:
                results: list = [None] * len(waves)
                short_ix = [i for i in range(len(waves)) if i not in long_ix]
                if short_ix:
                    dense = self._transcribe_batch_dense(
                        [waves[i] for i in short_ix], opts, pad_to_multiple=pad_to_multiple)
                    for i, r in zip(short_ix, dense):
                        results[i] = r
                order = sorted(long_ix)
                for i, r in zip(order, self.transcribe_long_batch(
                        [waves[i] for i in order], opts.decoder, opts=opts)):
                    results[i] = r
                return results
            sources = waves  # already loaded; decode densely
        return self._transcribe_batch_dense(sources, opts, pad_to_multiple=pad_to_multiple)

    def _transcribe_batch_dense(
        self, sources: list, opts: TranscribeOptions | None = None, *, pad_to_multiple: int | None = None
    ) -> list[TranscribeResult]:
        """One dense decode whatever the clips' length (no window routing):
        exactly decode_prepared(prepare_batch(...))."""
        return self.decode_prepared(self.prepare_batch(sources, opts, pad_to_multiple=pad_to_multiple))

    def prepare_batch(
        self, sources: list, opts: TranscribeOptions | None = None, *, pad_to_multiple: int | None = None
    ):
        """Stage 1: load audio and run the mel frontend on the device.
        Returns an opaque handle for `decode_prepared`: a 5-tuple whose
        `.trace` carries the call's record (trace.py) to it."""
        opts = opts or TranscribeOptions()
        self._check_options(opts)
        if not sources:
            return _Prepared(("empty", opts, pad_to_multiple, None, None))
        call = trace.CallTrace()
        with trace.stage(call), trace.span("frontend"):
            waves = []
            with trace.span("frontend.load"):
                for i, s in enumerate(sources):
                    waves.append(self._to_samples(s))
                    _emit_progress(opts, "load", i + 1, len(sources))
            feats, n_frames = preprocess_audio_batch(waves, self._audio_cfg, self.device)
            _emit_progress(opts, "preprocess", 1, 1)
        return _Prepared(("padded", opts, pad_to_multiple, feats, n_frames), call)

    def decode_prepared(self, prepared) -> list[TranscribeResult]:
        """Stage 2: encoder + decode + result assembly; the call's record
        closes and joins `traces`."""
        kind, opts, pad_to_multiple, feats, n_frames = prepared
        if kind == "empty":
            return []
        with trace.stage(getattr(prepared, "trace", None), self.traces):
            return self._decode_padded(feats, n_frames, opts, pad_to_multiple)

    def transcribe_features(self, features, opts: TranscribeOptions | None = None):
        """Decode precomputed mel features, (T, mel) or (B, T, mel); returns
        one result for 2-D / batch-1 input, else a list."""
        opts = opts or TranscribeOptions()
        self._check_options(opts)
        f = np.asarray(features, np.float32)
        if f.ndim == 2:
            f = f[None]
        if f.ndim != 3:
            raise ValueError(f"expected (T, mel) or (B, T, mel) features, got {f.shape}")
        results = self._decode_padded(torch.from_numpy(f), [f.shape[1]] * f.shape[0], opts, None)
        return results[0] if len(results) == 1 else results

    def _decode_padded(self, batch, mel_lens: list[int], opts: TranscribeOptions, pad_to_multiple):
        """Encoder + decode + result assembly; emits the "decode" stage once
        the results are on the host. On a mesh: the batch padded to a
        multiple of the 'data' axis with empty one-frame items, this rank's
        rows decoded, every rank's results gathered and the padding
        dropped."""
        t_max = batch.shape[1]
        if pad_to_multiple:
            pad_t = -(-t_max // pad_to_multiple) * pad_to_multiple - t_max
            batch = torch.nn.functional.pad(batch, (0, 0, 0, pad_t))
        n = batch.shape[0]
        if self.mesh is not None:
            from parakeet_tpu_torch.parallel.mesh import batch_sharding

            pad_items = (-n) % self.mesh.shape["data"]
            batch = torch.nn.functional.pad(batch, (0, 0, 0, 0, 0, pad_items))
            mel_lens = list(mel_lens) + [1] * pad_items
            rows = batch_sharding(self.mesh, n + pad_items)
            batch, mel_lens = batch[rows], mel_lens[rows]
        results = self._decode_rows(batch, mel_lens, opts)
        if self.mesh is not None:
            from parakeet_tpu_torch.parallel.collectives import gather_results

            results = gather_results(results, self.mesh.axis("data"), self.device)[:n]
        _emit_progress(opts, "decode", 1, 1)
        return results

    def _decode_rows(self, batch, mel_lens: list[int], opts: TranscribeOptions) -> list[TranscribeResult]:
        """Encoder + decode + result assembly of a padded batch."""
        enc_lens = encoded_lengths(torch.as_tensor(mel_lens)).tolist()
        enc = self.encode(batch, mel_lens)
        trace.count("encoder.frames", enc.shape[0] * enc.shape[1])
        trace.count("encoder.valid_frames", sum(enc_lens))
        trie = None
        if opts.boost_phrases:
            trie = ContextTrie()
            trie.build(opts.boost_phrases, self.tokenizer)
            if trie.empty():
                trie = None

        if opts.decoder == Decoder.CTC:
            log_probs = self.ctc_log_probs(enc)
            if opts.beam_size > 0:  # beam × boost raised in _check_options
                results = self._ctc_beam_results(log_probs, enc_lens, opts)
            elif opts.timestamps:
                if trie is not None:
                    ts = ctc_greedy_decode_with_timestamps_boosted(
                        log_probs, trie, opts.boost_score, self._blank_id, enc_lens)
                else:
                    ts = ctc_greedy_decode_with_timestamps(log_probs, self._blank_id, enc_lens)
                results = self._results(ts, opts, timed=True)
            else:
                if trie is not None:
                    toks = ctc_greedy_decode_boosted(log_probs, trie, opts.boost_score, self._blank_id, enc_lens)
                else:
                    toks = ctc_greedy_decode(log_probs, self._blank_id, enc_lens)
                results = self._results(toks, opts, timed=False)
        elif opts.beam_size > 0:
            results = self._transducer_beam_results(enc, enc_lens, opts)
        else:
            boost = None
            if trie is not None:
                boost = trie.device_boost(self.config.joint.vocab_size, enc.shape[0], opts.boost_score, self.device)
            with torch.inference_mode():
                res = transducer_greedy_decode(
                    self.params,
                    enc,
                    pred_hidden=self.config.prediction.pred_hidden,
                    num_lstm_layers=self.config.prediction.num_lstm_layers,
                    durations=self._durations(),
                    blank_id=self._blank_id,
                    is_tdt=self.is_tdt,
                    joint_prefix=self.joint_prefix,
                    enc_lengths=enc_lens,
                    boost=boost,
                    model=self._model,
                )
            trace.count("decode.steps", res.steps)
            results = self._results(res.timestamped if opts.timestamps else res.tokens, opts, timed=opts.timestamps)
        return results

    def _results(self, rows: list, opts: TranscribeOptions, *, timed: bool) -> list[TranscribeResult]:
        """The results of a greedy decode's rows: TimestampedToken lists
        when `timed`, else token-id lists."""
        with trace.span("results"):
            if timed:
                return [self._result_from_ts(t, opts.timestamp_mode) for t in rows]
            return [self._result_from_tokens(t) for t in rows]

    def _durations(self) -> tuple[int, ...]:
        return tuple(self.config.durations) if self.is_tdt else (0,)

    def _transducer_beam_results(self, enc, enc_lens, opts: TranscribeOptions) -> list[TranscribeResult]:
        """The batched transducer beam (decode/beam_transducer.py); with an
        LM and a nonzero weight its n-best list (beam_size long) is
        rescored. Timestamps: each token's emission frame, its span closing
        at the next emission."""
        from parakeet_tpu_torch.decode.beam_transducer import transducer_beam_decode

        use_lm = opts.lm is not None and opts.lm_weight != 0.0
        hyps = transducer_beam_decode(
            self.params,
            enc,
            num_lstm_layers=self.config.prediction.num_lstm_layers,
            durations=self._durations(),
            blank_id=self._blank_id,
            is_tdt=self.is_tdt,
            joint_prefix=self.joint_prefix,
            enc_lengths=enc_lens,
            beam_size=opts.beam_size,
            n_best=opts.beam_size if use_lm else 1,
            model=self._model,
        )
        if use_lm:
            from parakeet_tpu_torch.text.ngram_lm import rescore_nbest

            hyps = [rescore_nbest(h, opts.lm, opts.lm_weight) for h in hyps]
        out = []
        for i, h in enumerate(hyps):
            best = h[0]
            if not opts.timestamps:
                out.append(self._result_from_tokens(best.tokens))
                continue
            toks = []
            for j, (tok, fr, lp) in enumerate(zip(best.tokens, best.frames, best.token_logprobs)):
                end = (best.frames[j + 1] - 1) if j + 1 < len(best.frames) else enc_lens[i] - 1
                toks.append(TimestampedToken(tok, fr, max(fr, end), float(np.exp(lp))))
            out.append(self._result_from_ts(toks, opts.timestamp_mode))
        return out

    def _ctc_beam_results(self, log_probs, enc_lens, opts: TranscribeOptions) -> list[TranscribeResult]:
        """The CTC prefix beam on the host over the fetched log-probs, with
        the LM fused token by token; timestamps from each token's first
        frame, its span closing at the next token's."""
        from parakeet_tpu_torch.decode.ctc_beam import ctc_beam_search

        lp_np = log_probs.float().cpu().numpy()
        out = []
        for i, t_i in enumerate(enc_lens):
            hyp = ctc_beam_search(lp_np[i, :t_i], self._blank_id, beam_size=opts.beam_size, lm=opts.lm,
                                  lm_weight=opts.lm_weight)[0]
            if not opts.timestamps:
                out.append(self._result_from_tokens(hyp.tokens))
                continue
            toks = []
            for j, (tok, fr) in enumerate(zip(hyp.tokens, hyp.frames)):
                end = (hyp.frames[j + 1] - 1) if j + 1 < len(hyp.frames) else t_i - 1
                toks.append(TimestampedToken(tok, fr, max(fr, end), float(np.exp(lp_np[i, fr, tok]))))
            out.append(self._result_from_ts(toks, opts.timestamp_mode))
        return out

    # ── Long audio ───────────────────────────────────────────────────────

    def transcribe_long(
        self,
        source,
        decoder: Decoder = Decoder.TDT,
        *,
        window_s: float = 60.0,
        overlap_s: float = 10.0,
        boost_phrases: list[str] | None = None,
        boost_score: float = DEFAULT_BOOST_SCORE,
        timestamp_mode: TimestampMode = TimestampMode.WORDS,
        on_progress=None,
        progress_batch: int = 8,
    ) -> TranscribeResult:
        """One long clip through overlapping windows and an ownership merge:
        windows of `window_s` overlapping by `overlap_s` decode with
        timestamps, and each window keeps the words that start in its
        exclusive half of the overlaps, so every instant has one owner.
        A clip that fits one window decodes densely. With on_progress, the
        windows run `progress_batch` at a time and ("window", done, total)
        fires after each; without it they run as one batched call."""
        if overlap_s < 0 or overlap_s >= window_s:
            raise ValueError(f"overlap_s ({overlap_s}) must be >= 0 and < window_s ({window_s})")
        samples = self._to_samples(source)
        sr = self._audio_cfg.sample_rate
        win = int(window_s * sr)
        hop = int((window_s - overlap_s) * sr)
        if len(samples) <= win:
            # densely, not through transcribe(): that would re-enter the
            # auto-routing with the facade's window geometry
            opts1 = TranscribeOptions(decoder, True, list(boost_phrases or []), boost_score, timestamp_mode)
            return self._transcribe_batch_dense([samples], opts1)[0]

        starts = self._long_window_starts(len(samples), win, hop)
        opts = TranscribeOptions(decoder, True, list(boost_phrases or []), boost_score)
        windows = [samples[s0: s0 + win] for s0 in starts]
        if on_progress is None:
            results = self._transcribe_batch_dense(windows, opts)
        else:
            results = []
            step = max(1, int(progress_batch))
            for lo in range(0, len(windows), step):
                results.extend(self._transcribe_batch_dense(windows[lo: lo + step], opts))
                on_progress("window", min(lo + step, len(windows)), len(windows))
        return self._merge_long_results(len(samples), starts, results, win, window_s, overlap_s, timestamp_mode)

    def _long_window_starts(self, n_samples: int, win: int, hop: int) -> list[int]:
        """Window start offsets (samples). A trailing sliver (under 0.25 s)
        is dropped only when the previous window already reaches the end of
        the audio; otherwise no window would own its words."""
        sr = self._audio_cfg.sample_rate
        starts: list[int] = []
        for s0 in range(0, n_samples, hop):
            if n_samples - s0 < sr // 4 and starts and starts[-1] + win >= n_samples:
                break
            starts.append(s0)
            if s0 + win >= n_samples:
                break
        return starts

    def _merge_long_results(
        self,
        n_samples: int,
        starts: list[int],
        results: list[TranscribeResult],
        win: int,
        window_s: float,
        overlap_s: float,
        timestamp_mode: TimestampMode,
    ) -> TranscribeResult:
        """Overlap merge of per-window decodes, owned by word: a window owns
        every word whose start falls in its exclusive half of the overlaps
        and contributes that word's tokens whole. Without a vocab every
        token is its own word."""
        sr = self._audio_cfg.sample_rate
        pieces = self.tokenizer.pieces if self.tokenizer.loaded else None
        owned_words: list[list[TimestampedToken]] = []
        for wi, (s0, res) in enumerate(zip(starts, results)):
            offset_s = s0 / sr
            keep_lo = 0.0 if wi == 0 else offset_s + overlap_s / 2.0
            keep_hi = (
                float("inf")
                if s0 + win >= n_samples or wi == len(starts) - 1
                else offset_s + window_s - overlap_s / 2.0
            )
            frame_off = int(round(offset_s / FRAME_DURATION_S))
            shifted = [
                TimestampedToken(t.token_id, t.start_frame + frame_off, t.end_frame + frame_off, t.confidence)
                for t in res.timestamped_tokens
            ]
            for word in group_token_words(shifted, pieces):
                if keep_lo <= word[0].start_frame * FRAME_DURATION_S < keep_hi:
                    owned_words.append(word)
        owned_words.sort(key=lambda w: w[0].start_frame)
        return self._result_from_ts([t for w in owned_words for t in w], timestamp_mode)

    def transcribe_long_batch(
        self,
        sources: list,
        decoder: Decoder = Decoder.TDT,
        *,
        window_s: float | None = None,
        overlap_s: float | None = None,
        boost_phrases: list[str] | None = None,
        boost_score: float = DEFAULT_BOOST_SCORE,
        timestamp_mode: TimestampMode = TimestampMode.WORDS,
        max_batch: int = 192,
        opts: TranscribeOptions | None = None,
    ) -> list[TranscribeResult]:
        """Many long clips, their windows batched across clips: every clip
        is cut into `window_s` windows overlapping by `overlap_s` (default
        the facade's long_window_s / long_overlap_s), all windows decode in
        `max_batch`-sized calls, and each clip is merged as in
        transcribe_long. Emits ("window", done, total) on opts.on_progress
        after each call. `opts` passes decoder and progress on from
        transcribe_batch; timestamps are forced on (the merge needs them)."""
        window_s = self.long_window_s if window_s is None else window_s
        overlap_s = self.long_overlap_s if overlap_s is None else overlap_s
        if overlap_s < 0 or overlap_s >= window_s:
            raise ValueError(f"overlap_s ({overlap_s}) must be >= 0 and < window_s ({window_s})")
        base = opts or TranscribeOptions(decoder, True, list(boost_phrases or []), boost_score, timestamp_mode)
        timestamp_mode = base.timestamp_mode
        wopts = replace(base, timestamps=True)
        sr = self._audio_cfg.sample_rate
        win = int(window_s * sr)
        hop = int((window_s - overlap_s) * sr)

        all_windows: list[np.ndarray] = []
        spans: list[tuple[int, list[int], int]] = []
        for s in sources:
            w = self._to_samples(s)
            starts = [0] if len(w) <= win else self._long_window_starts(len(w), win, hop)
            spans.append((len(all_windows), starts, len(w)))
            all_windows.extend(w[s0: s0 + win] for s0 in starts)

        results: list[TranscribeResult] = []
        step = max(1, int(max_batch))
        for lo in range(0, len(all_windows), step):
            results.extend(self._transcribe_batch_dense(all_windows[lo: lo + step], wopts))
            _emit_progress(base, "window", min(lo + step, len(all_windows)), len(all_windows))

        out: list[TranscribeResult] = []
        for off, starts, n_samples in spans:
            rs = results[off: off + len(starts)]
            if len(starts) == 1:
                out.append(self._result_from_ts(rs[0].timestamped_tokens, timestamp_mode))
            else:
                out.append(self._merge_long_results(n_samples, starts, rs, win, window_s, overlap_s,
                                                    timestamp_mode))
        return out

    # ── VAD ──────────────────────────────────────────────────────────────

    def transcribe_vad(
        self,
        source,
        decoder: Decoder = Decoder.TDT,
        *,
        opts: TranscribeOptions | None = None,
        vad_config=None,
        boost_phrases: list[str] | None = None,
        boost_score: float = DEFAULT_BOOST_SCORE,
        timestamp_mode: TimestampMode = TimestampMode.WORDS,
    ) -> TranscribeResult:
        """Transcribe only the speech regions the energy VAD finds
        (audio/vad.py), all in one batched call, with timestamps shifted
        back to the untrimmed audio. `opts` is the full decode configuration
        (timestamps forced on); the keyword arguments apply only without
        it."""
        from parakeet_tpu_torch.audio.vad import vad_segments

        if opts is None:
            opts = TranscribeOptions(decoder, True, list(boost_phrases or []), boost_score, timestamp_mode)
        else:
            opts = replace(opts, timestamps=True)
            timestamp_mode = opts.timestamp_mode
        samples = self._to_samples(source)
        sr = self._audio_cfg.sample_rate
        segments = vad_segments(samples, sr, vad_config)
        if not segments:
            return TranscribeResult()
        results = self.transcribe_batch([samples[lo:hi] for lo, hi in segments], opts)
        merged: list[TimestampedToken] = []
        for (lo, _), res in zip(segments, results):
            frame_off = int(round(lo / sr / FRAME_DURATION_S))
            merged.extend(
                TimestampedToken(t.token_id, t.start_frame + frame_off, t.end_frame + frame_off, t.confidence)
                for t in res.timestamped_tokens
            )
        return self._result_from_ts(merged, timestamp_mode)

    # ── Forced alignment ─────────────────────────────────────────────────

    def _check_align(self) -> None:
        if not self.has_ctc:
            raise ValueError("forced alignment needs the CTC head (tdt-ctc models)")
        if not self.tokenizer.loaded:
            raise ValueError("forced alignment needs a vocab (tokenizer not loaded)")

    def _ctc_log_probs_np(self, waves: list[np.ndarray], pad_to_multiple: int | None = None):
        """CTC log-probs of the padded batch (B, T', V) on the host, and each
        item's encoded length."""
        feats, n_frames = preprocess_audio_batch(waves, self._audio_cfg, self.device)
        if pad_to_multiple:
            t_max = feats.shape[1]
            feats = torch.nn.functional.pad(feats, (0, 0, 0, -(-t_max // pad_to_multiple) * pad_to_multiple - t_max))
        lp = self.ctc_log_probs(self.encode(feats, n_frames))
        enc_lens = encoded_lengths(torch.as_tensor(n_frames)).tolist()
        return lp.to(torch.float32).cpu().numpy(), enc_lens

    def align(self, source, text: str, *, timestamp_mode: TimestampMode = TimestampMode.WORDS) -> TranscribeResult:
        """Forced alignment: token and word timings for a known transcript,
        the most probable CTC path that emits exactly its tokens
        (decode/align.py). Needs the CTC head and a vocab; ValueError when
        the clip is too short for the transcript."""
        return self.align_batch([source], [text], timestamp_mode=timestamp_mode)[0]

    def align_batch(
        self,
        sources: list,
        texts: list[str],
        *,
        timestamp_mode: TimestampMode = TimestampMode.WORDS,
        pad_to_multiple: int | None = None,
    ) -> list[TranscribeResult]:
        """Forced-align several clips in one padded encoder call."""
        from parakeet_tpu_torch.decode.align import ctc_forced_align

        self._check_align()
        if len(sources) != len(texts):
            raise ValueError(f"{len(sources)} sources vs {len(texts)} texts")
        token_lists = [self.tokenizer.encode(t) for t in texts]
        for text, toks in zip(texts, token_lists):
            if not toks:
                raise ValueError(f"text tokenized to zero tokens: {text!r}")
        lp_np, enc_lens = self._ctc_log_probs_np([self._to_samples(s) for s in sources], pad_to_multiple)
        return [
            self._result_from_ts(
                ctc_forced_align(lp_np[i], token_lists[i], self._blank_id, length=enc_lens[i]), timestamp_mode)
            for i in range(len(sources))
        ]

    def align_long(
        self,
        source,
        text: str,
        *,
        window_s: float = 60.0,
        overlap_s: float = 10.0,
        timestamp_mode: TimestampMode = TimestampMode.WORDS,
    ) -> TranscribeResult:
        """Forced alignment past one window: overlapping windows give CTC
        log-probs, each absolute frame is owned by one window (the exclusive
        half of the overlaps, decode/align.py stitch_frame_ownership), and
        one Viterbi pass aligns the whole transcript over the stitched
        frames. The hop is snapped to the 0.08 s encoder frame grid, so
        stitched rows carry exact absolute frame indices."""
        from parakeet_tpu_torch.decode.align import ctc_forced_align, stitch_frame_ownership

        self._check_align()
        if overlap_s < 0 or overlap_s >= window_s:
            raise ValueError(f"overlap_s ({overlap_s}) must be >= 0 and < window_s ({window_s})")
        samples = self._to_samples(source)
        sr = self._audio_cfg.sample_rate
        win = int(window_s * sr)
        if len(samples) <= win:
            return self.align(samples, text, timestamp_mode=timestamp_mode)
        tokens = self.tokenizer.encode(text)
        if not tokens:
            raise ValueError("text tokenized to zero tokens")

        frame_samples = 8 * self._audio_cfg.hop_length
        hop_frames = max(1, round((window_s - overlap_s) * sr / frame_samples))
        hop = hop_frames * frame_samples
        starts = list(range(0, max(len(samples) - win, 0) + hop, hop))
        lp_np, enc_lens = self._ctc_log_probs_np([samples[s0: s0 + win] for s0 in starts])

        abs_starts = [s0 // frame_samples for s0 in starts]
        ranges = stitch_frame_ownership(abs_starts, enc_lens, win // frame_samples - hop_frames)
        stitched = np.concatenate([lp_np[i, lo:hi] for i, (lo, hi) in enumerate(ranges)], axis=0)
        abs_frames = np.concatenate([np.arange(lo, hi) + abs_starts[i] for i, (lo, hi) in enumerate(ranges)])

        # host DP footprint guard: the (T, S) backpointer table is the cost
        n_states = 2 * len(tokens) + 1
        if stitched.shape[0] * n_states > 1_500_000_000:
            raise ValueError(
                f"alignment lattice too large ({stitched.shape[0]} frames × {n_states} states); "
                "split the transcript and align sections")
        ts = ctc_forced_align(stitched, tokens, self._blank_id)
        remapped = [
            TimestampedToken(t.token_id, int(abs_frames[t.start_frame]), int(abs_frames[t.end_frame]), t.confidence)
            for t in ts
        ]
        return self._result_from_ts(remapped, timestamp_mode)

    # ── Result assembly ──────────────────────────────────────────────────

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


class Transcriber(_TranscriberBase):
    """Offline TDT-CTC transcriber (transcribe.hpp:55-190); default 110m."""

    has_ctc = True
    joint_prefix = "tdt_joint_"

    def __init__(self, weights_path=None, vocab_path=None, config: TDTCTCConfig | None = None, **kw):
        super().__init__(weights_path, vocab_path, config or make_110m_config(), **kw)

    def _spec(self):
        return P.tdt_ctc_spec(self.config)


class TDTTranscriber(_TranscriberBase):
    """TDT-only transcriber for the 600m models (transcribe.hpp:200-299);
    default tdt-600m."""

    has_ctc = False
    joint_prefix = "joint_"

    def __init__(self, weights_path=None, vocab_path=None, config: TDTConfig | None = None, **kw):
        super().__init__(weights_path, vocab_path, config or make_tdt_600m_config(), **kw)

    def _spec(self):
        return P.tdt_spec(self.config)


class RNNTTranscriber(_TranscriberBase):
    """RNNT transcriber (parakeet-rnnt-0.6b by default): greedy decode as
    TDT with durations (0,)."""

    has_ctc = False
    joint_prefix = "joint_"
    is_tdt = False

    def __init__(self, weights_path=None, vocab_path=None, config: RNNTConfig | None = None, **kw):
        super().__init__(weights_path, vocab_path, config or make_rnnt_600m_config(), **kw)

    def _spec(self):
        return P.rnnt_spec(self.config)


__all__ = ["Decoder", "TranscribeOptions", "TranscribeResult", "Transcriber", "TDTTranscriber",
           "RNNTTranscriber", "fused_layers_for"]
