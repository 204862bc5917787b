"""Streaming transcribers: EOU (`StreamingTranscriber`), Nemotron, and the
lockstep batch (port of parakeet_tpu/streaming.py).

Mirrors the reference facades (include/parakeet/eou.hpp:101-160,
nemotron.hpp:78-133): feed raw PCM chunks, get text deltas; a partial
result callback; reset(); accumulated text and timestamped tokens.

Per chunk: StreamingAudioPreprocessor → the fixed-shape streaming encoder
chunk → TDT chunk decode with the LSTM state and last token carried across
chunks → the text delta. The reference runs each step as one jitted
program; the port runs the same sequence of torch ops eagerly on the card
(or the CPU when asked). Every entry point runs on the card unless given
device="cpu"; with no card it raises.

quantize="int8"|"int4" quantizes the weights after the compute-dtype cast
(quantize.py), as in the reference; the streaming encoder runs no kernel
either way. `StreamingBatchTranscriber(mesh=)` shards the lockstep cohort
over the mesh's 'data' axis (parallel/mesh.py make_mesh), SPMD over
torch.distributed: every rank makes the same calls, keeps every slot's
host queues and holds the caches, LSTM state and last tokens of its own
slots; each step uploads and runs only its slots, and the step's tokens
are gathered so every rank returns (and keeps) the whole cohort's.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from parakeet_tpu_torch import params as P
from parakeet_tpu_torch.audio.frontend import StreamingAudioPreprocessor, streaming_log_mel_batch
from parakeet_tpu_torch.config import AudioConfig, EOUConfig, NemotronConfig, make_eou_120m_config, \
    make_nemotron_600m_config
from parakeet_tpu_torch.decode.timestamp import TimestampedToken
from parakeet_tpu_torch.decode.transducer import transducer_greedy_decode
from parakeet_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from parakeet_tpu_torch.models.rnnt import prediction_zero_state
from parakeet_tpu_torch.models.streaming_encoder import (
    StreamingEncoderSession,
    encoder_compute_dtype,
    init_encoder_cache,
    streaming_encoder_chunk,
)
from parakeet_tpu_torch.text.tokenizer import Tokenizer
from parakeet_tpu_torch.transcribe import _DTYPES

PartialResultCallback = Callable[[str], None]


class _StreamingBase:
    joint_prefix = "tdt_joint_"

    def _spec(self):
        raise NotImplementedError

    def __init__(
        self,
        weights_path: str | None = None,
        vocab_path: str | None = None,
        config=None,
        *,
        params: dict | None = None,
        compute_dtype: str = "float32",
        seed: int = 0,
        quantize: str | None = None,
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        """params: a flat {name: array} dict used instead of weights_path.
        device: the card unless given; "cpu" runs on the CPU. quantize:
        "int8" or "int4" weight-only quantization (quantize.py)."""
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {compute_dtype!r}")
        self.config = config
        self.device = resolve_device(device)
        if params is None:
            params = P.load_params_numpy(self._spec(), weights_path, seed=seed,
                                         warn=lambda m: print(f"[parakeet] {m}"))
        self.params = P.device_params(params, self.device, _DTYPES[compute_dtype], quantize)
        self.tokenizer = Tokenizer(vocab_path) if vocab_path else Tokenizer()
        self._blank_id = config.joint.vocab_size - 1
        self._audio_cfg = AudioConfig(n_mels=config.encoder.mel_bins)
        self._partial_cb: PartialResultCallback | None = None
        self.preprocessor = StreamingAudioPreprocessor(self._audio_cfg, self.device)
        self.encoder_session = StreamingEncoderSession(self.params, config.encoder, batch=1)
        self._init_decode_state()

    def _init_decode_state(self) -> None:
        self._last_token = torch.full((1,), self._blank_id, dtype=torch.int64, device=self.device)
        self._lstm = prediction_zero_state(self.config.prediction.num_lstm_layers, 1,
                                           self.config.prediction.pred_hidden, device=self.device)
        self._tokens: list[int] = []
        self._timestamped: list[TimestampedToken] = []
        self._frame_offset = 0

    # ── Public API (eou.hpp:113-158) ─────────────────────────────────────

    @torch.inference_mode()
    def transcribe_chunk(self, samples) -> str:
        """Raw PCM chunk (float32 or int16, 1-D) → the new text of this chunk."""
        x = np.asarray(samples)
        if x.dtype == np.int16:
            x = x.astype(np.float32) / 32768.0
        feats = self.preprocessor.process_chunk(x.astype(np.float32).reshape(-1))
        if feats is None:
            return ""
        enc = self.encoder_session.forward_chunk(feats)
        if enc is None:
            return ""
        res = transducer_greedy_decode(
            self.params,
            enc,
            pred_hidden=self.config.prediction.pred_hidden,
            num_lstm_layers=self.config.prediction.num_lstm_layers,
            durations=tuple(self.config.durations),
            blank_id=self._blank_id,
            is_tdt=True,
            joint_prefix=self.joint_prefix,
            init_token=self._last_token,
            init_lstm=self._lstm,
            frame_offset=self._frame_offset,
            clamp_end=False,  # the streaming decode does not clamp (eou.cpp:81-84)
        )
        self._last_token = res.last_token
        self._lstm = res.lstm_state
        self._frame_offset += enc.shape[1]

        new_tokens = res.tokens[0]
        self._tokens.extend(new_tokens)
        self._timestamped.extend(res.timestamped[0])
        if new_tokens and self.tokenizer.loaded:
            text = self.tokenizer.decode(new_tokens)
            if self._partial_cb:
                self._partial_cb(text)
            return text
        return ""

    def reset(self) -> None:
        self.preprocessor.reset()
        self.encoder_session.reset()
        self._init_decode_state()

    def get_text(self) -> str:
        if self.tokenizer.loaded and self._tokens:
            return self.tokenizer.decode(self._tokens)
        return ""

    def get_tokens(self) -> list[int]:
        return list(self._tokens)

    def get_timestamped_tokens(self) -> list[TimestampedToken]:
        return list(self._timestamped)

    def set_partial_callback(self, cb: PartialResultCallback) -> None:
        self._partial_cb = cb

    def to_gpu(self) -> None:
        """API-compatibility no-op (the reference C++ API moves weights to
        its GPU here); the facade already holds its weights on `device`."""


class StreamingTranscriber(_StreamingBase):
    """EOU-120m streaming transcriber (eou.hpp:101-160)."""

    joint_prefix = "tdt_joint_"

    def __init__(self, weights_path=None, vocab_path=None, config: EOUConfig | None = None, **kw):
        super().__init__(weights_path, vocab_path, config or make_eou_120m_config(), **kw)

    def _spec(self):
        return P.eou_spec(self.config)


class NemotronTranscriber(_StreamingBase):
    """Nemotron-600m multilingual streaming transcriber with latency modes
    (nemotron.hpp:78-133); the right context is latency_frames."""

    joint_prefix = "joint_"

    def __init__(self, weights_path=None, vocab_path=None, config: NemotronConfig | None = None, **kw):
        super().__init__(weights_path, vocab_path, config or make_nemotron_600m_config(), **kw)

    def _spec(self):
        return P.nemotron_spec(self.config)


class StreamingBatchTranscriber:
    """B concurrent streaming sessions in lockstep (the reference's TPU
    addition; its C++ original is single-stream).

    Fixed B slots step together. Two frontends: per_push, where each slot
    has its own mel preprocessor and a mel-frame queue and a step needs
    `mel_frames_per_step` frames; and fused, where slots queue raw samples,
    a step needs `_chunk_samples` of them, and the whole cohort's mel is
    computed inside the step. Inactive slots feed zeros and their tokens
    are discarded. Streams leave with `deactivate_slot(i)` and (re)join with
    `reset_slot(i)`, both edits of the state in place.
    """

    def __init__(
        self,
        batch: int,
        weights_path: str | None = None,
        vocab_path: str | None = None,
        config=None,
        *,
        model: str = "eou",  # "eou" | "nemotron": the preset and weight schema
        frontend: str = "per_push",  # "per_push" | "fused"
        wire_dtype: str = "float32",  # "float32" | "int16" (fused only)
        params: dict | None = None,
        mel_frames_per_step: int = 16,  # a multiple of 8 (the subsampling stride)
        seed: int = 0,
        quantize: str | None = None,
        mesh=None,
        compute_dtype: str = "float32",
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        """frontend="per_push": each push() runs the slot's mel frontend
        (StreamingAudioPreprocessor: the mel grid restarts at every push,
        so the output depends on the push cadence).

        frontend="fused": push() only queues raw samples on the host; a
        step slices `mel_frames_per_step·hop + (win-hop)` samples per slot
        and computes the cohort's mel on the device with the encoder and
        decoder, so the output does not depend on the push cadence. Per
        slot it equals per_push fed exactly step-sized pushes.

        wire_dtype="int16" (fused only): the raw queues and each step's
        upload stay int16, converted on the device as x/32768 (exact);
        float pushes are quantised to int16 on push.

        device: the card unless given; "cpu" runs on the CPU.

        mesh: a parallel.mesh.Mesh with a 'data' axis that divides batch
        (its 'model' and 'seq' axes one rank wide): this rank runs slots
        batch_sharding(mesh, batch) on the mesh's device (module note).
        Tokens equal the unsharded run's."""
        if mel_frames_per_step % 8:
            raise ValueError("mel_frames_per_step must be a multiple of 8")
        if model not in ("eou", "nemotron"):
            raise ValueError(f"model must be 'eou' or 'nemotron', got {model!r}")
        if frontend not in ("per_push", "fused"):
            raise ValueError(f"frontend must be 'per_push' or 'fused', got {frontend!r}")
        if wire_dtype not in ("float32", "int16"):
            raise ValueError(f"wire_dtype must be 'float32' or 'int16', got {wire_dtype!r}")
        if wire_dtype == "int16" and frontend != "fused":
            raise ValueError("wire_dtype='int16' requires frontend='fused'")
        self._slots = range(batch)  # the slots whose device state this rank holds
        if mesh is not None:
            from parakeet_tpu_torch.parallel.mesh import batch_sharding, mesh_device

            device = mesh_device(mesh, device)
            if any(mesh.shape.get(a, 1) > 1 for a in ("model", "seq", "pipe")):
                raise ValueError(f"the streaming cohort shards over 'data' only; mesh {mesh.shape}")
            if batch % mesh.shape["data"]:
                raise ValueError(f"batch {batch} must divide by the mesh's data axis ({mesh.shape['data']})")
            rows = batch_sharding(mesh, batch)
            self._slots = range(rows.start, rows.stop)
        self._mesh = mesh
        proto_cls = StreamingTranscriber if model == "eou" else NemotronTranscriber
        self.batch = batch
        self._mel_step = mel_frames_per_step
        self._frontend = frontend
        self._wire_dtype = np.int16 if wire_dtype == "int16" else np.float32
        self._joint_prefix = proto_cls.joint_prefix

        proto = proto_cls(weights_path, vocab_path, config, params=params, seed=seed,
                          compute_dtype=compute_dtype, quantize=quantize, device=device)
        self.config = proto.config  # the preset when config was None
        self.params = proto.params
        self.device = proto.device
        self.tokenizer = proto.tokenizer
        self._blank_id = proto._blank_id
        self._audio_cfg = proto._audio_cfg
        self._decode_max_out = (mel_frames_per_step // 8) * 10
        acfg = self._audio_cfg
        self._chunk_samples = mel_frames_per_step * acfg.hop_length + acfg.win_length - acfg.hop_length
        self.reset()

    def reset(self) -> None:
        cfg = self.config
        local = len(self._slots)
        # the caches follow the compute dtype (streaming_encoder_chunk casts the f32 mel)
        self._cache = init_encoder_cache(cfg.encoder, local, encoder_compute_dtype(self.params), self.device)
        if self._frontend == "fused":
            self._pre = []  # the preemphasis carry lives in _preemph_prev
            self._queues = [np.zeros((0,), self._wire_dtype) for _ in range(self.batch)]
            self._preemph_prev = np.zeros(self.batch, np.float32)
        else:
            self._pre = [StreamingAudioPreprocessor(self._audio_cfg, self.device) for _ in range(self.batch)]
            self._queues = [np.zeros((0, cfg.encoder.mel_bins), np.float32) for _ in range(self.batch)]
        self._last_token = torch.full((local,), self._blank_id, dtype=torch.int64, device=self.device)
        self._lstm = prediction_zero_state(cfg.prediction.num_lstm_layers, local,
                                           cfg.prediction.pred_hidden, device=self.device)
        self._tokens: list[list[int]] = [[] for _ in range(self.batch)]
        self._timestamped: list[list[TimestampedToken]] = [[] for _ in range(self.batch)]
        self._frame_offset = [0] * self.batch
        self._active = [True] * self.batch

    def deactivate_slot(self, slot: int) -> None:
        """Mark a slot vacant: it feeds zeros and its decode output is
        discarded, so the other streams keep flowing."""
        self._active[slot] = False

    @torch.inference_mode()
    def reset_slot(self, slot: int) -> None:
        """Clear one stream's state in place and (re)activate it."""
        self._active[slot] = True
        if self._frontend == "fused":
            self._queues[slot] = np.zeros((0,), self._wire_dtype)
            self._preemph_prev[slot] = 0.0
        else:
            self._pre[slot].reset()
            self._queues[slot] = np.zeros((0, self.config.encoder.mel_bins), np.float32)
        if slot in self._slots:  # the device state lives on the slot's rank
            row = slot - self._slots.start
            cache = {k: v.clone() for k, v in self._cache.items()}
            for k in ("conv", "key", "value"):
                cache[k][:, row] = 0
            cache["valid"][row] = 0
            self._cache = cache
            last, lstm = self._last_token.clone(), self._lstm.clone()
            last[row] = self._blank_id
            lstm[:, :, row] = 0
            self._last_token, self._lstm = last, lstm
        self._tokens[slot] = []
        self._timestamped[slot] = []
        self._frame_offset[slot] = 0

    def push(self, slot: int, samples) -> None:
        """Feed raw PCM to one slot. per_push: runs the slot's mel frontend
        now. fused: queues the samples on the host; the mel of the whole
        cohort is computed inside step()."""
        x = np.asarray(samples).reshape(-1)
        if self._frontend == "fused" and self._wire_dtype == np.int16:
            if x.dtype != np.int16:  # float callers: quantise to the wire
                x = np.clip(x.astype(np.float32) * 32768.0, -32768, 32767).astype(np.int16)
            self._queues[slot] = np.concatenate([self._queues[slot], x])
            return
        if x.dtype == np.int16:
            x = x.astype(np.float32) / 32768.0
        x = x.astype(np.float32)
        if self._frontend == "fused":
            self._queues[slot] = np.concatenate([self._queues[slot], x])
            return
        with torch.inference_mode():
            feats = self._pre[slot].process_chunk(x)
        if feats is not None:
            self._queues[slot] = np.concatenate([self._queues[slot], feats[0].cpu().numpy()], axis=0)

    @property
    def _step_units(self) -> int:
        """Queue units one step consumes: mel frames (per_push) or raw
        samples (fused)."""
        return self._mel_step if self._frontend == "per_push" else self._chunk_samples

    def ready(self) -> bool:
        return any(self._active) and all(
            q.shape[0] >= self._step_units for q, act in zip(self._queues, self._active) if act
        )

    def lagging_slots(self) -> list[int]:
        """Active slots without enough buffered input for a step:
        candidates for `step(hold=...)` so they do not stall the cohort."""
        return [i for i, (q, act) in enumerate(zip(self._queues, self._active))
                if act and q.shape[0] < self._step_units]

    def ready_any(self) -> bool:
        """True when at least one active slot can step (the lagging ones can
        be passed as `hold`)."""
        return any(act and q.shape[0] >= self._step_units for q, act in zip(self._queues, self._active))

    @torch.inference_mode()
    def step(self, hold=()) -> list[list[int]]:
        """Run one batch step; returns the new tokens of each active slot
        (empty lists for the others).

        hold: slots whose streams lag. They ride through the batched
        encoder and decoder, but all their state (caches, valid counters,
        LSTM state, last token, tokens, frame offsets, queues) is restored,
        as if the step never happened for them. Nothing is rebound until
        the step's results are on the host, so a step that raises leaves
        every queue, cache and decode state as it was."""
        hold = {int(i) for i in hold}
        for i in hold:
            if not 0 <= i < self.batch:
                raise ValueError(f"hold slot {i} out of range for batch {self.batch}")
        runnable = [act and (i not in hold) for i, act in enumerate(self._active)]
        if not any(runnable):
            raise RuntimeError("no active un-held slot to step")
        if any(self._queues[i].shape[0] < self._step_units for i, r in enumerate(runnable) if r):
            raise RuntimeError(
                "not every active un-held slot has enough buffered input; "
                "check ready()/lagging_slots()"
            )
        cfg = self.config
        mine = self._slots
        if self._frontend == "fused":
            cs = self._chunk_samples
            zeros = np.zeros((cs,), self._wire_dtype)
            raw = np.stack([self._queues[i][:cs] if runnable[i] else zeros for i in mine])
            raw_t = torch.from_numpy(raw).to(self.device)
            if raw_t.dtype == torch.int16:
                raw_t = raw_t.to(torch.float32) / 32768.0
            prev = torch.from_numpy(self._preemph_prev[mine.start:mine.stop].copy()).to(self.device)
            mel = streaming_log_mel_batch(raw_t, prev, self._audio_cfg, self._mel_step)
        else:
            zeros = np.zeros((self._mel_step, cfg.encoder.mel_bins), np.float32)
            mel = torch.from_numpy(np.stack([
                self._queues[i][: self._mel_step] if runnable[i] else zeros for i in mine
            ])).to(self.device)

        enc, new_cache = streaming_encoder_chunk(self.params, mel, self._cache, cfg=cfg.encoder)
        res = transducer_greedy_decode(
            self.params,
            enc,
            pred_hidden=cfg.prediction.pred_hidden,
            num_lstm_layers=cfg.prediction.num_lstm_layers,
            durations=tuple(cfg.durations),
            blank_id=self._blank_id,
            max_symbols=10,
            is_tdt=True,
            joint_prefix=self._joint_prefix,
            init_token=self._last_token,
            init_lstm=self._lstm,
            max_out=self._decode_max_out,
            clamp_end=False,  # the streaming decode does not clamp (eou.cpp:81-84)
        )
        new_last, new_lstm = res.last_token, res.lstm_state
        held = sorted(i - mine.start for i in hold if self._active[i] and i in mine)
        if held:
            # un-step the held slots: restore every piece of their state
            idx = torch.as_tensor(held, device=self.device)
            new_cache = dict(new_cache)
            for k in ("conv", "key", "value"):
                new_cache[k] = new_cache[k].index_copy(1, idx, self._cache[k].index_select(1, idx))
            new_cache["valid"] = new_cache["valid"].index_copy(0, idx, self._cache["valid"].index_select(0, idx))
            new_last = new_last.index_copy(0, idx, self._last_token.index_select(0, idx))
            new_lstm = new_lstm.index_copy(2, idx, self._lstm.index_select(2, idx))

        tokens, timestamped = res.tokens, res.timestamped
        if self._mesh is not None:  # every rank's slots, in slot order
            from parakeet_tpu_torch.parallel.collectives import gather_results

            every = gather_results(list(zip(tokens, timestamped)), self._mesh.axis("data"), self.device)
            tokens, timestamped = [t for t, _ in every], [ts for _, ts in every]

        # the decode's results are on the host: commit the step
        self._cache, self._last_token, self._lstm = new_cache, new_last, new_lstm
        if self._frontend == "fused":
            for i, r in enumerate(runnable):
                if r:  # held and inactive slots keep their preemphasis carry
                    last = self._queues[i][self._chunk_samples - 1]
                    self._preemph_prev[i] = last / 32768.0 if self._wire_dtype == np.int16 else last
        self._queues = [q[self._step_units:] if r else q for q, r in zip(self._queues, runnable)]
        chunk_len = self._mel_step // 8
        out: list[list[int]] = []
        for i in range(self.batch):
            if not self._active[i] or i in hold:
                out.append([])
                continue
            toks = tokens[i]
            self._tokens[i].extend(toks)
            off = self._frame_offset[i]
            self._timestamped[i].extend(
                TimestampedToken(t.token_id, t.start_frame + off, t.end_frame + off, t.confidence)
                for t in timestamped[i]
            )
            self._frame_offset[i] += chunk_len
            out.append(toks)
        return out

    def get_text(self, slot: int) -> str:
        if self.tokenizer.loaded and self._tokens[slot]:
            return self.tokenizer.decode(self._tokens[slot])
        return ""

    def get_timestamped_tokens(self, slot: int) -> list[TimestampedToken]:
        """Stream-absolute timestamped tokens of one slot."""
        return list(self._timestamped[slot])


__all__ = [
    "StreamingTranscriber",
    "NemotronTranscriber",
    "StreamingBatchTranscriber",
    "PartialResultCallback",
]
