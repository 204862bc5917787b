"""Sortformer speaker diarization (port of parakeet_tpu/models/sortformer.py).

Reference: src/sortformer.cpp. NEST encoder (FastConformer, 128 mel, ReLU
subsampling, xscaling) → Linear 512→192 → 18-layer post-norm transformer
→ speaker head relu → first_hidden_ → relu → output_proj_ → sigmoid →
(B, T, 4) activity probabilities. `hidden_to_spks_` is in the schema for
state-dict compatibility and unused, as in the reference.

The NEST encoder is the offline `fastconformer_encode` with
`FusedLayers()`: each block's attention is the attention block kernel K1
on the card and its plain version on the CPU. `diarize_chunk` runs the
streaming encoder session instead (models/streaming_encoder.py).

On the host: probabilities → segments (sortformer.cpp:70-113), the AOSC
arrival-order cache (:9-38), streaming diarize_chunk (:125-150).
`sortformer_logits` is the training forward (train.py's Sortformer loss).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from parakeet_tpu_torch import params as P
from parakeet_tpu_torch.config import SortformerConfig, make_sortformer_117m_config
from parakeet_tpu_torch.decode.timestamp import frame_to_seconds
from parakeet_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from parakeet_tpu_torch.models.encoder import (
    EncoderSplit,
    FusedLayers,
    encoded_lengths,
    fastconformer_encode,
    length_mask,
)
from parakeet_tpu_torch.models.streaming_encoder import StreamingEncoderSession
from parakeet_tpu_torch.models.transformer import transformer_encode
from parakeet_tpu_torch.ops.layers import linear
from parakeet_tpu_torch.params import Params


@dataclass
class DiarizationSegment:
    speaker_id: int
    start: float  # seconds
    end: float


class AOSCCache:
    """Arrival-order speaker cache (sortformer.cpp:9-38)."""

    def __init__(self, max_speakers: int = 4):
        self.max_speakers = max_speakers
        self.reset()

    def update(self, probs) -> None:
        """probs: (T, max_speakers) sigmoid activity."""
        p = np.asarray(probs)
        for t in range(p.shape[0]):
            for s in range(min(p.shape[1], self.max_speakers)):
                if p[t, s] > 0.5 and not self._active[s]:
                    self._active[s] = True
                    self._order.append(s)

    def speaker_order(self) -> list[int]:
        return list(self._order)

    def reset(self) -> None:
        self._active = [False] * self.max_speakers
        self._order: list[int] = []


def _speaker_logits(root: Params, trans_out: torch.Tensor) -> torch.Tensor:
    h = torch.relu(linear(root.sub("first_hidden_"), torch.relu(trans_out)))
    return linear(root.sub("output_proj_"), h)


def _speaker_head(root: Params, trans_out: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(_speaker_logits(root, trans_out).to(torch.float32))


def sortformer_logits(
    params: dict,
    features: torch.Tensor,
    *,
    cfg: SortformerConfig,
    mel_lengths: torch.Tensor | None = None,
    remat: bool = False,
    split: EncoderSplit | None = None,
) -> torch.Tensor:
    """(B, mel_len, 128) → (B, T, max_speakers) pre-sigmoid activity
    logits, f32: the training-side twin of `sortformer_forward` (the BCE
    losses in train.py take logits). `mel_lengths` masks padding in the
    NEST encoder and in the transformer, so pad frames never reach a valid
    frame's logits; `remat` rematerializes the encoder blocks in backward.
    split: a 'model' split of the NEST encoder and the transformer (this
    rank's shards in `params`; no 'seq' axis, as in the reference). Runs
    under whatever grad mode the caller has."""
    root = Params(params)
    enc = fastconformer_encode(root.sub("nest_encoder_"), cfg.nest_encoder, features, mel_lengths,
                               fused=FusedLayers(), remat=remat, split=split)
    mask = None
    if mel_lengths is not None:
        t = enc.shape[1]
        enc_lens = torch.clamp(encoded_lengths(torch.as_tensor(mel_lengths, device=enc.device)), max=t)
        mask = length_mask(enc_lens, t)
    proj = linear(root.sub("projection_"), enc)
    trans = transformer_encode(root.sub("transformer_"), cfg.transformer, proj, mask,
                               None if split is None else split.model)
    return _speaker_logits(root, trans).to(torch.float32)


@torch.inference_mode()
def _sortformer_tail_states(params: dict, enc: torch.Tensor, *, cfg: SortformerConfig):
    """projection → transformer → speaker head: ((B, T, D) pre-head states,
    (B, T, S) probabilities). One implementation for every tail consumer,
    so the embedding states cannot drift from diarize()'s probabilities."""
    root = Params(params)
    proj = linear(root.sub("projection_"), enc)
    trans = transformer_encode(root.sub("transformer_"), cfg.transformer, proj)
    return trans, _speaker_head(root, trans)


def _sortformer_tail(params: dict, enc: torch.Tensor, *, cfg: SortformerConfig) -> torch.Tensor:
    """projection → transformer → speaker head (the full and chunk paths)."""
    return _sortformer_tail_states(params, enc, cfg=cfg)[1]


@torch.inference_mode()
def sortformer_states(params: dict, features: torch.Tensor, *, cfg: SortformerConfig):
    """(B, mel_len, 128) unnormalised log-mel → ((B, T, D) transformer
    states, (B, T, max_speakers) activity probabilities)."""
    enc = fastconformer_encode(Params(params).sub("nest_encoder_"), cfg.nest_encoder, features,
                               fused=FusedLayers())
    return _sortformer_tail_states(params, enc, cfg=cfg)


def sortformer_forward(params: dict, features: torch.Tensor, *, cfg: SortformerConfig) -> torch.Tensor:
    """(B, mel_len, 128) unnormalised log-mel → (B, T, max_speakers)
    probabilities (sortformer.cpp:50-68)."""
    return sortformer_states(params, features, cfg=cfg)[1]


def speaker_embeddings(
    hidden: np.ndarray,
    probs: np.ndarray,
    *,
    activity_threshold: float = 0.5,
    min_frames: int = 2,
) -> tuple[np.ndarray, list[bool]]:
    """Per-speaker embeddings of one utterance: hidden (T, D) transformer
    states, probs (T, S) activity. Each speaker's embedding is the
    probability-weighted mean of the states over the frames where it is
    active (> threshold), L2-normalised. Returns ((S, D) embeddings, active
    flags); a speaker with fewer than `min_frames` active frames gets a zero
    vector and active=False."""
    h = np.asarray(hidden, np.float32)
    p = np.asarray(probs, np.float32)
    out = np.zeros((p.shape[1], h.shape[1]), np.float32)
    active: list[bool] = []
    for s in range(p.shape[1]):
        mask = p[:, s] > activity_threshold
        if mask.sum() < min_frames:
            active.append(False)
            continue
        w = p[mask, s]
        emb = (h[mask] * w[:, None]).sum(0) / w.sum()
        norm = float(np.linalg.norm(emb))
        out[s] = emb / norm if norm > 0 else emb
        active.append(True)
    return out, active


def probs_to_segments(probs, activity_threshold: float = 0.5) -> list[DiarizationSegment]:
    """(T, S) probabilities → each speaker's contiguous active runs, sorted
    by start (sortformer.cpp:70-113)."""
    p = np.asarray(probs)
    t_len, s_len = p.shape
    segments: list[DiarizationSegment] = []
    for s in range(s_len):
        active = p[:, s] > activity_threshold
        in_seg = False
        start = 0
        for t in range(t_len):
            if active[t] and not in_seg:
                start, in_seg = t, True
            elif not active[t] and in_seg:
                segments.append(DiarizationSegment(s, frame_to_seconds(start), frame_to_seconds(t - 1)))
                in_seg = False
        if in_seg:
            segments.append(DiarizationSegment(s, frame_to_seconds(start), frame_to_seconds(t_len - 1)))
    segments.sort(key=lambda seg: seg.start)
    return segments


class Sortformer:
    """Facade mirroring the reference class (sortformer.hpp:100-139). Runs
    on the card unless given device="cpu"; with no card it raises."""

    def __init__(
        self,
        weights_path: str | None = None,
        config: SortformerConfig | None = None,
        *,
        params: dict | None = None,
        seed: int = 0,
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        """params: a flat {name: array} dict used instead of weights_path."""
        self.config = config or make_sortformer_117m_config()
        self.device = resolve_device(device)
        if params is None:
            params = P.load_params_numpy(P.sortformer_spec(self.config), weights_path, seed=seed,
                                         warn=lambda m: print(f"[parakeet] {m}"))
        self.params = P.params_from_numpy(params, self.device)
        self._stream_session: StreamingEncoderSession | None = None

    def to_gpu(self) -> None:
        """API-compatibility no-op (the reference C++ API moves weights to
        its GPU here); the facade already holds its weights on `device`."""

    def _features(self, features) -> torch.Tensor:
        if isinstance(features, torch.Tensor):
            return features.to(device=self.device, dtype=torch.float32)
        return torch.from_numpy(np.asarray(features, np.float32)).to(self.device)

    def forward(self, features) -> torch.Tensor:
        """(B, mel_len, mel) features → (B, T, max_speakers) probabilities."""
        return sortformer_forward(self.params, self._features(features), cfg=self.config)

    def diarize(self, features) -> list[DiarizationSegment]:
        probs = self.forward(features)[0].cpu().numpy()  # (T, S)
        return probs_to_segments(probs, self.config.activity_threshold)

    def extract_embeddings(self, features) -> tuple[np.ndarray, list[bool]]:
        """(max_speakers, D) L2-normalised speaker embeddings and active
        flags for one utterance; compare utterances by cosine similarity."""
        hidden, probs = sortformer_states(self.params, self._features(features), cfg=self.config)
        return speaker_embeddings(hidden[0].cpu().numpy(), probs[0].cpu().numpy(),
                                  activity_threshold=self.config.activity_threshold)

    # ── Streaming (sortformer.cpp:125-150) ───────────────────────────────

    def reset_stream(self) -> None:
        self._stream_session = None

    def diarize_chunk(self, features, aosc: AOSCCache) -> list[DiarizationSegment]:
        """One feature chunk through the streaming NEST encoder; returns
        this chunk's segments."""
        if self._stream_session is None:
            self._stream_session = StreamingEncoderSession(self.params, self.config.nest_encoder, batch=1,
                                                           prefix="nest_encoder_")
        if isinstance(features, torch.Tensor):
            features = features.cpu().numpy()
        enc = self._stream_session.forward_chunk(np.asarray(features))
        if enc is None:
            return []
        probs = _sortformer_tail(self.params, enc, cfg=self.config)[0].cpu().numpy()
        aosc.update(probs)
        return probs_to_segments(probs, self.config.activity_threshold)


__all__ = [
    "AOSCCache",
    "DiarizationSegment",
    "Sortformer",
    "probs_to_segments",
    "sortformer_forward",
    "sortformer_logits",
    "sortformer_states",
    "speaker_embeddings",
]
