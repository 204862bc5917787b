"""Configuration structs + model presets.

Mirrors the reference's plain-struct config layer
(include/parakeet/config.hpp:9-135, streaming_encoder.hpp:16-24,
eou.hpp:24-56, nemotron.hpp:22-54, sortformer.hpp:29-72,
transformer.hpp:13-22, audio.hpp:7-19). Presets encode the published
hyperparameters of the NVIDIA Parakeet / Sortformer checkpoints.

A copy of parakeet_tpu/config.py (the JAX reference), so the port never
imports the reference package. All configs are frozen dataclasses: hashable,
comparable field by field with the reference presets.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


def _frozen(cls):
    return dataclass(frozen=True)(cls)


# ─── Audio frontend ──────────────────────────────────────────────────────────


@_frozen
class AudioConfig:
    """Mel-spectrogram frontend config (reference: audio.hpp:7-19).

    Note: `dither` is declared but never applied in the reference either —
    preprocessing is deterministic (verified by its determinism test).
    """

    sample_rate: int = 16000
    n_fft: int = 512
    win_length: int = 400  # 25 ms
    hop_length: int = 160  # 10 ms
    n_mels: int = 80
    dither: float = 1e-5  # declared, unused (parity with reference)
    f_min: float = 0.0
    f_max: float = -1.0  # <=0 → sample_rate / 2
    normalize: bool = True  # per-feature normalization over time


# ─── Encoder ─────────────────────────────────────────────────────────────────


@_frozen
class EncoderConfig:
    """FastConformer encoder config (reference: config.hpp:9-21)."""

    mel_bins: int = 80
    subsampling_factor: int = 8
    subsampling_channels: int = 256
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 8
    ffn_intermediate: int = 4096
    conv_kernel_size: int = 9
    dropout: float = 0.1
    layer_norm_eps: float = 1e-5


class SubsamplingActivation:
    """Activation used inside conv subsampling (streaming_encoder.hpp:16)."""

    SILU = "silu"
    RELU = "relu"


@_frozen
class StreamingEncoderConfig(EncoderConfig):
    """Streaming FastConformer config (reference: streaming_encoder.hpp:18-24)."""

    att_context_left: int = 70
    att_context_right: int = 0
    chunk_size: int = 20  # encoder frames per chunk (after 8x subsampling)
    subsampling_activation: str = SubsamplingActivation.RELU
    xscaling: bool = False  # multiply subsampling output by sqrt(d_model)


# ─── Heads ───────────────────────────────────────────────────────────────────


@_frozen
class CTCConfig:
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    vocab_size: int = 1025  # 1024 tokens + 1 blank


@_frozen
class PredictionConfig:
    vocab_size: int = 1025
    pred_hidden: int = 640
    num_lstm_layers: int = 2
    dropout: float = 0.1


@_frozen
class JointConfig:
    encoder_hidden: int = 1024
    pred_hidden: int = 640
    joint_hidden: int = 640
    vocab_size: int = 1025


# ─── Model assemblies ────────────────────────────────────────────────────────


@_frozen
class RNNTConfig:
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    prediction: PredictionConfig = field(default_factory=PredictionConfig)
    joint: JointConfig = field(default_factory=JointConfig)


@_frozen
class TDTConfig:
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    prediction: PredictionConfig = field(default_factory=PredictionConfig)
    joint: JointConfig = field(default_factory=JointConfig)
    durations: tuple[int, ...] = (0, 1, 2, 3, 4)


@_frozen
class TDTCTCConfig:
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    prediction: PredictionConfig = field(default_factory=PredictionConfig)
    joint: JointConfig = field(default_factory=JointConfig)
    durations: tuple[int, ...] = (0, 1, 2, 3, 4)
    ctc_vocab_size: int = 1025


@_frozen
class EOUConfig:
    """Streaming EOU model config (reference: eou.hpp:24-56)."""

    encoder: StreamingEncoderConfig = field(default_factory=StreamingEncoderConfig)
    prediction: PredictionConfig = field(default_factory=PredictionConfig)
    joint: JointConfig = field(default_factory=JointConfig)
    durations: tuple[int, ...] = (0, 1, 2, 3, 4)
    eou_token_id: int = -1  # -1 = disabled
    ctc_vocab_size: int = 1025


@_frozen
class NemotronConfig:
    """Nemotron streaming config; latency via right context (nemotron.hpp:22-54)."""

    encoder: StreamingEncoderConfig = field(default_factory=StreamingEncoderConfig)
    prediction: PredictionConfig = field(default_factory=PredictionConfig)
    joint: JointConfig = field(default_factory=JointConfig)
    durations: tuple[int, ...] = (0, 1, 2, 3, 4)
    latency_frames: int = 0  # 0→80ms, 1→160ms, 6→560ms, 13→1120ms


@_frozen
class TransformerConfig:
    """Vanilla transformer config for the Sortformer head (transformer.hpp:13-22)."""

    hidden_size: int = 192
    num_layers: int = 18
    num_heads: int = 8
    ffn_intermediate: int = 768
    dropout: float = 0.1
    layer_norm_eps: float = 1e-5
    pre_ln: bool = True
    has_final_norm: bool = False


@_frozen
class SortformerConfig:
    """Sortformer diarization config (reference: sortformer.hpp:29-72)."""

    nest_encoder: StreamingEncoderConfig = field(default_factory=StreamingEncoderConfig)
    encoder_hidden: int = 512
    transformer_hidden: int = 192
    transformer: TransformerConfig = field(default_factory=TransformerConfig)
    max_speakers: int = 4
    activity_threshold: float = 0.5


# ─── Presets ─────────────────────────────────────────────────────────────────


def make_110m_config() -> TDTCTCConfig:
    """nvidia/parakeet-tdt_ctc-110m (reference: config.hpp:77-95)."""
    return TDTCTCConfig(
        encoder=EncoderConfig(
            hidden_size=512,
            num_layers=17,
            num_heads=8,
            ffn_intermediate=2048,
            subsampling_channels=256,
            conv_kernel_size=9,
        ),
        prediction=PredictionConfig(vocab_size=1025, pred_hidden=640, num_lstm_layers=1),
        joint=JointConfig(encoder_hidden=512, pred_hidden=640, joint_hidden=640, vocab_size=1025),
        durations=(0, 1, 2, 3, 4),
        ctc_vocab_size=1025,
    )


def make_tdt_600m_config() -> TDTConfig:
    """nvidia/parakeet-tdt-0.6b-v3 (reference: config.hpp:98-116)."""
    return TDTConfig(
        encoder=EncoderConfig(
            mel_bins=128,
            hidden_size=1024,
            num_layers=24,
            num_heads=8,
            ffn_intermediate=4096,
            subsampling_channels=256,
            conv_kernel_size=9,
        ),
        prediction=PredictionConfig(vocab_size=8193, pred_hidden=640, num_lstm_layers=2),
        joint=JointConfig(encoder_hidden=1024, pred_hidden=640, joint_hidden=640, vocab_size=8193),
        durations=(0, 1, 2, 3, 4),
    )


def make_rnnt_600m_config() -> RNNTConfig:
    """nvidia/parakeet-rnnt-0.6b (reference: config.hpp:119-135)."""
    return RNNTConfig(
        encoder=EncoderConfig(
            hidden_size=1024,
            num_layers=24,
            num_heads=8,
            ffn_intermediate=4096,
            subsampling_channels=256,
            conv_kernel_size=9,
        ),
        prediction=PredictionConfig(vocab_size=1025, pred_hidden=640, num_lstm_layers=2),
        joint=JointConfig(encoder_hidden=1024, pred_hidden=640, joint_hidden=640, vocab_size=1025),
    )


def make_eou_120m_config() -> EOUConfig:
    """Streaming EOU 120m (reference: eou.hpp:34-56)."""
    return EOUConfig(
        encoder=StreamingEncoderConfig(
            hidden_size=512,
            num_layers=17,
            num_heads=8,
            ffn_intermediate=2048,
            subsampling_channels=256,
            conv_kernel_size=9,
            att_context_left=70,
            att_context_right=1,
            chunk_size=20,  # ~160 ms chunks
        ),
        prediction=PredictionConfig(vocab_size=1025, pred_hidden=640, num_lstm_layers=1),
        joint=JointConfig(encoder_hidden=512, pred_hidden=640, joint_hidden=640, vocab_size=1025),
        durations=(0, 1, 2, 3, 4),
        eou_token_id=1024,  # blank acts as EOU
        ctc_vocab_size=1025,
    )


def make_nemotron_600m_config(latency_frames: int = 0) -> NemotronConfig:
    """Nemotron 600m multilingual streaming (reference: nemotron.hpp:33-54)."""
    return NemotronConfig(
        encoder=StreamingEncoderConfig(
            hidden_size=1024,
            num_layers=24,
            num_heads=8,
            ffn_intermediate=4096,
            subsampling_channels=256,
            conv_kernel_size=9,
            att_context_left=70,
            att_context_right=latency_frames,
            chunk_size=20,
        ),
        prediction=PredictionConfig(vocab_size=8193, pred_hidden=640, num_lstm_layers=2),
        joint=JointConfig(encoder_hidden=1024, pred_hidden=640, joint_hidden=640, vocab_size=8193),
        durations=(0, 1, 2, 3, 4),
        latency_frames=latency_frames,
    )


def make_sortformer_117m_config() -> SortformerConfig:
    """nvidia Sortformer-117m diarizer (reference: sortformer.hpp:43-72)."""
    return SortformerConfig(
        nest_encoder=StreamingEncoderConfig(
            mel_bins=128,
            hidden_size=512,
            num_layers=17,
            num_heads=8,
            ffn_intermediate=2048,
            subsampling_channels=256,
            conv_kernel_size=9,
            att_context_left=70,
            att_context_right=0,
            chunk_size=20,
            subsampling_activation=SubsamplingActivation.RELU,
            xscaling=True,  # NeMo NEST multiplies by sqrt(d_model)
        ),
        encoder_hidden=512,
        transformer_hidden=192,
        transformer=TransformerConfig(
            hidden_size=192,
            num_layers=18,
            num_heads=8,
            ffn_intermediate=768,
            pre_ln=False,  # NeMo sortformer uses post-norm
            has_final_norm=False,
        ),
        max_speakers=4,
        activity_threshold=0.5,
    )


def as_streaming(cfg: EncoderConfig, **kwargs) -> StreamingEncoderConfig:
    """Promote an EncoderConfig to a StreamingEncoderConfig."""
    base = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(EncoderConfig)}
    base.update(kwargs)
    return StreamingEncoderConfig(**base)


__all__ = [n for n in dir() if not n.startswith("_")]
