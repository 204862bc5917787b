"""parakeet_tpu_torch: the PyTorch/CUDA port of parakeet_tpu.

Offline speech recognition on an NVIDIA H100 with the tdt-ctc, TDT-only
and RNNT models (`Transcriber`, `TDTTranscriber`, `RNNTTranscriber`): mel
frontend → FastConformer encoder (each block's rel-pos attention a
hand-written CUDA kernel, ops/rel_attention.py + csrc/rel_attention.cu;
with FusedLayers the FFNs, conv modules and subsampling front too) →
greedy TDT, RNNT or CTC decode → text, with windowed or dense long audio,
forced alignment, VAD and WAV/FLAC/MP3/OGG input; streaming ASR
(`StreamingTranscriber` eou-120m, `NemotronTranscriber` nemotron-600m in
its latency modes, the lockstep `StreamingBatchTranscriber`) and Sortformer
diarization (`Sortformer`, `DiarizedTranscriber`). Every facade takes
quantize="int8"|"int4" (`quantize_params`); transcribe* takes phrase
boosting, beam search and n-gram or neural LMs (`NgramLM`, `NeuralLM`);
`HotwordDetector` spots a wake phrase; `word_error_rate` and `corpus_wer`
score transcripts. Serving: `TranscriptionService` (dynamic batching) and
`StreamingService` (live streams in lockstep slots), the HTTP server
(`python -m parakeet_tpu_torch.serve_http`), the `parakeet` CLI
(`python -m parakeet_tpu_torch.cli`), the flat C API (capi.py,
csrc/parakeet_capi.cpp), `parakeet-bench` (`python -m
parakeet_tpu_torch.benchmark`) and the NeMo converter (tools/convert.py).
Training (train.py): the CTC, RNNT, TDT, hybrid and Sortformer losses
(`rnnt_loss`, `tdt_loss`), the data pipeline (`ManifestDataset`,
`TrainDataLoader`), checkpoints and the train CLIs (`python -m
parakeet_tpu_torch.train_cli`, `python -m parakeet_tpu_torch.train_diar_cli`).
Meshes: the offline facades take mesh= (data, tensor and sequence
parallel) and the lockstep StreamingBatchTranscriber a data-parallel one,
over torch.distributed (`parakeet_tpu_torch.parallel`: make_mesh,
shard_params). Entry points run on the card unless given device="cpu". Module paths
mirror the JAX reference package parakeet_tpu, which this package never
imports; `NOT_PORTED` lists the reference's public names it does not
export.
"""

from parakeet_tpu_torch.config import (
    AudioConfig,
    CTCConfig,
    EncoderConfig,
    EOUConfig,
    JointConfig,
    NemotronConfig,
    PredictionConfig,
    RNNTConfig,
    SortformerConfig,
    StreamingEncoderConfig,
    TDTConfig,
    TDTCTCConfig,
    TransformerConfig,
    make_110m_config,
    make_eou_120m_config,
    make_nemotron_600m_config,
    make_rnnt_600m_config,
    make_sortformer_117m_config,
    make_tdt_600m_config,
)
from parakeet_tpu_torch.audio.frontend import StreamingAudioPreprocessor, preprocess_audio
from parakeet_tpu_torch.audio.io import (
    AudioData,
    detect_format_by_extension,
    detect_format_by_magic,
    get_audio_duration,
    read_audio,
    resample,
    write_wav,
)
from parakeet_tpu_torch.audio.vad import VadConfig, vad_segments
from parakeet_tpu_torch.data import ManifestDataset, TrainDataLoader
from parakeet_tpu_torch.decode.align import ctc_forced_align
from parakeet_tpu_torch.decode.keyword import HotwordDetector, keyword_log_odds
from parakeet_tpu_torch.decode.phrase_boost import ContextTrie
from parakeet_tpu_torch.decode.timestamp import (
    FRAME_DURATION_S,
    TimestampedToken,
    TimestampMode,
    WordTimestamp,
    frame_to_seconds,
    group_timestamps,
)
from parakeet_tpu_torch.diarize import DiarizedResult, DiarizedTranscriber, DiarizedWord, diarize_transcription
from parakeet_tpu_torch.metrics import corpus_wer, word_error_rate
from parakeet_tpu_torch.models.encoder import FusedLayers
from parakeet_tpu_torch.models.sortformer import AOSCCache, DiarizationSegment, Sortformer
from parakeet_tpu_torch.ops.transducer_loss import rnnt_loss, tdt_loss
from parakeet_tpu_torch.quantize import quantize_params, quantized_fraction
from parakeet_tpu_torch.serve import StreamingService, TranscriptionService
from parakeet_tpu_torch.streaming import NemotronTranscriber, StreamingBatchTranscriber, StreamingTranscriber
from parakeet_tpu_torch.text.neural_lm import NeuralLM, NeuralLMConfig, train_neural_lm
from parakeet_tpu_torch.text.ngram_lm import NgramLM, rescore_nbest
from parakeet_tpu_torch.text.tokenizer import Tokenizer
from parakeet_tpu_torch.transcribe import (
    Decoder,
    RNNTTranscriber,
    TDTTranscriber,
    TranscribeOptions,
    TranscribeResult,
    Transcriber,
)

__version__ = "0.1.0"

# the reference's public names that the port does not export: the
# encoder's process globals, which FusedLayers replaces as an explicit
# argument
NOT_PORTED = ("set_fused_attention", "set_conv_layout", "set_fused_ffn", "set_fused_block2")

__all__ = [
    "AOSCCache", "AudioConfig", "AudioData", "CTCConfig", "ContextTrie", "Decoder", "DiarizationSegment",
    "DiarizedResult", "DiarizedTranscriber", "DiarizedWord", "EOUConfig", "EncoderConfig", "FRAME_DURATION_S",
    "FusedLayers", "HotwordDetector", "JointConfig", "ManifestDataset", "NemotronConfig", "NemotronTranscriber", "NeuralLM",
    "NeuralLMConfig", "NgramLM", "PredictionConfig", "RNNTConfig", "RNNTTranscriber", "Sortformer",
    "SortformerConfig", "StreamingAudioPreprocessor", "StreamingBatchTranscriber", "StreamingEncoderConfig",
    "StreamingService", "StreamingTranscriber", "TDTCTCConfig", "TDTConfig", "TDTTranscriber", "TimestampMode",
    "TimestampedToken", "Tokenizer", "TrainDataLoader", "TranscribeOptions", "TranscribeResult", "Transcriber",
    "TranscriptionService", "TransformerConfig", "VadConfig", "WordTimestamp", "corpus_wer", "ctc_forced_align",
    "detect_format_by_extension", "detect_format_by_magic", "diarize_transcription", "frame_to_seconds",
    "get_audio_duration", "group_timestamps", "keyword_log_odds", "make_110m_config", "make_eou_120m_config",
    "make_nemotron_600m_config", "make_rnnt_600m_config", "make_sortformer_117m_config", "make_tdt_600m_config",
    "preprocess_audio", "quantize_params", "quantized_fraction", "read_audio", "resample", "rescore_nbest",
    "rnnt_loss", "tdt_loss", "train_neural_lm", "vad_segments", "word_error_rate", "write_wav",
]
