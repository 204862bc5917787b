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
score transcripts. Entry points run on the
card unless given device="cpu". Module paths mirror the JAX reference
package parakeet_tpu, which this package never imports.
"""

from parakeet_tpu_torch.config import (
    make_110m_config,
    make_eou_120m_config,
    make_nemotron_600m_config,
    make_rnnt_600m_config,
    make_sortformer_117m_config,
    make_tdt_600m_config,
)
from parakeet_tpu_torch.decode.keyword import HotwordDetector
from parakeet_tpu_torch.diarize import DiarizedTranscriber
from parakeet_tpu_torch.metrics import corpus_wer, word_error_rate
from parakeet_tpu_torch.models.encoder import FusedLayers
from parakeet_tpu_torch.models.sortformer import Sortformer
from parakeet_tpu_torch.quantize import quantize_params, quantized_fraction
from parakeet_tpu_torch.streaming import NemotronTranscriber, StreamingBatchTranscriber, StreamingTranscriber
from parakeet_tpu_torch.text.neural_lm import NeuralLM, NeuralLMConfig
from parakeet_tpu_torch.text.ngram_lm import NgramLM
from parakeet_tpu_torch.transcribe import (
    Decoder,
    RNNTTranscriber,
    TDTTranscriber,
    TranscribeOptions,
    TranscribeResult,
    Transcriber,
)

__all__ = ["Decoder", "DiarizedTranscriber", "FusedLayers", "HotwordDetector", "NemotronTranscriber", "NeuralLM",
           "NeuralLMConfig", "NgramLM", "RNNTTranscriber", "Sortformer", "StreamingBatchTranscriber",
           "StreamingTranscriber", "TDTTranscriber", "TranscribeOptions", "TranscribeResult", "Transcriber",
           "corpus_wer", "make_110m_config", "make_eou_120m_config", "make_nemotron_600m_config",
           "make_rnnt_600m_config", "make_sortformer_117m_config", "make_tdt_600m_config", "quantize_params",
           "quantized_fraction", "word_error_rate"]
