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
diarization (`Sortformer`, `DiarizedTranscriber`). Entry points run on the
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
from parakeet_tpu_torch.diarize import DiarizedTranscriber
from parakeet_tpu_torch.models.encoder import FusedLayers
from parakeet_tpu_torch.models.sortformer import Sortformer
from parakeet_tpu_torch.streaming import NemotronTranscriber, StreamingBatchTranscriber, StreamingTranscriber
from parakeet_tpu_torch.transcribe import (
    Decoder,
    RNNTTranscriber,
    TDTTranscriber,
    TranscribeOptions,
    TranscribeResult,
    Transcriber,
)

__all__ = ["Decoder", "DiarizedTranscriber", "FusedLayers", "NemotronTranscriber", "RNNTTranscriber", "Sortformer",
           "StreamingBatchTranscriber", "StreamingTranscriber", "TDTTranscriber", "TranscribeOptions",
           "TranscribeResult", "Transcriber", "make_110m_config", "make_eou_120m_config",
           "make_nemotron_600m_config", "make_rnnt_600m_config", "make_sortformer_117m_config",
           "make_tdt_600m_config"]
