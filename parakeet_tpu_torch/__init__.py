"""parakeet_tpu_torch: the PyTorch/CUDA port of parakeet_tpu.

Offline tdt-ctc speech recognition on an NVIDIA H100: mel frontend →
FastConformer encoder (each block's rel-pos attention a hand-written CUDA
kernel, ops/rel_attention.py + csrc/rel_attention.cu; with FusedLayers the
FFNs, conv modules and subsampling front too) → greedy TDT or CTC decode →
text. Module paths mirror the JAX reference package parakeet_tpu,
which this package never imports.
"""

from parakeet_tpu_torch.config import make_110m_config
from parakeet_tpu_torch.models.encoder import FusedLayers
from parakeet_tpu_torch.transcribe import (
    Decoder,
    TranscribeOptions,
    TranscribeResult,
    Transcriber,
)

__all__ = ["Decoder", "FusedLayers", "TranscribeOptions", "TranscribeResult", "Transcriber", "make_110m_config"]
