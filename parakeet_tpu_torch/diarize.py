"""Speaker-attributed transcription: DiarizedTranscriber (port of
parakeet_tpu/diarize.py).

Reference: src/diarize.cpp. ASR with word timestamps, Sortformer on its
own features (128 mel, normalize=False, diarize.cpp:81-89: the audio is
preprocessed twice with different configurations), then each word gets the
speaker with the largest total overlap in time (:10-48); no overlap gives
speaker −1. Runs on the card unless given device="cpu".
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from parakeet_tpu_torch.audio.frontend import preprocess_audio
from parakeet_tpu_torch.audio.io import read_audio
from parakeet_tpu_torch.config import AudioConfig, SortformerConfig, TDTCTCConfig, make_110m_config, \
    make_sortformer_117m_config
from parakeet_tpu_torch.decode.timestamp import WordTimestamp
from parakeet_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from parakeet_tpu_torch.models.sortformer import DiarizationSegment, Sortformer
from parakeet_tpu_torch.transcribe import Decoder, Transcriber


@dataclass
class DiarizedWord:
    word: str
    start: float
    end: float
    confidence: float = 1.0
    speaker_id: int = -1


@dataclass
class DiarizedResult:
    text: str = ""
    words: list[DiarizedWord] = field(default_factory=list)
    segments: list[DiarizationSegment] = field(default_factory=list)
    word_timestamps: list[WordTimestamp] = field(default_factory=list)


def diarize_transcription(
    words: list[WordTimestamp], segments: list[DiarizationSegment]
) -> list[DiarizedWord]:
    """Max-overlap speaker assignment (diarize.cpp:10-48)."""
    out: list[DiarizedWord] = []
    for w in words:
        overlap_by_speaker: dict[int, float] = {}
        for seg in segments:
            overlap = min(w.end, seg.end) - max(w.start, seg.start)
            if overlap > 0.0:
                overlap_by_speaker[seg.speaker_id] = overlap_by_speaker.get(seg.speaker_id, 0.0) + overlap
        best_speaker, best_overlap = -1, 0.0
        for spk, ovl in overlap_by_speaker.items():
            if ovl > best_overlap:
                best_overlap, best_speaker = ovl, spk
        out.append(DiarizedWord(w.word, w.start, w.end, w.confidence, best_speaker))
    return out


class DiarizedTranscriber:
    """ASR and Sortformer fused (diarize.hpp:20-74)."""

    def __init__(
        self,
        asr_weights: str | None = None,
        sortformer_weights: str | None = None,
        vocab_path: str | None = None,
        config: TDTCTCConfig | None = None,
        sf_config: SortformerConfig | None = None,
        *,
        asr_params: dict | None = None,
        sortformer_params: dict | None = None,
        compute_dtype: str = "float32",
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        """device: the card unless given; "cpu" runs both models on the CPU."""
        self.device = resolve_device(device)
        self.transcriber = Transcriber(asr_weights, vocab_path, config or make_110m_config(),
                                       params=asr_params, compute_dtype=compute_dtype, device=self.device)
        self.sf_config = sf_config or make_sortformer_117m_config()
        self.sortformer = Sortformer(sortformer_weights, self.sf_config, params=sortformer_params,
                                     device=self.device)

    def to_gpu(self) -> None:
        """API-compatibility no-op (the reference C++ API moves weights to
        its GPU here); both models already hold their weights on `device`."""

    def _to_samples(self, source) -> np.ndarray:
        if isinstance(source, (str, bytes, bytearray)) or hasattr(source, "__fspath__"):
            return read_audio(source, 16000).samples
        arr = np.asarray(source)
        if arr.dtype == np.int16 or arr.ndim > 1:
            # int16 scaling and channel downmix, as Transcriber._to_samples
            return read_audio(arr, sample_rate=16000).samples
        return arr.astype(np.float32).reshape(-1)

    def _segments(self, samples: np.ndarray) -> list[DiarizationSegment]:
        """Sortformer on its own features: 128 mel, no normalisation."""
        sf_audio_cfg = AudioConfig(n_mels=self.sf_config.nest_encoder.mel_bins, normalize=False)
        return self.sortformer.diarize(preprocess_audio(samples, sf_audio_cfg, self.device))

    def transcribe(self, source, decoder: Decoder = Decoder.TDT) -> DiarizedResult:
        samples = self._to_samples(source)
        asr = self.transcriber.transcribe(samples, decoder, timestamps=True)
        segments = self._segments(samples)
        return DiarizedResult(text=asr.text, words=diarize_transcription(asr.word_timestamps, segments),
                              segments=segments, word_timestamps=asr.word_timestamps)

    def align(self, source, text: str, *, window_s: float | None = None, overlap_s: float = 10.0) -> DiarizedResult:
        """Speaker-attributed forced alignment: word timings of a known
        transcript (Transcriber.align, or align_long when window_s is
        given) fused with the Sortformer segments."""
        samples = self._to_samples(source)
        if window_s is not None:
            asr = self.transcriber.align_long(samples, text, window_s=window_s, overlap_s=overlap_s)
        else:
            asr = self.transcriber.align(samples, text)
        segments = self._segments(samples)
        return DiarizedResult(text=asr.text, words=diarize_transcription(asr.word_timestamps, segments),
                              segments=segments, word_timestamps=asr.word_timestamps)


__all__ = ["DiarizedWord", "DiarizedResult", "diarize_transcription", "DiarizedTranscriber"]
