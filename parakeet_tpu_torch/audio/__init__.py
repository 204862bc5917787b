from parakeet_tpu_torch.audio.frontend import (
    StreamingAudioPreprocessor,
    mel_filterbank,
    preprocess_audio,
)

__all__ = ["preprocess_audio", "StreamingAudioPreprocessor", "mel_filterbank"]
