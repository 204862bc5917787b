from parakeet_tpu_torch.decode.beam_transducer import (
    BeamHypothesis,
    transducer_beam_decode,
)
from parakeet_tpu_torch.decode.timestamp import (
    FRAME_DURATION_S,
    TimestampedToken,
    TimestampMode,
    WordTimestamp,
    frame_to_seconds,
    group_timestamps,
)

__all__ = [
    "BeamHypothesis",
    "transducer_beam_decode",
    "FRAME_DURATION_S",
    "TimestampedToken",
    "WordTimestamp",
    "TimestampMode",
    "frame_to_seconds",
    "group_timestamps",
]
