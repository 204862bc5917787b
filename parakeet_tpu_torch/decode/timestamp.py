"""Token → word/sentence timestamp grouping.

Behavioral parity with the reference (src/timestamp.cpp:24-111,
include/parakeet/timestamp.hpp:26-35):
  * each encoder frame = subsampling(8) × hop(160) / 16000 = 0.08 s
  * words split at SentencePiece ``▁`` (U+2581) prefix
  * word confidence = min over its tokens' confidences
  * Sentences mode merges words ending in ``. ? !``

Pure host-side Python; runs on the (tiny) token list after device decode.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from parakeet_tpu_torch.text.tokenizer import SP_MARKER

# Encoder frames → seconds: 8 * 160 / 16000 (timestamp.hpp:26-35).
FRAME_DURATION_S = 0.08


def frame_to_seconds(frame: int) -> float:
    return float(frame) * FRAME_DURATION_S


@dataclass
class TimestampedToken:
    token_id: int
    start_frame: int  # encoder frame index
    end_frame: int  # inclusive
    confidence: float = 1.0  # exp(log_prob) in [0, 1]


@dataclass
class WordTimestamp:
    word: str
    start: float  # seconds
    end: float  # seconds
    confidence: float = 1.0  # min of token confidences


class TimestampMode(enum.Enum):
    WORDS = "words"
    SENTENCES = "sentences"


def _is_sentence_end(word: str) -> bool:
    return bool(word) and word[-1] in ".?!"


def group_token_words(
    tokens: list[TimestampedToken], pieces: list[str] | None
) -> list[list[TimestampedToken]]:
    """Timestamped tokens grouped into words by group_timestamps' boundary
    rule (a word starts at a ▁-prefixed piece), keeping every token:
    out-of-range ids continue the current word. The long-audio merge owns
    whole words by this grouping. pieces=None: every token is its own word."""
    words: list[list[TimestampedToken]] = []
    for t in tokens:
        starts_word = (
            pieces is None
            or not words
            or (0 <= t.token_id < len(pieces) and pieces[t.token_id].startswith(SP_MARKER))
        )
        if starts_word:
            words.append([t])
        else:
            words[-1].append(t)
    return words


def group_timestamps(
    tokens: list[TimestampedToken],
    pieces: list[str],
    mode: TimestampMode = TimestampMode.WORDS,
) -> list[WordTimestamp]:
    if not tokens:
        return []

    words: list[WordTimestamp] = []
    current_word = ""
    word_start_frame = tokens[0].start_frame
    word_end_frame = tokens[0].end_frame
    word_min_conf = 1.0

    for tok in tokens:
        if tok.token_id < 0 or tok.token_id >= len(pieces):
            continue
        piece = pieces[tok.token_id]
        starts_word = piece.startswith(SP_MARKER)

        if starts_word and current_word:
            words.append(
                WordTimestamp(
                    current_word,
                    frame_to_seconds(word_start_frame),
                    frame_to_seconds(word_end_frame),
                    word_min_conf,
                )
            )
            current_word = ""
            word_start_frame = tok.start_frame
            word_min_conf = 1.0

        current_word += piece[len(SP_MARKER) :] if starts_word else piece
        word_end_frame = tok.end_frame
        word_min_conf = min(word_min_conf, tok.confidence)

    if current_word:
        words.append(
            WordTimestamp(
                current_word,
                frame_to_seconds(word_start_frame),
                frame_to_seconds(word_end_frame),
                word_min_conf,
            )
        )

    if mode is TimestampMode.SENTENCES:
        sentences: list[WordTimestamp] = []
        cur = ""
        start = end = 0.0
        min_conf = 1.0
        for w in words:
            if not cur:
                start = w.start
            else:
                cur += " "
            cur += w.word
            end = w.end
            min_conf = min(min_conf, w.confidence)
            if _is_sentence_end(w.word):
                sentences.append(WordTimestamp(cur, start, end, min_conf))
                cur = ""
                min_conf = 1.0
        if cur:
            sentences.append(WordTimestamp(cur, start, end, min_conf))
        return sentences

    return words


__all__ = [
    "FRAME_DURATION_S",
    "frame_to_seconds",
    "TimestampedToken",
    "WordTimestamp",
    "TimestampMode",
    "group_token_words",
    "group_timestamps",
]
