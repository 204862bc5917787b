"""SRT / WebVTT subtitle rendering from word timestamps (a host copy of
parakeet_tpu/text/subtitles.py).

Turns a ``list[WordTimestamp]`` (``TranscribeResult.word_timestamps``) into
subtitle files, with the usual authoring conventions:

  * cues wrap to at most ``max_lines`` lines of ``max_line_chars``
  * a new cue starts on a silence gap > ``max_gap`` seconds, when the cue
    would exceed ``max_duration`` seconds, or after a sentence-ending word
  * cues are padded to ``min_duration`` but never overlap the next cue
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["SubtitleCue", "build_cues", "format_srt", "format_vtt"]


@dataclass
class SubtitleCue:
    start: float  # seconds
    end: float  # seconds
    lines: list[str]

    @property
    def text(self) -> str:
        return "\n".join(self.lines)


def _sentence_end(word: str) -> bool:
    # same terminator set as timestamp.TimestampMode.SENTENCES
    return bool(word) and word[-1] in ".?!"


def _wrap(words: list[str], max_line_chars: int) -> list[str]:
    """Greedy word wrap; a single over-long word gets its own line."""
    lines: list[str] = []
    cur = ""
    for w in words:
        if not cur:
            cur = w
        elif len(cur) + 1 + len(w) <= max_line_chars:
            cur += " " + w
        else:
            lines.append(cur)
            cur = w
    if cur:
        lines.append(cur)
    return lines


def build_cues(
    words,
    *,
    max_line_chars: int = 42,
    max_lines: int = 2,
    max_duration: float = 6.0,
    max_gap: float = 1.0,
    min_duration: float = 0.5,
) -> list[SubtitleCue]:
    """Group word timestamps into subtitle cues.

    ``words``: any sequence of objects with ``.word``/``.start``/``.end``
    attributes (``WordTimestamp``). Words with empty text are skipped.
    """
    words = [w for w in words if getattr(w, "word", "")]
    cues: list[SubtitleCue] = []
    group: list = []

    def flush() -> None:
        if not group:
            return
        cues.append(
            SubtitleCue(
                start=group[0].start,
                end=group[-1].end,
                lines=_wrap([w.word for w in group], max_line_chars),
            )
        )
        group.clear()

    for w in words:
        if group:
            # wrap-test the prospective group: a plain char budget can admit
            # word sets no layout fits in max_lines lines (e.g. three
            # 22-char words under 2×42 wrap to 3 lines)
            prospective = _wrap([g.word for g in group] + [w.word], max_line_chars)
            over_text = len(prospective) > max_lines
            over_time = w.end - group[0].start > max_duration
            gap = w.start - group[-1].end > max_gap
            if over_text or over_time or gap or _sentence_end(group[-1].word):
                flush()
        group.append(w)
    flush()

    # pad short cues, clamped so a cue never overlaps its successor
    for i, c in enumerate(cues):
        if c.end - c.start < min_duration:
            limit = cues[i + 1].start if i + 1 < len(cues) else float("inf")
            c.end = max(c.end, min(c.start + min_duration, limit))
    return cues


def _timecode(seconds: float, ms_sep: str) -> str:
    total_ms = max(0, int(round(seconds * 1000.0)))
    ms = total_ms % 1000
    s = (total_ms // 1000) % 60
    m = (total_ms // 60_000) % 60
    h = total_ms // 3_600_000
    return f"{h:02d}:{m:02d}:{s:02d}{ms_sep}{ms:03d}"


def format_srt(words, **cue_kwargs) -> str:
    """Render word timestamps as an SRT document (``HH:MM:SS,mmm``)."""
    out: list[str] = []
    for i, c in enumerate(build_cues(words, **cue_kwargs), start=1):
        out.append(str(i))
        out.append(f"{_timecode(c.start, ',')} --> {_timecode(c.end, ',')}")
        out.append(c.text)
        out.append("")
    return "\n".join(out) + ("\n" if out else "")


def format_vtt(words, **cue_kwargs) -> str:
    """Render word timestamps as a WebVTT document (``HH:MM:SS.mmm``)."""
    out: list[str] = ["WEBVTT", ""]
    for c in build_cues(words, **cue_kwargs):
        out.append(f"{_timecode(c.start, '.')} --> {_timecode(c.end, '.')}")
        out.append(c.text)
        out.append("")
    return "\n".join(out) + "\n"
