"""ASR evaluation metrics: WER, CER and corpus aggregation (a host copy of
parakeet_tpu/metrics.py)."""

from __future__ import annotations

from dataclasses import dataclass


def _edit_distance(ref: list[str], hyp: list[str]) -> tuple[int, int, int, int]:
    """Levenshtein alignment → (substitutions, deletions, insertions, hits)."""
    m, n = len(ref), len(hyp)
    # dp[i][j] = (cost, subs, dels, ins)
    prev = [(j, 0, 0, j) for j in range(n + 1)]
    for i in range(1, m + 1):
        cur = [(i, 0, i, 0)] + [None] * n
        for j in range(1, n + 1):
            if ref[i - 1] == hyp[j - 1]:
                cost, s, d, ins = prev[j - 1]
                cur[j] = (cost, s, d, ins)
            else:
                sub = prev[j - 1]
                dele = prev[j]
                insr = cur[j - 1]
                best = min(sub[0], dele[0], insr[0])
                if best == sub[0]:
                    cur[j] = (sub[0] + 1, sub[1] + 1, sub[2], sub[3])
                elif best == dele[0]:
                    cur[j] = (dele[0] + 1, dele[1], dele[2] + 1, dele[3])
                else:
                    cur[j] = (insr[0] + 1, insr[1], insr[2], insr[3] + 1)
        prev = cur
    cost, s, d, ins = prev[n]
    return s, d, ins, len(ref) - s - d


@dataclass
class WerResult:
    wer: float
    substitutions: int
    deletions: int
    insertions: int
    ref_words: int

    def __str__(self):
        return (
            f"WER {self.wer * 100:.2f}% "
            f"(S={self.substitutions} D={self.deletions} I={self.insertions} "
            f"/ {self.ref_words} ref words)"
        )


def _normalize(text: str) -> list[str]:
    return text.strip().lower().split()


def word_error_rate(reference: str, hypothesis: str) -> WerResult:
    """WER = (S+D+I) / max(1, ref_words) — the same convention corpus_wer
    aggregates with, so a single pair scores identically through either
    entry point (an empty reference counts every hypothesis word as an
    insertion over a denominator of 1, i.e. WER can exceed 1.0)."""
    ref, hyp = _normalize(reference), _normalize(hypothesis)
    if not ref:
        return WerResult(float(len(hyp)), 0, 0, len(hyp), 0)
    s, d, i, _ = _edit_distance(ref, hyp)
    return WerResult((s + d + i) / len(ref), s, d, i, len(ref))


def character_error_rate(reference: str, hypothesis: str) -> float:
    ref = list(" ".join(_normalize(reference)))
    hyp = list(" ".join(_normalize(hypothesis)))
    if not ref:
        return 0.0 if not hyp else 1.0
    s, d, i, _ = _edit_distance(ref, hyp)
    return (s + d + i) / len(ref)


def corpus_wer(pairs: list[tuple[str, str]]) -> WerResult:
    """Aggregate WER over (reference, hypothesis) pairs (word-weighted)."""
    tot_s = tot_d = tot_i = tot_ref = 0
    for ref_text, hyp_text in pairs:
        r = word_error_rate(ref_text, hyp_text)
        tot_s += r.substitutions
        tot_d += r.deletions
        tot_i += r.insertions
        tot_ref += r.ref_words
    wer = (tot_s + tot_d + tot_i) / max(1, tot_ref)
    return WerResult(wer, tot_s, tot_d, tot_i, tot_ref)


__all__ = ["WerResult", "word_error_rate", "character_error_rate", "corpus_wer"]
