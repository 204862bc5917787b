"""ARPA n-gram language model for shallow fusion and n-best rescoring (a
host copy of parakeet_tpu/text/ngram_lm.py).

Token-level fusion inside the host CTC prefix beam (decode/ctc_beam.py) and
n-best rescoring of the transducer beam (decode/beam_transducer.py), with
Katz-backoff scoring over a dependency-free ARPA parser:

    score(w | ctx) = logp(ctx + w)                       if the n-gram exists
                   = backoff(ctx) + score(w | ctx[1:])   otherwise

All scores are natural logs (ARPA's log10 values are converted at load).
The LM is built over string tokens (tokenizer pieces or words); `bind()`
resolves token ids against a tokenizer's piece list, so the decoders score
integer ids.
"""

from __future__ import annotations

import math
from pathlib import Path

_LN10 = math.log(10.0)
_FLOOR = -99.0 * _LN10  # ARPA convention: -99 log10 ≈ "impossible"

BOS = "<s>"
EOS = "</s>"
UNK = "<unk>"


class NgramLM:
    """Backoff n-gram LM over string tokens, loaded from ARPA text."""

    def __init__(self, probs: dict, backoffs: dict, order: int):
        self.probs = probs  # tuple[str, ...] -> ln p
        self.backoffs = backoffs  # tuple[str, ...] -> ln backoff weight
        self.order = order
        self._has_unk = (UNK,) in probs

    # ── Construction ─────────────────────────────────────────────────────

    @classmethod
    def from_arpa(cls, source: str | Path) -> "NgramLM":
        """Parse ARPA text. `source` is a path or the ARPA string itself
        (anything containing a newline is treated as content)."""
        text = str(source)
        if "\n" not in text:
            text = Path(source).read_text(encoding="utf-8")
        probs: dict = {}
        backoffs: dict = {}
        order = 0
        cur_n = None
        in_data = False
        for raw in text.splitlines():
            line = raw.strip()
            if not line:
                continue
            if line == "\\data\\":
                in_data = True
                continue
            if line == "\\end\\":
                break
            if line.startswith("\\") and line.endswith("-grams:"):
                cur_n = int(line[1:].split("-")[0])
                order = max(order, cur_n)
                in_data = False
                continue
            if in_data:
                continue  # "ngram N=count" headers
            if cur_n is None:
                continue
            parts = line.split()
            # logp tok1 ... tokN [backoff]
            if len(parts) == cur_n + 2:
                lp, toks, bow = parts[0], parts[1 : 1 + cur_n], parts[-1]
            elif len(parts) == cur_n + 1:
                lp, toks, bow = parts[0], parts[1:], None
            else:
                raise ValueError(f"malformed ARPA {cur_n}-gram line: {raw!r}")
            key = tuple(toks)
            probs[key] = float(lp) * _LN10
            if bow is not None:
                backoffs[key] = float(bow) * _LN10
        if order == 0:
            raise ValueError("no n-gram sections found (not an ARPA file?)")
        return cls(probs, backoffs, order)

    # ── Scoring ──────────────────────────────────────────────────────────

    def _norm(self, tok: str) -> str:
        if (tok,) in self.probs:
            return tok
        return UNK if self._has_unk else tok

    def score(self, context: tuple[str, ...], token: str) -> float:
        """ln p(token | context), Katz backoff."""
        token = self._norm(token)
        ctx = tuple(self._norm(t) for t in context[-(self.order - 1) :]) if self.order > 1 else ()
        return self._score(ctx, token)

    def _score(self, ctx: tuple[str, ...], token: str) -> float:
        ng = ctx + (token,)
        if ng in self.probs:
            return self.probs[ng]
        if not ctx:
            return _FLOOR  # unigram missing and no <unk>
        # back off: charge the context's backoff weight and shorten
        return self.backoffs.get(ctx, 0.0) + self._score(ctx[1:], token)

    def start_state(self) -> tuple[str, ...]:
        return (BOS,) if (BOS,) in self.probs else ()

    def advance(self, state: tuple[str, ...], token: str) -> tuple[tuple[str, ...], float]:
        """(new_state, ln p(token | state)) — the beam-fusion step API."""
        lp = self.score(state, token)
        new_state = (state + (token,))[-(self.order - 1) :] if self.order > 1 else ()
        return new_state, lp

    def score_sequence(self, tokens: list[str], *, bos: bool = True, eos: bool = False) -> float:
        """Total ln-probability of a token sequence (for rescoring)."""
        state = self.start_state() if bos else ()
        total = 0.0
        for t in tokens:
            state, lp = self.advance(state, t)
            total += lp
        if eos:
            total += self.score(state, EOS)
        return total

    def bind(self, pieces: list[str]) -> "BoundNgramLM":
        """Bind to a tokenizer's piece list for id-based scoring."""
        return BoundNgramLM(self, pieces)


class BoundNgramLM:
    """NgramLM with token ids resolved against a piece list — the object
    the beam decoders consume (advance/score_sequence over ints)."""

    def __init__(self, lm: NgramLM, pieces: list[str]):
        self.lm = lm
        self.pieces = list(pieces)

    def _tok(self, token_id: int) -> str:
        if 0 <= token_id < len(self.pieces):
            return self.pieces[token_id]
        return UNK

    def start_state(self):
        return self.lm.start_state()

    def advance(self, state, token_id: int):
        return self.lm.advance(state, self._tok(token_id))

    def score_sequence(self, token_ids, **kw) -> float:
        return self.lm.score_sequence([self._tok(t) for t in token_ids], **kw)


def rescore_nbest(hypotheses, lm, lm_weight: float, *, eos: bool = False):
    """Re-rank an n-best list by combined score — the reference roadmap's
    "LM rescoring" seam (works with BoundNgramLM or any object exposing
    score_sequence(token_ids) -> float, e.g. a neural LM wrapper).

    Each hypothesis needs `.tokens` and `.score`; returns a NEW list sorted
    by (score + lm_weight * lm_score), best first, leaving inputs intact.
    """
    rescored = sorted(
        hypotheses,
        key=lambda h: -(h.score + lm_weight * lm.score_sequence(list(h.tokens), eos=eos)),
    )
    return list(rescored)


__all__ = ["NgramLM", "BoundNgramLM", "rescore_nbest", "BOS", "EOS", "UNK"]
