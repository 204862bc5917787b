"""Hotword / wake-word detection by CTC keyword spotting (port of
parakeet_tpu/decode/keyword.py).

The keyword-filler score over CTC posteriors:

    score = best Viterbi path that EMITS the keyword somewhere in the
            window  −  best unconstrained path (per-frame max)

Both paths cover all T frames; garbage states score each frame at its
maximum, so the log-odds deficit comes only from the frames forced through
the keyword's tokens: a clearly emitted keyword scores about 0, an absent
one very negative (−inf without a legal alignment). The DP runs on the
host in numpy (a few hundred frames, 2·len(keyword)+2 states).

`HotwordDetector` wraps a CTC-headed Transcriber into a feed-samples,
get-trigger loop: a rolling window scored every hop, the encoder and CTC
head on the facade's device.
"""

from __future__ import annotations

import numpy as np

_NEG = -np.inf


def keyword_log_odds(log_probs, keyword: list[int], blank_id: int) -> float:
    """Log-odds that `keyword` (token-id sequence) is emitted, in order,
    somewhere inside the (T, V) CTC log-prob window. ≤ 0; ~0 = certain.

    States: pre-garbage → tok_0 [→ blank_i →] tok_1 … tok_{U-1} → post.
    Garbage states emit the per-frame max (any token incl. blank); blank
    states between tokens are optional except between equal tokens (CTC
    needs the separating blank, ctc.cpp collapse semantics).
    """
    lp = np.asarray(log_probs, np.float64)
    t_len, v = lp.shape
    kw = list(keyword)
    u = len(kw)
    if u == 0:
        return 0.0
    if any(not 0 <= k < v or k == blank_id for k in kw):
        raise ValueError("keyword ids must be non-blank and inside the vocab")
    frame_max = lp.max(axis=1)

    # state layout: 0 = pre | 1 + 2i = tok_i | 2 + 2i = blank after tok_i | last = post
    n_states = 2 * u + 2
    pre, post = 0, n_states - 1

    def tok(i):
        return 1 + 2 * i

    def blk(i):
        return 2 + 2 * i

    score = np.full(n_states, _NEG)
    score[pre] = 0.0
    for t in range(t_len):
        nxt = np.full(n_states, _NEG)

        def bump(state, val):
            if val > nxt[state]:
                nxt[state] = val

        # pre-garbage: stay, or enter the first token
        bump(pre, score[pre] + frame_max[t])
        bump(tok(0), score[pre] + lp[t, kw[0]])
        for i in range(u):
            s_tok = score[tok(i)]
            if s_tok > _NEG:
                bump(tok(i), s_tok + lp[t, kw[i]])  # repeat frame
                bump(blk(i), s_tok + lp[t, blank_id])
                if i + 1 < u:
                    if kw[i + 1] != kw[i]:  # equal tokens need the blank
                        bump(tok(i + 1), s_tok + lp[t, kw[i + 1]])
                else:
                    bump(post, s_tok + frame_max[t])
            s_blk = score[blk(i)]
            if s_blk > _NEG:
                bump(blk(i), s_blk + lp[t, blank_id])
                if i + 1 < u:
                    bump(tok(i + 1), s_blk + lp[t, kw[i + 1]])
                else:
                    bump(post, s_blk + frame_max[t])
        bump(post, score[post] + frame_max[t])
        score = nxt

    best = max(score[tok(u - 1)], score[blk(u - 1)], score[post])
    if best == _NEG:
        return float("-inf")
    return float(best - frame_max.sum())


class HotwordDetector:
    """Rolling-window wake-word detector over a CTC-headed Transcriber.

    feed(samples) accumulates audio; every `hop_s` of new audio the last
    `window_s` are scored and the score is returned if it clears
    `threshold` (None otherwise). One device call per hop.
    """

    def __init__(
        self,
        transcriber,
        phrase: str,
        *,
        threshold: float = -8.0,
        window_s: float = 2.0,
        hop_s: float = 0.5,
    ):
        if not getattr(transcriber, "has_ctc", False):
            raise ValueError("HotwordDetector needs a CTC-headed model (Transcriber)")
        self.tr = transcriber
        self.keyword = transcriber.tokenizer.encode(phrase)
        if not self.keyword:
            raise ValueError(f"phrase {phrase!r} tokenizes to nothing")
        self.threshold = float(threshold)
        self._sr = transcriber._audio_cfg.sample_rate
        self._window = int(window_s * self._sr)
        self._hop = int(hop_s * self._sr)
        self.reset()

    def reset(self) -> None:
        self._buf = np.zeros(0, np.float32)
        self._since_eval = 0

    def score_window(self, samples: np.ndarray) -> float:
        """Keyword log-odds for one audio window (one encoder call on the
        facade's device)."""
        from parakeet_tpu_torch.audio.frontend import preprocess_audio

        feats = preprocess_audio(np.asarray(samples, np.float32), self.tr._audio_cfg, self.tr.device)
        lp = self.tr.ctc_log_probs(self.tr.encode(feats, [feats.shape[1]]))
        return keyword_log_odds(lp[0].float().cpu().numpy(), self.keyword, self.tr._blank_id)

    def feed(self, samples) -> float | None:
        """Add audio; returns the trigger score when the phrase fires.

        A trigger clears the rolling buffer (rearm): one spoken phrase
        fires ONCE, not again on every following hop while it remains
        inside the window."""
        x = np.asarray(samples, np.float32).reshape(-1)
        self._buf = np.concatenate([self._buf, x])[-self._window :]
        self._since_eval += x.size
        if self._since_eval < self._hop or self._buf.size < self._hop:
            return None
        self._since_eval = 0
        score = self.score_window(self._buf)
        if score >= self.threshold:
            self._buf = np.zeros(0, np.float32)  # rearm
            return score
        return None


__all__ = ["keyword_log_odds", "HotwordDetector"]
