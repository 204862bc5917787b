"""CTC prefix beam search with shallow LM fusion (a host copy of
parakeet_tpu/decode/ctc_beam.py).

Standard prefix beam search (Hannun et al. 2014): beams are label prefixes
scored by the pair (p_blank, p_nonblank), the posterior mass of all
alignments that map to the prefix and end in blank or in its last token.
Exact when beam_size ≥ the number of distinct prefixes; pruned otherwise.

The encoder and the CTC head give (T, V) log-probs on the device; this
search, branchy and small, runs on the host over the fetched matrix. Each
step extends every beam by at most `token_top_k` candidate tokens.

Timestamps: each appended token records the frame that first extended the
prefix with it, the greedy path's "first frame of the run".
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

_NEG = -math.inf


def _lse(a: float, b: float) -> float:
    if a == _NEG:
        return b
    if b == _NEG:
        return a
    m = a if a > b else b
    return m + math.log(math.exp(a - m) + math.exp(b - m))


@dataclass
class BeamHypothesis:
    tokens: list[int]
    score: float  # total log posterior of the prefix
    frames: list[int]  # first-emission frame per token


def ctc_beam_search(
    log_probs: np.ndarray,
    blank_id: int,
    *,
    beam_size: int = 16,
    token_top_k: int = 16,
    prune_logp: float = -12.0,
    n_best: int = 1,
    lm=None,
    lm_weight: float = 0.0,
    length_bonus: float = 0.0,
) -> list[BeamHypothesis]:
    """Prefix beam search over (T, V) CTC log-probs.

    Args:
      log_probs: (T, V) per-frame log-softmax outputs (numpy array or CPU tensor).
      blank_id: CTC blank index.
      beam_size: beams kept per step.
      token_top_k: non-blank extension candidates per step (by frame logp).
      prune_logp: skip extension tokens with frame logp below this.
      n_best: hypotheses to return (≤ beam_size), best first.
      lm: optional shallow-fusion LM (text.ngram_lm.BoundNgramLM or any
        object with start_state() and advance(state, token_id) ->
        (state, ln_p)); scored once per appended token.
      lm_weight: fusion weight λ — ranking score = acoustic + λ·LM
        (+ length_bonus per token). With lm=None results are identical to
        the unfused search.
      length_bonus: per-token insertion bonus (counters the LM's shrinkage
        bias; only active with lm).

    Returns: n_best BeamHypothesis, sorted by descending combined score.
    """
    lp = np.asarray(log_probs, np.float64)
    t_len, v = lp.shape
    if not 0 <= blank_id < v:
        raise ValueError(f"blank_id {blank_id} outside vocab {v}")
    fuse = lm is not None and lm_weight != 0.0

    # prefix -> [p_blank, p_nonblank, frames-tuple, lm_state, lm_total]
    lm_state0 = lm.start_state() if fuse else None
    beams: dict[tuple[int, ...], list] = {(): [0.0, _NEG, (), lm_state0, 0.0]}

    # the insertion bonus exists to counter the LM's shrinkage bias — per
    # the documented contract it is inert without fusion, so lm=None
    # results stay identical to the plain search for ANY length_bonus
    bonus = length_bonus if fuse else 0.0

    def rank(entry) -> float:
        pb, pnb, frames, _, lm_total = entry
        return _lse(pb, pnb) + lm_total + bonus * len(frames)

    for t in range(t_len):
        frame = lp[t]
        cand = np.argpartition(frame, -min(token_top_k + 1, v))[-(token_top_k + 1):]
        cand = [int(c) for c in cand if c != blank_id and frame[c] >= prune_logp]
        p_blank_t = float(frame[blank_id])

        nxt: dict[tuple[int, ...], list] = {}

        def bump(key, pb, pnb, frames, lm_state, lm_total):
            e = nxt.get(key)
            if e is None:
                nxt[key] = [pb, pnb, frames, lm_state, lm_total]
            else:
                # same prefix ⇒ same deterministic LM state/total
                e[0] = _lse(e[0], pb)
                e[1] = _lse(e[1], pnb)

        for prefix, (pb, pnb, frames, lm_state, lm_total) in beams.items():
            total = _lse(pb, pnb)
            # stay: blank after anything
            bump(prefix, total + p_blank_t, _NEG, frames, lm_state, lm_total)
            # stay: repeat of the last token extends its alignment run
            if prefix:
                bump(prefix, _NEG, pnb + float(frame[prefix[-1]]), frames, lm_state, lm_total)
            for c in cand:
                p_c = float(frame[c])
                if prefix and c == prefix[-1]:
                    # same token again only via an intervening blank
                    grow = pb + p_c
                else:
                    grow = total + p_c
                if grow == _NEG:
                    continue
                if fuse:
                    st, tok_lp = lm.advance(lm_state, c)
                    bump(prefix + (c,), _NEG, grow, frames + (t,), st,
                         lm_total + lm_weight * tok_lp)
                else:
                    bump(prefix + (c,), _NEG, grow, frames + (t,), None, 0.0)

        scored = sorted(nxt.items(), key=lambda kv: -rank(kv[1]))
        beams = dict(scored[:beam_size])

    out = [
        BeamHypothesis(list(prefix), rank(entry), list(entry[2]))
        for prefix, entry in beams.items()
    ]
    out.sort(key=lambda h: -h.score)
    return out[: max(1, n_best)]


__all__ = ["BeamHypothesis", "ctc_beam_search"]
