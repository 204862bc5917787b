"""Phrase boosting: ContextTrie and the boosted greedy CTC decodes (port of
parakeet_tpu/decode/phrase_boost.py).

Reference: phrase_boost.cpp. Boost phrases tokenize into a token-id trie;
during a greedy decode the tokens reachable from the active trie states
get `boost_score` added to their log-prob before the argmax, the trie
advances only on an emission, the root stays active, and the confidence
is the unboosted log-prob.

The trie's dense form is a (n_nodes, vocab) transition table, -1 = no
child (node 0 the root): the transducer's greedy loop (decode/
transducer.py) takes its mask and advance from it on the device. The
boosted CTC decodes take the per-frame argmax, max and the candidate
token columns on the device and run the trie on the host: with a
non-negative score boosting can only move the argmax to a trie token, so
the full (T, V) matrix never leaves the device.
"""

from __future__ import annotations

import numpy as np
import torch

from parakeet_tpu_torch.decode.timestamp import TimestampedToken
from parakeet_tpu_torch.text.tokenizer import Tokenizer

DEFAULT_BOOST_SCORE = 5.0


class ContextTrie:
    """Vector-backed token-id trie (phrase_boost.cpp:9-66)."""

    def __init__(self):
        self._children: list[dict[int, int]] = [{}]
        self._is_end: list[bool] = [False]

    def insert(self, token_ids: list[int]) -> None:
        if not token_ids:
            return
        node = 0
        for tid in token_ids:
            nxt = self._children[node].get(tid)
            if nxt is None:
                nxt = len(self._children)
                self._children[node][tid] = nxt
                self._children.append({})
                self._is_end.append(False)
            node = nxt
        self._is_end[node] = True

    def build(self, phrases: list[str], tokenizer: Tokenizer) -> None:
        for phrase in phrases:
            ids = tokenizer.encode(phrase)
            if ids:
                self.insert(ids)

    @property
    def num_nodes(self) -> int:
        return len(self._children)

    def empty(self) -> bool:
        return len(self._children) == 1 and not self._children[0]

    # ── Host set semantics (the reference API) ───────────────────────────

    def get_boosted_tokens(self, active_states: set[int]) -> set[int]:
        boosted: set[int] = set()
        for state in active_states:
            if 0 <= state < len(self._children):
                boosted.update(self._children[state].keys())
        return boosted

    def advance(self, active_states: set[int], token_id: int) -> set[int]:
        nxt = {0}  # root always active
        for state in active_states:
            if 0 <= state < len(self._children):
                child = self._children[state].get(token_id)
                if child is not None:
                    nxt.add(child)
        return nxt

    # ── Dense form ───────────────────────────────────────────────────────

    def to_arrays(self, vocab_size: int) -> np.ndarray:
        """(n_nodes, vocab) int32 transition table, -1 = no child."""
        trans = np.full((len(self._children), vocab_size), -1, dtype=np.int32)
        for node, children in enumerate(self._children):
            for tid, child in children.items():
                if tid < vocab_size:
                    trans[node, tid] = child
        return trans

    def device_boost(self, vocab_size: int, batch: int, boost_score: float, device="cpu"):
        """(transitions (N, V) int64, initial active (B, N) bool, score) on
        `device`, for transducer_greedy_decode's `boost`."""
        trans = torch.from_numpy(self.to_arrays(vocab_size)).to(device=device, dtype=torch.int64)
        active0 = torch.zeros((batch, len(self._children)), dtype=torch.bool, device=device)
        active0[:, 0] = True
        return trans, active0, float(boost_score)


# ─── Boosted CTC greedy decode (phrase_boost.cpp:70-173) ─────────────────────


def _boosted_ctc_one(
    best_ids: np.ndarray,  # (T,) unboosted argmax
    best_vals: np.ndarray,  # (T,) unboosted max log-prob
    cand_vals: np.ndarray,  # (T, C) log-probs of the trie's candidate tokens
    cand_tokens: np.ndarray,  # (C,) candidate token ids
    trans: np.ndarray,  # (N, V)
    boost_score: float,
    blank_id: int,
    want_timestamps: bool,
):
    t_len = best_ids.shape[0]
    n_nodes = trans.shape[0]
    reach_c = trans[:, cand_tokens] >= 0 if len(cand_tokens) else np.zeros((n_nodes, 0), bool)
    active = np.zeros(n_nodes, bool)
    active[0] = True

    tokens: list[int] = []
    toks_ts: list[TimestampedToken] = []
    prev = -1
    for t in range(t_len):
        best = int(best_ids[t])
        raw_lp = float(best_vals[t])
        if len(cand_tokens):
            boosted_mask = reach_c[active].any(axis=0)  # (C,)
            if boosted_mask.any():
                vals = cand_vals[t] + boost_score * boosted_mask
                ci = int(np.argmax(vals))
                # first-max ties, as the reference's scan over v = 0..V-1
                cand_tok = int(cand_tokens[ci])
                if vals[ci] > best_vals[t] or (vals[ci] == best_vals[t] and cand_tok < best):
                    best = cand_tok
                    raw_lp = float(cand_vals[t, ci])
        emitted = False
        if want_timestamps:
            if best != prev:
                if prev != -1 and prev != blank_id and toks_ts:
                    toks_ts[-1].end_frame = t - 1
                if best != blank_id:
                    toks_ts.append(TimestampedToken(best, t, t, float(np.exp(raw_lp))))
                    emitted = True
        elif best != blank_id and best != prev:
            tokens.append(best)
            emitted = True
        if emitted:
            nxt = trans[active, best]
            active = np.zeros(n_nodes, bool)
            active[0] = True
            active[nxt[nxt >= 0]] = True
        prev = best
    if want_timestamps:
        if toks_ts:
            toks_ts[-1].end_frame = t_len - 1
        return toks_ts
    return tokens


def _candidate_tokens(trie: ContextTrie, vocab: int) -> np.ndarray:
    return np.asarray(sorted({tid for children in trie._children for tid in children if tid < vocab}),
                      dtype=np.int64)


def _prepare_boosted(log_probs, trie: ContextTrie, lengths, boost_score: float):
    """The device-side reduction: per-frame argmax and max and the candidate
    columns only. Valid for boost_score ≥ 0, where boosting can only move
    the argmax to a candidate token; a negative score would need the whole
    matrix and raises."""
    if boost_score < 0:
        raise ValueError(
            "boost_score must be >= 0 (negative suppression is not supported "
            "by the candidate-column reduction)"
        )
    lp = torch.as_tensor(log_probs)
    b, t, v = lp.shape
    cand_tokens = _candidate_tokens(trie, v)
    best_ids = torch.argmax(lp, dim=-1).cpu().numpy()  # first max wins
    best_vals = torch.amax(lp, dim=-1).cpu().numpy()
    if len(cand_tokens):
        cand_vals = lp[:, :, torch.from_numpy(cand_tokens).to(lp.device)].cpu().numpy()
    else:
        cand_vals = np.zeros((b, t, 0), np.float32)
    lens = [t] * b if lengths is None else [int(l) for l in np.asarray(lengths)]
    return b, best_ids, best_vals, cand_vals, cand_tokens, trie.to_arrays(v), lens


def _boosted(log_probs, trie, boost_score, blank_id, lengths, want_timestamps):
    b, bi, bv, cv, ct, trans, lens = _prepare_boosted(log_probs, trie, lengths, boost_score)
    return [_boosted_ctc_one(bi[i, : lens[i]], bv[i, : lens[i]], cv[i, : lens[i]], ct, trans, boost_score,
                             blank_id, want_timestamps) for i in range(b)]


def ctc_greedy_decode_boosted(
    log_probs, trie: ContextTrie, boost_score: float = DEFAULT_BOOST_SCORE, blank_id: int = 1024, lengths=None
) -> list[list[int]]:
    return _boosted(log_probs, trie, boost_score, blank_id, lengths, False)


def ctc_greedy_decode_with_timestamps_boosted(
    log_probs, trie: ContextTrie, boost_score: float = DEFAULT_BOOST_SCORE, blank_id: int = 1024, lengths=None
) -> list[list[TimestampedToken]]:
    return _boosted(log_probs, trie, boost_score, blank_id, lengths, True)


__all__ = [
    "ContextTrie",
    "DEFAULT_BOOST_SCORE",
    "ctc_greedy_decode_boosted",
    "ctc_greedy_decode_with_timestamps_boosted",
]
