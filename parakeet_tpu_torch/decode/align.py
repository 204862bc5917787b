"""CTC forced alignment: Viterbi over the blank-interleaved label lattice
(port of parakeet_tpu/decode/align.py; numpy, copied, not imported).

Aligns a KNOWN transcript to audio — the max-probability CTC path
constrained to emit exactly `tokens` — yielding per-token frame spans.
Beyond the reference (which only timestamps its own greedy decode,
ctc.cpp:79-127): the standard uses are word timings for human-provided
transcripts (subtitles from scripts) and building training alignments.

Host-side vectorized numpy, like the repo's other CTC host algorithms
(models/ctc.py collapse, decode/ctc_beam.py): the DP is T×S lane-parallel
ops (a few million on the longest offline clips — sub-ms), so a device
program plus a (T, S) backpointer fetch would only add latency. The
encoder/CTC log-probs stay the device-side heavy half.
"""

from __future__ import annotations

import numpy as np

from parakeet_tpu_torch.decode.timestamp import TimestampedToken

_NEG = np.float32(-1e30)


def ctc_forced_align(
    log_probs, tokens, blank_id: int, *, length: int | None = None
) -> list[TimestampedToken]:
    """Viterbi-align `tokens` to (T, V) CTC `log_probs`.

    Returns one TimestampedToken per input token, in order, with
    start/end = the first/last frame of its emission run and
    confidence = exp(mean frame log-prob over that run).

    length: optional valid-frame count (padded inputs).
    Raises ValueError when the alignment is infeasible (too few frames
    for the token sequence, empty tokens, blank in tokens).
    """
    lp = np.asarray(log_probs, np.float32)
    if lp.ndim != 2:
        raise ValueError(f"expected (T, V) log-probs, got shape {lp.shape}")
    if length is not None:
        lp = lp[: int(length)]
    t_total, vocab = lp.shape
    toks = [int(t) for t in tokens]
    n_labels = len(toks)
    if n_labels == 0:
        raise ValueError("tokens must be non-empty")
    if any(t < 0 or t >= vocab for t in toks):
        raise ValueError(f"token id out of range for vocab {vocab}")
    if blank_id in toks:
        raise ValueError(f"blank id {blank_id} cannot appear in tokens")
    # repeated labels need a separating blank frame
    need = n_labels + sum(1 for i in range(1, n_labels) if toks[i] == toks[i - 1])
    if t_total < need:
        raise ValueError(
            f"{t_total} frames cannot emit {n_labels} tokens "
            f"({need} frames required)")

    # blank-interleaved state sequence: [∅, t1, ∅, t2, …, tL, ∅]
    n_states = 2 * n_labels + 1
    z = np.full(n_states, blank_id, np.int32)
    z[1::2] = toks
    lpz = lp[:, z]  # (T, S) per-state frame scores

    # s-2 skip is legal only into a non-blank state that differs from the
    # label two back (standard CTC topology)
    allow_skip = np.zeros(n_states, bool)
    allow_skip[3::2] = z[3::2] != z[1:-2:2]

    alpha = np.full(n_states, _NEG, np.float32)
    alpha[0] = lpz[0, 0]
    alpha[1] = lpz[0, 1]
    # bp[t, s] ∈ {0,1,2}: alpha[t, s] came from state s-bp[t, s] at t-1
    bp = np.zeros((t_total, n_states), np.int8)
    idx = np.arange(n_states)
    for t in range(1, t_total):
        diag = np.concatenate(([_NEG], alpha[:-1]))
        skip = np.where(allow_skip, np.concatenate(([_NEG, _NEG], alpha[:-2])), _NEG)
        stacked = np.stack((alpha, diag, skip))
        choice = np.argmax(stacked, axis=0).astype(np.int8)
        alpha = stacked[choice, idx] + lpz[t]
        bp[t] = choice

    # best complete path ends on the final blank or the final label
    s = n_states - 1 if alpha[n_states - 1] >= alpha[n_states - 2] else n_states - 2
    if alpha[s] <= _NEG / 2:
        raise ValueError("no feasible alignment path")  # unreachable given the
        # frame-count guard; kept as a hard failure over silent garbage
    states = np.empty(t_total, np.int32)
    for t in range(t_total - 1, -1, -1):
        states[t] = s
        s -= bp[t, s]

    out: list[TimestampedToken] = []
    for label_pos in range(n_labels):
        frames = np.nonzero(states == 2 * label_pos + 1)[0]
        conf = float(np.exp(np.mean(lpz[frames, 2 * label_pos + 1])))
        out.append(TimestampedToken(toks[label_pos], int(frames[0]),
                                    int(frames[-1]), conf))
    return out


def stitch_frame_ownership(
    abs_start_frames: list[int], enc_lens: list[int], overlap_frames: int
) -> list[tuple[int, int]]:
    """Window→frame ownership for long-form alignment (align_long).

    Windows i cover absolute encoder frames [A_i, A_i + enc_lens[i]); the
    boundary between consecutive windows sits mid-overlap, so every
    absolute frame is owned by exactly one window (same exclusive-half
    rule as transcribe_long's word ownership, at frame granularity).
    Returns per-window RELATIVE [lo, hi) ranges; concatenating
    lp_i[lo_i:hi_i] yields one gapless, duplicate-free frame timeline.
    """
    n = len(abs_start_frames)
    if n != len(enc_lens) or n == 0:
        raise ValueError("need one start per window")
    half = (overlap_frames + 1) // 2
    bounds = [0]
    for i in range(1, n):
        bounds.append(abs_start_frames[i] + half)
    bounds.append(abs_start_frames[-1] + enc_lens[-1])
    out = []
    for i in range(n):
        lo = max(bounds[i] - abs_start_frames[i], 0)
        hi = min(bounds[i + 1] - abs_start_frames[i], enc_lens[i])
        if hi < lo:
            hi = lo  # fully-shadowed sliver window owns nothing
        out.append((lo, hi))
    return out


__all__ = ["ctc_forced_align", "stitch_frame_ownership"]
