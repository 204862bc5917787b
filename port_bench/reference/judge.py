"""How far a served transcript lies from the reference's best choices.

A served decode is a path of choices: CTC picks a label a frame; TDT picks
a label and a duration at each step. At each choice the gap is the
reference's best log-prob minus the log-prob of what was served (0 where
the two agree). A path's gap is its widest gap; where the served output
leaves choices open (CTC's alignment, TDT's blank steps and the duration
of an emission whose end frame does not fix it), the gap is the least
over every path the reference could take that serves exactly that output.
An output that no path serves reads `UNREACHABLE`.

Rounding moves a choice only where the reference's top two log-probs are
close, so a sound program's gap stays near its rounding error; a lower
precision, a wrong token or a dropped clip reads far above it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .torch_ref import F32, Arith, joint, prediction_lstm

UNREACHABLE = 1e9


def ctc_gap(log_probs: np.ndarray, tokens: list[int], blank: int) -> float:
    """Least widest gap over the CTC alignments of `tokens` (blank between
    repeats) to the (T, V) reference log-probs of a clip's valid frames."""
    t_len = log_probs.shape[0]
    if len(tokens) > t_len:
        return UNREACHABLE
    gap = log_probs.max(axis=1, keepdims=True) - log_probs
    lab = np.full(2 * len(tokens) + 1, blank)
    lab[1::2] = tokens
    g = gap[:, lab]  # (T, S)
    skip = np.zeros(len(lab), bool)
    skip[3::2] = lab[3::2] != lab[1:-2:2]  # token → token when the two differ
    inf = np.inf
    best = np.full(len(lab), inf)
    best[0] = g[0, 0]
    if len(lab) > 1:
        best[1] = g[0, 1]
    for t in range(1, t_len):
        stay = best
        step = np.concatenate([[inf], best[:-1]])
        jump = np.where(skip, np.concatenate([[inf, inf], best[:-2]]), inf)
        best = np.maximum(np.minimum(np.minimum(stay, step), jump), g[t])
    end = min(best[-1], best[-2]) if len(lab) > 1 else best[-1]
    return float(end) if math.isfinite(end) else UNREACHABLE


def _prediction_outputs(params, tokens: list[int], blank: int, ar: Arith) -> torch.Tensor:
    """(U+1, H) prediction outputs after feeding blank (SOS), then each token."""
    lstm, _, _ = prediction_lstm(params, ar)
    emb = params["prediction_.embed_.weight"]
    ids = torch.tensor([blank] + list(tokens), device=emb.device)
    out, _ = lstm(emb[ids][None])
    return out[0]


def tdt_gap(params, enc: torch.Tensor, emissions, *, blank: int, durations, joint_prefix: str,
            max_symbols: int = 10, ar: Arith = F32) -> float:
    """Least widest gap of a served TDT decode of one clip: `enc` the
    reference's (T, d) frames, `emissions` [(token, start, end)] in the
    order served. Every step is scored (a blank's label and duration, an
    emission's token and duration), the emissions land on their served
    frames with durations that give their served end frames, and the walk
    follows the greedy loop's rules (blank advances max(d, 1); d = 0 stays
    on the frame until the max_symbols cap forces t + 1); it ends once t
    reaches T."""
    t_len, n = enc.shape[0], len(emissions)
    toks = [int(e[0]) for e in emissions]
    start = [int(e[1]) for e in emissions]
    end = [int(e[2]) for e in emissions]
    if any(not 0 <= s < t_len for s in start) or any(b < a for a, b in zip(start, start[1:])):
        return UNREACHABLE
    dur = [int(d) for d in durations]
    with torch.no_grad():
        g = _prediction_outputs(params, toks, blank, ar)
        lo = [0] + start  # stratum u (u tokens fed) spans frames lo[u] .. hi[u]
        hi = start + [t_len - 1]
        base = np.cumsum([0] + [h - l + 1 for l, h in zip(lo, hi)])
        t_ix = torch.cat([torch.arange(l, h + 1) for l, h in zip(lo, hi)]).to(enc.device)
        u_ix = torch.cat([torch.full((h - l + 1,), u) for u, (l, h) in enumerate(zip(lo, hi))]).to(enc.device)
        label_lp, dur_lp = joint(params, enc[t_ix], g[u_ix], joint_prefix, ar)
        label = label_lp.double().cpu().numpy()
        dgap = (dur_lp.max(dim=-1, keepdim=True).values - dur_lp).double().cpu().numpy()
    lmax = label.max(axis=1)
    bgap = lmax - label[:, blank]

    inf = math.inf
    entries = {(0, 0): 0.0}  # (frame, zero-duration emissions on it) → least widest gap so far
    for u in range(n + 1):
        final = u == n
        l0, h0 = lo[u], hi[u]
        walk = np.full(h0 - l0 + 1, inf)  # reached by frame, any count
        direct: dict[int, float] = {}  # at h0 with no blank step, by count
        for (a, sym), c in entries.items():
            if a > h0:  # past the last frame: the clip is done (final stratum only)
                continue
            walk[a - l0] = min(walk[a - l0], c)
            if a == h0:
                direct[sym] = min(direct.get(sym, inf), c)
        walked, done = inf, inf
        for t in range(l0, h0 + (1 if final else 0)):
            c = walk[t - l0]
            if not math.isfinite(c):
                continue
            p = base[u] + t - l0
            for j, d in enumerate(dur):
                val = max(c, bgap[p], dgap[p, j])
                nt = t + max(d, 1)
                if final and nt >= t_len:
                    done = min(done, val)
                elif nt <= h0:
                    walk[nt - l0] = min(walk[nt - l0], val)
                    if nt == h0:
                        walked = min(walked, val)
        if final:
            ends = [done] + [c for (a, _), c in entries.items() if a >= t_len]
            best = min(ends)
            return float(best) if math.isfinite(best) else UNREACHABLE
        # emission u+1 of the served path at frame h0, state u
        p = base[u] + h0 - l0
        tgap = lmax[p] - label[p, toks[u]]
        arrivals = dict(direct)
        arrivals[0] = min(arrivals.get(0, inf), walked)
        nxt_entries: dict[tuple[int, int], float] = {}
        for sym, c in arrivals.items():
            if not math.isfinite(c):
                continue
            for j, d in enumerate(dur):
                if min(h0 + max(d, 1) - 1, t_len - 1) != end[u]:
                    continue
                val = max(c, tgap, dgap[p, j])
                if d > 0:
                    key = (h0 + d, 0)
                elif sym + 1 >= max_symbols:
                    key = (h0 + 1, 0)
                else:
                    key = (h0, sym + 1)
                last = u + 1 == n
                if (not last and key[0] > start[u + 1]) or (not last and key[0] >= t_len):
                    continue
                nxt_entries[key] = min(nxt_entries.get(key, inf), val)
        entries = nxt_entries
        if not entries:
            return UNREACHABLE
    return UNREACHABLE
