"""RNNT and TDT lattice losses (port of parakeet_tpu/ops/transducer_loss.py).

The forward variable of both lattices,

    RNNT: alpha[t, u] = alpha[t-1, u] + blank[t-1, u]  ⊕  alpha[t, u-1] + emit[t, u-1]
    TDT:  alpha[t, u] = ⊕_{d ≥ 1} alpha[t-d, u] + blank[t-d, u] + dur_d[t-d, u]
                      ⊕ ⊕_{d}   alpha[t-d, u-1] + emit[t-d, u-1] + dur_d[t-d, u-1]

(⊕ = logaddexp), only reads nodes of earlier anti-diagonals n = t + u: a
label with d = 0 comes from the diagonal just before, a blank or label
with d ≥ 1 from diagonal n-d or n-d-1. So the port runs one loop over the
T+U diagonals, each step a handful of (B, U+1) ops over every lattice
node of the diagonal at once, where the reference runs a scan over frames
with an associative scan inside each row. Both are the same sums up to the
order of the logaddexps; gradients come from autograd.

As in the reference: f32 lattice math; the finite -1e30 stands in for
-inf (logaddexp of two of them has the gradient 0.5 / 0.5, where true -inf
gives NaN); TDT's `sigma` is subtracted from every token and blank
log-prob; a TDT path ends with a blank that lands exactly on the frame
length.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_F32 = torch.float32
_NEG = -1e30


def _gather_label_lp(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """log_probs (B, T, U+1, V), labels (B, U) → emit (B, T, U) with
    emit[b, t, u] = log_probs[b, t, u, labels[b, u]]."""
    v = log_probs.shape[-1]
    u = labels.shape[1]
    safe = labels.to(log_probs.device).long().clamp(0, v - 1)
    idx = safe[:, None, :, None].expand(-1, log_probs.shape[1], -1, 1)
    return log_probs[:, :, :u, :].gather(3, idx)[..., 0]


def _with_end_column(emit: torch.Tensor) -> torch.Tensor:
    """(B, T, U, K) label terms → (B, T, U+1, K): no label leaves column U."""
    return F.pad(emit, (0, 0, 0, 1), value=_NEG)


def _diagonals(t: int, u1: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Frame index t = n - u of every (diagonal n, column u), clamped, and
    whether it is a lattice node (0 ≤ n - u < T): ((N, U+1), (N, U+1))."""
    n = torch.arange(t + u1 - 1, device=device)[:, None]
    frame = n - torch.arange(u1, device=device)[None, :]
    return frame.clamp(0, t - 1), (frame >= 0) & (frame < t)


def _skew(q: torch.Tensor, frame: torch.Tensor, node: torch.Tensor, shifts: tuple[int, ...]) -> torch.Tensor:
    """(B, T, U+1, K) per-node terms → (B, N, U+1, K) laid out by diagonal,
    term k taken from diagonal n - shifts[k] (−1e30 where that is no node)."""
    cols = torch.arange(q.shape[2], device=q.device).expand_as(frame)
    sk = torch.where(node[None, :, :, None], q[:, frame, cols], _NEG)
    return torch.stack([F.pad(sk[:, :, :, k], (0, 0, s, 0), value=_NEG)[:, : sk.shape[1]]
                        for k, s in enumerate(shifts)], dim=-1)


def _lattice_alphas(blank_terms: torch.Tensor, label_terms: torch.Tensor,
                    blank_durs: tuple[int, ...], label_durs: tuple[int, ...]) -> torch.Tensor:
    """Forward variables of a transducer lattice, by anti-diagonal.

    blank_terms (B, T, U+1, Kb): log-weight of the blank move out of (t, u)
    that advances blank_durs[k] ≥ 1 frames; label_terms (B, T, U+1, Kl):
    the label move (t, u) → (t + label_durs[k], u + 1), −1e30 in column U.
    Returns (B, N, U+1), N = T + U: entry [b, n, u] is alpha[b, n − u, u]
    (−1e30 off the lattice)."""
    b, t, u1, _ = blank_terms.shape
    frame, node = _diagonals(t, u1, blank_terms.device)
    # the move into diagonal n from diagonal n - d (blank) or n - d - 1 (label)
    bsk = _skew(blank_terms, frame, node, blank_durs)
    lsk = _skew(label_terms, frame, node, tuple(d + 1 for d in label_durs))
    neg = torch.full((b, u1), _NEG, dtype=_F32, device=blank_terms.device)
    diags = [torch.cat([torch.zeros((b, 1), dtype=_F32, device=neg.device), neg[:, 1:]], dim=1)]
    for n in range(1, t + u1 - 1):
        via_blank = torch.stack([diags[n - d] if n >= d else neg for d in blank_durs], -1) + bsk[:, n]
        via_label = torch.stack([diags[n - d - 1] if n > d else neg for d in label_durs], -1) + lsk[:, n]
        via_label = F.pad(via_label[:, :-1], (0, 0, 1, 0), value=_NEG)  # column u-1 → u
        # the −1e30 term keeps a node no path reaches at −1e30, as the
        # reference's pending buffer does, instead of summing sentinels
        alpha = torch.logsumexp(torch.cat([via_blank, via_label, neg[..., None]], dim=-1), dim=-1)
        diags.append(torch.where(node[n], alpha, _NEG))
    return torch.stack(diags, dim=1)


def _alpha_at(alphas: torch.Tensor, t: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """alpha[b, t[b], u[b]] from the by-diagonal layout."""
    return alphas[torch.arange(alphas.shape[0], device=alphas.device), t + u, u]


def rnnt_loss(
    log_probs: torch.Tensor,
    labels: torch.Tensor,
    frame_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    blank_id: int,
) -> torch.Tensor:
    """Negative log-likelihood of the RNNT lattice (Graves 2012), per batch
    element.

    log_probs (B, T, U+1, V) joint log-softmax outputs (rnnt_joint over all
    (frame, label-prefix) pairs); labels (B, U) target tokens (no blanks;
    padding past label_lengths is ignored); frame_lengths (B,) valid encoder
    frames (1 ≤ · ≤ T); label_lengths (B,) valid labels (0 ≤ · ≤ U).
    Returns (B,) f32 −log p(labels | frames)."""
    log_probs = log_probs.to(_F32)
    b, t, u1, _ = log_probs.shape
    blank_lp = log_probs[..., blank_id]  # (B, T, U+1)
    emit_lp = _with_end_column(_gather_label_lp(log_probs, labels)[..., None])
    alphas = _lattice_alphas(blank_lp[..., None], emit_lp, (1,), (0,))
    dev = log_probs.device
    t_last = (torch.as_tensor(frame_lengths, device=dev).long() - 1).clamp(0, t - 1)
    u_last = torch.as_tensor(label_lengths, device=dev).long().clamp(0, u1 - 1)
    ll = _alpha_at(alphas, t_last, u_last) + blank_lp[torch.arange(b, device=dev), t_last, u_last]
    return -ll


def tdt_loss(
    label_log_probs: torch.Tensor,
    duration_log_probs: torch.Tensor,
    labels: torch.Tensor,
    frame_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    blank_id: int,
    durations: tuple[int, ...],
    sigma: float = 0.0,
) -> torch.Tensor:
    """Negative log-likelihood of the TDT lattice (Xu et al., ICML 2023),
    per batch element.

    Out of node (t, u): token y_{u+1} with duration d → (t+d, u+1), any d
    in `durations` (0 allowed); blank with d ≥ 1 → (t+d, u). A path ends
    with a blank landing exactly on t = frame_length. `sigma` is
    subtracted from every token and blank log-prob inside the lattice.

    label_log_probs (B, T, U+1, V) and duration_log_probs (B, T, U+1, D)
    from tdt_joint, D = len(durations); durations sorted, unique,
    non-negative, with at least one d ≥ 1. Returns (B,) f32."""
    if (not durations or list(durations) != sorted(set(durations))
            or durations[0] < 0):
        raise ValueError(f"durations must be sorted unique non-negative, got {durations}")
    pos = [(j, d) for j, d in enumerate(durations) if d >= 1]
    if not pos:
        raise ValueError("durations must include at least one d >= 1 (blank advance)")
    label_log_probs = label_log_probs.to(_F32) - sigma
    dur_lp = duration_log_probs.to(_F32)
    b, t, u1, _ = label_log_probs.shape

    blank_lp = label_log_probs[..., blank_id]  # (B, T, U+1)
    emit_lp = _gather_label_lp(label_log_probs, labels)  # (B, T, U)
    blank_terms = torch.stack([blank_lp + dur_lp[..., j] for j, _ in pos], dim=-1)
    label_terms = _with_end_column(emit_lp[..., None] + dur_lp[:, :, :-1, :])
    alphas = _lattice_alphas(blank_terms, label_terms, tuple(d for _, d in pos), tuple(durations))

    dev = label_log_probs.device
    t_len = torch.as_tensor(frame_lengths, device=dev).long()
    u_last = torch.as_tensor(label_lengths, device=dev).long().clamp(0, u1 - 1)
    batch = torch.arange(b, device=dev)
    terms = []
    for k, (_, d) in enumerate(pos):
        t_src = t_len - d
        t_safe = t_src.clamp(0, t - 1)
        term = _alpha_at(alphas, t_safe, u_last) + blank_terms[batch, t_safe, u_last, k]
        terms.append(torch.where(t_src >= 0, term, _NEG))
    return -torch.logsumexp(torch.stack(terms, dim=0), dim=0)


__all__ = ["rnnt_loss", "tdt_loss"]
