"""Batched TDT/RNNT beam search (port of parakeet_tpu/decode/beam_transducer.py).

Expansion-synchronous beam without prefix merging: every step advances all
(batch × beam) hypotheses by one transducer decision, one batched
prediction-LSTM step and joint, with the greedy loop's semantics per
hypothesis (decode/transducer.py):

  * blank → the parent's LSTM state kept, t += max(skip, 1)
  * non-blank → emit and feed back; zero-duration emissions capped at
    max_symbols with the same forced t += 1
  * TDT durations: the duration head's argmax, whose log-prob joins the
    path score, so scores are joint path log-probabilities
  * RNNT ≡ TDT with durations (0,)

Each step expands the top `expand_k` labels of every live hypothesis (a
finished or dead one contributes one self-candidate) and keeps the top
`beam_size` per batch item. Only beam 0 is live at the start. Selection is
a stable descending sort, so ties go to the lower index, as jax.lax.top_k
breaks them: dead candidates tie at _DEAD in bulk. With beam_size=1 the
decode is the greedy one.

The loop checks on the host whether any hypothesis is live every
CHECK_EVERY steps; a step with none live keeps every finished hypothesis
as it is (their self-candidates are already in score order), so the extra
steps change nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from parakeet_tpu_torch.decode.transducer import CHECK_EVERY
from parakeet_tpu_torch.models.rnnt import (
    joint_encoder_projection,
    prediction_step,
    prediction_zero_state,
    rnnt_joint_precomputed,
    tdt_joint_precomputed,
)
from parakeet_tpu_torch.ops.layers import hoist_dequant
from parakeet_tpu_torch.params import Params

_F32 = torch.float32
_DEAD = -1.0e30


@dataclass
class BeamHypothesis:
    tokens: list[int]
    score: float  # joint path log-probability
    frames: list[int]  # emission frame per token
    token_logprobs: list[float]  # raw label log-prob per emitted token


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last dim, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _by_parent(x: torch.Tensor, parent: torch.Tensor) -> torch.Tensor:
    """x (B, K, ...) reordered along the beam by parent (B, K)."""
    ix = parent.reshape(parent.shape + (1,) * (x.dim() - 2)).expand(-1, -1, *x.shape[2:])
    return x.gather(1, ix)


def _beam_loop(
    params: dict,
    enc: torch.Tensor,  # (B, T, H)
    enc_len: torch.Tensor,  # (B,)
    *,
    num_lstm_layers: int,
    durations: tuple[int, ...],
    blank_id: int,
    max_symbols: int,
    max_out: int,
    is_tdt: bool,
    joint_prefix: str,
    beam_size: int,
    expand_k: int,
    model=None,
):
    b, t_max, _ = enc.shape
    k, m = beam_size, expand_k
    dev = enc.device
    root = Params(hoist_dequant(params, ("prediction_", joint_prefix)))
    pred_p, joint_p = root.sub("prediction_"), root.sub(joint_prefix)
    dur_arr = torch.as_tensor(durations, dtype=torch.int64, device=dev)
    bix = torch.arange(b, device=dev)[:, None]
    enc_pre = joint_encoder_projection(joint_p, enc)  # (B, T, J)
    # from the OUT dim: int4 packing halves the in-dim
    pred_hidden = params["prediction_.lstm_.cells_.0.hidden_proj_.weight"].shape[0] // 4
    n_l = num_lstm_layers

    t = torch.zeros((b, k), dtype=torch.int64, device=dev)
    token = torch.full((b, k), blank_id, dtype=torch.int64, device=dev)
    # carried as (B, K, L, 2, H) so reordering the beam is one gather
    lstm = prediction_zero_state(n_l, b * k, pred_hidden, device=dev).reshape(
        n_l, 2, b, k, pred_hidden).permute(2, 3, 0, 1, 4)
    sym = torch.zeros_like(t)
    score = torch.full((b, k), _DEAD, dtype=_F32, device=dev)
    score[:, 0] = 0.0
    n_out = torch.zeros_like(t)
    out_tok = torch.zeros((b, k, max_out), dtype=torch.int64, device=dev)
    out_frame = torch.zeros_like(out_tok)
    out_lp = torch.zeros((b, k, max_out), dtype=_F32, device=dev)
    dead_fill = torch.full((b, k, m - 1), _DEAD, dtype=_F32, device=dev)

    def live():
        return (t < enc_len[:, None]) & (score > _DEAD / 2)

    steps = 0
    while steps % CHECK_EVERY or bool(live().any()):
        active = live()
        enc_pre_t = enc_pre[bix, t.clamp(0, t_max - 1)]  # (B, K, J)
        lstm_flat = lstm.permute(2, 3, 0, 1, 4).reshape(n_l, 2, b * k, pred_hidden)
        pred_flat, new_flat = prediction_step(pred_p, token.reshape(b * k), lstm_flat, n_l, model)
        pred = pred_flat.reshape(b, k, -1)
        new_lstm = new_flat.reshape(n_l, 2, b, k, pred_hidden).permute(2, 3, 0, 1, 4)

        if is_tdt:
            label_lp, dur_lp = tdt_joint_precomputed(joint_p, enc_pre_t, pred, model)
            dur_idx = torch.argmax(dur_lp, dim=-1)
            skip = dur_arr[dur_idx.clamp(0, len(durations) - 1)]  # (B, K)
            dur_bonus = dur_lp.gather(-1, dur_idx[..., None])[..., 0]
        else:
            label_lp = rnnt_joint_precomputed(joint_p, enc_pre_t, pred, model)
            skip = torch.zeros_like(t)
            dur_bonus = torch.zeros((b, k), dtype=_F32, device=dev)

        top_lp, top_tok = _top_k(label_lp, m)  # (B, K, M)
        cand_live = score[..., None] + top_lp + dur_bonus[..., None]
        # a finished or dead hypothesis: one self-candidate (slot 0)
        self_only = torch.cat([score[..., None], dead_fill], dim=-1)
        cand = torch.where(active[..., None], cand_live, self_only)
        sel_score, sel_ix = _top_k(cand.reshape(b, k * m), k)  # (B, K)
        parent, slot = sel_ix // m, sel_ix % m

        t_p, token_p, sym_p, skip_p = (_by_parent(x, parent) for x in (t, token, sym, skip))
        n_out_p, expanded = _by_parent(n_out, parent), _by_parent(active, parent)
        lstm_p, lstm_n = _by_parent(lstm, parent), _by_parent(new_lstm, parent)
        out_tok_p, out_frame_p, out_lp_p = (_by_parent(x, parent) for x in (out_tok, out_frame, out_lp))
        tok_sel = _by_parent(top_tok, parent).gather(2, slot[..., None])[..., 0]
        lp_sel = _by_parent(top_lp, parent).gather(2, slot[..., None])[..., 0]  # raw label log-prob

        # the greedy loop's state machine on each selected expansion
        is_blank = tok_sel == blank_id
        emit = expanded & ~is_blank
        zero_dur = emit & (skip_p == 0)
        forced = zero_dur & (sym_p + 1 >= max_symbols)
        new_t = torch.where(
            is_blank, t_p + skip_p.clamp(min=1),
            torch.where(skip_p > 0, t_p + skip_p, torch.where(forced, t_p + 1, t_p)))
        t = torch.where(expanded, new_t, t_p)
        sym = torch.where(expanded, torch.where(zero_dur & ~forced, sym_p + 1, torch.zeros_like(sym_p)), sym_p)
        token = torch.where(emit, tok_sel, token_p)
        lstm = torch.where(emit[..., None, None, None], lstm_n, lstm_p)  # blank restore

        idx = n_out_p.clamp(0, max_out - 1)[..., None]

        def record(buf, val):
            return buf.scatter(2, idx, torch.where(emit, val, buf.gather(2, idx)[..., 0])[..., None])

        out_tok, out_frame, out_lp = record(out_tok_p, tok_sel), record(out_frame_p, t_p), record(out_lp_p, lp_sel)
        score = sel_score
        n_out = n_out_p + emit.to(n_out_p.dtype)
        steps += 1
    return out_tok, out_frame, out_lp, n_out, score


def transducer_beam_decode(
    params: dict,
    enc: torch.Tensor,
    *,
    num_lstm_layers: int,
    durations: tuple[int, ...] = (0, 1, 2, 3, 4),
    blank_id: int = 1024,
    max_symbols: int = 10,
    is_tdt: bool = True,
    joint_prefix: str = "tdt_joint_",
    enc_lengths=None,
    beam_size: int = 4,
    expand_k: int | None = None,
    n_best: int = 1,
    max_out: int | None = None,
    model=None,
) -> list[list[BeamHypothesis]]:
    """Beam-decode a batch; per item its n-best hypotheses, best first
    (scores are joint path log-probabilities). model: the mesh's 'model'
    axis when the vocab heads are split (models/rnnt.py)."""
    b, t_max, _ = enc.shape
    if enc_lengths is None:
        enc_len = torch.full((b,), t_max, dtype=torch.int64, device=enc.device)
    else:
        enc_len = torch.as_tensor(enc_lengths, device=enc.device).to(torch.int64)
    if expand_k is None:
        expand_k = min(beam_size + 1, 8)
    if max_out is None:
        max_out = max(8, t_max * max_symbols)
    with torch.inference_mode():
        out = _beam_loop(
            params, enc, enc_len, num_lstm_layers=num_lstm_layers, durations=tuple(durations),
            blank_id=blank_id, max_symbols=max_symbols, max_out=max_out, is_tdt=is_tdt,
            joint_prefix=joint_prefix, beam_size=beam_size, expand_k=expand_k, model=model)
    out_tok, out_frame, out_lp, n_out, score = (x.cpu().tolist() for x in out)

    results: list[list[BeamHypothesis]] = []
    for i in range(b):
        hyps = [
            BeamHypothesis(tokens=out_tok[i][j][: n_out[i][j]], score=score[i][j],
                           frames=out_frame[i][j][: n_out[i][j]], token_logprobs=out_lp[i][j][: n_out[i][j]])
            for j in range(beam_size)
            if score[i][j] > _DEAD / 2
        ]
        hyps.sort(key=lambda h: -h.score)
        results.append(hyps[: max(1, n_best)])
    return results


__all__ = ["BeamHypothesis", "transducer_beam_decode"]
