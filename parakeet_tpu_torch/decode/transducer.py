"""Batched TDT/RNNT greedy decode (port of parakeet_tpu/decode/transducer.py::_decode_loop).

Semantics (tdt.cpp:66-105):
  * SOS = blank (its embedding row is the start state)
  * blank → restore the saved LSTM state, t += max(skip, 1)
  * non-blank → emit and feed the token back; skip > 0 → t += skip;
    skip == 0 → another symbol on the same frame, capped at max_symbols,
    where the cap forces t += 1 (the reference's documented anti-livelock)
  * timestamps: start = t, end = t + max(skip, 1) − 1, clamped to len − 1
    when clamp_end; confidence = exp(label log-prob)
  * RNNT ≡ TDT with durations (0,): blank advances by 1, non-blank stays.

Phrase boosting (phrase_boost.cpp:180-258) rides along as the trie's dense
transition table (decode/phrase_boost.py): the boosted tokens are
(active @ reach) > 0, the selection is label_lp + score·mask, the
confidence stays unboosted, and the trie advances only on an emission with
the root always active.

Quantized prediction and joint weights are converted once per call, before
the loop (ops/layers.py hoist_dequant), which is identical to converting
them at every step.

Under tensor parallelism (`model`) the joint's vocab-split logits are
gathered every step (models/rnnt.py), so every rank of a 'model' group
sees the same log-probs, takes the same argmax and stop decisions, and so
reaches every collective of the loop the same number of times. Padded
vocab lanes (parallel/mesh.py pad_vocab_dim) carry −1e9 logits; the boost
mask is padded with unboosted lanes to their width, as in the reference.

The whole batch steps in lockstep on the device, each item running its own
state machine; an item whose t has reached its length takes exact no-op
steps. Python drives the loop and asks the device whether any item is
still active only every CHECK_EVERY steps, so the host waits on the
device once per CHECK_EVERY steps instead of once per step. Inside an
offline call the decode records its spans (trace.py).

Two loop bodies, as in the reference (`impl`), with identical outputs:
  * "step": one LSTM step and one single-frame joint per iteration;
  * "lookahead" (port of _decode_loop_lookahead): one LSTM step, then the
    joint over a `window`-frame lookahead of each item against that one
    prediction output (between emissions the prediction input is
    unchanged, so every frame of the window sees the prediction the step
    loop would recompute), a chase through the window's blank frames, and
    at most one committed emission per item. A blank stretch advances up
    to `window` frames an iteration instead of one.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from parakeet_tpu_torch import trace
from parakeet_tpu_torch.decode.timestamp import TimestampedToken
from parakeet_tpu_torch.models.rnnt import (
    joint_encoder_projection,
    prediction_step,
    prediction_zero_state,
    rnnt_joint_precomputed,
    tdt_joint_precomputed,
)
from parakeet_tpu_torch.ops.layers import hoist_dequant
from parakeet_tpu_torch.params import Params

# steps between host checks of "any item still active"; extra steps taken
# after the last item finished are exact no-ops
CHECK_EVERY = 8


@dataclass
class TransducerResult:
    """Host-side decode output for one batch."""

    tokens: list[list[int]]
    timestamped: list[list[TimestampedToken]]
    last_token: torch.Tensor  # (B,)
    lstm_state: torch.Tensor  # (L, 2, B, H)
    boost_active: torch.Tensor | None = None  # (B, N) bool, the trie states
    steps: int = 0  # loop iterations run, the masked tail included


def _blank_chase(blank_w: torch.Tensor, skip_w: torch.Tensor, t: torch.Tensor, enc_len: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """Offset of the first frame of each item's (B, K) window on which the
    chase through blanks stops: a non-blank frame (an emission), the end
    of the item, or past the window. From offset j a blank frame moves on
    by max(skip_j, 1), as the reference's K unrolled chase steps do
    (transducer.py:381-391); here the successor table is composed with
    itself ceil(log2 K) times, K gathers' worth of chase in log2 K. pos:
    arange(K + the longest duration), room for the last jump out of the
    window."""
    k = blank_w.shape[1]
    stop = (pos >= k) | (t[:, None] + pos >= enc_len[:, None])
    stop[:, :k] |= ~blank_w
    jump = pos + torch.nn.functional.pad(skip_w.clamp(min=1), (0, len(pos) - k))
    nxt = torch.where(stop, pos, jump)  # (B, K + max_skip): one chase step from each offset
    for _ in range((k - 1).bit_length()):  # every chase ends within K steps
        nxt = nxt.gather(1, nxt)
    return nxt[:, 0]


@trace.spanned("decode")
def transducer_greedy_decode(
    params: dict,
    enc: torch.Tensor,  # (B, T, H)
    *,
    pred_hidden: int,
    num_lstm_layers: int,
    durations: tuple[int, ...] = (0, 1, 2, 3, 4),
    blank_id: int = 1024,
    max_symbols: int = 10,
    is_tdt: bool = True,
    joint_prefix: str = "tdt_joint_",
    enc_lengths=None,
    init_token=None,
    init_lstm=None,
    boost=None,
    frame_offset: int = 0,
    max_out: int | None = None,
    clamp_end: bool = True,
    impl: str = "step",
    window: int = 8,
    unroll: int = 1,
    model=None,
) -> TransducerResult:
    """Greedy decode of (B, T, H) encoder frames. A streaming caller carries
    the decode state across chunks: `init_token` (B,) and `init_lstm`
    (L, 2, B, H) from the previous chunk's `last_token` and `lstm_state`
    (blank and zeros when None), `frame_offset` added to every reported
    start and end frame, and `max_out` emission slots per item (default
    max(8, T · max_symbols); past it the last slot is overwritten, as in
    the reference). `boost`: (transitions (N, V), initial active (B, N)
    bool, score), as ContextTrie.device_boost gives it. `model`: the
    mesh's 'model' axis when the vocab heads are split.

    impl: "step" (the default) or "lookahead" with a `window` of frames
    (clamped to [1, T]); both give identical results. `unroll`: the
    reference's state-machine steps per compiled loop iteration; the
    port has no compiled iteration, and its counterpart of the loop's
    condition is the host check, so the host asks every
    CHECK_EVERY · unroll iterations (identical results; unroll=1 is the
    default schedule)."""
    if impl not in ("step", "lookahead"):
        raise ValueError(f"unknown decode impl {impl!r} (want 'lookahead' or 'step')")
    b, t_max, _ = enc.shape
    dev = enc.device
    check_every = CHECK_EVERY * max(1, int(unroll))
    k = max(1, min(window, t_max))
    root = Params(hoist_dequant(params, ("prediction_", joint_prefix)))
    pred_p = root.sub("prediction_")
    joint_p = root.sub(joint_prefix)
    # host lists to the device: pageable copies the host waits for, so the
    # first waits out the work still queued before the decode (the encoder's)
    with trace.span("decode.upload"):
        if enc_lengths is None:
            enc_len = torch.full((b,), t_max, dtype=torch.int64, device=dev)
        else:
            enc_len = torch.as_tensor(enc_lengths, device=dev).to(torch.int64)
        dur_arr = torch.as_tensor(durations, dtype=torch.int64, device=dev)
    if max_out is None:
        max_out = max(8, t_max * max_symbols)
    batch_ix = torch.arange(b, device=dev)
    pos = torch.arange(k + max(max(durations), 1), device=dev)
    win = pos[:k]

    enc_pre = joint_encoder_projection(joint_p, enc)  # (B, T, joint_h)

    t = torch.zeros(b, dtype=torch.int64, device=dev)
    if init_token is None:
        token = torch.full((b,), blank_id, dtype=torch.int64, device=dev)
    else:
        token = torch.as_tensor(init_token, device=dev).to(torch.int64)
    if init_lstm is None:
        lstm = prediction_zero_state(num_lstm_layers, b, pred_hidden, device=dev)
    else:
        lstm = torch.as_tensor(init_lstm, device=dev)
    sym = torch.zeros_like(t)
    n_out = torch.zeros_like(t)
    # emission records token | start | end | f32 confidence bits, one
    # (B, 4) row per step: one gather and one scatter commit all four
    out_pack = torch.zeros((b, max_out, 4), dtype=torch.int32, device=dev)
    boost_active = None
    if boost is not None:
        trans, boost_active, boost_score = boost
        trans = torch.as_tensor(trans, device=dev).to(torch.int64)
        boost_active = torch.as_tensor(boost_active, device=dev).to(torch.bool)
        reach = (trans >= 0).to(torch.float32)  # (N, V)

    def joint(enc_pre_x, pred):
        """Label log-probs, the boosted selection's argmax and the durations
        at enc_pre_x's leading shape ((B,) or (B, K))."""
        if is_tdt:
            label_lp, dur_lp = tdt_joint_precomputed(joint_p, enc_pre_x, pred, model)
            skip = dur_arr[torch.argmax(dur_lp, dim=-1).clamp(0, len(durations) - 1)]
        else:
            label_lp = rnnt_joint_precomputed(joint_p, enc_pre_x, pred, model)
            skip = torch.zeros(label_lp.shape[:-1], dtype=torch.int64, device=dev)
        select_lp = label_lp
        if boost is not None:
            mask = (boost_active.to(torch.float32) @ reach) > 0  # (B, V): children of active nodes
            if mask.shape[-1] < label_lp.shape[-1]:  # padded vocab lanes: never boosted
                mask = torch.nn.functional.pad(mask, (0, label_lp.shape[-1] - mask.shape[-1]))
            mask = mask.to(torch.float32)
            select_lp = label_lp + boost_score * (mask if label_lp.dim() == 2 else mask[:, None, :])
        return label_lp, torch.argmax(select_lp, dim=-1), skip

    def step_body():
        """One frame: (emit, token, its unboosted log-prob, start frame,
        duration, next t, next sym count, candidate LSTM state)."""
        active = t < enc_len
        enc_pre_t = enc_pre[batch_ix, t.clamp(0, t_max - 1)]  # (B, joint_h)
        pred, new_lstm = prediction_step(pred_p, token, lstm, num_lstm_layers, model)
        label_lp, tok_id, skip = joint(enc_pre_t, pred)
        raw_lp = label_lp[batch_ix, tok_id]  # unboosted: the confidence

        is_blank = tok_id == blank_id
        emit = active & ~is_blank
        zero_dur = emit & (skip == 0)
        forced = zero_dur & (sym + 1 >= max_symbols)
        new_t = torch.where(
            is_blank,
            t + skip.clamp(min=1),
            torch.where(skip > 0, t + skip, torch.where(forced, t + 1, t)),
        )
        new_t = torch.where(active, new_t, t)
        new_sym = torch.where(zero_dur & ~forced, sym + 1, torch.zeros_like(sym))
        return emit, tok_id, raw_lp, t, skip, new_t, new_sym, new_lstm

    def lookahead_body():
        """The joint over each item's K-frame window against one prediction
        step, the chase through its blanks, at most one emission; an item
        at its end stops at offset 0 and emits nothing (a no-op)."""
        pred, new_lstm = prediction_step(pred_p, token, lstm, num_lstm_layers, model)
        win_ix = (t[:, None] + win).clamp(0, t_max - 1)  # (B, K)
        enc_w = enc_pre[batch_ix[:, None], win_ix]  # (B, K, joint_h)
        label_lp, tok_w, skip_w = joint(enc_w, pred[:, None, :])  # (B, K, V), (B, K), (B, K)

        off = _blank_chase(tok_w == blank_id, skip_w, t, enc_len, pos)
        emit = (off < k) & (t + off < enc_len)
        e_off = off.clamp(max=k - 1)
        e_tok = tok_w[batch_ix, e_off]
        e_skip = skip_w[batch_ix, e_off]
        e_lp = label_lp[batch_ix, e_off, e_tok]  # unboosted: the confidence
        e_t = t + off

        # sym counts zero-duration emissions on one frame: the blanks chased
        # before an emission (off > 0) moved to another frame
        zero_dur = emit & (e_skip == 0)
        pre_sym = torch.where(off == 0, sym, torch.zeros_like(sym))
        forced = zero_dur & (pre_sym + 1 >= max_symbols)
        new_sym = torch.where(zero_dur & ~forced, pre_sym + 1, torch.zeros_like(sym))
        advance = torch.where(e_skip > 0, e_skip, forced.to(e_skip.dtype))
        new_t = torch.where(emit, e_t + advance, e_t)
        return emit, e_tok, e_lp, e_t, e_skip, new_t, new_sym, new_lstm

    body = lookahead_body if impl == "lookahead" else step_body
    steps = 0
    with trace.span("decode.loop"):
        while True:
            if steps % check_every == 0:
                with trace.span("decode.check"):
                    more = bool((t < enc_len).any())
                if not more:
                    break
            emit, tok_id, raw_lp, start, skip, t_next, sym, new_lstm = body()

            end_frame = start + skip.clamp(min=1) - 1
            if clamp_end:
                end_frame = torch.minimum(end_frame, enc_len - 1)
            idx = n_out.clamp(0, max_out - 1)
            conf_bits = torch.exp(raw_lp).to(torch.float32).view(torch.int32)
            row = torch.stack([tok_id.to(torch.int32), start.to(torch.int32), end_frame.to(torch.int32), conf_bits],
                              -1)
            out_pack[batch_ix, idx] = torch.where(emit[:, None], row, out_pack[batch_ix, idx])

            t = t_next
            token = torch.where(emit, tok_id, token)
            lstm = torch.where(emit[None, None, :, None], new_lstm, lstm)
            n_out = n_out + emit.to(n_out.dtype)
            if boost is not None:
                # advance on emission: each active node's child by the token
                child = trans.t()[tok_id]  # (B, N)
                valid = boost_active & (child >= 0)
                advanced = torch.zeros(valid.shape, device=dev).scatter_add(
                    1, child.clamp(min=0), valid.to(torch.float32)) > 0
                advanced[:, 0] = True  # root always active
                boost_active = torch.where(emit[:, None], advanced, boost_active)
            steps += 1

    with trace.span("decode.fetch"):
        n_host = n_out.cpu().tolist()
        pack = out_pack.cpu()
    with trace.span("decode.unpack"):
        conf = pack[..., 3].contiguous().view(torch.float32)
        tokens: list[list[int]] = []
        timestamped: list[list[TimestampedToken]] = []
        for i in range(b):
            n = n_host[i]
            toks, starts, ends = pack[i, :n, :3].T.tolist()
            tokens.append(toks)
            timestamped.append([
                TimestampedToken(tok, s + frame_offset, e + frame_offset, c)
                for tok, s, e, c in zip(toks, starts, ends, conf[i, :n].tolist())
            ])
    return TransducerResult(tokens, timestamped, token, lstm, boost_active, steps)


__all__ = ["transducer_greedy_decode", "TransducerResult"]
