"""CTC head + greedy decode (port of parakeet_tpu/models/ctc.py).

The head is a 1×1 Conv1d + log_softmax (ctc.cpp:10-25). Greedy decode
(ctc.cpp:40-127): per-frame argmax (first max wins) → collapse repeats →
drop blank. Argmax and max run on the device over the whole batch; only the
(B, T) results cross to the host, where the collapse is a numpy pass.
"""

from __future__ import annotations

import numpy as np
import torch

from parakeet_tpu_torch import trace
from parakeet_tpu_torch.decode.timestamp import TimestampedToken
from parakeet_tpu_torch.ops.layers import conv1d
from parakeet_tpu_torch.params import Params


def ctc_log_probs(p: Params, encoder_out: torch.Tensor, model=None, vocab: int | None = None) -> torch.Tensor:
    """(B, T, H) → (B, T, V) f32 log-probs; `p` at the ctc head prefix.
    model: the mesh's 'model' axis when the head's vocab rows are split
    (this rank's block of logits, gathered); vocab: the schema vocabulary,
    to which padded log-probs are cut after the softmax."""
    if model is not None and model.split:  # column-parallel over the vocab: the input's gradient summed
        from parakeet_tpu_torch.parallel.collectives import copy_to_model, gather_last

        x = conv1d(p.sub("proj_"), copy_to_model(encoder_out, model).transpose(1, 2)).transpose(1, 2)
        x = gather_last(x.contiguous(), model)
    else:
        x = conv1d(p.sub("proj_"), encoder_out.transpose(1, 2)).transpose(1, 2)  # (B, T, V)
    lp = torch.log_softmax(x.to(torch.float32), dim=-1)
    return lp if vocab is None else lp[..., :vocab]


def _argmax_and_max(log_probs) -> tuple[np.ndarray, np.ndarray]:
    lp = torch.as_tensor(log_probs)
    best = torch.argmax(lp, dim=-1)  # documented first-max tie-breaking
    best_lp = torch.amax(lp, dim=-1)
    return best.to(torch.int32).cpu().numpy(), best_lp.cpu().numpy()


def _lengths(lengths, b: int, t: int) -> list[int]:
    return [t] * b if lengths is None else [int(l) for l in np.asarray(lengths)]


def _collapse(best: np.ndarray, blank_id: int, length: int) -> list[int]:
    best = best[:length]
    prev = np.concatenate([[-1], best[:-1]])
    emit = (best != blank_id) & (best != prev)
    return best[emit].tolist()


@trace.spanned("ctc_decode")
def ctc_greedy_decode(log_probs, blank_id: int = 1024, lengths=None) -> list[list[int]]:
    """(B, T, V) log-probs → per-item token lists; `lengths` = valid frames."""
    best, _ = _argmax_and_max(log_probs)
    b, t = best.shape
    lens = _lengths(lengths, b, t)
    return [_collapse(best[i], blank_id, lens[i]) for i in range(b)]


@trace.spanned("ctc_decode")
def ctc_greedy_decode_with_timestamps(
    log_probs, blank_id: int = 1024, lengths=None
) -> list[list[TimestampedToken]]:
    """Same, with {start, end, confidence=exp(max_lp)} spans: a token's span
    closes when the argmax changes; the final token ends at T-1."""
    best, best_lp = _argmax_and_max(log_probs)
    b, t = best.shape
    lens = _lengths(lengths, b, t)
    results: list[list[TimestampedToken]] = []
    for i in range(b):
        n = lens[i]
        seq, lps = best[i][:n], best_lp[i][:n]
        prev = np.concatenate([[-1], seq[:-1]])
        change = seq != prev
        emit_idx = np.nonzero(change & (seq != blank_id))[0]
        change_idx = np.nonzero(change)[0]
        toks: list[TimestampedToken] = []
        for start in emit_idx:
            j = np.searchsorted(change_idx, start + 1)
            nxt = change_idx[j] if j < len(change_idx) else n
            toks.append(
                TimestampedToken(int(seq[start]), int(start), int(nxt - 1), float(np.exp(lps[start])))
            )
        if toks:
            toks[-1].end_frame = n - 1
        results.append(toks)
    return results


__all__ = ["ctc_log_probs", "ctc_greedy_decode", "ctc_greedy_decode_with_timestamps"]
