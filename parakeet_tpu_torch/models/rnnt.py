"""RNNT/TDT prediction network and joints (port of parakeet_tpu/models/rnnt.py).

Prediction = Embedding → LSTM (rnnt.cpp:9-28). The TDT joint (tdt.cpp:9-24)
is relu(enc_proj(enc) + pred_proj(pred)) split into a label head (vocab)
and a duration head; the RNNT joint has one out_proj head. pred_proj is
bias-free. SOS is the blank token id: its embedding row starts decoding.
"""

from __future__ import annotations

import torch

from parakeet_tpu_torch.ops.layers import embedding, linear
from parakeet_tpu_torch.ops.lstm import lstm_forward, lstm_step, lstm_zero_state
from parakeet_tpu_torch.params import Params

_F32 = torch.float32


def prediction_step(
    p: Params, token: torch.Tensor, lstm_state: torch.Tensor, num_lstm_layers: int, model=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step: token (B,) → ((B, pred_hidden), new_state)."""
    x = embedding(p.sub("embed_"), token, vocab_group=model)
    return lstm_step(p.sub("lstm_"), x, lstm_state, num_lstm_layers)


def prediction_forward(
    p: Params, labels: torch.Tensor, lstm_state: torch.Tensor, num_lstm_layers: int, model=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequence forward: labels (B, U) → ((B, U, pred_hidden), state).
    model: the 'model' axis over which the embedding's vocab rows are
    split (parallel/collectives.py parallel_embedding)."""
    x = embedding(p.sub("embed_"), labels, vocab_group=model)
    return lstm_forward(p.sub("lstm_"), x, lstm_state, num_lstm_layers)


def prediction_zero_state(
    num_lstm_layers: int, batch: int, pred_hidden: int, dtype=_F32, device="cpu"
) -> torch.Tensor:
    return lstm_zero_state(num_lstm_layers, batch, pred_hidden, dtype, device)


def joint_encoder_projection(p: Params, enc: torch.Tensor) -> torch.Tensor:
    """enc_proj over all frames, hoisted out of the decode loop:
    (B, T, enc_h) → (B, T, joint_h). Row-wise, so identical to per-step."""
    return linear(p.sub("enc_proj_"), enc)


def rnnt_joint(p: Params, enc: torch.Tensor, pred: torch.Tensor, model=None) -> torch.Tensor:
    """(…, enc_h) × (…, pred_h) → (…, V) log-probs (rnnt.cpp:38-44)."""
    return rnnt_joint_precomputed(p, joint_encoder_projection(p, enc), pred, model)


def tdt_joint(p: Params, enc: torch.Tensor, pred: torch.Tensor, model=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(…, enc_h) × (…, pred_h) → ((…, V), (…, n_dur)) log-probs (tdt.cpp:15-24)."""
    return tdt_joint_precomputed(p, joint_encoder_projection(p, enc), pred, model)


def _vocab_logits(p: Params, hidden: torch.Tensor, model) -> torch.Tensor:
    """A vocab head's logits; under a split (column-parallel over the
    vocab), this rank's block gathered."""
    logits = linear(p, hidden, col_group=model)
    if model is not None and model.split:
        from parakeet_tpu_torch.parallel.collectives import gather_last

        logits = gather_last(logits, model)
    return logits


def rnnt_joint_precomputed(p: Params, enc_pre: torch.Tensor, pred: torch.Tensor, model=None) -> torch.Tensor:
    """RNNT joint with enc_proj already applied → (…, V) log-probs."""
    hidden = torch.relu(enc_pre + linear(p.sub("pred_proj_"), pred))
    return torch.log_softmax(_vocab_logits(p.sub("out_proj_"), hidden, model).to(_F32), dim=-1)


def tdt_joint_precomputed(
    p: Params, enc_pre: torch.Tensor, pred: torch.Tensor, model=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """TDT joint with enc_proj already applied → ((…, V), (…, n_dur)) log-probs."""
    hidden = torch.relu(enc_pre + linear(p.sub("pred_proj_"), pred))
    label_lp = torch.log_softmax(_vocab_logits(p.sub("label_proj_"), hidden, model).to(_F32), dim=-1)
    dur_lp = torch.log_softmax(linear(p.sub("duration_proj_"), hidden).to(_F32), dim=-1)
    return label_lp, dur_lp


__all__ = [
    "prediction_step",
    "prediction_forward",
    "prediction_zero_state",
    "joint_encoder_projection",
    "rnnt_joint",
    "tdt_joint",
    "rnnt_joint_precomputed",
    "tdt_joint_precomputed",
]
