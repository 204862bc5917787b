"""Hand-rolled LSTM matching the reference cell (port of parakeet_tpu/ops/lstm.py).

Gates = input_proj(x) + hidden_proj(h); input_proj carries the merged NeMo
bias (bias_ih + bias_hh), hidden_proj is bias-free. Gate order after
chunk(4): i, f, g, o;  c' = σ(f)·c + σ(i)·tanh(g);  h' = σ(o)·tanh(c').

State is one (num_layers, 2, B, H) tensor: [:, 0] = h, [:, 1] = c, so a
decode loop saves and restores it with one `torch.where`.
"""

from __future__ import annotations

import torch

from parakeet_tpu_torch.ops.layers import linear
from parakeet_tpu_torch.params import Params


def lstm_zero_state(
    num_layers: int, batch: int, hidden: int, dtype=torch.float32, device="cpu"
) -> torch.Tensor:
    return torch.zeros((num_layers, 2, batch, hidden), dtype=dtype, device=device)


def _cell(p: Params, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    gates = linear(p.sub("input_proj_"), x) + linear(p.sub("hidden_proj_"), h)
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_step(
    p: Params, x: torch.Tensor, state: torch.Tensor, num_layers: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """One timestep through all layers. p: view at the `lstm_` prefix;
    x: (B, in). Returns (output (B, H), new_state (L, 2, B, H))."""
    new_layers = []
    for l in range(num_layers):
        h, c = _cell(p.sub("cells_").sub(str(l)), x, state[l, 0], state[l, 1])
        new_layers.append(torch.stack([h, c]))
        x = h
    return x, torch.stack(new_layers)


def lstm_forward(
    p: Params, xs: torch.Tensor, state: torch.Tensor, num_layers: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequence forward: xs (B, T, in) → ((B, T, H), final state), one
    lstm_step per timestep (the reference's lax.scan)."""
    outs = []
    for t in range(xs.shape[1]):
        out, state = lstm_step(p, xs[:, t], state, num_layers)
        outs.append(out)
    return torch.stack(outs, dim=1), state


__all__ = ["lstm_zero_state", "lstm_step", "lstm_forward"]
