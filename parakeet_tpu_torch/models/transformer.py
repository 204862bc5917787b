"""Plain transformer encoder, the Sortformer head (port of
parakeet_tpu/models/transformer.py).

Reference: src/transformer.cpp:9-88. MHA and ReLU FFN blocks with pre- or
post-norm (Sortformer's is post-norm: the norm after the residual add,
transformer.cpp:51,61) and an optional final norm.
"""

from __future__ import annotations

import math

import torch

from parakeet_tpu_torch.config import TransformerConfig
from parakeet_tpu_torch.ops.layers import layer_norm, linear
from parakeet_tpu_torch.params import Params

_F32 = torch.float32
_NEG_INF = -1e9


def transformer_block(
    p: Params, x: torch.Tensor, cfg: TransformerConfig, mask: torch.Tensor | None = None, model=None
) -> torch.Tensor:
    """One block on (B, T, d); mask (B, 1, T, T) bool, True = masked.
    model: the 'model' axis over which parallel/mesh.py's rules split the
    heads (q/k/v rows, out_proj columns: row-parallel) and the FFN (fc1
    rows, fc2 columns: row-parallel); this rank's shards in `p`."""
    eps = cfg.layer_norm_eps
    b, t, d = x.shape
    hd = d // cfg.num_heads
    scale = 1.0 / math.sqrt(hd)

    mha_in = layer_norm(p.sub("norm1_"), x, eps) if cfg.pre_ln else x
    mha = p.sub("mha_")
    if model is not None and model.split:  # column-parallel q, k, v: one copy for the three
        from parakeet_tpu_torch.parallel.collectives import copy_to_model

        mha_in = copy_to_model(mha_in, model)

    def split(v):
        return v.reshape(b, t, -1, hd).transpose(1, 2)

    q = split(linear(mha.sub("q_proj"), mha_in))
    k = split(linear(mha.sub("k_proj"), mha_in))
    v = split(linear(mha.sub("v_proj"), mha_in))
    scores = torch.matmul(q.to(_F32), k.to(_F32).transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores.masked_fill(mask, _NEG_INF)
    attn = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.matmul(attn.to(_F32), v.to(_F32)).to(x.dtype)
    out = linear(mha.sub("out_proj"), out.transpose(1, 2).reshape(b, t, -1), row_group=model)

    x = (x + out) if cfg.pre_ln else layer_norm(p.sub("norm1_"), x + out, eps)
    ffn_in = layer_norm(p.sub("norm2_"), x, eps) if cfg.pre_ln else x
    h = linear(p.sub("fc2_"), torch.relu(linear(p.sub("fc1_"), ffn_in, col_group=model)), row_group=model)
    return (x + h) if cfg.pre_ln else layer_norm(p.sub("norm2_"), x + h, eps)


def transformer_encode(
    p: Params, cfg: TransformerConfig, x: torch.Tensor, mask: torch.Tensor | None = None, model=None
) -> torch.Tensor:
    layers = p.sub("layers_")
    for i in range(cfg.num_layers):
        x = transformer_block(layers.sub(str(i)), x, cfg, mask, model)
    if cfg.has_final_norm:
        x = layer_norm(p.sub("final_norm_"), x, cfg.layer_norm_eps)
    return x


__all__ = ["transformer_block", "transformer_encode"]
