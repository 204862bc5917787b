"""Random weights from the seed, made on the device in the type they are
served in, and the synthetic vocabulary.

Leaves follow the schema's init kinds (the repo's init_params): "w" normal
with std 1/sqrt(fan_in), "emb" and "bias_param" normal with std 0.02,
biases and BatchNorm means zero, norm weights and BatchNorm variances one.
All normal draws are one torch.randn call on the card; the float leaves
are bfloat16 (the compute dtype) and the normalisation leaves float32, as
the facade holds them.

Random weights make a degenerate encoder: after many random blocks the
frames of a clip differ little (their spread is about a tenth of the
LayerNorm scale), so the margin of the best token over the blank is about
the same on every frame and differs by whole nats from seed to seed, and
one duration wins everywhere. A fixed blank offset then gives one seed no
tokens and the next ten a frame. So the rules of the configuration file
("assumed") fix what the decode does per frame, the same for every seed:

* "blank_rows_zero": the blank's row of each label head is zero, so the
  blank's logit is its bias alone;
* "fixed_duration": the duration head's weights are zero and its bias is
  one at one index, so every step moves that many frames. The files take
  the largest of the published durations (4 of 0-4): no greedy TDT decode
  of a clip of T' frames takes fewer than ⌈T'/4⌉ steps, so the cells run
  the least decode work the model allows, and speech's is at least as
  much;
* "emitting_share": each blank bias gets the offset that puts that share
  of the seed's frames above the blank, as the reference scores them at
  the decode's start state (`blank_offsets`): a steady emission density.
"""

from __future__ import annotations

import numpy as np
import torch


def is_norm(key: str) -> bool:
    """LayerNorm and BatchNorm leaves, which the facade keeps in float32."""
    return "norm" in key


def make_weights(spec: dict, seed: int, device, dtype: torch.dtype, blank: int, rules: dict) -> dict:
    """{key: tensor on device}: `spec` {key: (shape, kind)}; `rules` the
    configuration's "assumed" (module note), applied after the draw."""
    keys = sorted(spec)
    random = [k for k in keys if spec[k][1] in ("w", "emb", "bias_param")]
    sizes = [int(np.prod(spec[k][0])) for k in random]
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=dtype)
    out = {}
    for key, part in zip(random, torch.split(flat, sizes)):
        shape, kind = spec[key]
        std = 1.0 / np.sqrt(max(int(np.prod(shape[1:])) if len(shape) > 1 else shape[0], 1)) if kind == "w" else 0.02
        out[key] = part.view(shape).mul_(std)
    for key in keys:
        shape, kind = spec[key]
        if key in out:
            continue
        leaf_dtype = torch.float32 if is_norm(key) else dtype
        fill = 1.0 if kind in ("norm_w", "bn_var") else 0.0
        out[key] = torch.full(shape, fill, device=device, dtype=leaf_dtype)
    for key in rules.get("blank_rows_zero", []):
        out[key][blank] = 0
    if "fixed_duration" in rules:
        fixed = rules["fixed_duration"]
        out[fixed["weight"]].zero_()
        out[fixed["bias"]].zero_()[fixed["index"]] = 1.0
    return out


def blank_offsets(margins: dict, shares: dict) -> dict:
    """{bias key: offset}: the offset that leaves `shares[key]` of the
    margins (best token over blank, one per frame) above the blank."""
    return {key: float(torch.quantile(margins[key].double(), 1.0 - shares[key])) for key in shares}


def host_copy(weights: dict) -> dict:
    """float32 CPU tensors of `weights`, for a facade whose constructor takes
    host arrays."""
    return {k: v.to(torch.float32).cpu() for k, v in weights.items()}


def vocab_pieces(vocab_size: int) -> list[str]:
    """A synthetic SentencePiece vocabulary without the blank: every third
    piece starts a word ("▁w<i>"), the others continue one ("p<i>"), so
    word grouping and detokenisation do real work."""
    return [f"▁w{i}" if i % 3 == 0 else f"p{i}" for i in range(vocab_size - 1)]
