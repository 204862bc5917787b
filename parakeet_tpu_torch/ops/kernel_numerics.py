"""Shared numerics of the fused encoder kernels, as plain torch.

Port of parakeet_tpu/ops/pallas_utils.py's kernel-side functions. The
plain versions of the hand-written kernels (ops/feed_forward.py,
ops/conv_module.py) are built from these, so they round where the TPU
kernels round, which is not always where the port's plain encoder layers
round: LayerNorm output, the fc1 and pw1 results, SiLU and GLU each round
to the activation dtype, the residual is added in float32, and the folded
BatchNorm scale and bias are rounded to the activation dtype. Every product
accumulates in float32.

The attention cores' rounding points (their plain versions are in
ops/rel_attention.py): K1's block kernel rounds the unnormalised
probabilities exp(s − max) to the activation dtype before AV and divides
the product by the unrounded sum after it; K2's (the v1 kernel) normalises
first, exp(s − max) / sum, rounds that to the dtype, and rounds AV once, so
its bf16 core needs each row's max and sum before its first AV product
(two sweeps over the keys). In f32 that rounding is the identity and K2's
core divides after AV, as K1's does: only the place of one f32 division
an output moves.

Left out on purpose: round_up, whole_block, depthwise_taps and
kernel_precision, which are TPU layout and precision plumbing.
"""

from __future__ import annotations

import torch

_F32 = torch.float32


def kernel_layer_norm(x: torch.Tensor, w, b, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics, result in x.dtype."""
    xf = x.to(_F32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * w.to(_F32) + b.to(_F32)).to(x.dtype)


def sigmoid_f32(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(−x)) in float32."""
    return 1.0 / (1.0 + torch.exp(-x.to(_F32)))


def silu_kernelside(x: torch.Tensor) -> torch.Tensor:
    """x·sigmoid(x) with the sigmoid in float32; result in x.dtype."""
    return (x.to(_F32) * sigmoid_f32(x)).to(x.dtype)


def fold_batch_norm(bn_w, bn_b, bn_mean, bn_var, d: int, dtype):
    """Inference BatchNorm running statistics → (scale, bias), each (1, d)
    and rounded to `dtype` (eps 1e-5, torch's default)."""
    inv = torch.rsqrt(bn_var.to(_F32) + 1e-5)
    scale = (bn_w.to(_F32) * inv).reshape(1, d)
    bias = (bn_b.to(_F32) - bn_mean.to(_F32) * inv * bn_w.to(_F32)).reshape(1, d)
    return scale.to(dtype), bias.to(dtype)


def _matmul_nt(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ wᵀ with float32 operands and accumulation (exact products of
    bf16 inputs, as the TPU kernels' preferred_element_type=f32)."""
    return a.to(_F32) @ w.to(_F32).transpose(-1, -2)


def ffn_body(x, nw, nb, w1, b1, w2, b2, eps: float) -> torch.Tensor:
    """Macaron FFN half-step: LN → fc1 → SiLU → fc2 → x + 0.5·y.
    (…, D) in x.dtype in and out; y is added unrounded."""
    h = kernel_layer_norm(x, nw, nb, eps)
    h = _matmul_nt(h, w1) + b1.to(_F32)
    h = silu_kernelside(h.to(x.dtype))
    y = _matmul_nt(h, w2) + b2.to(_F32)
    return (x.to(_F32) + 0.5 * y).to(x.dtype)


def conv_module_body(x, valid, nw, nb, w1, b1, wd_taps, bd, bn_scale, bn_bias,
                     w2, b2, eps: float, kernel_size: int) -> torch.Tensor:
    """Conformer conv module on (B, T, D): LN → pw1 → GLU → zero rows at or
    past `valid` → depthwise taps over time → folded BN → SiLU → pw2 → +x.

    valid: (B,) valid row counts. wd_taps: (k, D), tap-major (the torch
    depthwise weight (D, 1, k) transposed). w1 (2D, D), w2 (D, D)."""
    _, t, d = x.shape
    h = kernel_layer_norm(x, nw, nb, eps)
    y = (_matmul_nt(h, w1) + b1.to(_F32)).to(x.dtype)
    a, g = y[..., :d], y[..., d:]
    h = (a.to(_F32) * sigmoid_f32(g)).to(x.dtype)  # GLU

    rows = torch.arange(t, device=x.device)[None, :, None]
    h = torch.where(rows < valid.to(x.device)[:, None, None], h, torch.zeros_like(h))

    pad = (kernel_size - 1) // 2
    hp = torch.nn.functional.pad(h.to(_F32), (0, 0, pad, pad))
    acc = torch.zeros(h.shape, dtype=_F32, device=x.device)
    for k in range(kernel_size):
        acc = acc + hp[:, k: k + t, :] * wd_taps[k][None, None, :].to(_F32)
    acc = acc + bd.to(_F32)
    acc = acc * bn_scale.to(_F32) + bn_bias.to(_F32)
    acc = silu_kernelside(acc.to(x.dtype))
    o = _matmul_nt(acc, w2) + b2.to(_F32)
    return (x.to(_F32) + o).to(x.dtype)


__all__ = [
    "kernel_layer_norm",
    "sigmoid_f32",
    "silu_kernelside",
    "fold_batch_norm",
    "ffn_body",
    "conv_module_body",
]
