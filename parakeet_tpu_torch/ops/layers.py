"""Primitive NN ops over torch-layout weights (port of parakeet_tpu/ops/layers.py).

Plain functions on a `Params` prefix view. Weight layouts are torch's:
Linear (out, in), Conv1d (out, in/groups, k), Conv2d (out, in/groups, kh, kw).

Numerics follow the reference: every product accumulates in float32 and
rounds once to the activation dtype; normalization runs in float32. On
CUDA that needs IEEE float32 products, so the port turns TF32 off for
matmuls and cuDNN convolutions before it first runs there
(`require_ieee_f32`, the CUDA form of the reference's Precision.HIGHEST).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from parakeet_tpu_torch.params import Params

_F32 = torch.float32


def require_ieee_f32() -> None:
    """Turn TF32 off for CUDA matmuls and cuDNN convolutions. cuDNN convs
    default to TF32 (about three decimal digits), which breaks f32 parity
    with the reference in the subsampling and conv-module convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _f32(t: torch.Tensor | None) -> torch.Tensor | None:
    return None if t is None else t.to(_F32)


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W.T (+ b), float32 accumulation, result in x.dtype."""
    w = p["weight"]
    b = p.get("bias")
    if x.dtype == _F32 and w.dtype == _F32:
        return F.linear(x, w, b)
    return F.linear(x.to(_F32), w.to(_F32), _f32(b)).to(x.dtype)


def embedding(p: Params, ids: torch.Tensor) -> torch.Tensor:
    """ids (...,) integer → (..., dim)."""
    return p["weight"][ids]


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics."""
    y = F.layer_norm(x.to(_F32), (x.shape[-1],), _f32(p["weight"]), _f32(p["bias"]), eps)
    return y.to(x.dtype)


def batch_norm_1d(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode BatchNorm1d over (B, C, T) using running stats."""
    mean = p["running_mean"].to(_F32)[None, :, None]
    var = p["running_var"].to(_F32)[None, :, None]
    w = p["weight"].to(_F32)[None, :, None]
    b = p["bias"].to(_F32)[None, :, None]
    y = (x.to(_F32) - mean) * torch.rsqrt(var + eps) * w + b
    return y.to(x.dtype)


def conv1d(
    p: Params, x: torch.Tensor, *, stride: int = 1, padding: int = 0, groups: int = 1
) -> torch.Tensor:
    """x: (B, C_in, T) → (B, C_out, T'). Weight: (C_out, C_in/groups, k)."""
    y = F.conv1d(
        x.to(_F32), p["weight"].to(_F32), _f32(p.get("bias")),
        stride=stride, padding=padding, groups=groups,
    )
    return y.to(x.dtype)


def conv2d(
    p: Params,
    x: torch.Tensor,
    *,
    stride: tuple[int, int] = (1, 1),
    padding: tuple[int, int] = (0, 0),
    groups: int = 1,
) -> torch.Tensor:
    """NCHW 2-D conv over torch-layout weights (C_out, C_in/g, kh, kw)."""
    y = F.conv2d(
        x.to(_F32), p["weight"].to(_F32), _f32(p.get("bias")),
        stride=stride, padding=padding, groups=groups,
    )
    return y.to(x.dtype)


def glu(x: torch.Tensor, dim: int) -> torch.Tensor:
    a, b = torch.chunk(x, 2, dim=dim)
    return a * torch.sigmoid(b)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


__all__ = [
    "require_ieee_f32",
    "linear",
    "embedding",
    "layer_norm",
    "batch_norm_1d",
    "conv1d",
    "conv2d",
    "glu",
    "silu",
]
