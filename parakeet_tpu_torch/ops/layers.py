"""Primitive NN ops over torch-layout weights (port of parakeet_tpu/ops/layers.py).

Plain functions on a `Params` prefix view. Weight layouts are torch's:
Linear (out, in), Conv1d (out, in/groups, k), Conv2d (out, in/groups, kh, kw).

Numerics follow the reference: every product accumulates in float32 and
rounds once to the activation dtype; normalization runs in float32. On
CUDA that needs IEEE float32 products, so the port turns TF32 off for
matmuls and cuDNN convolutions before it first runs there
(`require_ieee_f32`, the CUDA form of the reference's Precision.HIGHEST).

Where the activation, the weight and the bias are all bfloat16 on the card,
`linear`, `conv1d` and `conv2d` run the product there natively: bf16
operands on the tensor cores, float32 accumulation, the bias added in
float32 before the one rounding to bf16, with no float32 copy of any
operand (the reference's dot with preferred_element_type=float32).
Pointwise convolutions run as one GEMM over the channel-last rows with the
bias in its epilogue, depthwise ones as PyTorch's depthwise kernel (f32
accumulation from the bias, one rounding). The CPU, float32 inputs and a
convolution no such route takes keep the float32 form: the operands
upcast, an IEEE float32 product, one cast back. The open call's record
(trace.py) counts each float product by route: `layers.bf16_products`,
`layers.f32_products` (the quantized routes count in neither).

`linear` takes quantized weights (quantize.py) as the reference's does:
int8 codes scale the product, packed int4 dequantises before it, and
`set_int8_compute(True)` runs int8 linears as W8A8.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.modules.utils import _pair

from parakeet_tpu_torch import trace
from parakeet_tpu_torch.params import Params

_F32 = torch.float32
_BF16 = torch.bfloat16
BF16_PRODUCTS = "layers.bf16_products"
F32_PRODUCTS = "layers.f32_products"


def require_ieee_f32() -> None:
    """Turn TF32 off for CUDA matmuls and cuDNN convolutions, and keep the
    split-K reductions of bf16 GEMMs in float32. cuDNN convs default to
    TF32 (about three decimal digits), which breaks f32 parity with the
    reference in the subsampling and conv-module convolutions; a bf16
    partial sum would round before the one rounding of the result."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _f32(t: torch.Tensor | None) -> torch.Tensor | None:
    return None if t is None else t.to(_F32)


def _bf16_on_card(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> bool:
    """Activation, weight and bias all bf16 on the card: the product can run
    natively on the tensor cores."""
    return x.is_cuda and x.dtype == _BF16 and w.dtype == _BF16 and (b is None or b.dtype == _BF16)


def _gemm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """x (..., K) @ w (N, K).T + b as one 2-D addmm: the bias joins the
    float32 accumulator in the GEMM's epilogue before the one rounding.
    F.linear folds a 3-D input into one addmm only when it is contiguous
    (else a matmul, then the bias added to the rounded product: two
    roundings), so the rows are folded here, a strided x copied."""
    return F.linear(x.reshape(-1, x.shape[-1]), w, b).view(*x.shape[:-1], w.shape[0])


# When True, int8-weight linears run as W8A8: a dynamic per-row absmax
# int8 quantization of the activations and an s8×s8→s32 product (the
# reference's set_int8_compute; not bit-parity with the weight-only path).
_INT8_COMPUTE = False

# the float32 form of a quantized weight, hoisted out of a decode loop
# (`hoist_dequant`): int8 codes as floats, or the dequantised int4 weight
DEQUANT_SUFFIX = "##dq"


def set_int8_compute(enabled: bool) -> None:
    global _INT8_COMPUTE
    _INT8_COMPUTE = bool(enabled)


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


def int8_matmul(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 activations times (N, K) int8 weights transposed → the
    exact (M, N) integer sums, as float32. On the card torch._int_mm (s32
    accumulation), which needs more than 16 rows and K and N multiples of
    8: rows and columns are zero-padded, which adds nothing to any sum, and
    the result sliced. On the CPU a float64 product, exact for int8 codes
    (every partial sum stays far below 2^53), so both give the same
    integers."""
    m, k = xq.shape
    n = w.shape[0]
    if xq.is_cuda:
        kp = max(32, _ceil8(k))
        a = F.pad(xq, (0, kp - k, 0, max(32, _ceil8(m)) - m))
        b = F.pad(w, (0, kp - k, 0, _ceil8(n) - n))
        return torch._int_mm(a, b.t())[:m, :n].to(_F32)
    return (xq.to(torch.float64) @ w.to(torch.float64).t()).to(_F32)


def _linear_int8(p: Params, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The reference's int8 branch: the product in float32 with no bias in
    it, then × the per-channel scale, then + bias, then one cast to x.dtype.
    Under set_int8_compute(True): W8A8, x quantised per row (absmax / 127,
    round half to even), the integer product, then × sx × scale."""
    from parakeet_tpu_torch.quantize import SCALE_SUFFIX

    scale = p["weight" + SCALE_SUFFIX].to(_F32)
    if _INT8_COMPUTE and w.dtype == torch.int8:
        xf = x.to(_F32)
        sx = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / 127.0
        xq = torch.round(xf / sx).to(torch.int8)
        y = int8_matmul(xq.reshape(-1, xq.shape[-1]), w).reshape(*x.shape[:-1], w.shape[0])
        y = y * sx * scale
    else:
        wf = p.get("weight" + DEQUANT_SUFFIX)
        y = F.linear(x.to(_F32), w.to(_F32) if wf is None else wf) * scale
    b = p.get("bias")
    if b is not None:
        y = y + b.to(_F32)
    return y.to(x.dtype)


def linear(p: Params, x: torch.Tensor, *, row_group=None, col_group=None) -> torch.Tensor:
    """y = x @ W.T (+ b), float32 accumulation, result in x.dtype.

    int8 W (+ `##scale`, quantize.quantize_params): the scale multiplies
    the product (`_linear_int8`). Packed int4 W (uint8 + `##scale4`):
    dequantised to x.dtype first, then the float path.

    Under tensor parallelism (the mesh axis, parallel/mesh.py AxisGroup;
    the gradients through parallel/collectives.py):
    row_group: a row-parallel linear: x holds this rank's input columns
    and W the matching weight columns; the f32 products are summed over
    the axis (`reduce_from_model`), then the bias is added once and the
    sum rounded once. col_group: a column-parallel linear: W holds this
    rank's output rows and x is replicated over the axis; x passes
    through `copy_to_model`, so its gradient is summed over the axis."""
    if row_group is not None and row_group.split:
        from parakeet_tpu_torch.parallel.collectives import reduce_from_model

        if not p["weight"].is_floating_point():
            raise ValueError("a row-parallel linear takes float weights")
        trace.count(F32_PRODUCTS, 1)
        y = reduce_from_model(F.linear(x.to(_F32), p["weight"].to(_F32)), row_group)
        b = p.get("bias")
        return (y if b is None else y + b.to(_F32)).to(x.dtype)
    if col_group is not None and col_group.split:
        from parakeet_tpu_torch.parallel.collectives import copy_to_model

        x = copy_to_model(x, col_group)
    w = p["weight"]
    if w.dtype == torch.int8:
        return _linear_int8(p, w, x)
    if w.dtype == torch.uint8:
        from parakeet_tpu_torch.quantize import SCALE4_SUFFIX, dequantize_int4_torch

        wf = p.get("weight" + DEQUANT_SUFFIX)
        w = (dequantize_int4_torch(w, p["weight" + SCALE4_SUFFIX], x.dtype) if wf is None
             else wf.to(x.dtype))
    b = p.get("bias")
    if _bf16_on_card(x, w, b):
        trace.count(BF16_PRODUCTS, 1)
        return _gemm(x, w, b)
    trace.count(F32_PRODUCTS, 1)
    if x.dtype == _F32 and w.dtype == _F32:
        return F.linear(x, w, b)
    return F.linear(x.to(_F32), w.to(_F32), _f32(b)).to(x.dtype)


def hoist_dequant(params: dict, prefixes: tuple[str, ...]) -> dict:
    """`params` with a float32 `##dq` sidecar beside each quantized weight
    under `prefixes`, for a decode loop that runs the same linears every
    step: int8 codes converted once (linear still scales each product),
    int4 weights dequantised once in float32 (linear casts them to x.dtype,
    as dequantize_int4_torch does). Results are identical to converting per
    step. Under W8A8 the int8 codes stay int8 and are not converted."""
    from parakeet_tpu_torch.quantize import SCALE4_SUFFIX, dequantize_int4_torch

    out = dict(params)
    for k, v in params.items():
        if not k.startswith(prefixes) or "##" in k:
            continue
        if v.dtype == torch.int8 and not _INT8_COMPUTE:
            out[k + DEQUANT_SUFFIX] = v.to(_F32)
        elif v.dtype == torch.uint8:
            out[k + DEQUANT_SUFFIX] = dequantize_int4_torch(v, params[k + SCALE4_SUFFIX], _F32)
    return out


def embedding(p: Params, ids: torch.Tensor, *, vocab_group=None) -> torch.Tensor:
    """ids (...,) integer → (..., dim). vocab_group: the mesh axis over
    which the weight's vocab rows are split (tensor parallelism): this
    rank's rows looked up, zero elsewhere, summed over the axis
    (parallel/collectives.py parallel_embedding)."""
    if vocab_group is not None and vocab_group.split:
        from parakeet_tpu_torch.parallel.collectives import parallel_embedding

        return parallel_embedding(p["weight"], ids, vocab_group)
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
    """x: (B, C_in, T) → (B, C_out, T'). Weight: (C_out, C_in/groups, k).
    bf16 on the card: a pointwise conv is one GEMM over x's channel-last
    rows (free when x is the transpose of a (B, T, C) tensor), its output
    that GEMM's (B, T, C_out) transposed; a depthwise conv runs on a
    contiguous x (a strided one would go to cuDNN, which adds the bias to
    the rounded output)."""
    w, b = p["weight"], p.get("bias")
    if _bf16_on_card(x, w, b):
        if w.shape[2] == 1 and stride == 1 and padding == 0 and groups == 1:
            trace.count(BF16_PRODUCTS, 1)
            return _gemm(x.transpose(1, 2), w[:, :, 0], b).transpose(1, 2)
        if groups == x.shape[1] > 1:
            trace.count(BF16_PRODUCTS, 1)
            return F.conv1d(x.contiguous(), w, b, stride=stride, padding=padding, groups=groups)
    trace.count(F32_PRODUCTS, 1)
    y = F.conv1d(x.to(_F32), w.to(_F32), _f32(b), stride=stride, padding=padding, groups=groups)
    return y.to(x.dtype)


def conv2d(
    p: Params,
    x: torch.Tensor,
    *,
    stride: tuple[int, int] = (1, 1),
    padding: tuple[int, int] = (0, 0),
    groups: int = 1,
) -> torch.Tensor:
    """NCHW 2-D conv over torch-layout weights (C_out, C_in/g, kh, kw).
    bf16 on the card: a 1×1 conv is one GEMM over x's channel-last rows,
    its output that GEMM's (B, H, W, C_out) permuted to NCHW (a view); a
    depthwise conv runs on a contiguous x, as conv1d's."""
    w, b = p["weight"], p.get("bias")
    if _bf16_on_card(x, w, b):
        if w.shape[2:] == (1, 1) and _pair(stride) == (1, 1) and _pair(padding) == (0, 0) and groups == 1:
            trace.count(BF16_PRODUCTS, 1)
            return _gemm(x.permute(0, 2, 3, 1), w[:, :, 0, 0], b).permute(0, 3, 1, 2)
        if groups == x.shape[1] > 1:
            trace.count(BF16_PRODUCTS, 1)
            return F.conv2d(x.contiguous(), w, b, stride=stride, padding=padding, groups=groups)
    trace.count(F32_PRODUCTS, 1)
    y = F.conv2d(x.to(_F32), w.to(_F32), _f32(b), stride=stride, padding=padding, groups=groups)
    return y.to(x.dtype)


def glu(x: torch.Tensor, axis: int) -> torch.Tensor:
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


__all__ = [
    "require_ieee_f32",
    "set_int8_compute",
    "int8_matmul",
    "hoist_dequant",
    "linear",
    "embedding",
    "layer_norm",
    "batch_norm_1d",
    "conv1d",
    "conv2d",
    "glu",
    "silu",
]
