"""Fused front of the conv subsampling (conv1 → dw1 → conv2): K8.

Replaces the TPU kernel parakeet_tpu/ops/pallas_subsample.py::
fused_subsample_block1 (body _subsample_kernel, host prep _im2col_blocked),
which the reference's encoder runs once per call under
set_fused_subsample(True) (bench.py --fused-subsample). On mel x (B, T, F):

    conv1 3×3/s2, 1→C, f32 from x, bias rounded to the activation dtype,
    output not rounded and exactly 0 outside [0, T2) × [0, F2) → act →
    depthwise 3×3/s2 accumulated in f32 from bd → round → pointwise conv2
    C→C + b2 (rounded) → act → round

with act ReLU or SiLU. It returns NCHW (B, C, T4, F4), the layout the
port's subsampling continues in (the TPU kernel returns NHWC).

`fused_subsample_block1` dispatches on the tensor's device: CUDA tensors
run the hand-written kernel in csrc/subsample.cu (or raise), CPU tensors
run `fused_subsample_block1_reference`, the plain torch version with the
same rounding points. What bounds the kernel on the card and how its design
answers that is at the top of the .cu source: conv2 runs on the shared
tiled GEMM (csrc/ffn_gemm.cuh) with the block rows of `subsample_plan`.
What it drops from the TPU kernel: the blocked, parity-ordered im2col with
its validity-gate column and the T4 tiles; it takes any T and any F. The
caller's guards (T4 ≥ 32, even F2) are the encoder's, as in the reference
(models/encoder.py).

On a mesh K8 runs on each rank before any split: the tensor-parallel
rules leave the subsampling whole, and a 'seq' axis splits the frames only
after it (models/encoder.py).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from parakeet_tpu_torch.ops._build import DTYPE_CODE, check_rc, load, refuse_grad, stream
from parakeet_tpu_torch.ops.gemm_plan import GemmPlan, gemm_plan

_F32 = torch.float32
_ACT_CODE = {"relu": 0, "silu": 1}


def _act(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "relu":
        return torch.relu(x)
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _check_activation(activation: str) -> None:
    if activation not in _ACT_CODE:
        raise ValueError(f"activation must be one of {sorted(_ACT_CODE)}, got {activation!r}")


def fused_subsample_block1_reference(
    x: torch.Tensor,  # (B, T, F) mel features
    w1, b1,  # torch Conv2d (C, 1, 3, 3), (C,)
    wd, bd,  # torch depthwise (C, 1, 3, 3), (C,)
    w2, b2,  # torch pointwise (C, C, 1, 1), (C,)
    activation: str = "relu",
) -> torch.Tensor:
    """Plain torch version of the kernel: same signature, same rounding
    points; (B, C, T4, F4) in x.dtype."""
    _check_activation(activation)
    dt = x.dtype
    c = w1.shape[0]

    def rounded(w):  # weight rounded to the activation dtype, math in f32
        return w.to(dt).to(_F32)

    y1 = F.conv2d(x.to(_F32)[:, None], rounded(w1), rounded(b1), stride=2, padding=1)
    y1 = _act(y1, activation)  # f32, not rounded; dw1's padding is exact zeros
    y2 = F.conv2d(y1, wd.to(_F32), bd.to(_F32), stride=2, padding=1, groups=c).to(dt)
    z = F.conv2d(y2.to(_F32), rounded(w2), rounded(b2))
    return _act(z, activation).to(dt)


def out_size(n: int) -> int:
    """Frames (or bins) after two 3×3 stride-2 convolutions with padding 1."""
    return ((n - 1) // 2) // 2 + 1


def subsample_plan(m: int, c: int, itemsize: int = 4) -> GemmPlan:
    """How K8's conv2 launches (ops/gemm_plan.py) for m = B·T4·F4 positions
    and C channels: a (m, C) × (C, C) GEMM with a nonlinear epilogue, so no
    split; the 64-, 96- or 128-row tiles that load the busiest SM least."""
    return gemm_plan(m, c, c, itemsize, split_k=False)


def _lib() -> ctypes.CDLL:
    lib = load("subsample")
    fn = lib.pk_subsample_block1
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [p] * 7 + [i] + [p] * 2 + [i] * 5 + [p]
        fn.restype = i
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _lib()


def _launch(x, w1, b1, wd, bd, w2, b2, activation):
    refuse_grad("fused_subsample_block1", x, w1, b1, wd, bd, w2, b2)
    b, t, f = x.shape
    c = w1.shape[0]
    dt = x.dtype
    if dt not in DTYPE_CODE:
        raise TypeError(f"fused_subsample_block1 kernel takes float32 or bfloat16, got {dt}")
    shapes = dict(w1=(w1, (c, 1, 3, 3)), b1=(b1, (c,)), wd=(wd, (c, 1, 3, 3)), bd=(bd, (c,)),
                  w2=(w2, (c, c, 1, 1)), b2=(b2, (c,)))
    for name, (w, shape) in shapes.items():
        if w.device != x.device or not w.is_floating_point():
            raise ValueError(f"fused_subsample_block1: {name} is {w.dtype} on {w.device}, x is on {x.device}")
        if tuple(w.shape) != shape:
            raise ValueError(f"fused_subsample_block1: {name} has shape {tuple(w.shape)}, want {shape}")
    x = x.contiguous()
    w1m, b1v, w2m, b2v = (w.to(dt).reshape(c, -1).contiguous() for w in (w1, b1, w2, b2))
    wdm, bdv = (w.to(_F32).reshape(c, -1).contiguous() for w in (wd, bd))
    t4, f4 = out_size(t), out_size(f)
    plan = subsample_plan(b * t4 * f4, c, x.element_size())

    out = torch.empty((b, c, t4, f4), dtype=dt, device=x.device)
    y2 = torch.empty((b * t4 * f4, c), dtype=dt, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.pk_subsample_block1(
            DTYPE_CODE[dt], x.data_ptr(), w1m.data_ptr(), b1v.data_ptr(), wdm.data_ptr(),
            bdv.data_ptr(), w2m.data_ptr(), b2v.data_ptr(), _ACT_CODE[activation],
            y2.data_ptr(), out.data_ptr(), b, t, f, c, plan.rows, stream(x.device),
        )
    check_rc(rc, "fused_subsample_block1")
    fused_subsample_block1.launches += 1
    return out


def fused_subsample_block1(
    x: torch.Tensor,
    w1, b1,
    wd, bd,
    w2, b2,
    activation: str = "relu",
) -> torch.Tensor:
    """conv1 → act → dw1 → conv2 → act on mel (B, T, F); (B, C, T4, F4).

    On a CUDA tensor this launches the hand-written kernel or raises; on a
    CPU tensor it runs `fused_subsample_block1_reference`. Each kernel
    launch adds one to `fused_subsample_block1.launches`."""
    _check_activation(activation)
    args = (x, w1, b1, wd, bd, w2, b2, activation)
    if x.device.type == "cuda":
        return _launch(*args)
    if x.device.type == "cpu":
        return fused_subsample_block1_reference(*args)
    raise ValueError(f"fused_subsample_block1: no implementation for device {x.device}")


fused_subsample_block1.launches = 0

__all__ = ["subsample_plan", "out_size", "fused_subsample_block1",
           "fused_subsample_block1_reference", "build"]
