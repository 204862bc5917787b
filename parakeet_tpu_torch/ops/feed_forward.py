"""Fused macaron feed-forward (+ optional final LayerNorm): K6.

Replaces the TPU kernel parakeet_tpu/ops/pallas_ffn.py::fused_feed_forward
(body _ffn_kernel / pallas_utils.ffn_body), which the reference's encoder
runs for ffn1 and, with the block's final LayerNorm fused in, for ffn2
when set_fused_ffn(True) (bench.py --fused-ffn). Per call:

    LN(x) (f32 statistics) → fc1 + b1 → round → SiLU (f32 sigmoid) → round
    → fc2 + b2 → x + 0.5·y in f32 → round [→ final LN → round]

`fused_feed_forward` dispatches on the tensor's device: CUDA tensors run
the hand-written kernel in csrc/feed_forward.cu (or raise), CPU tensors run
`fused_feed_forward_reference`, the plain torch version built from
ops/kernel_numerics.py with the TPU kernel's rounding points. What bounds
the kernel on the card and how its design answers that is at the top of
the .cu source. What it drops from the TPU kernel: T padded to 128 lanes,
whole-array VMEM weight blocks and the caller's guards (T ≥ 64, 8 MiB of
weights); it takes any T and any width.

On a mesh with a 'model' axis > 1 (parallel/mesh.py) K6 takes the whole FFN
weights, gathered once when the facade is built, and computes its
sublayer replicated over 'model', as XLA's partitioner does around a
kernel it has no rule for (models/encoder.py); only the plain FFN is split.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from parakeet_tpu_torch.ops._build import DTYPE_CODE, check_rc, load, ptr, refuse_grad, stream
from parakeet_tpu_torch.ops.gemm_plan import GEMM_K_STEP, MAX_SPLITS, gemm_plan
from parakeet_tpu_torch.ops.kernel_numerics import ffn_body, kernel_layer_norm

_F32 = torch.float32

# fc1 and fc2 run on csrc/ffn_gemm.cuh's 128 x 128 tiles (fc1 keeps them
# rather than the plan's rows for nonlinear epilogues, so K6's launches stay
# as they were)
GEMM_TILE = (128, 128)


@dataclass(frozen=True)
class FfnPlan:
    """How K6 launches for (M, D, F): fc2's k slices, the GEMMs' shared
    memory per block and the scratch the wrapper allocates (bytes)."""

    tile: tuple[int, int]
    splits: int
    smem: int
    scratch: int


def ffn_plan(m: int, d: int, f: int, itemsize: int = 4) -> FfnPlan:
    """fc2 (N = D, K = F) is cut into k slices by the shared GEMM plan
    (ops/gemm_plan.py gemm_plan: at B=8, 110m widths, 8 slices at T'=126,
    2 at T'=751, 1 from T'=1001). Scratch: the LayerNorm output (M, D) and
    the hidden (M, F) in the activation dtype, fc2's f32 partials (splits,
    M, D)."""
    fc2 = gemm_plan(m, d, f, itemsize)
    scratch = (m * d + m * f) * itemsize + fc2.splits * m * d * 4
    return FfnPlan(GEMM_TILE, fc2.splits, fc2.smem, scratch)


def fused_feed_forward_reference(
    x: torch.Tensor,  # (B, T, D)
    norm_w, norm_b,  # (D,)
    w1, b1,  # torch Linear (F, D), (F,)
    w2, b2,  # (D, F), (D,)
    final_norm_w=None, final_norm_b=None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Plain torch version of the kernel: same signature, same rounding points."""
    out = ffn_body(x, norm_w, norm_b, w1, b1, w2, b2, eps)
    if final_norm_w is not None:
        out = kernel_layer_norm(out, final_norm_w, final_norm_b, eps)
    return out


def _lib() -> ctypes.CDLL:
    lib = load("feed_forward")
    fn = lib.pk_feed_forward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [p] * 9 + [ctypes.c_float] + [p] * 4 + [i] * 4 + [p]
        fn.restype = i
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _lib()


def checked_args(x, norm_w, norm_b, w1, b1, w2, b2, final_norm_w=None, final_norm_b=None,
                 name: str = "fused_feed_forward"):
    """The kernel's operands, checked against x and made contiguous: the
    weights in x's dtype and device, the four norm vectors in f32 (None
    where not given). Raises on what the kernel does not take. Shared with
    the kernels that run the FFN sequence (K4, K7)."""
    d = x.shape[-1]
    f = w1.shape[0]
    dt = x.dtype
    if dt not in DTYPE_CODE:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {dt}")
    shapes = dict(w1=(f, d), b1=(f,), w2=(d, f), b2=(d,))
    for key, w in dict(w1=w1, b1=b1, w2=w2, b2=b2).items():
        if w.device != x.device or w.dtype != dt:
            raise ValueError(f"{name}: {key} is {w.dtype} on {w.device}, x is {dt} on {x.device}")
        if tuple(w.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(w.shape)}, want {shapes[key]}")
    norms = [norm_w, norm_b, final_norm_w, final_norm_b]
    norms = [None if v is None else v.to(device=x.device, dtype=_F32).contiguous() for v in norms]
    return (*(a.contiguous() for a in (x, w1, b1, w2, b2)), norms)


def _launch(x, norm_w, norm_b, w1, b1, w2, b2, final_norm_w, final_norm_b, eps):
    refuse_grad("fused_feed_forward", x, norm_w, norm_b, w1, b1, w2, b2, final_norm_w, final_norm_b)
    x, w1, b1, w2, b2, norms = checked_args(x, norm_w, norm_b, w1, b1, w2, b2, final_norm_w, final_norm_b)
    b, t, d = x.shape
    f = w1.shape[0]
    dt = x.dtype

    m = b * t
    out = torch.empty_like(x)
    plan = ffn_plan(m, d, f, x.element_size())
    xn = torch.empty((m, d), dtype=dt, device=x.device)
    h = torch.empty((m, f), dtype=dt, device=x.device)
    part = torch.empty((plan.splits, m, d), dtype=_F32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.pk_feed_forward(
            DTYPE_CODE[dt], ptr(x), ptr(norms[0]), ptr(norms[1]), ptr(w1), ptr(b1),
            ptr(w2), ptr(b2), ptr(norms[2]), ptr(norms[3]), float(eps),
            ptr(xn), ptr(h), ptr(part), ptr(out), m, d, f, plan.splits, stream(x.device),
        )
    check_rc(rc, "fused_feed_forward")
    fused_feed_forward.launches += 1
    return out


def fused_feed_forward(
    x: torch.Tensor,
    norm_w, norm_b,
    w1, b1,
    w2, b2,
    final_norm_w=None, final_norm_b=None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """x + 0.5·FFN(LN(x)), then the final LayerNorm when its weights are
    given; (B, T, D) in x.dtype.

    On a CUDA tensor this launches the hand-written kernel or raises; on a
    CPU tensor it runs `fused_feed_forward_reference`. Each kernel launch
    adds one to `fused_feed_forward.launches`."""
    args = (x, norm_w, norm_b, w1, b1, w2, b2, final_norm_w, final_norm_b, eps)
    if x.device.type == "cuda":
        return _launch(*args)
    if x.device.type == "cpu":
        return fused_feed_forward_reference(*args)
    raise ValueError(f"fused_feed_forward: no implementation for device {x.device}")


fused_feed_forward.launches = 0

__all__ = ["fused_feed_forward", "fused_feed_forward_reference", "build", "FfnPlan", "ffn_plan",
           "GEMM_K_STEP", "MAX_SPLITS"]
