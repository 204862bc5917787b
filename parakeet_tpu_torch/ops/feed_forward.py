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
from parakeet_tpu_torch.ops.gemm_plan import (GEMM_K_STEP, MAX_SPLITS, GemmPlan, HopperPlan, gemm_plan, gemm_smem,
                                               hopper_fits, hopper_plan, tiles)
from parakeet_tpu_torch.ops.kernel_numerics import ffn_body, kernel_layer_norm

_F32 = torch.float32

# the tiled route's fc1 runs on 128 x 128 tiles (csrc/feed_forward.cuh run_ffn)
FC1_ROWS = 128


@dataclass(frozen=True)
class FfnPlan:
    """How K6 launches for (M, D, F): the route, fc1's and fc2's plans, the
    kernel launches of one call and the scratch the wrapper allocates
    (bytes).

    - "hopper" (bf16, gemm_plan.hopper_fits): fc1 + SiLU with the LayerNorm
      on its A path (once a cluster of column tiles, into xn) and fc2 split
      over a thread-block cluster that closes it (spanning the row's column
      tiles when a LayerNorm of the result follows), both on
      hopper_gemm_kernel: 2 launches; scratch xn (M, D) and h (M, F).
    - "tiled" (f32; bf16 rows wider than a cluster): the LayerNorm, fc1 on
      128-row tiles, fc2 in k slices of f32 partials (gemm_plan: at B=8,
      110m widths, 8 slices at T'=126, 2 at T'=751, 1 from T'=1001) and the
      closing pass: 4 launches; scratch xn, h and the partials."""

    route: str
    launches: int
    fc1: GemmPlan | HopperPlan
    fc2: GemmPlan | HopperPlan
    scratch: int

    @property
    def splits(self) -> int:
        return self.fc2.splits

    def ints(self) -> tuple[int, int, int]:
        """(hopper, fc1_cols, splits), as the C entries take them: fc1_cols
        is the Hopper design's LayerNorm cluster of column tiles (0 on the
        tiled route)."""
        if self.route == "hopper":
            return 1, self.fc1.cluster_cols, self.fc2.splits
        return 0, 0, self.fc2.splits

    def part_elems(self, m: int, d: int) -> int:
        """f32 elements of fc2's partials (the tiled route; 0 on the Hopper
        route, whose fc2 closes in its cluster)."""
        return self.fc2.splits * m * d if self.route == "tiled" else 0


def ffn_plan(m: int, d: int, f: int, itemsize: int = 4, final_norm: bool = False) -> FfnPlan:
    """K6's plan for (M, D, F) in the dtype of `itemsize`, with or without a
    LayerNorm of the result (the final one; K7's LN_attn) in fc2's cluster
    (see FfnPlan for the routes). At B=8, T'=126, 110m widths in bf16: fc1
    in 256 blocks (LayerNorm clusters of 2 column tiles), fc2 in 128 (2 k
    slices in clusters of 2; of 4 column tiles x 2 with the final
    LayerNorm)."""
    if itemsize == 2 and hopper_fits(d):
        fc1 = hopper_plan(m, f, d, "silu", ln=True)
        fc2 = hopper_plan(m, d, f, "linear", whole_rows=final_norm)
        return FfnPlan("hopper", 2, fc1, fc2, (m * d + m * f) * 2)
    fc1 = GemmPlan(FC1_ROWS, 1, gemm_smem(FC1_ROWS, itemsize), tiles(m, f, FC1_ROWS))
    fc2 = gemm_plan(m, d, f, itemsize)
    return FfnPlan("tiled", 4, fc1, fc2, (m * d + m * f) * itemsize + fc2.splits * m * d * 4)


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
        fn.argtypes = [i] + [p] * 9 + [ctypes.c_float] + [p] * 4 + [i] * 6 + [p]
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
    plan = ffn_plan(m, d, f, x.element_size(), final_norm_w is not None)
    xn = torch.empty((m, d), dtype=dt, device=x.device)
    h = torch.empty((m, f), dtype=dt, device=x.device)
    part = torch.empty(plan.part_elems(m, d), dtype=_F32, device=x.device) if plan.part_elems(m, d) else None
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.pk_feed_forward(
            DTYPE_CODE[dt], ptr(x), ptr(norms[0]), ptr(norms[1]), ptr(w1), ptr(b1),
            ptr(w2), ptr(b2), ptr(norms[2]), ptr(norms[3]), float(eps),
            ptr(xn), ptr(h), ptr(part), ptr(out), m, d, f, *plan.ints(), stream(x.device),
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

__all__ = ["fused_feed_forward", "fused_feed_forward_reference", "build", "FfnPlan", "ffn_plan", "FC1_ROWS",
           "GEMM_K_STEP", "MAX_SPLITS"]
