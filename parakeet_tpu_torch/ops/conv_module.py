"""Fused conformer conv module: K5.

Replaces the TPU kernel parakeet_tpu/ops/pallas_conv.py::fused_conv_module
(body _conv_module_kernel / pallas_utils.conv_module_body), which the
reference's encoder runs for every conformer layer under
set_conv_layout("pallas") (bench.py --conv-layout pallas). Per call:

    LN(x) → pointwise d→2d + b1 → round → GLU a·sigmoid_f32(g) → round →
    rows at or past min(len_b, T) set to 0 → k-tap depthwise over time in
    f32 + bd → inference BatchNorm folded to (scale, bias), each rounded →
    round → SiLU → round → pointwise d→d + b2 → x + o in f32 → round

`fused_conv_module` dispatches on the tensor's device: CUDA tensors run the
hand-written kernel in csrc/conv_module.cu (or raise), CPU tensors run
`fused_conv_module_reference`, the plain torch version built from
ops/kernel_numerics.py with the TPU kernel's rounding points. What bounds
the kernel on the card and how its design answers that is at the top of the
.cu source. What it drops from the TPU kernel: T padded to 128 lanes, the
SMEM length block, the tap-major depthwise weight padded to 8 sublanes and
whole-array VMEM weight blocks; it takes any T, any width and any odd k.

On a mesh with a 'model' axis > 1 (parallel/mesh.py) K5 takes the whole
conv-module weights, gathered once when the facade is built, and computes
its sublayer replicated over 'model', as XLA's partitioner does around a
kernel it has no rule for (models/encoder.py); only the plain conv module
is split.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from parakeet_tpu_torch.ops._build import DTYPE_CODE, check_rc, load, ptr, refuse_grad, stream
from parakeet_tpu_torch.ops.gemm_plan import GemmPlan, HopperPlan, gemm_plan, hopper_fits, hopper_plan, partial_elems
from parakeet_tpu_torch.ops.kernel_numerics import conv_module_body, fold_batch_norm

_F32 = torch.float32


def _valid_rows(lengths, b: int, t: int, device, clamp: bool = True) -> torch.Tensor:
    """(B,) int32 valid row counts, min(len_b, T) (clamp=False: as given,
    for a kernel that takes the min itself); all T without lengths."""
    if lengths is None:
        return torch.full((b,), t, dtype=torch.int32, device=device)
    lengths = torch.as_tensor(lengths, device=device).to(torch.int32)
    return lengths.clamp(max=t) if clamp else lengths


def fused_conv_module_reference(
    x: torch.Tensor,  # (B, T, D)
    norm_w, norm_b,  # (D,)
    w1, b1,  # torch Conv1d (2D, D, 1), (2D,)
    wd, bd,  # torch depthwise (D, 1, k), (D,)
    bn_w, bn_b, bn_mean, bn_var,  # (D,)
    w2, b2,  # (D, D, 1), (D,)
    lengths=None,  # (B,) valid rows
    eps: float = 1e-5,
) -> torch.Tensor:
    """Plain torch version of the kernel: same signature, same rounding points."""
    b, t, d = x.shape
    k = wd.shape[-1]
    scale, bias = fold_batch_norm(bn_w, bn_b, bn_mean, bn_var, d, x.dtype)
    return conv_module_body(
        x, _valid_rows(lengths, b, t, x.device), norm_w, norm_b, w1[:, :, 0], b1,
        wd[:, 0, :].transpose(0, 1), bd, scale, bias, w2[:, :, 0], b2, eps, k,
    )


@dataclass(frozen=True)
class ConvPlan:
    """How K5 launches for (M, D): the route ("hopper" or "tiled", as K6's),
    pw1's and pw2's plans, the kernel launches of one call and the f32
    partials the wrapper allocates.

    - "hopper" (bf16, gemm_plan.hopper_fits): pw1 + GLU with the LayerNorm
      on its A path (hopper_gemm_kernel; once a cluster of column tiles,
      into h2), the depthwise pass, pw2 split over a thread-block cluster
      that closes it (spanning the row's column tiles when a LayerNorm of
      the result follows: K4's LN_ffn): 3 launches, no partials.
    - "tiled" (f32; bf16 rows wider than a cluster): the LayerNorm, pw1 +
      GLU on the 64-, 96- or 128-row tiles that load the busiest SM least
      (no split), the depthwise pass, pw2 in k slices of f32 partials and
      its closing pass: 5 launches."""

    route: str
    launches: int
    pw1: GemmPlan | HopperPlan
    pw2: GemmPlan | HopperPlan
    partials: int

    def ints(self) -> tuple[int, int, int]:
        """(hopper, pw1_rows, pw2_splits), as the C entries take them:
        pw1_rows is pw1's block rows on the tiled route, the column tiles
        of its LayerNorm cluster on the Hopper route."""
        if self.route == "hopper":
            return 1, self.pw1.cluster_cols, self.pw2.splits
        return 0, self.pw1.rows, self.pw2.splits


def conv_plan(m: int, d: int, itemsize: int = 4, ln_out: bool = False) -> ConvPlan:
    """K5's plan for (M, D) in the dtype of `itemsize`; ln_out: a LayerNorm
    of the result follows in pw2's cluster (K4's bf16 Hopper design). At
    B=8, T'=126, D=512 in bf16: pw1 in 128 blocks of 64 GLU outputs
    (LayerNorm clusters of 8 column tiles), pw2 in 128 (2 k slices in
    clusters of 2)."""
    if itemsize == 2 and hopper_fits(d):
        return ConvPlan("hopper", 3, hopper_plan(m, 2 * d, d, "glu", ln=True),
                        hopper_plan(m, d, d, "linear", whole_rows=ln_out), 0)
    pw1 = gemm_plan(m, 2 * d, d, itemsize, split_k=False)
    pw2 = gemm_plan(m, d, d, itemsize)
    return ConvPlan("tiled", 5, pw1, pw2, partial_elems(m, d, pw2))


def _lib() -> ctypes.CDLL:
    lib = load("conv_module")
    fn = lib.pk_conv_module
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [p] * 14 + [ctypes.c_float] + [p] * 4 + [i] * 7 + [p]
        fn.restype = i
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _lib()


def checked_args(x, norm_w, norm_b, w1, b1, wd, bd, bn_w, bn_b, bn_mean, bn_var, w2, b2, lengths,
                 name: str = "fused_conv_module", clamp: bool = True):
    """The kernel's operands, checked against x and made contiguous:
    (x, w1, b1, wd, bd, w2, b2) in x's dtype, the six norm and BN vectors
    in f32, and the (B,) int32 valid row counts. Raises on what the kernel
    does not take. Shared with K4, whose kernels take min(len, T)
    themselves (clamp=False leaves the lengths as given)."""
    b, t, d = x.shape
    k = wd.shape[-1]
    dt = x.dtype
    if dt not in DTYPE_CODE:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {dt}")
    if k % 2 == 0:
        raise ValueError(f"{name} kernel: depthwise kernel size {k} must be odd")
    mats = dict(w1=(w1, (2 * d, d, 1)), b1=(b1, (2 * d,)), wd=(wd, (d, 1, k)), bd=(bd, (d,)),
                w2=(w2, (d, d, 1)), b2=(b2, (d,)))
    for key, (w, shape) in mats.items():
        if w.device != x.device or w.dtype != dt:
            raise ValueError(f"{name}: {key} is {w.dtype} on {w.device}, x is {dt} on {x.device}")
        if tuple(w.shape) != shape:
            raise ValueError(f"{name}: {key} has shape {tuple(w.shape)}, want {shape}")
    tensors = tuple(a.contiguous() for a in (x, w1, b1, wd, bd, w2, b2))
    vecs = [v.to(device=x.device, dtype=_F32).contiguous() for v in (norm_w, norm_b, bn_w, bn_b, bn_mean, bn_var)]
    return (*tensors, vecs, _valid_rows(lengths, b, t, x.device, clamp).contiguous())


def _launch(x, norm_w, norm_b, w1, b1, wd, bd, bn_w, bn_b, bn_mean, bn_var, w2, b2, lengths, eps):
    refuse_grad("fused_conv_module", x, norm_w, norm_b, w1, b1, wd, bd, bn_w, bn_b, bn_mean, bn_var, w2, b2)
    x, w1, b1, wd, bd, w2, b2, vecs, valid = checked_args(
        x, norm_w, norm_b, w1, b1, wd, bd, bn_w, bn_b, bn_mean, bn_var, w2, b2, lengths, clamp=False)
    b, t, d = x.shape
    k = wd.shape[-1]
    dt = x.dtype

    out = torch.empty_like(x)
    plan = conv_plan(b * t, d, x.element_size())
    part = torch.empty(plan.partials, dtype=_F32, device=x.device) if plan.partials else None
    h, h2 = torch.empty_like(x), torch.empty_like(x)  # h2 also holds the wide route's LayerNorm output
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.pk_conv_module(
            DTYPE_CODE[dt], ptr(x), ptr(vecs[0]), ptr(vecs[1]), ptr(w1), ptr(b1),
            ptr(wd), ptr(bd), ptr(vecs[2]), ptr(vecs[3]), ptr(vecs[4]), ptr(vecs[5]),
            ptr(w2), ptr(b2), ptr(valid), float(eps), ptr(part), ptr(h), ptr(h2),
            ptr(out), b, t, d, k, *plan.ints(), stream(x.device),
        )
    check_rc(rc, "fused_conv_module")
    fused_conv_module.launches += 1
    return out


def fused_conv_module(
    x: torch.Tensor,
    norm_w, norm_b,
    w1, b1,
    wd, bd,
    bn_w, bn_b, bn_mean, bn_var,
    w2, b2,
    lengths=None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """x + ConvModule(x) with pad rows masked, (B, T, D) in x.dtype.

    On a CUDA tensor this launches the hand-written kernel or raises; on a
    CPU tensor it runs `fused_conv_module_reference`. Each kernel launch
    adds one to `fused_conv_module.launches`."""
    args = (x, norm_w, norm_b, w1, b1, wd, bd, bn_w, bn_b, bn_mean, bn_var, w2, b2, lengths, eps)
    if x.device.type == "cuda":
        return _launch(*args)
    if x.device.type == "cpu":
        return fused_conv_module_reference(*args)
    raise ValueError(f"fused_conv_module: no implementation for device {x.device}")


fused_conv_module.launches = 0

__all__ = ["fused_conv_module", "fused_conv_module_reference", "build", "ConvPlan", "conv_plan"]
