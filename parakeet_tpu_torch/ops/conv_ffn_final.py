"""The second half of a conformer block in one call: K4.

Replaces the TPU kernel parakeet_tpu/ops/pallas_block.py::
fused_conv_ffn_final (body _conv_ffn_kernel), which the reference's encoder
runs for every block under set_fused_block2(True) (bench.py
--fused-block2). Per call:

    x2 = x + ConvModule(x), pad rows masked (K5's function) →
    x3 = x2 + 0.5·FFN(x2) (K6's function) → final LayerNorm

Both bodies round to the activation dtype in the reference, so K4's result
is K5's followed by K6's with the final LayerNorm, exactly; the plain
version `fused_conv_ffn_final_reference` is that composition of the two
plain versions. `fused_conv_ffn_final` dispatches on the tensor's device:
CUDA tensors run the hand-written kernel in csrc/conv_ffn_final.cu or
raise, CPU tensors run the plain version. In bf16 the kernel is five
launches of its own (`k4_plan`; see the .cu's note): K5's Hopper sequence
(pw1 with the GLU on the LayerNorm'd rows, the depthwise pass, pw2 closing
in a thread-block cluster that also writes LN_ffn(x2)) and K6's (fc1, and
fc2 closing in a cluster with the final LayerNorm), the GEMMs on wgmma with
TMA loads. In f32 (IEEE FMA on the CUDA cores), and in bf16 where a row
spans more than a cluster's 8 column tiles (D > 1024), it runs K5's
sequence of that route and then K6's in the same C call. What it drops from the TPU kernel: T padded to 128 lanes, the
SMEM length block and whole-array VMEM weight blocks.

On a mesh with a 'model' axis > 1 (parallel/mesh.py) K4 takes the whole
weights, gathered once when the facade is built, and computes its
sublayers replicated over 'model', as XLA's partitioner does around a
kernel it has no rule for (models/encoder.py).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from parakeet_tpu_torch.ops import conv_module as CM
from parakeet_tpu_torch.ops import feed_forward as FF
from parakeet_tpu_torch.ops._build import DTYPE_CODE, check_rc, load, ptr, refuse_grad, stream
from parakeet_tpu_torch.ops.gemm_plan import hopper_fits


@dataclass(frozen=True)
class K4Plan:
    """How K4 launches for (B, T, D, F): K5's plan (`conv`, ops/conv_module.py
    conv_plan) and then K6's with the final LayerNorm (`ffn`,
    ops/feed_forward.py ffn_plan), of the same route: in bf16 where a row
    fits a cluster (`hopper`) the Hopper design, where pw2's cluster also
    writes LN_ffn(x2) and fc1 reads it as it is. `launches`: the kernel
    launches of one call."""

    hopper: bool
    launches: int
    conv: CM.ConvPlan
    ffn: FF.FfnPlan

    def ints(self) -> tuple[int, int, int, int, int]:
        """(hopper, splits, pw1_rows, pw2_splits, pw1_cols), as the C entry
        takes them."""
        hopper, pw1, pw2_splits = self.conv.ints()
        if self.hopper:
            return 1, self.ffn.splits, 0, pw2_splits, pw1
        return 0, self.ffn.splits, pw1, pw2_splits, 0

    def partials(self, m: int, d: int) -> int:
        """f32 elements of the split partials and results the sequences
        share in one buffer (0 for the Hopper design)."""
        return 0 if self.hopper else max(self.ffn.part_elems(m, d), self.conv.partials)


def k4_plan(b: int, t: int, d: int, f: int, itemsize: int = 4) -> K4Plan:
    """K5's plan then K6's with the final LayerNorm. The Hopper design in
    bf16 (gemm_plan.hopper_fits): pw1 (GLU over W1's 2D rows, the LayerNorm
    on its A path), pw2 and fc2 (k split over a cluster that holds every
    column tile of their rows, for LN_ffn and the final LayerNorm), fc1 (N
    = F). At B=8, T'=126, D=512: 128, 128 (clusters of 4 column tiles x 2 k
    slices), 256 and 128 blocks; 5 launches. In f32, and in bf16 rows wider
    than a cluster, K5's and K6's tiled routes (5 and 4 launches)."""
    m = b * t
    hopper = itemsize == 2 and hopper_fits(d)
    conv = CM.conv_plan(m, d, itemsize, ln_out=hopper)
    ffn = FF.ffn_plan(m, d, f, itemsize, final_norm=True)
    return K4Plan(hopper, conv.launches + ffn.launches, conv, ffn)


def fused_conv_ffn_final_reference(
    x: torch.Tensor,  # (B, T, D)
    conv_norm_w, conv_norm_b,  # (D,)
    w1, b1,  # torch Conv1d (2D, D, 1), (2D,)
    wd, bd,  # torch depthwise (D, 1, k), (D,)
    bn_w, bn_b, bn_mean, bn_var,  # (D,)
    w2, b2,  # (D, D, 1), (D,)
    ffn_norm_w, ffn_norm_b,  # (D,)
    fc1_w, fc1_b,  # torch Linear (F, D), (F,)
    fc2_w, fc2_b,  # (D, F), (D,)
    final_norm_w, final_norm_b,  # (D,)
    lengths=None,  # (B,) valid rows (the conv half masks by them)
    eps: float = 1e-5,
) -> torch.Tensor:
    """Plain torch version of the kernel: same signature, same rounding points."""
    x2 = CM.fused_conv_module_reference(x, conv_norm_w, conv_norm_b, w1, b1, wd, bd, bn_w, bn_b,
                                        bn_mean, bn_var, w2, b2, lengths, eps)
    return FF.fused_feed_forward_reference(x2, ffn_norm_w, ffn_norm_b, fc1_w, fc1_b, fc2_w, fc2_b,
                                           final_norm_w, final_norm_b, eps)


def _lib() -> ctypes.CDLL:
    lib = load("conv_ffn_final")
    fn = lib.pk_conv_ffn_final
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [p] * 22 + [ctypes.c_float] + [p] * 6 + [i] * 10 + [p]
        fn.restype = i
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _lib()


def _launch(x, conv_norm_w, conv_norm_b, w1, b1, wd, bd, bn_w, bn_b, bn_mean, bn_var, w2, b2,
            ffn_norm_w, ffn_norm_b, fc1_w, fc1_b, fc2_w, fc2_b, final_norm_w, final_norm_b,
            lengths, eps):
    refuse_grad("fused_conv_ffn_final", x, conv_norm_w, conv_norm_b, w1, b1, wd, bd, bn_w, bn_b, bn_mean, bn_var, w2, b2, ffn_norm_w, ffn_norm_b, fc1_w, fc1_b, fc2_w, fc2_b, final_norm_w, final_norm_b)
    name = "fused_conv_ffn_final"
    x, w1, b1, wd, bd, w2, b2, cvecs, valid = CM.checked_args(
        x, conv_norm_w, conv_norm_b, w1, b1, wd, bd, bn_w, bn_b, bn_mean, bn_var, w2, b2, lengths, name,
        clamp=False)
    _, fc1_w, fc1_b, fc2_w, fc2_b, fvecs = FF.checked_args(
        x, ffn_norm_w, ffn_norm_b, fc1_w, fc1_b, fc2_w, fc2_b, final_norm_w, final_norm_b, name)
    b, t, d = x.shape
    k, f = wd.shape[-1], fc1_w.shape[0]
    dt = x.dtype

    out = torch.empty_like(x)
    h, h2, x2 = (torch.empty_like(x) for _ in range(3))  # each half's LayerNorm output borrows h2, then h
    plan = k4_plan(b, t, d, f, x.element_size())
    hf = torch.empty((b * t, f), dtype=dt, device=x.device)
    n_part = plan.partials(b * t, d)
    part = torch.empty(n_part, dtype=torch.float32, device=x.device) if n_part else None
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.pk_conv_ffn_final(
            DTYPE_CODE[dt], ptr(x), ptr(cvecs[0]), ptr(cvecs[1]), ptr(w1), ptr(b1), ptr(wd), ptr(bd),
            ptr(cvecs[2]), ptr(cvecs[3]), ptr(cvecs[4]), ptr(cvecs[5]), ptr(w2), ptr(b2), ptr(valid),
            ptr(fvecs[0]), ptr(fvecs[1]), ptr(fc1_w), ptr(fc1_b), ptr(fc2_w), ptr(fc2_b),
            ptr(fvecs[2]), ptr(fvecs[3]), float(eps),
            ptr(h), ptr(h2), ptr(x2), ptr(hf), ptr(part), ptr(out), b, t, d, k, f,
            *plan.ints(), stream(x.device),
        )
    check_rc(rc, name)
    fused_conv_ffn_final.launches += 1
    return out


def fused_conv_ffn_final(
    x: torch.Tensor,
    conv_norm_w, conv_norm_b,
    w1, b1,
    wd, bd,
    bn_w, bn_b, bn_mean, bn_var,
    w2, b2,
    ffn_norm_w, ffn_norm_b,
    fc1_w, fc1_b,
    fc2_w, fc2_b,
    final_norm_w, final_norm_b,
    lengths=None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LN_final(x2 + 0.5·FFN(x2)) with x2 = x + ConvModule(x), pad rows
    masked; (B, T, D) in x.dtype.

    On a CUDA tensor this launches the hand-written kernel or raises; on a
    CPU tensor it runs `fused_conv_ffn_final_reference`. Each kernel launch
    adds one to `fused_conv_ffn_final.launches`."""
    args = (x, conv_norm_w, conv_norm_b, w1, b1, wd, bd, bn_w, bn_b, bn_mean, bn_var, w2, b2,
            ffn_norm_w, ffn_norm_b, fc1_w, fc1_b, fc2_w, fc2_b, final_norm_w, final_norm_b,
            lengths, eps)
    if x.device.type == "cuda":
        return _launch(*args)
    if x.device.type == "cpu":
        return fused_conv_ffn_final_reference(*args)
    raise ValueError(f"fused_conv_ffn_final: no implementation for device {x.device}")


fused_conv_ffn_final.launches = 0

__all__ = ["fused_conv_ffn_final", "fused_conv_ffn_final_reference", "build", "K4Plan", "k4_plan"]
