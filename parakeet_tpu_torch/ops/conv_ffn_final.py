"""The second half of a conformer block in one call: K4.

Replaces the TPU kernel parakeet_tpu/ops/pallas_block.py::
fused_conv_ffn_final (body _conv_ffn_kernel), which the reference's encoder
runs for every block under set_fused_block2(True) (bench.py
--fused-block2). Per call:

    x2 = x + ConvModule(x), pad rows masked (K5's function) →
    x3 = x2 + 0.5·FFN(x2) (K6's function) → final LayerNorm

Both bodies round to the activation dtype in the reference, so K4 is K5
followed by K6 with the final LayerNorm, exactly; the plain version
`fused_conv_ffn_final_reference` is that composition of the two plain
versions. `fused_conv_ffn_final` dispatches on the tensor's device: CUDA
tensors run the hand-written kernel in csrc/conv_ffn_final.cu (the launch
sequences of K5 and K6 in one C call, see its note) or raise, CPU tensors
run the plain version. What it drops from the TPU kernel: T padded to 128
lanes, the SMEM length block and whole-array VMEM weight blocks.

On a mesh with a 'model' axis > 1 (parallel/mesh.py) K4 takes the whole
weights, gathered once when the facade is built, and computes its
sublayers replicated over 'model', as XLA's partitioner does around a
kernel it has no rule for (models/encoder.py).
"""

from __future__ import annotations

import ctypes

import torch

from parakeet_tpu_torch.ops import conv_module as CM
from parakeet_tpu_torch.ops import feed_forward as FF
from parakeet_tpu_torch.ops._build import DTYPE_CODE, check_rc, load, ptr, refuse_grad, stream

_F32 = torch.float32


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
        fn.argtypes = [i] + [p] * 22 + [ctypes.c_float] + [p] * 6 + [i] * 8 + [p]
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
        x, conv_norm_w, conv_norm_b, w1, b1, wd, bd, bn_w, bn_b, bn_mean, bn_var, w2, b2, lengths, name)
    _, fc1_w, fc1_b, fc2_w, fc2_b, fvecs = FF.checked_args(
        x, ffn_norm_w, ffn_norm_b, fc1_w, fc1_b, fc2_w, fc2_b, final_norm_w, final_norm_b, name)
    b, t, d = x.shape
    k, f = wd.shape[-1], fc1_w.shape[0]
    dt = x.dtype

    out = torch.empty_like(x)
    h, h2, x2 = (torch.empty_like(x) for _ in range(3))
    # the FFN half's LayerNorm output reuses h (see csrc/conv_ffn_final.cu)
    plan = FF.ffn_plan(b * t, d, f, x.element_size())
    conv = CM.conv_plan(b * t, d, x.element_size())
    hf = torch.empty((b * t, f), dtype=dt, device=x.device)
    # pw2's partials, then fc2's: one buffer for both
    part = torch.empty(max(plan.splits * b * t * d, conv.partials), dtype=_F32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.pk_conv_ffn_final(
            DTYPE_CODE[dt], ptr(x), ptr(cvecs[0]), ptr(cvecs[1]), ptr(w1), ptr(b1), ptr(wd), ptr(bd),
            ptr(cvecs[2]), ptr(cvecs[3]), ptr(cvecs[4]), ptr(cvecs[5]), ptr(w2), ptr(b2), ptr(valid),
            ptr(fvecs[0]), ptr(fvecs[1]), ptr(fc1_w), ptr(fc1_b), ptr(fc2_w), ptr(fc2_b),
            ptr(fvecs[2]), ptr(fvecs[3]), float(eps),
            ptr(h), ptr(h2), ptr(x2), ptr(hf), ptr(part), ptr(out), b, t, d, k, f,
            plan.splits, *conv.ints(), stream(x.device),
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

__all__ = ["fused_conv_ffn_final", "fused_conv_ffn_final_reference", "build"]
