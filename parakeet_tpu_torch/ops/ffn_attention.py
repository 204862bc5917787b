"""ffn1 and the attention sublayer of a conformer block in one call: K7.

Replaces the TPU kernel parakeet_tpu/ops/pallas_attention.py::
fused_ffn_attention (body _ffn_attn_kernel), which the reference's encoder
runs for every block under set_fused_attention("mega") (bench.py
--fused-mode mega). Per call:

    x2 = x + 0.5·FFN(LN(x)) (K6's function, no final LayerNorm) →
    out = x2 + Attention(LN(x2)) (K1's function with the fused pre-LN; the
    residual is x2, not x)

ffn_body rounds to the activation dtype in the reference, so K7 is K6
followed by K1, exactly; the plain version `fused_ffn_attention_reference`
is that composition of the two plain versions. `fused_ffn_attention`
dispatches on the tensor's device: CUDA tensors run the hand-written
kernel in csrc/ffn_attention.cu (the launch sequences of K6 and K1 in one
C call, see its note) or raise, CPU tensors run the plain version. The
reference's core scores the position term by the angle-addition
factorisation of the sinusoidal table; the port gathers projected table
rows (K1). The two agree to f32 rounding; in bf16 they round the table at
different points.

On a mesh with a 'model' axis > 1 (parallel/mesh.py) K7 takes the whole
weights, gathered once when the facade is built, and computes ffn1 and
the attention replicated over 'model', as XLA's partitioner does around a
kernel it has no rule for (models/encoder.py); K1 alone has a
head-sharded mode.
"""

from __future__ import annotations

import ctypes

import torch

from parakeet_tpu_torch.ops import feed_forward as FF
from parakeet_tpu_torch.ops import rel_attention as RA
from parakeet_tpu_torch.ops._build import DTYPE_CODE, check_rc, load, ptr, refuse_grad, stream


def fused_ffn_attention_reference(
    x: torch.Tensor,  # (B, T, D) block input
    ffn_norm_w, ffn_norm_b,  # (D,)
    fc1_w, fc1_b,  # torch Linear (F, D), (F,)
    fc2_w, fc2_b,  # (D, F), (D,)
    attn_norm_w, attn_norm_b,  # (D,)
    wq, bq, wk, bk, wv, bv,  # (D, D) / (D,)
    bias_u, bias_v,  # (H, hd)
    pos_w,  # (D, D) pos_proj weight, bias-free
    wo, bo,
    lengths=None,  # (B,) valid key counts
    eps: float = 1e-5,
) -> torch.Tensor:
    """Plain torch version of the kernel: same signature, same rounding points."""
    x2 = FF.fused_feed_forward_reference(x, ffn_norm_w, ffn_norm_b, fc1_w, fc1_b, fc2_w, fc2_b, eps=eps)
    return RA.rel_attention_block_reference(x2, wq, bq, wk, bk, wv, bv, bias_u, bias_v, pos_w, wo, bo,
                                            lengths, attn_norm_w, attn_norm_b, eps)


def _lib() -> ctypes.CDLL:
    lib = load("ffn_attention")
    fn = lib.pk_ffn_attention
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [p] * 9 + [ctypes.c_float] + [p] * 23 + [i] * 9 + [p]
        fn.restype = i
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _lib()


def _launch(x, ffn_norm_w, ffn_norm_b, fc1_w, fc1_b, fc2_w, fc2_b, attn_norm_w, attn_norm_b,
            wq, bq, wk, bk, wv, bv, bias_u, bias_v, pos_w, wo, bo, lengths, eps):
    refuse_grad("fused_ffn_attention", x, ffn_norm_w, ffn_norm_b, fc1_w, fc1_b, fc2_w, fc2_b, attn_norm_w, attn_norm_b, wq, bq, wk, bk, wv, bv, bias_u, bias_v, pos_w, wo, bo)
    name = "fused_ffn_attention"
    x, fc1_w, fc1_b, fc2_w, fc2_b, fvecs = FF.checked_args(
        x, ffn_norm_w, ffn_norm_b, fc1_w, fc1_b, fc2_w, fc2_b, name=name)
    a = RA.checked_args(x, wq, bq, wk, bk, wv, bv, bias_u, bias_v, pos_w, wo, bo, lengths,
                        attn_norm_w, attn_norm_b, name)
    b, t, d = x.shape
    heads, hd = bias_u.shape
    f = fc1_w.shape[0]
    dt = x.dtype

    out = torch.empty_like(x)
    hf = torch.empty((b * t, f), dtype=dt, device=x.device)
    plan = FF.ffn_plan(b * t, d, f, x.element_size())
    attn = RA.block_plan(b, t, d, x.element_size())
    # fc2's partials, then the attention half's: one buffer for both
    part = torch.empty(max(plan.splits * b * t * d, attn.partials), dtype=torch.float32, device=x.device)
    x2, ctx = torch.empty_like(x), torch.empty_like(x)  # ctx also holds both LayerNorm outputs
    qu, qv, kh, vh = (torch.empty((b, heads, t, hd), dtype=dt, device=x.device) for _ in range(4))
    pos = torch.empty((2 * t - 1, d), dtype=dt, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.pk_ffn_attention(
            DTYPE_CODE[dt], ptr(x), ptr(fvecs[0]), ptr(fvecs[1]), ptr(fc1_w), ptr(fc1_b),
            ptr(fc2_w), ptr(fc2_b), ptr(a["norm_w"]), ptr(a["norm_b"]), float(eps),
            ptr(a["wq"]), ptr(a["bq"]), ptr(a["wk"]), ptr(a["bk"]), ptr(a["wv"]), ptr(a["bv"]),
            ptr(a["bias_u"]), ptr(a["bias_v"]), ptr(a["pe"]), ptr(a["pos_w"]), ptr(a["wo"]),
            ptr(a["bo"]), ptr(a["kv"]), ptr(hf), ptr(part), ptr(x2),
            ptr(qu), ptr(qv), ptr(kh), ptr(vh), ptr(pos), ptr(ctx), ptr(out),
            b, t, d, heads, f, plan.splits, *attn.ints(), stream(x.device),
        )
    check_rc(rc, name)
    fused_ffn_attention.launches += 1
    return out


def fused_ffn_attention(
    x: torch.Tensor,
    ffn_norm_w, ffn_norm_b,
    fc1_w, fc1_b,
    fc2_w, fc2_b,
    attn_norm_w, attn_norm_b,
    wq, bq, wk, bk, wv, bv,
    bias_u, bias_v,
    pos_w,
    wo, bo,
    lengths=None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """x2 + attention(LN(x2)) with x2 = x + 0.5·FFN(LN(x)); (B, T, D) in
    x.dtype.

    On a CUDA tensor this launches the hand-written kernel or raises; on a
    CPU tensor it runs `fused_ffn_attention_reference`. Each kernel launch
    adds one to `fused_ffn_attention.launches`."""
    if attn_norm_w is None:
        raise ValueError("fused_ffn_attention: the attention pre-LayerNorm weights are required")
    args = (x, ffn_norm_w, ffn_norm_b, fc1_w, fc1_b, fc2_w, fc2_b, attn_norm_w, attn_norm_b,
            wq, bq, wk, bk, wv, bv, bias_u, bias_v, pos_w, wo, bo, lengths, eps)
    if x.device.type == "cuda":
        return _launch(*args)
    if x.device.type == "cpu":
        return fused_ffn_attention_reference(*args)
    raise ValueError(f"fused_ffn_attention: no implementation for device {x.device}")


fused_ffn_attention.launches = 0

__all__ = ["fused_ffn_attention", "fused_ffn_attention_reference", "build"]
