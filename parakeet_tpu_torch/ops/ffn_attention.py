"""ffn1 and the attention sublayer of a conformer block in one call: K7.

Replaces the TPU kernel parakeet_tpu/ops/pallas_attention.py::
fused_ffn_attention (body _ffn_attn_kernel), which the reference's encoder
runs for every block under set_fused_attention("mega") (bench.py
--fused-mode mega). Per call:

    x2 = x + 0.5·FFN(LN(x)) (K6's function, no final LayerNorm) →
    out = x2 + Attention(LN(x2)) (K1's function with the fused pre-LN; the
    residual is x2, not x)

ffn_body rounds to the activation dtype in the reference, so K7's result is
K6's followed by K1's, exactly; the plain version
`fused_ffn_attention_reference` is that composition of the two plain
versions. `fused_ffn_attention` dispatches on the tensor's device: CUDA
tensors run the hand-written kernel in csrc/ffn_attention.cu or raise, CPU
tensors run the plain version. In bf16 the kernel is five launches of its
own (`k7_plan`; see the .cu's note): K6's Hopper sequence (fc1 on the
LayerNorm'd rows, fc2 closing in a thread-block cluster that also writes
LN_attn(x2)), QKV with the position GEMM in the same launch, K1's bf16
attention core (wgmma) and the out-projection closing in a cluster, the
GEMMs on wgmma with TMA loads. In f32 (IEEE FMA on the CUDA cores), and in
bf16 where a row spans more than a cluster's 8 column tiles (D > 1024), it
runs K6's sequence of that route and then K1's tiled one in the same C
call. The reference's core scores the position term
by the angle-addition factorisation of the sinusoidal table; the port
gathers projected table rows (K1's core). The two agree to f32 rounding; in
bf16 they round the table at different points.

On a mesh with a 'model' axis > 1 (parallel/mesh.py) K7 takes the whole
weights, gathered once when the facade is built, and computes ffn1 and
the attention replicated over 'model', as XLA's partitioner does around a
kernel it has no rule for (models/encoder.py); K1 alone has a
head-sharded mode.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from parakeet_tpu_torch.ops import feed_forward as FF
from parakeet_tpu_torch.ops import rel_attention as RA
from parakeet_tpu_torch.ops._build import DTYPE_CODE, check_rc, load, ptr, refuse_grad, stream
from parakeet_tpu_torch.ops.gemm_plan import HopperPlan, hopper_fits, hopper_plan


@dataclass(frozen=True)
class K7Plan:
    """How K7 launches for (B, T, D, F): K6's plan (`ffn`, ops/feed_forward.py
    ffn_plan) for its FFN half, then in bf16 where a row fits a cluster
    (`hopper`) the Hopper design's QKV + position launch and out-projection
    (ops/gemm_plan.py hopper_plan) around K1's core, else K1's tiled plan
    (`attn`). `launches`: the kernel launches of one call."""

    hopper: bool
    launches: int
    core: RA.CorePlan
    ffn: FF.FfnPlan
    qkv_pos: HopperPlan | None = None
    out: HopperPlan | None = None
    attn: RA.BlockPlan | None = None

    def ints(self) -> tuple[int, int, int, int, int, int, int]:
        """(hopper, splits, qkv_rows, pos_splits, out_splits, fc1_cols,
        core_splits), as the C entry takes them."""
        _, fc1_cols, splits = self.ffn.ints()
        if self.hopper:
            return 1, splits, 0, 0, self.out.splits, fc1_cols, self.core.splits
        return 0, splits, self.attn.qkv.rows, self.attn.pos.splits, self.attn.out.splits, 0, self.core.splits

    def partials(self, m: int, d: int) -> int:
        """f32 elements of the tiled sequences' split partials (0 for the
        Hopper design): the FFN half's, then the attention half's, in one
        buffer."""
        return 0 if self.hopper else max(self.ffn.part_elems(m, d), self.attn.partials)


def k7_plan(b: int, t: int, d: int, f: int, itemsize: int = 4, heads: int = 8) -> K7Plan:
    """The Hopper design in bf16 (gemm_plan.hopper_fits): K6's Hopper route
    with fc2's cluster spanning every column tile of its rows (it also
    writes LN_attn(x2)), QKV (N = 3D) with the position GEMM ((2T−1) × D)
    in one launch, and the out-projection (k split over a cluster). At B=8,
    T'=126, D=512: 256, 128 (clusters of 4 column tiles x 2 k slices), 208
    and 128 blocks (2 k slices); 5 launches. In f32, and in bf16 rows wider
    than a cluster, K6's tiled route (4 launches) and K1's tiled plan
    (heads_plan over every head, 7): 11. K1's core (`core`, RA.core_plan)
    in both."""
    m = b * t
    core = RA.core_plan(b, t, heads, d // heads, itemsize)
    hopper = itemsize == 2 and hopper_fits(d)
    ffn = FF.ffn_plan(m, d, f, itemsize, final_norm=hopper)  # the Hopper fc2 closes LN_attn(x2) in its cluster
    if hopper:
        return K7Plan(True, ffn.launches + RA.HOPPER_LAUNCHES, core, ffn,
                      qkv_pos=hopper_plan(m, 3 * d, d, "qkv_pos", extra=(2 * t - 1, d)),
                      out=hopper_plan(m, d, d, "linear"))
    attn = RA.heads_plan(b, t, d, d, itemsize, heads)
    return K7Plan(False, ffn.launches + RA.TILED_LAUNCHES, core, ffn, attn=attn)


def hopper_active_clusters(size: int) -> int:
    """Clusters of `size` blocks of the Hopper GEMM that this card holds at
    once (cudaOccupancyMaxActiveClusters): what gemm_plan's
    HOPPER_ACTIVE_CLUSTERS says for an H100. Raises without a card."""
    n = _lib().pk_hopper_active_clusters(size)
    check_rc(max(0, -n), "hopper_active_clusters")
    return n


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
        fn.argtypes = [i] + [p] * 9 + [ctypes.c_float] + [p] * 23 + [i] * 12 + [p]
        fn.restype = i
        lib.pk_hopper_active_clusters.argtypes = [i]
        lib.pk_hopper_active_clusters.restype = i
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
                        attn_norm_w, attn_norm_b, name, clamp=False)
    b, t, d = x.shape
    heads, hd = bias_u.shape
    f = fc1_w.shape[0]
    dt = x.dtype

    out = torch.empty_like(x)
    hf = torch.empty((b * t, f), dtype=dt, device=x.device)
    plan = k7_plan(b, t, d, f, x.element_size(), heads)
    n_part = plan.partials(b * t, d)
    part = torch.empty(n_part, dtype=torch.float32, device=x.device) if n_part else None
    x2, ctx = torch.empty_like(x), torch.empty_like(x)  # ctx also holds both LayerNorms' outputs
    qu, qv, kh = (torch.empty((b, heads, t, hd), dtype=dt, device=x.device) for _ in range(3))
    vh = RA.values_scratch(b, heads, t, hd, dt, x.device)
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
            b, t, d, heads, f, *plan.ints(), stream(x.device),
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

__all__ = ["fused_ffn_attention", "fused_ffn_attention_reference", "build", "K7Plan", "k7_plan",
           "hopper_active_clusters"]
