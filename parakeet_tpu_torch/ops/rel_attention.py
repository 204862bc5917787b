"""Fused relative-position attention block: the encoder's one kernel.

Replaces the TPU kernel parakeet_tpu/ops/pallas_attention.py::
fused_rel_attention_block (body _attn_block_kernel / _attention_core), which
the reference's encoder runs for every conformer layer (models/encoder.py
_block_attention_or_none). Per layer:

    optional pre-LayerNorm (f32 statistics) → q/k/v projections + bias →
    1/√hd folded into q and the u/v position biases → content (q+u)kᵀ plus
    the relative-position term (q+v)·P[T−1−t+s] → key-length mask −1e9 →
    f32 softmax, normalised after AV → out-projection + bias → optional
    residual.

`rel_attention_block` dispatches on the tensor's device: CUDA tensors run
the hand-written kernel in csrc/rel_attention.cu (or raise), CPU tensors
run `rel_attention_block_reference`, the plain torch version of the same
function. The kernel's note on what bounds it on the card and how its
design answers that is at the top of the .cu source. In bf16 at D ≤ 1024
it runs three launches (QKV with the LayerNorm and the position GEMM on
the Hopper GEMM, the wgmma attention core, the out-projection in a
cluster); in f32, in bf16 at D > 1024 and head-sharded, seven (the tiled
GEMMs around the core of the dtype). `block_plan`, `heads_plan` and
`core_plan` choose the launches, the core's tiles and its key splits.
What it drops from the TPU kernel: T padded to 128 lanes, the SMEM length
block, the blockN/hp/bdN MXU packings and the VMEM guards; it tiles keys
flash-style instead, so any length runs.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.nn.functional as F

from parakeet_tpu_torch.ops._build import (DTYPE_CODE, SHARED_MEMORY_LIMIT, SM_COUNT, check_rc, load, ptr, refuse_grad,
                                           stream)
from parakeet_tpu_torch.ops.gemm_plan import (WAVE_FILL, GemmPlan, HopperPlan, gemm_plan, hopper_fits, hopper_plan,
                                              partial_elems)

_F32 = torch.float32
_NEG_INF = -1e9
_HEAD_DIMS = (32, 64, 128)


@functools.lru_cache(maxsize=64)
def position_table_np(seq_len: int, d_model: int) -> np.ndarray:
    """(2T−1, d) sinusoidal table; row r is relative position T−1−r
    (f64 construction, f32 storage — encoder.cpp:9-30)."""
    total = 2 * seq_len - 1
    position = (seq_len - 1 - np.arange(total, dtype=np.float64))[:, None]
    i = np.arange(0, d_model, 2, dtype=np.float64)
    div_term = np.exp(i * (-math.log(10000.0) / d_model))[None, :]
    pe = np.zeros((total, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)[:, : pe[:, 1::2].shape[1]]
    return pe.astype(np.float32)


@functools.lru_cache(maxsize=32)
def position_table(seq_len: int, d_model: int, device: torch.device, dtype: torch.dtype):
    """position_table_np on `device` in `dtype`, cached per (T, d, device, dtype).
    Made outside inference mode even when first asked for inside it, so
    the cached table also serves autograd (a trainer after a facade)."""
    with torch.inference_mode(False):
        return torch.from_numpy(position_table_np(seq_len, d_model)).to(device=device, dtype=dtype)


def _check_score_storage(score_bf16: bool) -> None:
    if score_bf16:
        raise NotImplementedError(
            "score_bf16: bf16 score storage is not implemented by any port path; "
            "scores are always float32"
        )


def _key_lengths(lengths, b: int, t: int, device, clamp: bool = True) -> torch.Tensor:
    """(B,) int32 key counts, min(len, T) (clamp=False: as given, for a
    kernel that takes the min itself); all T without lengths."""
    if lengths is None:
        return torch.full((b,), t, dtype=torch.int32, device=device)
    lengths = torch.as_tensor(lengths, device=device).to(torch.int32)
    return lengths.clamp(max=t) if clamp else lengths


def rel_attention_block_reference(
    x: torch.Tensor,  # (B, T, D): attention input, or the block input with norm_w
    wq, bq, wk, bk, wv, bv,  # torch Linear layouts (D, D) / (D,)
    bias_u, bias_v,  # (H, hd)
    pos_w,  # (D, D) pos_proj weight, bias-free
    wo, bo,
    lengths=None,  # (B,) valid key counts
    norm_w=None,
    norm_b=None,
    eps: float = 1e-5,
    score_bf16: bool = False,
    heads_partial: bool = False,
    x_kv: torch.Tensor | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Plain torch version of the kernel: same signature, same rounding
    points (products accumulate in f32; q/k/v, P and the AV result round to
    x.dtype; in bf16 the unnormalised probabilities round to bf16 before
    AV and the product is normalised after, as the reference kernel does;
    in f32 the softmax normalises before AV, one order of the same sums).
    Pad query rows (t ≥ length) hold garbage, as in the kernel.

    heads_partial: the head-sharded mode (`rel_attention_block_heads`): the
    weights hold H of the layer's heads (wq, wk, wv, pos_w (H·hd, D), wo (D,
    H·hd), bias_u, bias_v (H, hd)), bo is unused, and the result is the
    f32 out-projection of those heads with no bias and no residual.

    x_kv, q_offset: the keys and values from x_kv (B, Tk, D), normed as x
    is, and query row t at position q_offset + t of those Tk frames (a
    'seq' rank's block of queries against every rank's frames,
    models/encoder.py); by default x itself at offset 0."""
    _check_score_storage(score_bf16)
    b, t, d = x.shape
    heads, hd = bias_u.shape
    dl = heads * hd
    scale = 1.0 / math.sqrt(hd)
    dt = x.dtype

    def f(a):
        return a.to(_F32)

    def normed(y):
        return y if norm_w is None else F.layer_norm(f(y), (d,), f(norm_w), f(norm_b), eps).to(dt)

    xin = normed(x)
    xkv = xin if x_kv is None else normed(x_kv)
    tk = xkv.shape[1]

    def proj(y, w, bias):
        return f(y) @ f(w).T + f(bias)  # (B, T, DL) f32

    def split(y):
        return f(y).view(b, -1, heads, hd).transpose(1, 2)  # (B, H, T, hd)

    q_s = (proj(xin, wq, bq) * scale).to(dt)
    k = proj(xkv, wk, bk).to(dt)
    v = proj(xkv, wv, bv).to(dt)
    qu = (f(q_s) + f((f(bias_u).reshape(dl) * scale).to(dt))).to(dt)
    qv = (f(q_s) + f((f(bias_v).reshape(dl) * scale).to(dt))).to(dt)

    pe = position_table(tk, d, x.device, dt)
    pos = (f(pe) @ f(pos_w).T).to(dt)  # (2Tk−1, DL)
    content = split(qu) @ split(k).transpose(-1, -2)  # (B, H, T, Tk)
    raw = split(qv) @ f(pos).view(2 * tk - 1, heads, hd).permute(1, 2, 0)  # (B, H, T, 2Tk−1)
    rows = torch.arange(t, device=x.device) + q_offset
    keys = torch.arange(tk, device=x.device)
    idx = (tk - 1 - rows[:, None] + keys[None, :]).expand(b, heads, t, tk)  # r = Tk−1−t+s
    scores = content + raw.gather(-1, idx)

    kv = _key_lengths(lengths, b, tk, x.device)
    key_pad = keys[None, :] >= kv[:, None]  # (B, Tk)
    scores = scores.masked_fill(key_pad[:, None, None, :], _NEG_INF)
    if dt == _F32:  # rounding e to f32 is the identity: normalised before AV
        ctx = torch.softmax(scores, dim=-1) @ split(v)
    else:  # the reference kernel's: e = exp(s − max) rounded for AV, the product scaled by 1 / Σe (unrounded)
        e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        ctx = (f(e.to(dt)) @ split(v)) * (1.0 / e.sum(dim=-1, keepdim=True))
    ctx = ctx.transpose(1, 2).reshape(b, t, dl).to(dt)
    out = f(ctx) @ f(wo).T
    if heads_partial:
        return out
    out = out + f(bo)
    if norm_w is not None:
        out = f(x) + out
    return out.to(dt)


# the SM's shared memory (228 KB) and what each resident block reserves of it
SM_SHARED_MEMORY, BLOCK_RESERVED = 233_472, 1024
CORE_SPLITS = (1, 2, 4, 8)


@dataclass(frozen=True)
class CorePlan:
    """How K1's attention core launches for (B, T, H, hd) in a dtype
    (csrc/rel_attention.cuh): `rows` query rows a block, `key_tile` keys a
    tile, `threads` a block, `smem` bytes of dynamic shared memory,
    `resident` blocks an SM holds at once (by shared memory; the card's
    cudaOccupancyMaxActiveBlocksPerMultiprocessor answers the same,
    chip_smoke.py prints it), `blocks` of the grid without a split, and
    `splits`, the key splits of each query tile (a thread-block cluster of
    that many blocks, merged in distributed shared memory), of the `tiles`
    key tiles of T. `kept`: K2's bf16 core's key tiles of scores a split
    keeps in shared memory between its two sweeps (0: it computes them
    again; K1's cores run one sweep), counted in `smem`."""

    itemsize: int
    hd: int
    rows: int
    key_tile: int
    threads: int
    smem: int
    resident: int
    blocks: int
    splits: int
    tiles: int
    kept: int = 0

    @property
    def tiles_per_split(self) -> int:
        """Key tiles of a split (the last may take fewer; an item's own key
        count cuts them too)."""
        return -(-self.tiles // self.splits)

    @property
    def warps(self) -> int:
        """Warps resident on an SM."""
        return self.resident * self.threads // 32


def core_tile(itemsize: int, hd: int) -> tuple[int, int, int, int]:
    """(query rows, key tile, threads, dynamic shared memory) of the core of
    a dtype at head dim hd, as csrc/rel_attention.cuh sizes them. f32
    (F32Tile): 256 threads (8 warps) of RPT rows x BN/8 keys: 128 rows of 4
    at hd = 64; 64 rows of 4 at hd = 128, over half the head dims each;
    64 rows of 2 at hd = 32; BN = 64 (32 at hd = 128); the probabilities,
    q_u and q_v, two stages of keys and values and one position band of
    BM + BN − 1 rows. bf16 (WgTile): 64 rows, one consumer
    warpgroup and a producer warp (160 threads), 64-key tiles; 1 KB of
    alignment, q_u and q_v and two stages (keys, 128 band rows, values
    transposed) in 128-byte rows of 64 values (hd = 128: two a row), the
    skew buffer (64 x 68 f32), the row maxima and sums and 5 mbarriers."""
    if hd not in _HEAD_DIMS:
        raise ValueError(f"core_tile: head dim {hd}; supported {_HEAD_DIMS}")
    if itemsize == 4:
        bm, bn = (128 if hd == 64 else 64), (32 if hd == 128 else 64)
        return bm, bn, 256, 4 * (bm * (bn + 4) + hd * (2 * bm + 4 * bn + bm + bn - 1))
    bm, hc = 64, max(1, hd // 64)
    stage = 64 * 128 * hc + 128 * 128 * hc + hd * 128
    return bm, 64, 160, 1024 + 2 * bm * 128 * hc + 2 * stage + bm * (bm + 4) * 4 + 2 * bm * 4 + 64


def core_plan(b: int, t: int, heads: int, hd: int, itemsize: int = 4) -> CorePlan:
    """The core's plan: ceil(T / rows) x B·H blocks; where they fill less
    than WAVE_FILL of the waves (one block an SM) they take, the fewest key
    splits of CORE_SPLITS that do, else the most; a split takes whole key
    tiles, and no split is left without one. E.g. at H=8: B=8 at T'=751
    does not split (768 blocks of 64 rows in bf16, 384 of 128 in f32 at hd
    64), nor bf16 at T'=126 (128 blocks); f32 there (64 blocks of 128
    rows) splits 2; B=1, T'=751 (96 or 48 blocks) splits 4; B=4, T'=125,
    hd 128 (64 blocks) splits 2; B=1, T'=1188, hd 128 (152 blocks, two
    waves of which the second holds 20) splits 4."""
    bm, bn, threads, smem = core_tile(itemsize, hd)
    if smem > SHARED_MEMORY_LIMIT:
        raise ValueError(f"core_plan: {smem} B of shared memory per block")
    resident = SM_SHARED_MEMORY // (smem + BLOCK_RESERVED)
    blocks = -(-t // bm) * b * heads
    tiles = -(-t // bn)
    # each split whole key tiles, and none empty
    options = [s for s in CORE_SPLITS if (s - 1) * -(-tiles // s) < tiles]
    splits = next((s for s in options if _fills(blocks * s)), options[-1])
    return CorePlan(itemsize, hd, bm, bn, threads, smem, resident, blocks, splits, tiles)


def _fills(blocks: int) -> bool:
    """Whether `blocks` fill at least WAVE_FILL of the waves (one block an
    SM) that they take."""
    return blocks >= WAVE_FILL * SM_COUNT * -(-blocks // SM_COUNT)


# launches of one call: the Hopper design; the tiled design with the
# LayerNorm (one fewer without)
HOPPER_LAUNCHES, TILED_LAUNCHES = 3, 7


@dataclass(frozen=True)
class BlockPlan:
    """How K1 launches for (B, T, D, H). In bf16 at D ≤ 1024 and over every
    head (`hopper`), the Hopper design: `qkv_pos`, QKV with the LayerNorm on
    its A path and the position GEMM in one hopper_gemm_kernel launch
    (gemm_plan.hopper_plan), the core, and `out_proj`, the out-projection
    split over a cluster. Otherwise the tiled design (ops/gemm_plan.py
    gemm_plan): the QKV GEMM (nonlinear epilogue, no split: the 64-, 96- or
    128-row tiles that load the busiest SM least), the position GEMM P =
    pe Wposᵀ and the out-projection (k slices, closed by the reduction
    pass), and the f32 partials the two share. `core`, the attention
    core's plan, in both."""

    qkv: GemmPlan
    pos: GemmPlan
    out: GemmPlan
    partials: int
    core: CorePlan
    hopper: bool = False
    qkv_pos: HopperPlan | None = None
    out_proj: HopperPlan | None = None

    @property
    def launches(self) -> int:
        """Kernel launches of a call with the fused LayerNorm (the tiled
        design launches one fewer without it)."""
        return HOPPER_LAUNCHES if self.hopper else TILED_LAUNCHES

    def ints(self) -> tuple[int, int, int, int, int]:
        """(hopper, qkv, pos_splits, out_splits, core_splits), as the C
        entries take them: qkv is the tiled QKV GEMM's block rows, or the
        Hopper design's LayerNorm cluster of column tiles."""
        if self.hopper:
            return 1, self.qkv_pos.cluster_cols, 0, self.out_proj.splits, self.core.splits
        return 0, self.qkv.rows, self.pos.splits, self.out.splits, self.core.splits


def block_plan(b: int, t: int, d: int, itemsize: int = 4, heads: int = 8) -> BlockPlan:
    """K1's plan for (B, T, D) over every head: in bf16 at D ≤ 1024 the
    Hopper design, else `heads_plan` with DL = D. At B=8, T'=126, D=512 in
    bf16: QKV and the position GEMM in 210 blocks (LayerNorm clusters of
    6 column tiles), the core in 128, the out-projection in 128 (2 k
    slices)."""
    plan = heads_plan(b, t, d, d, itemsize, heads)
    if itemsize != 2 or not hopper_fits(d):
        return plan
    m = b * t
    return replace(plan, hopper=True, partials=0,
                   qkv_pos=hopper_plan(m, 3 * d, d, "qkv_pos", extra=(2 * t - 1, d), ln=True),
                   out_proj=hopper_plan(m, d, d, "linear"))


def heads_plan(b: int, t: int, d: int, dl: int, itemsize: int = 4, heads: int = 8) -> BlockPlan:
    """The tiled plan over `heads` heads DL = H·hd wide of a layer D wide:
    the QKV GEMM (N = 3·DL, K = D), the position GEMM (N = DL, K = D), the
    out-projection (N = D, K = DL) and the core. DL = D is `block_plan`'s
    tiled design; DL < D, one 'model' rank's heads
    (`rel_attention_block_heads`, which always runs the tiled design)."""
    m, p_rows = b * t, 2 * t - 1
    qkv = gemm_plan(m, 3 * dl, d, itemsize, split_k=False)
    pos = gemm_plan(p_rows, dl, d, itemsize)
    out = gemm_plan(m, d, dl, itemsize)
    return BlockPlan(qkv, pos, out, max(partial_elems(p_rows, dl, pos), partial_elems(m, d, out)),
                     core_plan(b, t, heads, dl // heads, itemsize))


def core_resident(itemsize: int, hd: int) -> int:
    """Blocks of the core that one SM of this card holds at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor): what core_plan's
    `resident` says for an H100. Raises without a card."""
    n = _lib().pk_rel_attention_core_resident(0 if itemsize == 4 else 1, hd)
    check_rc(max(0, -n), "core_resident")
    return n


def _lib() -> ctypes.CDLL:
    lib = load("rel_attention")
    fn = lib.pk_rel_attention_block
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, ctypes.c_float] + [p] * 12 + [p] + [p] * 8 + [i] * 9 + [p]
        fn.restype = i
    fn = lib.pk_rel_attention_block_heads
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, p, p, p, ctypes.c_float] + [p] * 11 + [p] + [p] * 8 + [i] * 9 + [p]
        fn.restype = i
    fn = lib.pk_rel_attention_core_resident
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel libraries of K1 and K2."""
    _lib()
    _lib_v1()


def checked_args(x, wq, bq, wk, bk, wv, bv, bias_u, bias_v, pos_w, wo, bo, lengths, norm_w, norm_b,
                 name: str = "rel_attention_block", heads_partial: bool = False, clamp: bool = True) -> dict:
    """The block kernel's operands, checked against x and made contiguous:
    the weights in x's dtype, the norm vectors in f32 (None without the
    fused pre-LN), the (B,) int32 key lengths and the position table pe.
    Raises on what the kernel does not take. Shared with K7, which runs the
    block's launch sequence in f32 and its own in bf16. heads_partial: the
    head-sharded mode's operands (H·hd rows of the layer's D; no bo).
    clamp=False leaves the lengths as given (K7's kernels take min(len, T)
    themselves)."""
    b, t, d = x.shape
    heads, hd = bias_u.shape
    dl = heads * hd
    dt = x.dtype
    if dt not in DTYPE_CODE:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {dt}")
    if hd not in _HEAD_DIMS or (dl > d if heads_partial else dl != d):
        raise ValueError(f"{name} kernel: D={d}, H={heads} gives head dim {hd}; supported {_HEAD_DIMS}")
    mats = dict(wq=wq, wk=wk, wv=wv, pos_w=pos_w, wo=wo)
    vecs = dict(bq=bq, bk=bk, bv=bv, bias_u=bias_u, bias_v=bias_v)
    if not heads_partial:
        vecs["bo"] = bo
    for key, w in {**mats, **vecs}.items():
        if w.device != x.device or w.dtype != dt:
            raise ValueError(f"{name}: {key} is {w.dtype} on {w.device}, x is {dt} on {x.device}")
    for key, w in mats.items():
        want = (d, dl) if key == "wo" else (dl, d)
        if tuple(w.shape) != want:
            raise ValueError(f"{name}: {key} has shape {tuple(w.shape)}, want {want}")
    for key in ("bq", "bk", "bv", "bo"):
        if key in vecs and vecs[key].numel() != (d if key == "bo" else dl):
            raise ValueError(f"{name}: {key} has {vecs[key].numel()} elements, want {d if key == 'bo' else dl}")
    out = {k: w.contiguous() for k, w in {**mats, **vecs}.items()}
    if norm_w is not None:
        norm_w = norm_w.to(device=x.device, dtype=_F32).contiguous()
        norm_b = norm_b.to(device=x.device, dtype=_F32).contiguous()
    out.update(norm_w=norm_w, norm_b=norm_b, kv=_key_lengths(lengths, b, t, x.device, clamp).contiguous(),
               pe=position_table(t, d, x.device, dt))
    return out


def values_scratch(b: int, heads: int, t: int, hd: int, dtype: torch.dtype, device) -> torch.Tensor:
    """The core's values: (B, H, T, hd) in f32; in bf16 transposed, (B, H,
    hd, T rounded up to 8), the K-major B operand of the core's AV wgmma
    (rows 16-byte aligned for its TMA loads)."""
    if dtype == torch.bfloat16:
        return torch.empty((b, heads, hd, -(-t // 8) * 8), dtype=dtype, device=device)
    return torch.empty((b, heads, t, hd), dtype=dtype, device=device)


def _launch(x, wq, bq, wk, bk, wv, bv, bias_u, bias_v, pos_w, wo, bo, lengths, norm_w, norm_b, eps,
            heads_partial: bool = False):
    """Launch K1 (or, heads_partial, its head-sharded mode: no bo, the f32
    partial out-projection back) on the current stream."""
    name = "rel_attention_block_heads" if heads_partial else "rel_attention_block"
    refuse_grad(name, x, wq, bq, wk, bk, wv, bv, bias_u, bias_v, pos_w, wo, bo, norm_w, norm_b)
    # the cores take min(len, T) themselves: no clamp launch
    a = checked_args(x, wq, bq, wk, bk, wv, bv, bias_u, bias_v, pos_w, wo, bo, lengths, norm_w, norm_b,
                     name=name, heads_partial=heads_partial, clamp=False)
    x = x.contiguous()
    b, t, d = x.shape
    heads, hd = bias_u.shape
    dt = x.dtype

    plan = (heads_plan(b, t, d, heads * hd, x.element_size(), heads) if heads_partial
            else block_plan(b, t, d, x.element_size(), heads))
    part = torch.empty(plan.partials, dtype=_F32, device=x.device)
    qu, qv, kh = (torch.empty((b, heads, t, hd), dtype=dt, device=x.device) for _ in range(3))
    vh = values_scratch(b, heads, t, hd, dt, x.device)
    pos = torch.empty((2 * t - 1, heads * hd), dtype=dt, device=x.device)
    ctx = torch.empty_like(x)  # the LayerNorm output (B, T, D) until the core writes its (B, T, H·hd)
    lib = _lib()
    common = (ptr(x), ptr(a["norm_w"]), ptr(a["norm_b"]), float(eps),
              ptr(a["wq"]), ptr(a["bq"]), ptr(a["wk"]), ptr(a["bk"]),
              ptr(a["wv"]), ptr(a["bv"]), ptr(a["bias_u"]), ptr(a["bias_v"]),
              ptr(a["pe"]), ptr(a["pos_w"]), ptr(a["wo"]))
    with torch.cuda.device(x.device):
        if heads_partial:
            out = torch.empty((b, t, d), dtype=_F32, device=x.device)
            rc = lib.pk_rel_attention_block_heads(
                DTYPE_CODE[dt], *common, ptr(a["kv"]),
                ptr(part), ptr(qu), ptr(qv), ptr(kh), ptr(vh), ptr(pos), ptr(ctx), ptr(out),
                b, t, d, heads, hd, *plan.ints()[1:], stream(x.device))
        else:
            out = torch.empty_like(x)
            rc = lib.pk_rel_attention_block(
                DTYPE_CODE[dt], *common, ptr(a["bo"]), ptr(a["kv"]),
                ptr(part), ptr(qu), ptr(qv), ptr(kh), ptr(vh), ptr(pos), ptr(ctx), ptr(out),
                b, t, d, heads, *plan.ints(), stream(x.device))
    check_rc(rc, name)
    if heads_partial:
        rel_attention_block_heads.launches += 1
    else:
        rel_attention_block.launches += 1
    return out


class RelAttentionBlockFunction(torch.autograd.Function):
    """K1 with a gradient: the forward launches the kernel (grad mode is
    off inside it, and `rel_attention_block.launches` counts the launch);
    the backward recomputes `rel_attention_block_reference` on the saved
    inputs under grad mode and returns its input gradients. The reference
    package has no backward kernel to port: its trainers differentiate the
    plain layers."""

    @staticmethod
    def forward(ctx, x, wq, bq, wk, bk, wv, bv, bias_u, bias_v, pos_w, wo, bo, lengths, norm_w, norm_b, eps):
        ctx.save_for_backward(x, wq, bq, wk, bk, wv, bv, bias_u, bias_v, pos_w, wo, bo, lengths, norm_w, norm_b)
        ctx.eps = eps
        return _launch(x, wq, bq, wk, bk, wv, bv, bias_u, bias_v, pos_w, wo, bo, lengths, norm_w, norm_b, eps)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        wants = ctx.needs_input_grad[:len(saved)]
        inputs = [t.detach().requires_grad_(w) if t is not None else None for t, w in zip(saved, wants)]
        with torch.enable_grad():
            out = rel_attention_block_reference(*inputs, ctx.eps)  # x … bo, lengths, norm_w, norm_b
        diff = [t for t, w in zip(inputs, wants) if w]
        grads = iter(torch.autograd.grad(out, diff, grad_out, allow_unused=True))
        return (*(next(grads) if w else None for w in wants), None)


def rel_attention_block(
    x: torch.Tensor,
    wq, bq, wk, bk, wv, bv,
    bias_u, bias_v,
    pos_w,
    wo, bo,
    lengths=None,
    norm_w=None,
    norm_b=None,
    eps: float = 1e-5,
    score_bf16: bool = False,
) -> torch.Tensor:
    """out = attention(LN?(x)) (+ x when norm_w is given), (B, T, D).

    On a CUDA tensor this launches the hand-written kernel or raises; on a
    CPU tensor it runs `rel_attention_block_reference`. Each kernel launch
    adds one to `rel_attention_block.launches`. Under grad mode, with an
    input that requires grad, the kernel runs inside
    `RelAttentionBlockFunction`, whose backward is the plain version's."""
    _check_score_storage(score_bf16)
    args = (x, wq, bq, wk, bk, wv, bv, bias_u, bias_v, pos_w, wo, bo)
    if x.device.type == "cuda":
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (*args, norm_w, norm_b)):
            kv = _key_lengths(lengths, x.shape[0], x.shape[1], x.device)
            return RelAttentionBlockFunction.apply(*args, kv, norm_w, norm_b, eps)
        return _launch(*args, lengths, norm_w, norm_b, eps)
    if x.device.type == "cpu":
        return rel_attention_block_reference(*args, lengths, norm_w, norm_b, eps)
    raise ValueError(f"rel_attention_block: no implementation for device {x.device}")


rel_attention_block.launches = 0


class RelAttentionBlockHeadsFunction(torch.autograd.Function):
    """K1 head-sharded with a gradient, as `RelAttentionBlockFunction` is
    for the whole block: the forward launches
    pk_rel_attention_block_heads (counted in
    `rel_attention_block_heads.launches`); the backward recomputes
    `rel_attention_block_reference(..., heads_partial=True)` on the saved
    inputs under grad mode and returns its input gradients. The caller
    sums the partial over 'model' (`reduce_from_model`) and passes x, the
    LayerNorm and the position biases through `copy_to_model`
    (models/encoder.py), so this rank's gradients here are its heads'
    shares."""

    @staticmethod
    def forward(ctx, x, wq, bq, wk, bk, wv, bv, bias_u, bias_v, pos_w, wo, lengths, norm_w, norm_b, eps):
        ctx.save_for_backward(x, wq, bq, wk, bk, wv, bv, bias_u, bias_v, pos_w, wo, lengths, norm_w, norm_b)
        ctx.eps = eps
        return _launch(x, wq, bq, wk, bk, wv, bv, bias_u, bias_v, pos_w, wo, None, lengths, norm_w, norm_b, eps,
                       heads_partial=True)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        wants = ctx.needs_input_grad[:len(saved)]
        inputs = [t.detach().requires_grad_(w) if t is not None else None for t, w in zip(saved, wants)]
        x, wq, bq, wk, bk, wv, bv, bias_u, bias_v, pos_w, wo, lengths, norm_w, norm_b = inputs
        with torch.enable_grad():
            out = rel_attention_block_reference(x, wq, bq, wk, bk, wv, bv, bias_u, bias_v, pos_w, wo, None, lengths,
                                                norm_w, norm_b, ctx.eps, heads_partial=True)
        diff = [t for t, w in zip(inputs, wants) if w]
        grads = iter(torch.autograd.grad(out, diff, grad_out, allow_unused=True))
        return (*(next(grads) if w else None for w in wants), None)


def rel_attention_block_heads(
    x: torch.Tensor,
    wq, bq, wk, bk, wv, bv,
    bias_u, bias_v,
    pos_w,
    wo,
    lengths=None,
    norm_w=None,
    norm_b=None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """K1 head-sharded: one 'model' rank's share of the attention block
    under tensor parallelism over heads. x (B, T, D) and the LayerNorm are
    the whole layer's; the weights hold this rank's H heads (wq, wk, wv,
    pos_w (H·hd, D); wo (D, H·hd); bias_u, bias_v (H, hd)). Returns the f32
    (B, T, D) out-projection of those heads with no bias and no residual:
    summed over the ranks, plus bo (and x with the LayerNorm), rounded,
    it is the block's output (models/encoder.py).

    On a CUDA tensor this launches the hand-written kernel
    (csrc/rel_attention.cu pk_rel_attention_block_heads: K1's launch
    sequence with N = H·hd for the QKV and position GEMMs and K = H·hd for
    the out-projection) or raises; on a CPU tensor it runs
    `rel_attention_block_reference(..., heads_partial=True)`. Each kernel
    launch adds one to `rel_attention_block_heads.launches`. Under grad
    mode, with an input that requires grad, the kernel runs inside
    `RelAttentionBlockHeadsFunction`, whose backward is the plain
    version's."""
    args = (x, wq, bq, wk, bk, wv, bv, bias_u, bias_v, pos_w, wo)
    if x.device.type == "cuda":
        if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (*args, norm_w, norm_b)):
            kv = _key_lengths(lengths, x.shape[0], x.shape[1], x.device)
            return RelAttentionBlockHeadsFunction.apply(*args, kv, norm_w, norm_b, eps)
        return _launch(*args, None, lengths, norm_w, norm_b, eps, heads_partial=True)
    if x.device.type == "cpu":
        return rel_attention_block_reference(*args, None, lengths, norm_w, norm_b, eps, heads_partial=True)
    raise ValueError(f"rel_attention_block_heads: no implementation for device {x.device}")


rel_attention_block_heads.launches = 0


# ─── K2: the attention core with the projections outside ("v1") ────────────


def fused_rel_attention_reference(
    q_u: torch.Tensor,  # (B, H, T, hd): q + pos_bias_u, rounded to the dtype
    q_v: torch.Tensor,  # (B, H, T, hd): q + pos_bias_v
    k: torch.Tensor,  # (B, H, T, hd)
    v: torch.Tensor,  # (B, H, T, hd)
    p: torch.Tensor,  # (H, 2T−1, hd): the projected position table, per head
    lengths=None,  # (B,) valid key counts
) -> torch.Tensor:
    """Plain torch version of K2, with the TPU kernel's order of operations:
    content (q_u kᵀ) and position (q_v Pᵀ, row t shifted to P[T−1−t+s]) in
    f32, summed, then scaled by 1/√hd; keys at or past the length −1e9;
    f32 softmax normalised before AV, the probabilities rounded to the
    dtype; AV in f32, rounded. (B, H, T, hd). Pad query rows hold garbage,
    as in the kernel."""
    b, heads, t, hd = q_u.shape
    dt = q_u.dtype

    def f(a):
        return a.to(_F32)

    content = f(q_u) @ f(k).transpose(-1, -2)  # (B, H, T, T)
    raw = f(q_v) @ f(p).transpose(-1, -2)  # (B, H, T, 2T−1)
    ar = torch.arange(t, device=q_u.device)
    idx = (t - 1 - ar[:, None] + ar[None, :]).expand(b, heads, t, t)  # r = T−1−t+s
    scores = (content + raw.gather(-1, idx)) * (1.0 / math.sqrt(hd))
    kv = _key_lengths(lengths, b, t, q_u.device)
    scores = scores.masked_fill((ar[None, :] >= kv[:, None])[:, None, None, :], _NEG_INF)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = (e / e.sum(dim=-1, keepdim=True)).to(dt)
    return (f(probs) @ f(v)).to(dt)


# K2's bf16 core keeps a split's scores between its sweeps in 64 x 64 f32
# tiles (csrc/rel_attention_v1.cu V1_KEPT_TILE)
V1_KEPT_TILE = 64 * 64 * 4


def v1_core_plan(b: int, t: int, heads: int, hd: int, itemsize: int = 4, keep: bool | None = None) -> CorePlan:
    """K2's plan (csrc/rel_attention_v1.cu) for (B, T, H, hd) in a dtype,
    beside K1's `core_plan`. f32: K1's f32 core on K2's operands, planned
    as `core_plan` plans it. bf16: the two-sweep wgmma core on K1's bf16
    tiles (64 query rows, 64-key tiles, 160 threads), by default with
    `core_plan`'s key splits (the fewest that fill the waves where the grid
    underfills them, whole key tiles a split, none empty) and the scores
    computed again in sweep 2. Kept instead (`kept` tiles of V1_KEPT_TILE
    bytes a split in shared memory, the keys split further until a split's
    tiles fit, the fewest splits that fill the waves among those) where a
    split's tiles fit and the kept grid takes one wave of one block an SM
    (as at B=8, T'=126: the second block an SM that the recompute design
    holds at hd ≤ 64 then buys nothing); `keep` True or False forces either
    design where it fits (chip_smoke.py times both). `resident` counts
    blocks an SM holds by shared memory."""
    if itemsize == 4:
        return core_plan(b, t, heads, hd, 4)
    plan = core_plan(b, t, heads, hd, 2)
    if keep is False:
        return plan
    most = (SHARED_MEMORY_LIMIT - plan.smem) // V1_KEPT_TILE
    options = [s for s in CORE_SPLITS if (s - 1) * -(-plan.tiles // s) < plan.tiles and -(-plan.tiles // s) <= most]
    if not options:
        return plan
    splits = next((s for s in options if _fills(plan.blocks * s)), options[-1])
    if keep is None and plan.blocks * splits > SM_COUNT:
        return plan
    kept = -(-plan.tiles // splits)
    smem = plan.smem + kept * V1_KEPT_TILE
    return replace(plan, splits=splits, kept=kept, smem=smem, resident=SM_SHARED_MEMORY // (smem + BLOCK_RESERVED))


def v1_core_resident(itemsize: int, hd: int, kept: int = 0) -> int:
    """Blocks of K2's core that one SM of this card holds at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor): what v1_core_plan's
    `resident` says for an H100. Raises without a card."""
    n = _lib_v1().pk_rel_attention_v1_resident(0 if itemsize == 4 else 1, hd, kept)
    check_rc(max(0, -n), "v1_core_resident")
    return n


def _lib_v1() -> ctypes.CDLL:
    lib = load("rel_attention_v1")
    fn = lib.pk_rel_attention_v1
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i] + [p] * 7 + [i] * 7 + [p]
        fn.restype = i
    fn = lib.pk_rel_attention_v1_resident
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
    return lib


def _aligned(a: torch.Tensor) -> torch.Tensor:
    """a contiguous, its data 16-byte aligned (the cores' TMA and cp.async
    loads), copied where it is not."""
    a = a.contiguous()
    return a if a.data_ptr() % 16 == 0 else a.clone()


def _launch_v1(q_u, q_v, k, v, p, lengths):
    refuse_grad("fused_rel_attention", q_u, q_v, k, v, p)
    b, heads, t, hd = q_u.shape
    dt = q_u.dtype
    if dt not in DTYPE_CODE:
        raise TypeError(f"fused_rel_attention kernel takes float32 or bfloat16, got {dt}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"fused_rel_attention kernel: head dim {hd}; supported {_HEAD_DIMS}")
    want = dict(q_v=(q_v, (b, heads, t, hd)), k=(k, (b, heads, t, hd)), v=(v, (b, heads, t, hd)),
                p=(p, (heads, 2 * t - 1, hd)))
    for name, (a, shape) in want.items():
        if a.device != q_u.device or a.dtype != dt:
            raise ValueError(f"fused_rel_attention: {name} is {a.dtype} on {a.device}, q_u is {dt} on {q_u.device}")
        if tuple(a.shape) != shape:
            raise ValueError(f"fused_rel_attention: {name} has shape {tuple(a.shape)}, want {shape}")
    q_u, q_v, k, v, p = (_aligned(a) for a in (q_u, q_v, k, v, p))
    # the cores take min(len, T) themselves: no clamp launch
    kv = _key_lengths(lengths, b, t, q_u.device, clamp=False).contiguous()
    out = torch.empty_like(q_u)
    plan = v1_core_plan(b, t, heads, hd, q_u.element_size())
    lib = _lib_v1()
    with torch.cuda.device(q_u.device):
        rc = lib.pk_rel_attention_v1(
            DTYPE_CODE[dt], ptr(q_u), ptr(q_v), ptr(k), ptr(v), ptr(p), ptr(kv), ptr(out),
            b, heads, t, hd, plan.splits, plan.kept, plan.smem, stream(q_u.device),
        )
    check_rc(rc, "fused_rel_attention")
    fused_rel_attention.launches += 1
    return out


def fused_rel_attention(q_u, q_v, k, v, p, lengths=None) -> torch.Tensor:
    """softmax(((q_u kᵀ) + rel_shift(q_v Pᵀ))/√hd, keys masked by length) v,
    per (b, h); (B, H, T, hd) in q_u's dtype. Port of the reference's v1
    kernel (pallas_attention.py::fused_rel_attention); the q/k/v, position
    and out projections stay outside, with the caller.

    On a CUDA tensor this launches the hand-written kernel
    (csrc/rel_attention_v1.cu: in f32 K1's 8-warp core, in bf16 a wgmma
    core in two sweeps over the keys, splits as `v1_core_plan` says) or
    raises; on a CPU tensor it runs `fused_rel_attention_reference`. Each
    kernel launch adds one to `fused_rel_attention.launches`. Unlike the
    reference (T ≤ 768 there), any T runs. On a mesh with a 'model' axis
    > 1 the v1 route runs on the whole weights, gathered once when the
    facade is built, replicated over 'model' (models/encoder.py)."""
    if q_u.device.type == "cuda":
        return _launch_v1(q_u, q_v, k, v, p, lengths)
    if q_u.device.type == "cpu":
        return fused_rel_attention_reference(q_u, q_v, k, v, p, lengths)
    raise ValueError(f"fused_rel_attention: no implementation for device {q_u.device}")


fused_rel_attention.launches = 0

__all__ = [
    "position_table_np",
    "position_table",
    "rel_attention_block",
    "rel_attention_block_heads",
    "rel_attention_block_reference",
    "RelAttentionBlockFunction",
    "RelAttentionBlockHeadsFunction",
    "fused_rel_attention",
    "fused_rel_attention_reference",
    "v1_core_plan",
    "v1_core_resident",
    "V1_KEPT_TILE",
    "BlockPlan",
    "block_plan",
    "heads_plan",
    "CorePlan",
    "core_plan",
    "core_tile",
    "core_resident",
    "values_scratch",
    "CORE_SPLITS",
    "HOPPER_LAUNCHES",
    "TILED_LAUNCHES",
    "checked_args",
    "build",
]
