"""Launch plans of csrc/ffn_gemm.cuh's GEMMs, computed in Python and passed
to the CUDA entries as ints: the shared tiled GEMM (`gemm_plan`) and the
Hopper GEMM of K7's and K4's sublayers in bf16 (`hopper_plan`, at the end).

The GEMM runs C[M, N] = A[M, K] @ W[N, K]^T in block tiles of `rows` x 128
outputs, k in steps of 32. A GEMM whose epilogue is linear (a bias and a
residual added to the sum: K6's fc2, K1's position GEMM and
out-projection, K5's pw2) writes the f32 sums of its k slices (one or
more), which a closing pass sums in a fixed order, on 128-row tiles. One
with a nonlinear epilogue (GLU, K1's QKV fold, K8's bias + act stored
channel-major) cannot split; it takes the block rows (64, 96 or 128) that
put the least work on the busiest SM, ceil(blocks / SMs) x rows, the
fewest rows on a tie. K3's DFT (`dft_plan`) has both: one slice ends in
its power epilogue, several in linear partials that its closing pass sums.
On an NVIDIA H100 80GB HBM3 at 700.00 W, f32, B=8 (chip_smoke.py
tile_choice), 64-row tiles ran K1's QKV GEMM and
K5's pw1 faster than 128-row tiles at T'=126 (whole K1 call 0.138 against
0.164 ms; K5 0.073 against 0.100) and at T'=751 (K1 0.863 against 0.998;
K5 0.324 against 0.332): two 64-row blocks share an SM, so a tie in work
goes to them. 32-row tiles (0.625 shared-memory words per FMA) ran slower
than all three (K1 0.142 and 0.955 ms; K5 0.083 and 0.398) and are not
offered. K6's fc1 keeps its 128-row tiles.
"""

from __future__ import annotations

from dataclasses import dataclass

from parakeet_tpu_torch.ops._build import SHARED_MEMORY_LIMIT, SM_COUNT

GEMM_COLS = 128
GEMM_ROWS = (64, 96, 128)
GEMM_K_STEP = 32
MAX_SPLITS = 16
# a split GEMM's blocks must fill at least this share of the waves (of one
# block per SM) that they take
WAVE_FILL = 0.9
# shared memory per block by element size: f32 3 stages, bf16 4 stages of
# (rows + 128) tile rows of 32 k, padded to 36 floats / 40 bf16 values
_STAGES = {4: 3, 2: 4}
_ROW_ELEMS = {4: GEMM_K_STEP + 4, 2: GEMM_K_STEP + 8}


def gemm_smem(rows: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of `rows` x 128 tiles (bytes)."""
    return _STAGES[itemsize] * (rows + GEMM_COLS) * _ROW_ELEMS[itemsize] * itemsize


@dataclass(frozen=True)
class GemmPlan:
    """How one GEMM launches: block tile rows, k slices (1 = no closing
    pass), shared memory per block (bytes) and the number of blocks."""

    rows: int
    splits: int
    smem: int
    blocks: int


def tiles(m: int, n: int, rows: int = 128) -> int:
    return -(-m // rows) * -(-n // GEMM_COLS)


def _fills(blocks: int) -> bool:
    """Whether `blocks` give every SM one and fill at least WAVE_FILL of
    the waves (one block an SM) that they take."""
    return blocks >= SM_COUNT and blocks >= WAVE_FILL * SM_COUNT * -(-blocks // SM_COUNT)


def gemm_plan(m: int, n: int, k: int, itemsize: int = 4, split_k: bool = True,
              rows: int = GEMM_ROWS[-1]) -> GemmPlan:
    """The plan of one (M, N, K) GEMM. split_k (linear epilogues): `rows`-row
    tiles (128 unless given) and the fewest k slices, each of whole k
    steps, whose blocks give every SM one and fill at least WAVE_FILL of
    the waves they take; when no count up to MAX_SPLITS does, the most.
    Otherwise (nonlinear epilogues, n counting the weight rows): no split,
    and the block rows with the least work on the busiest SM (the fewest on
    a tie)."""
    if split_k:
        base = tiles(m, n, rows)
        steps = -(-k // GEMM_K_STEP)
        divisors = [s for s in range(1, min(steps, MAX_SPLITS) + 1) if steps % s == 0]
        splits = next((s for s in divisors if _fills(base * s)), divisors[-1])
    else:
        rows, splits = min(GEMM_ROWS, key=lambda r: -(-tiles(m, n, r) // SM_COUNT) * r), 1
    smem = gemm_smem(rows, itemsize)
    if smem > SHARED_MEMORY_LIMIT:
        raise ValueError(f"gemm_plan: {smem} B of shared memory per block")
    return GemmPlan(rows, splits, smem, tiles(m, n, rows) * splits)


# K3's DFT: 64-row tiles (a 10 s clip has 1,001 frames)
DFT_ROWS = 64


def dft_cols(n_fft: int) -> int:
    """Columns of K3's DFT GEMM: bins 0 .. n_fft/2 − 1, 64 a tile, each
    tile 64 cos columns then their 64 sin columns (the Nyquist bin is
    taken in the closing pass)."""
    return -(-(n_fft // 2) // (GEMM_COLS // 2)) * GEMM_COLS


def dft_plan(frames: int, n_fft: int) -> GemmPlan:
    """K3's DFT (frames × n_fft @ n_fft × dft_cols, f32) on DFT_ROWS-row
    tiles, split as a linear epilogue: the fewest k slices that give every
    SM a block and fill their waves. One slice runs the power epilogue
    (no partials); several write re/im partials that the closing pass sums
    in order before it forms the power. On an NVIDIA H100 80GB HBM3 at
    700.00 W (chip_smoke.py dft_choice, whole K3 call) it picks one pass on
    a 60 s clip, the fastest plan (0.1009 ms; 2 slices 0.1105), and 4
    slices on a 10 s clip (0.0325 ms; one pass 0.0398; 2 slices, which
    leave 4 SMs without a block, 0.0295)."""
    return gemm_plan(frames, dft_cols(n_fft), n_fft, 4, split_k=True, rows=DFT_ROWS)


def partial_elems(m: int, n: int, plan: GemmPlan) -> int:
    """f32 partials a linear-epilogue GEMM writes before its closing pass."""
    return plan.splits * m * n


# ─── The bf16 sublayer GEMMs of K7 and K4 (ffn_gemm.cuh hopper_gemm_kernel) ──
# 64 x 128 output tiles on wgmma m64n128k16 fed by TMA boxes of 64 k values x
# 64 rows through a 4-stage ring (160 threads: one consumer warpgroup, one
# producer warp; shared memory holds two blocks an SM). A linear epilogue
# splits k over a thread-block cluster of at most MAX_CLUSTER blocks, which,
# when a LayerNorm of the result follows, also spans every column tile of
# the rows. The C launch runs the plan as given and refuses one that breaks
# these rules.
HOPPER_ROWS, HOPPER_COLS, HOPPER_K_STEP = 64, 128, 64
HOPPER_KINDS = ("silu", "glu", "qkv_pos", "linear")
MAX_CLUSTER = 8
TMA_BOX = (64, 64)  # (k values, rows) of one TMA box: the k extent is the 128-byte swizzle
WGMMA_N = HOPPER_COLS
# dynamic shared memory of a block (bytes): 1 KB to align the ring, the ring
# (4 stages of (64 + 128) rows x 64 bf16 values), 4 x 64 f32 row values
# (LayerNorm statistics, the cluster's row exchange), 3 x 128 f32 column
# values (an epilogue's biases) and 16 mbarriers (ffn_gemm.cuh HG_SMEM)
HOPPER_SMEM = 1024 + 4 * (HOPPER_ROWS + HOPPER_COLS) * HOPPER_K_STEP * 2 + (4 * HOPPER_ROWS + 3 * HOPPER_COLS) * 4 + 16 * 8
# Clusters of n blocks of hopper_gemm_kernel that an H100 SXM (132 SMs)
# holds at once, by n, as cudaOccupancyMaxActiveClusters answered on an
# NVIDIA H100 80GB HBM3 (ops/ffn_attention.py hopper_active_clusters;
# chip_smoke.py prints the card's answer beside this table). A cluster is
# scheduled whole inside one GPC, so clusters hold fewer blocks at once
# than the 264 that single blocks do.
HOPPER_ACTIVE_CLUSTERS = {1: 264, 2: 132, 3: 79, 4: 62, 5: 47, 6: 39, 7: 32, 8: 30}


# the longest k slice of each row that a block of a LayerNorm'd launch
# normalises when its cluster is made smaller to save a wave
LN_SLICE = 256


def hopper_waves(size: int, clusters: int) -> int:
    """Waves that `clusters` clusters of `size` blocks take on the card."""
    return -(-clusters // HOPPER_ACTIVE_CLUSTERS[size])


@dataclass(frozen=True)
class HopperPlan:
    """How one hopper_gemm_kernel launch runs: its epilogue kind, the k
    slices and the column tiles a cluster holds (cluster = cols x splits
    blocks; 1 without a cluster), the blocks and the k steps."""

    kind: str
    splits: int
    cluster_cols: int
    blocks: int
    k_steps: int

    @property
    def cluster(self) -> int:
        return self.cluster_cols * self.splits


def hopper_plan(m: int, n: int, k: int, kind: str, *, whole_rows: bool = False,
                extra: tuple[int, int] | None = None, ln: bool = False) -> HopperPlan:
    """The plan of one bf16 (M, N, K) GEMM of K7, K4 or K1. kind "silu",
    "glu" (N counts W1's 2D rows; a tile holds 64 outputs), "qkv_pos"
    (extra: the position GEMM's (rows, N), same K, tiled in the same
    launch) or "linear".

    ln: the A rows (of "qkv_pos", the QKV problem's) are LayerNorm'd on the
    way in, once a cluster of column tiles (the grid padded to whole
    clusters; the position GEMM's tiles follow, padded to whole clusters
    too): 8 of them (fewer when there are fewer; for "qkv_pos" the most
    that divide its column tiles, 6 of 12 at D=512, so that no block of a
    cluster only LayerNorms), down to 4 or 2 only where that puts the
    launch in one wave and leaves each block a slice of at most LN_SLICE
    values of each row (a smaller cluster LayerNorms a longer slice of each
    row in every block, which costs more than a wave of a long launch, and
    more than the wave it saves once the slice is longer: K5's pw1 at
    D=1024, B=8, T'=126 took 0.0612 ms in clusters of 2, 0.0564 in
    clusters of 8, on an NVIDIA H100 80GB HBM3 at 700.00 W, chip_smoke.py
    lna_choice).

    A linear GEMM splits k into the fewest slices (dividing the k steps and
    the tile's 64 rows, cluster at most MAX_CLUSTER) whose blocks give every
    SM one and fill at least WAVE_FILL of their waves, else the most; then
    into fewer where that costs fewer waves x k steps a block (the fewest
    waves on a tie), since the card holds fewer blocks at once in clusters.
    whole_rows puts every column tile of the rows in the cluster (a
    LayerNorm of the result follows); a row of more than MAX_CLUSTER tiles
    raises."""
    if kind not in HOPPER_KINDS:
        raise ValueError(f"hopper_plan: kind {kind!r}")
    row_tiles = -(-m // HOPPER_ROWS)
    cols = -(-(n // 2) // (HOPPER_COLS // 2)) if kind == "glu" else -(-n // HOPPER_COLS)
    steps = -(-k // HOPPER_K_STEP)
    extra_tiles = -(-extra[0] // HOPPER_ROWS) * -(-extra[1] // HOPPER_COLS) if extra is not None else 0
    if ln:
        if kind == "linear" or (extra is not None) != (kind == "qkv_pos"):
            raise ValueError("hopper_plan: a LayerNorm'd A needs a SiLU, GLU or QKV problem")

        def clusters(c):
            return row_tiles * -(-cols // c) + -(-extra_tiles // c)

        c = min(MAX_CLUSTER, cols)
        if kind == "qkv_pos":  # a width that divides the column tiles: no block only LayerNorms
            c = max(s for s in range(1, c + 1) if cols % s == 0)
        if hopper_waves(c, clusters(c)) > 1:
            c = next((s for s in (4, 2) if s < c and k <= LN_SLICE * s and hopper_waves(s, clusters(s)) == 1), c)
        return HopperPlan(kind, 1, c, clusters(c) * c, steps)
    if kind != "linear":
        return HopperPlan(kind, 1, 1, row_tiles * cols + extra_tiles, steps)
    cn = cols if whole_rows else 1
    if cn > MAX_CLUSTER:
        raise ValueError(f"hopper_plan: a row of {n} columns spans {cn} tiles, more than a cluster's "
                         f"{MAX_CLUSTER} blocks")
    options = [s for s in (1, 2, 4, 8) if s * cn <= MAX_CLUSTER and steps % s == 0]
    splits = next((s for s in options if _fills(row_tiles * cols * s)), options[-1])
    clusters = row_tiles * cols // cn
    for s in (s for s in options[::-1] if s < splits):  # waves / s against splits', cross-multiplied
        ws, wb = hopper_waves(cn * s, clusters), hopper_waves(cn * splits, clusters)
        if ws * splits < wb * s or (ws * splits == wb * s and ws < wb):
            splits = s
    return HopperPlan(kind, splits, cn, row_tiles * cols * splits, steps)


def hopper_fits(d: int) -> bool:
    """Whether the Hopper designs of K7, K4 and K1 take width D: a row of
    the LayerNorm'd results (fc2's, pw2's) fits one cluster's column
    tiles (K1's design follows K7's)."""
    return -(-d // HOPPER_COLS) <= MAX_CLUSTER


__all__ = ["GEMM_COLS", "GEMM_ROWS", "GEMM_K_STEP", "MAX_SPLITS", "WAVE_FILL", "DFT_ROWS", "GemmPlan",
           "gemm_plan", "gemm_smem", "dft_cols", "dft_plan", "partial_elems", "tiles", "HOPPER_ROWS",
           "HOPPER_COLS", "HOPPER_K_STEP", "HOPPER_KINDS", "HOPPER_SMEM", "LN_SLICE",
           "HOPPER_ACTIVE_CLUSTERS", "MAX_CLUSTER", "TMA_BOX", "WGMMA_N", "HopperPlan", "hopper_plan",
           "hopper_waves", "hopper_fits"]
