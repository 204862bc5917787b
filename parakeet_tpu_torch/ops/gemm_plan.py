"""Launch plan of the shared tiled GEMM (csrc/ffn_gemm.cuh), computed in
Python and passed to the CUDA entries as ints.

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

        def fills(s: int) -> bool:
            blocks = base * s
            return blocks >= SM_COUNT and blocks >= WAVE_FILL * SM_COUNT * -(-blocks // SM_COUNT)

        splits = next((s for s in divisors if fills(s)), divisors[-1])
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


__all__ = ["GEMM_COLS", "GEMM_ROWS", "GEMM_K_STEP", "MAX_SPLITS", "WAVE_FILL", "DFT_ROWS", "GemmPlan",
           "gemm_plan", "gemm_smem", "dft_cols", "dft_plan", "partial_elems", "tiles"]
