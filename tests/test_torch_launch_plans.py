"""Launch plans of the shared tiled GEMM (ops/gemm_plan.py gemm_plan, as
K6's ffn_plan, K1's block_plan, K5's conv_plan, K8's subsample_plan and
K3's dft_plan use it), of K7's and K4's Hopper GEMMs (hopper_plan, as
k7_plan and k4_plan use it) and of K2 (ops/rel_attention.py v1_core_plan), computed
in Python and passed to the CUDA kernels as ints. A launch refused for too much shared memory never runs,
so these checks are the guard that runs without a card."""

import re

import pytest
import torch

from parakeet_tpu_torch.ops import _build
from parakeet_tpu_torch.ops import conv_ffn_final as K4
from parakeet_tpu_torch.ops import conv_module as CM
from parakeet_tpu_torch.ops import ffn_attention as K7
from parakeet_tpu_torch.ops import feed_forward as FF
from parakeet_tpu_torch.ops import gemm_plan as GP
from parakeet_tpu_torch.ops import rel_attention as RA
from parakeet_tpu_torch.ops import subsample as SS

LIMIT = 232_448  # an H100 block's dynamic shared memory, bytes
SEQ_LENS = (1, 37, 126, 751, 1001, 3000, 6001)
ITEMSIZES = (4, 2)  # float32, bfloat16
FFN_WIDTHS = ((512, 2048), (1024, 4096))  # 110m, the 600m presets


def test_limits_are_the_h100s():
    assert _build.SHARED_MEMORY_LIMIT == LIMIT
    assert _build.SM_COUNT == 132


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("d, f", FFN_WIDTHS)
@pytest.mark.parametrize("t", SEQ_LENS)
def test_ffn_plan_fits_and_splits_whole_k_steps(t, d, f, itemsize):
    """K6's plan with and without a LayerNorm of the result. bf16 (rows
    within a cluster): the Hopper route, 2 launches, fc1's LayerNorm once a
    cluster of column tiles (8 of them, or 4 or 2 where that makes one
    wave), fc2's k slices dividing its k steps and the tile's 64 rows in a
    cluster of at most 8 blocks (every column tile of the rows with the
    LayerNorm). f32: the tiled route, 4 launches, fc1 on 128-row tiles, fc2
    split into whole k steps by the shared plan."""
    m = 8 * t
    for final in (False, True):
        plan = FF.ffn_plan(m, d, f, itemsize, final)
        fc1, fc2 = plan.fc1, plan.fc2
        if itemsize == 2:
            assert plan.route == "hopper" and plan.launches == 2 and plan.scratch == (m * d + m * f) * 2
            c, cols = fc1.cluster, -(-f // 128)
            assert fc1.kind == "silu" and fc1.splits == 1 and fc1 == GP.hopper_plan(m, f, d, "silu", ln=True)
            assert c == min(GP.MAX_CLUSTER, cols) or (c in (4, 2) and GP.hopper_waves(c, fc1.blocks // c) == 1)
            # a smaller cluster leaves each block at most LN_SLICE values of a row
            assert c == min(GP.MAX_CLUSTER, cols) or d <= GP.LN_SLICE * c
            assert fc1.blocks == -(-m // 64) * -(-cols // c) * c
            assert fc2.kind == "linear" and fc2.cluster_cols == (-(-d // 128) if final else 1)
            assert 1 <= fc2.cluster <= GP.MAX_CLUSTER and 64 % fc2.splits == 0
            assert fc2.k_steps == -(-f // 64) and fc2.k_steps % fc2.splits == 0
            assert plan.ints() == (1, c, fc2.splits) and plan.part_elems(m, d) == 0
            assert GP.HOPPER_SMEM <= LIMIT
            continue
        assert plan.route == "tiled" and plan.launches == 4
        assert fc1.rows == FF.FC1_ROWS == 128 and fc1.splits == 1 and fc1.smem <= LIMIT
        assert fc2 == GP.gemm_plan(m, d, f, 4) and fc2.smem <= LIMIT
        steps = -(-f // FF.GEMM_K_STEP)
        assert steps % fc2.splits == 0 and 1 <= fc2.splits <= FF.MAX_SPLITS
        assert plan.scratch == (m * d + m * f) * 4 + fc2.splits * m * d * 4
        assert plan.part_elems(m, d) == fc2.splits * m * d and plan.ints() == (0, 0, fc2.splits)
        tiles = -(-m // 128) * -(-d // 128)

        def fills(s):  # every SM gets a block and the waves are at least 90% full
            blocks = tiles * s
            return blocks >= 132 and blocks >= 0.9 * 132 * -(-blocks // 132)

        divisors = [s for s in range(1, min(steps, FF.MAX_SPLITS) + 1) if steps % s == 0]
        if any(fills(s) for s in divisors):
            assert fills(fc2.splits) and not any(fills(s) for s in divisors if s < fc2.splits)
        else:
            assert fc2.splits == divisors[-1]


@pytest.mark.parametrize("d, f", FFN_WIDTHS)
def test_ffn_plan_fills_the_card_at_ten_second_clips(d, f):
    """B=8, T'=126: fc2 (N = D) has too few output tiles alone. In f32 its
    128x128 tiles split k into 8 slices at D=512; in bf16 its 64x128 tiles
    split k over clusters that the card holds in one wave, and fc1 gives
    every SM a block."""
    m = 8 * 126
    f32, bf = FF.ffn_plan(m, d, f, 4), FF.ffn_plan(m, d, f, 2)
    assert -(-m // 128) * -(-d // 128) * f32.splits >= 132
    assert FF.ffn_plan(m, 512, 2048).splits == 8
    assert bf.fc2.blocks >= GP.WAVE_FILL * 132 and GP.hopper_waves(bf.fc2.cluster, bf.fc2.blocks // bf.fc2.cluster) == 1
    assert bf.fc1.blocks >= 132


def test_ffn_plan_evens_out_the_last_wave_at_sixty_second_clips():
    """B=8, T'=751: 188 tiles take two waves of 132 blocks, 71% full; two
    k slices make 376 half-length blocks in three waves, 95% full. From
    T'=1001 the tiles alone fill their waves."""
    assert FF.ffn_plan(8 * 751, 512, 2048).splits == 2
    assert FF.ffn_plan(8 * 1001, 512, 2048).splits == 1
    assert FF.ffn_plan(8 * 751, 1024, 4096).splits == 1


def test_ffn_plan_takes_odd_widths():
    plan = FF.ffn_plan(10, 36, 70)
    assert plan.splits >= 1 and -(-70 // 32) % plan.splits == 0


# the block kernels' GEMMs at the preset widths: (name, N as a multiple of
# D, whether the epilogue is linear and may split k)
BLOCK_GEMMS = (("qkv", 3, False), ("pw1", 2, False), ("out", 1, True), ("pw2", 1, True))


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("d", (512, 1024))
@pytest.mark.parametrize("t", SEQ_LENS)
@pytest.mark.parametrize("name, width, linear", BLOCK_GEMMS)
def test_gemm_plan_fits_and_splits_whole_k_steps(name, width, linear, t, d, itemsize):
    m, n = 8 * t, width * d
    plan = GP.gemm_plan(m, n, d, itemsize, split_k=linear)
    assert plan.smem <= LIMIT and plan.smem == GP.gemm_smem(plan.rows, itemsize)
    assert plan.rows in GP.GEMM_ROWS
    assert plan.blocks == -(-m // plan.rows) * -(-n // 128) * plan.splits
    steps = -(-d // GP.GEMM_K_STEP)
    assert steps % plan.splits == 0 and 1 <= plan.splits <= GP.MAX_SPLITS
    if linear:
        assert plan.rows == 128
    else:
        # a nonlinear epilogue never splits k; its block rows put the least
        # work on the busiest SM, the fewest rows on a tie
        def busiest(rows):
            return -(-(-(-m // rows) * -(-n // 128)) // 132) * rows

        assert plan.splits == 1
        assert all(busiest(plan.rows) < busiest(r) or (busiest(plan.rows) == busiest(r) and plan.rows <= r)
                   for r in GP.GEMM_ROWS)


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("d", (512, 1024))
def test_narrow_gemms_fill_the_card_at_ten_second_clips(d, itemsize):
    """B=8, T'=126: the out-projection and pw2 (N = D) have too few
    128x128 tiles alone (32 at D=512), so k is split: 8 slices at D=512."""
    m = 8 * 126
    assert GP.gemm_plan(m, d, d, itemsize).blocks >= 132
    assert GP.gemm_plan(m, 512, 512, itemsize).splits == 8
    # K1's QKV: 11 x 12 = 132 blocks of 96 rows, one per SM; K5's pw1: 128
    # blocks of 64 rows
    assert GP.gemm_plan(m, 3 * 512, 512, itemsize, split_k=False).rows == 96
    assert GP.gemm_plan(m, 2 * 512, 512, itemsize, split_k=False).rows == 64


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("t", SEQ_LENS)
def test_block_and_conv_plans_size_their_partials(t, itemsize):
    """K1's tiled position GEMM and out-projection share one f32 partials
    buffer (their closing passes run one after the other); K5's tiled pw2
    has its own. K1's and K5's Hopper designs (bf16) write none: their
    linear GEMMs close in a cluster."""
    b, d = 8, 512
    plan = RA.heads_plan(b, t, d, d, itemsize)
    assert plan.qkv.splits == 1 and not plan.hopper
    assert plan.ints() == (0, plan.qkv.rows, plan.pos.splits, plan.out.splits, plan.core.splits)
    assert plan.partials == max(plan.pos.splits * (2 * t - 1) * d, plan.out.splits * b * t * d)
    whole = RA.block_plan(b, t, d, itemsize)
    assert whole == plan if itemsize == 4 else (whole.hopper and whole.partials == 0)
    conv = CM.conv_plan(b * t, d, itemsize)
    assert conv.pw1.splits == 1
    if itemsize == 2:
        assert conv.route == "hopper" and conv.launches == 3 and conv.partials == 0
        assert conv.ints() == (1, conv.pw1.cluster_cols, conv.pw2.splits)
    else:
        assert conv.route == "tiled" and conv.launches == 5 and conv.ints() == (0, conv.pw1.rows, conv.pw2.splits)
        assert conv.partials == conv.pw2.splits * b * t * d


def test_ffn_plan_is_the_shared_plan_of_fc2():
    """fc2's plan is the shared one of its route: gemm_plan's split-K plan
    on the tiled route (f32; bf16 rows wider than a cluster), hopper_plan
    in bf16 rows within a cluster."""
    for m, d, f in ((1008, 512, 2048), (6008, 512, 2048), (1008, 1024, 4096), (10, 36, 70), (1008, 1280, 5120)):
        for itemsize in ITEMSIZES:
            plan = FF.ffn_plan(m, d, f, itemsize)
            if itemsize == 2 and GP.hopper_fits(d):
                assert plan.fc2 == GP.hopper_plan(m, d, f, "linear")
                assert plan.fc1 == GP.hopper_plan(m, f, d, "silu", ln=True)
            else:
                fc2 = GP.gemm_plan(m, d, f, itemsize)
                assert plan.route == "tiled" and (plan.splits, plan.fc2.smem) == (fc2.splits, fc2.smem)
                assert (plan.fc1.rows, plan.fc1.smem) == (128, GP.gemm_smem(128, itemsize))


def test_plans_follow_the_dtype_itemsize():
    assert torch.empty((), dtype=torch.bfloat16).element_size() == 2
    assert RA.v1_core_plan(8, 751, 8, 64, 2, keep=False).smem < RA.v1_core_plan(8, 751, 8, 64, 4).smem
    assert FF.ffn_plan(1008, 1280, 5120, 2).fc2.smem < FF.ffn_plan(1008, 1280, 5120, 4).fc2.smem
    assert FF.ffn_plan(1008, 512, 2048, 2).route == "hopper" and FF.ffn_plan(1008, 512, 2048, 4).route == "tiled"
    assert CM.conv_plan(1008, 512, 2).route == "hopper" and CM.conv_plan(1008, 512, 4).route == "tiled"


SUBSAMPLE_SHAPES = ((1001, 80), (6001, 80), (1001, 128), (129, 80))


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("t, mel", SUBSAMPLE_SHAPES)
def test_subsample_plan_fits_and_never_splits(t, mel, itemsize):
    """conv2's epilogue (bias, act, one rounding, channel-major stores) is
    nonlinear: one k slice, the busiest-SM block rows, and the staging
    tile of 128 channels x (rows + 2) floats inside the ring's shared
    memory."""
    m = 8 * SS.out_size(t) * SS.out_size(mel)
    plan = SS.subsample_plan(m, 256, itemsize)
    assert plan == GP.gemm_plan(m, 256, 256, itemsize, split_k=False)
    assert plan.splits == 1 and plan.smem <= LIMIT
    assert 128 * (plan.rows + 2) * 4 <= plan.smem
    if t >= 1001:
        assert plan.blocks >= 132  # hundreds of blocks: no SM idles


def test_subsample_plan_at_ten_second_clips():
    """B=8, T=1001: 40,160 positions; 64 and 128 rows both put 640 rows on
    the busiest SM, and the tie goes to 64 (two blocks share an SM)."""
    m = 8 * 251 * 20
    assert SS.out_size(1001) == 251 and SS.out_size(80) == 20
    assert SS.subsample_plan(m, 256).rows == 64
    assert SS.subsample_plan(m, 256).blocks == 628 * 2


@pytest.mark.parametrize("seconds", (1, 10, 30, 60))
def test_dft_plan_fits_and_splits_whole_k_steps(seconds):
    frames = (seconds * 16000 + 512 - 512) // 160 + 1
    plan = GP.dft_plan(frames, 512)
    assert GP.dft_cols(512) == 512 and plan.rows == GP.DFT_ROWS
    assert plan.smem == GP.gemm_smem(plan.rows, 4) <= LIMIT
    assert (512 // GP.GEMM_K_STEP) % plan.splits == 0 and 1 <= plan.splits <= GP.MAX_SPLITS
    assert plan.blocks == -(-frames // plan.rows) * 4 * plan.splits


def test_dft_plan_fills_the_card_at_ten_seconds_and_runs_one_pass_at_sixty():
    """10 s: 16 x 4 tiles of 64 frames leave most SMs idle, so k is split
    until every SM has a block; 60 s: 94 x 4 tiles fill their waves, so
    the DFT runs in one pass with the power epilogue (no partials)."""
    ten = GP.dft_plan(1001, 512)
    assert ten.splits > 1 and ten.blocks >= 132
    assert GP.dft_plan(6001, 512).splits == 1


def test_dft_plan_takes_other_n_fft():
    """n_fft 400 (200 bins): 4 tiles, the last one partly zero rows."""
    assert GP.dft_cols(400) == 512
    assert GP.dft_plan(1001, 400).smem <= LIMIT


# ─── the 600m shapes (tdt-600m, rnnt-600m: D=1024, F=4096, H=8, hd=128) ─────
# (B, T'): the 8-clip batch, 20 windows of 10 s, one dense 95 s clip
SHAPES_600M = ((8, 126), (20, 126), (1, 1188))


def _conv1_dw1_smem(mel: int) -> int:
    """csrc/subsample.cu conv1_dw1_smem_bytes: 4·4+3 mel rows of the padded
    row stride and a 9-row conv1 slab of (F2 + 2) columns x 32 channels."""
    f2 = (mel - 1) // 2 + 1
    row = 2 * 8 * -(-f2 // 8) + 4
    return ((4 * 4 + 3) * row + (2 * 4 + 1) * (f2 + 2) * 32) * 4


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("mel", (80, 128))
def test_subsample_plans_at_the_600m_mel_bins(mel, itemsize):
    """K8 on 128 mel bins (tdt-600m): F2 = 64, twice the columns of 80, in
    the conv1_dw1 slab and in conv2's GEMM; both fit a block."""
    assert _conv1_dw1_smem(mel) <= LIMIT
    assert _conv1_dw1_smem(128) == 86_064
    for b, t in ((8, 1001), (20, 1001), (1, 9501)):
        m = b * SS.out_size(t) * SS.out_size(mel)
        plan = SS.subsample_plan(m, 256, itemsize)
        assert plan.splits == 1 and plan.smem <= LIMIT and 128 * (plan.rows + 2) * 4 <= plan.smem
        assert plan.blocks == -(-m // plan.rows) * 2


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("b, t", SHAPES_600M)
def test_k7_and_k4_plans_at_the_600m_widths(b, t, itemsize):
    """At D=1024, F=4096 K7 runs K6's plan then K1's, K4 K5's then K6's
    with a LayerNorm of the result, of one route: in f32 (the tiled
    sequences) every GEMM fits a block and splits whole k steps."""
    d, f, m = 1024, 4096, b * t
    k7, k4 = K7.k7_plan(b, t, d, f, itemsize), K4.k4_plan(b, t, d, f, itemsize)
    assert k7.ffn == FF.ffn_plan(m, d, f, itemsize, final_norm=itemsize == 2)
    assert k4.ffn == FF.ffn_plan(m, d, f, itemsize, final_norm=True)
    assert k4.conv == CM.conv_plan(m, d, itemsize, ln_out=itemsize == 2)
    if itemsize == 2:
        assert k7.hopper and k4.hopper and k7.launches == k4.launches == 5
        return
    ffn, attn, conv = k7.ffn, k7.attn, k4.conv
    assert attn == RA.heads_plan(b, t, d, d, itemsize)
    assert ffn.fc2.smem <= LIMIT and (f // GP.GEMM_K_STEP) % ffn.splits == 0
    for g, k in ((attn.qkv, d), (attn.pos, d), (attn.out, d), (conv.pw1, d), (conv.pw2, d)):
        assert g.smem <= LIMIT and g.smem == GP.gemm_smem(g.rows, itemsize)
        assert (k // GP.GEMM_K_STEP) % g.splits == 0 and 1 <= g.splits <= GP.MAX_SPLITS
    assert attn.qkv.splits == 1 and conv.pw1.splits == 1
    assert attn.partials == max(attn.pos.splits * (2 * t - 1) * d, attn.out.splits * m * d)
    assert (k7.launches, k4.launches) == (11, 9)


# ─── K7's and K4's plans: the Hopper GEMMs in bf16 (gemm_plan.hopper_plan), else the tiled sequences ───

HOPPER_SEQ_LENS = (64, 126, 751, 1001, 3000)  # from the encoder's _FFN_MIN_FRAMES up


def _hopper_plans(b, t, d, f):
    """(name, plan, K, K of a LayerNorm'd A or 0) of every GEMM launch of K7 and K4 in bf16."""
    k7, k4 = K7.k7_plan(b, t, d, f, 2), K4.k4_plan(b, t, d, f, 2)
    return [("k7 fc1", k7.ffn.fc1, d, d), ("k7 fc2", k7.ffn.fc2, f, 0), ("k7 qkv_pos", k7.qkv_pos, d, 0),
            ("k7 out", k7.out, d, 0), ("k4 pw1", k4.conv.pw1, d, d), ("k4 pw2", k4.conv.pw2, d, 0),
            ("k4 fc1", k4.ffn.fc1, d, 0), ("k4 fc2", k4.ffn.fc2, f, 0)]


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("d, f", FFN_WIDTHS)
@pytest.mark.parametrize("t", HOPPER_SEQ_LENS)
@pytest.mark.parametrize("b", (1, 8))
def test_hopper_plans_fit_the_card(b, t, d, f, itemsize):
    """bf16: clusters of 1-8 blocks whose k slices divide the k steps (and
    the tile's 64 rows, each slice closing its share), the ring, its
    barriers and a LayerNorm's vectors within a block's shared memory, TMA
    boxes within 256 per dimension, a wgmma N that is a multiple of 8 up to
    256, and the blocks the tiles, clusters and slices make; the ints the C
    entries take. f32: K6's, K1's and K5's f32 plans, in the same ints."""
    m = b * t
    k7, k4 = K7.k7_plan(b, t, d, f, itemsize), K4.k4_plan(b, t, d, f, itemsize)
    if itemsize == 4:
        ffn, attn, conv = FF.ffn_plan(m, d, f, 4), RA.block_plan(b, t, d, 4), CM.conv_plan(m, d, 4)
        assert not k7.hopper and not k4.hopper
        assert (k7.ffn, k7.attn, k4.conv) == (ffn, attn, conv) and k4.ffn == FF.ffn_plan(m, d, f, 4, True)
        assert k7.ints() == (0, ffn.splits, attn.qkv.rows, attn.pos.splits, attn.out.splits, 0, attn.core.splits)
        assert k4.ints() == (0, ffn.splits, *conv.ints()[1:], 0)
        assert k7.partials(m, d) == max(ffn.splits * m * d, attn.partials)
        assert k4.partials(m, d) == max(ffn.splits * m * d, conv.partials)
        assert (k7.launches, k4.launches) == (4 + RA.TILED_LAUNCHES, 5 + 4) == (11, 9)
        return
    assert k7.hopper and k4.hopper and k7.launches == k4.launches == 5
    assert k7.partials(m, d) == k4.partials(m, d) == 0
    assert all(1 <= side <= 256 for side in GP.TMA_BOX) and GP.TMA_BOX[0] * 2 == 128  # the 128-byte swizzle
    assert GP.TMA_BOX == (GP.HOPPER_K_STEP, GP.HOPPER_COLS // 2)
    assert GP.WGMMA_N % 8 == 0 and GP.WGMMA_N <= 256
    assert GP.HOPPER_SMEM <= LIMIT and GP.HOPPER_SMEM * 2 <= 228 * 1024  # two blocks an SM
    rows = GP.HOPPER_ROWS
    for name, plan, k, ln_k in _hopper_plans(b, t, d, f):
        assert 1 <= plan.cluster <= GP.MAX_CLUSTER and rows % plan.splits == 0, name
        assert plan.k_steps == -(-k // GP.HOPPER_K_STEP) and plan.k_steps % plan.splits == 0, name
        if ln_k:
            # one cluster of column tiles LayerNorms the rows once: 8 of them, or 4 or 2 in one wave
            cols = -(-d // 64) if plan.kind == "glu" else -(-f // 128)
            c = plan.cluster
            assert c == min(GP.MAX_CLUSTER, cols) or (c in (4, 2) and GP.hopper_waves(c, -(-m // rows) * -(-cols // c)) == 1)
            assert c == min(GP.MAX_CLUSTER, cols) or d <= GP.LN_SLICE * c
            assert plan.splits == 1 and plan.blocks == -(-m // rows) * -(-cols // c) * c, name
        elif plan.kind == "linear":
            assert plan.blocks == -(-m // rows) * -(-d // 128) * plan.splits, name
        elif plan.kind == "qkv_pos":
            assert plan.blocks == -(-m // rows) * -(-3 * d // 128) + -(-(2 * t - 1) // rows) * -(-d // 128)
        else:
            assert plan.blocks == -(-m // rows) * -(-f // 128), name
    # a LayerNorm of the result follows fc2 and pw2: every column tile of the rows in the cluster
    for plan in (k7.ffn.fc2, k4.conv.pw2, k4.ffn.fc2):
        assert plan.cluster_cols == -(-d // 128)
    assert k7.out.cluster_cols == 1
    assert k7.ints() == (1, k7.ffn.fc2.splits, 0, 0, k7.out.splits, k7.ffn.fc1.cluster_cols, k7.core.splits)
    assert k7.core == RA.core_plan(b, t, 8, d // 8, 2)
    assert k4.ints() == (1, k4.ffn.fc2.splits, 0, k4.conv.pw2.splits, k4.conv.pw1.cluster_cols)


@pytest.mark.parametrize("d, f", FFN_WIDTHS)
def test_hopper_plans_fill_the_card_at_ten_second_clips(d, f):
    """B=8, T'=126 (M = 1008: 16 row tiles of 64). In bf16 fc1, QKV with
    the position GEMM and K4's fc1 give every SM a block. A GEMM whose
    result is LayerNorm'd keeps a row in one cluster of at most 8 blocks,
    so it takes at most 8 x 16 = 128 blocks: the plan takes all of them (k
    split in clusters of 8, 30 of which the card holds at once). The
    out-projection at D=512 takes 2 k slices, 128 blocks in 64 clusters of
    2, one wave: 4 slices would make 256 blocks in 64 clusters of 4, of
    which the card holds 62, two waves of half the k steps, and the tie
    goes to fewer waves. pw1's tiles of 64 GLU outputs make 16 x D/64
    blocks. In f32 K7 and K4 run the tiled sequences' plans."""
    k7, k4 = K7.k7_plan(8, 126, d, f, 2), K4.k4_plan(8, 126, d, f, 2)
    for plan in (k7.ffn.fc2, k4.conv.pw2, k4.ffn.fc2):
        assert plan.cluster == GP.MAX_CLUSTER and plan.blocks == 16 * GP.MAX_CLUSTER
        assert GP.hopper_waves(plan.cluster, 16) == 1  # one cluster a row tile
    assert k7.out.blocks >= GP.WAVE_FILL * 132 and GP.hopper_waves(k7.out.cluster, 16 * d // 128) == 1
    for plan in (k7.ffn.fc1, k7.qkv_pos, k4.ffn.fc1):
        assert plan.blocks >= 132
    assert k4.conv.pw1.blocks == 16 * d // 64
    if d == 512:
        assert (k7.ffn.fc2.splits, k7.out.splits) == (2, 2)
        assert GP.hopper_waves(4, 64) == 2 and GP.hopper_waves(2, 64) == 1
    assert not K7.k7_plan(8, 126, d, f, 4).hopper and not K4.k4_plan(8, 126, d, f, 4).hopper


_LAUNCH = re.compile(r"\b(launch_hopper_gemm|launch_hopper_gemm_ln|launch_cluster_linear|launch_depthwise|launch_attn|"
                     r"launch_layer_norm_rows|launch_tiled_gemm_rows|launch_tiled_gemm|launch_gemm_reduce|launch_linear|"
                     r"run_ffn_hopper|run_ffn|run_conv_hopper|run_conv|run_block)\b")
# the launch sequences, by the header that holds them
_SEQUENCES = {"run_ffn": "feed_forward.cuh", "run_ffn_hopper": "feed_forward.cuh", "run_conv": "conv_module.cuh",
              "run_conv_hopper": "conv_module.cuh", "run_block": "rel_attention.cuh"}


def _c_launches(path, fn: str) -> int:
    """Kernel launches of `int fn(` in a csrc/ file: one for each launcher
    called, two for launch_linear (its GEMM and closing pass), and the
    launch sequences (K6's run_ffn and run_ffn_hopper, K5's run_conv and
    run_conv_hopper, K1's run_block) counted in their headers (K1's tiled
    design: from its first tiled statement up to its head-sharded branch;
    `run_block/hopper`, its Hopper design, where the launches with and
    without the LayerNorm are alternatives)."""
    src = path.read_text()
    fn, _, part = fn.partition("/")
    body = src[re.search(rf"\bint {fn}\(", src).start():]
    body = body[body.index("{"):body.index("\n}\n")]
    if fn == "run_block":
        tiled = body.index("  g.a = x;\n")
        if part == "hopper":
            return len(set(_LAUNCH.findall(body[body.index("if (hopper) {"):tiled])))
        body = body[tiled:body.index("FfnGemmArgs o = {};")]
    calls = _LAUNCH.findall(body)
    n = sum(2 if c == "launch_linear" else 1 for c in calls if c not in _SEQUENCES)
    return n + sum(_c_launches(_build._CSRC / _SEQUENCES[c], c) for c in calls if c in _SEQUENCES)


def test_k7_and_k4_plans_count_their_c_launches():
    """K7 and K4 run K6's and K5's sequences of their route: bf16 the
    Hopper design (K6's 2 and K1's 3; K5's 3 and K6's 2), otherwise the
    tiled sequences (K6's 4 then K1's 7; K5's 5 then K6's 4)."""
    csrc = _build._CSRC
    for itemsize, fn, n7, n4 in ((2, "run_hopper", 5, 5), (4, "run_tiled", 11, 9)):
        k7, k4 = K7.k7_plan(8, 126, 512, 2048, itemsize), K4.k4_plan(8, 126, 512, 2048, itemsize)
        assert _c_launches(csrc / "ffn_attention.cu", fn) == k7.launches == n7
        assert _c_launches(csrc / "conv_ffn_final.cu", fn) == k4.launches == n4


@pytest.mark.parametrize("itemsize, d", ((2, 512), (2, 1024), (4, 512), (4, 1024), (2, 1280)))
def test_k6_and_k5_plans_count_their_c_launches(itemsize, d):
    """K6's and K5's C entries run one sequence a route: in bf16 rows within
    a cluster the Hopper design, 2 and 3 launches, with no LayerNorm launch
    and no closing pass (fc1's and pw1's LayerNorm on their A path, fc2 and
    pw2 closed in a cluster); otherwise the tiled sequences, 4 and 5."""
    csrc = _build._CSRC
    m = 8 * 126
    ffn, conv = FF.ffn_plan(m, d, 4 * d, itemsize), CM.conv_plan(m, d, itemsize)
    hopper = itemsize == 2 and d <= 1024
    assert ffn.route == conv.route == ("hopper" if hopper else "tiled")
    sfx = "_hopper" if hopper else ""
    assert _c_launches(csrc / "feed_forward.cuh", f"run_ffn{sfx}") == ffn.launches == (2 if hopper else 4)
    assert _c_launches(csrc / "conv_module.cuh", f"run_conv{sfx}") == conv.launches == (3 if hopper else 5)
    for header, fn in (("feed_forward.cuh", "run_ffn_hopper"), ("conv_module.cuh", "run_conv_hopper")):
        body = csrc.joinpath(header).read_text()
        body = body[body.index(f"int {fn}("):]
        body = body[:body.index("\n}\n")]
        assert not {"launch_layer_norm_rows", "launch_gemm_reduce", "launch_linear"} & set(_LAUNCH.findall(body))
    for entry, fn in (("feed_forward.cu", "run_ffn_hopper("), ("conv_module.cu", "run_conv_hopper(")):
        assert fn in csrc.joinpath(entry).read_text()


def test_k1_plans_count_their_c_launches():
    """K1 in bf16 at D ≤ 1024: 3 launches (QKV with the LayerNorm and the
    position GEMM, the core, the out-projection in a cluster); the tiled
    design (f32, bf16 at D > 1024): 7 with the LayerNorm."""
    rel = _build._CSRC / "rel_attention.cuh"
    assert _c_launches(rel, "run_block/hopper") == RA.HOPPER_LAUNCHES == 3
    assert _c_launches(rel, "run_block") == RA.TILED_LAUNCHES == 7
    for itemsize, d, hopper in ((2, 512, True), (2, 1024, True), (2, 1280, False), (4, 512, False), (4, 1024, False)):
        plan = RA.block_plan(8, 126, d, itemsize, d // 128 if d > 1024 else 8)
        assert plan.hopper == hopper and plan.launches == (3 if hopper else 7) and plan.ints()[0] == hopper


def test_layer_norm_clusters_shrink_only_to_short_slices():
    """A LayerNorm'd A's cluster shrinks from 8 column tiles to 4 or 2 only
    where that makes one wave and a block's slice of each row stays within
    LN_SLICE values: K6's fc1 at D=512, B=8, T'=126 runs in clusters of 2
    (256 values a block), K5's pw1 at D=1024 keeps 8 (2 would leave 512)."""
    assert GP.hopper_plan(1008, 2048, 512, "silu", ln=True).cluster_cols == 2
    assert GP.hopper_plan(1008, 2048, 1024, "glu", ln=True).cluster_cols == 8
    assert CM.conv_plan(1008, 1024, 2).pw1.cluster_cols == 8 and CM.conv_plan(1008, 512, 2).pw1.cluster_cols == 8
    assert FF.ffn_plan(1008, 1024, 4096, 2).fc1.cluster_cols == 8


def test_hopper_plan_refuses_a_row_past_one_cluster():
    with pytest.raises(ValueError, match="cluster"):
        GP.hopper_plan(1008, 2048, 2048, "linear", whole_rows=True)
    assert GP.hopper_plan(1008, 2048, 2048, "linear").cluster_cols == 1


@pytest.mark.parametrize("d", (1152, 1280, 2048))
def test_k7_and_k4_take_rows_wider_than_a_cluster(d):
    """A row of more than 8 column tiles (D > 1024) cannot be LayerNorm'd
    in one cluster: in bf16 too K7 and K4 then run the tiled sequences (K6's
    and K5's tiled routes), so they take every width their wrappers take."""
    assert GP.hopper_fits(1024) and not GP.hopper_fits(d)
    for itemsize in ITEMSIZES:
        k7, k4 = K7.k7_plan(8, 126, d, 4 * d, itemsize, d // 128), K4.k4_plan(8, 126, d, 4 * d, itemsize)
        assert not k7.hopper and not k4.hopper
        assert k7.ints()[0] == k4.ints()[0] == 0 and (k7.launches, k4.launches) == (11, 9)
        assert k7.ffn == FF.ffn_plan(8 * 126, d, 4 * d, itemsize) and k4.conv == CM.conv_plan(8 * 126, d, itemsize)
        assert k7.ffn.route == k4.conv.route == "tiled"


# ─── K1's attention core (ops/rel_attention.py core_plan) ───────────────────
SM_SHARED = 233_472  # an H100 SM's shared memory (228 KB); each block reserves 1 KB of it
HEAD_DIMS = (32, 64, 128)


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_core_plan_fits_a_block_and_holds_eight_warps_an_sm_in_f32(hd, itemsize):
    """The core's shared memory fits a block; in f32 an SM holds at least 8
    of its warps at hd 64 and 128 (the design before held 4 and 2), counted
    from the plan's bytes and threads; f32 keeps 4-row patches of scores
    at hd 64 and 128."""
    plan = RA.core_plan(8, 126, 8, hd, itemsize)
    assert plan.smem <= LIMIT and plan.threads % 32 == 0
    assert plan.resident == SM_SHARED // (plan.smem + 1024) >= 1
    assert plan.warps == plan.resident * plan.threads // 32
    if itemsize == 4:
        assert plan.warps >= 8 and plan.threads == 256
        bm, bn = plan.rows, plan.key_tile
        assert plan.smem == 4 * (bm * (bn + 4) + hd * (2 * bm + 4 * bn + bm + bn - 1))
        # scores a thread: 4 x 8 (hd 64), 4 x 4 over half the head dims (hd 128), 2 x 8 (hd 32)
        assert bm * bn * (2 if hd == 128 else 1) // plan.threads == {32: 16, 64: 32, 128: 16}[hd]
    else:
        assert plan.threads == 160 and (plan.rows, plan.key_tile) == (64, 64)  # a consumer warpgroup, a producer warp
        hc = max(1, hd // 64)
        assert plan.smem == 1024 + 2 * 8192 * hc + 2 * (8192 * hc + 16384 * hc + hd * 128) + 64 * 68 * 4 + 512 + 64
    assert RA.core_tile(itemsize, hd) == (plan.rows, plan.key_tile, plan.threads, plan.smem)


# (B, T', hd, whether the plan splits the keys in f32, in bf16): the 110m
# batch at 10 s (f32's 128-row query tiles make 64 blocks, which split) and
# 60 s; Sortformer's one 60 s clip; the 600m trainer's B=4 batch and the
# dense 95 s tdt-600m call
CORE_SHAPES = ((8, 126, 64, (True, False)), (8, 751, 64, (False, False)), (1, 751, 64, (True, True)),
               (4, 125, 128, (True, True)), (1, 1188, 128, (True, True)))


def _fills(blocks):
    return blocks >= 0.9 * 132 * -(-blocks // 132)


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("b, t, hd, split", CORE_SHAPES)
def test_core_plan_splits_keys_only_where_the_grid_underfills(b, t, hd, split, itemsize):
    """One key split where the grid (ceil(T/64) query tiles x B·H) fills 90%
    of its waves of one block an SM; otherwise the fewest of 2, 4, 8 that
    do. Each split takes whole key tiles and none is empty; a split's
    cluster holds at most 8 blocks, all resident at once (within one
    wave)."""
    heads = 8
    plan = RA.core_plan(b, t, heads, hd, itemsize)
    assert plan.blocks == -(-t // plan.rows) * b * heads
    assert plan.tiles == -(-t // plan.key_tile)
    assert (plan.splits > 1) == split[itemsize == 2]
    assert plan.splits in RA.CORE_SPLITS and plan.splits <= GP.MAX_CLUSTER
    assert plan.splits <= 132 * plan.resident  # a cluster's blocks fit the card at once
    assert _fills(plan.blocks) == (plan.splits == 1)
    if split:
        ok = [s for s in RA.CORE_SPLITS if (s - 1) * -(-plan.tiles // s) < plan.tiles]
        assert _fills(plan.blocks * plan.splits) or plan.splits == ok[-1]
        assert not any(_fills(plan.blocks * s) for s in ok if s < plan.splits)
    # whole key tiles a split, and the last split not empty
    tps = plan.tiles_per_split
    assert tps * plan.splits >= plan.tiles and (plan.splits - 1) * tps < plan.tiles
    assert RA.block_plan(b, t, hd * heads, itemsize, heads).core == plan


def test_core_plan_at_the_named_shapes():
    """B=1, T'=751, hd 64: 96 blocks in bf16 (48 in f32), 4 splits of 3
    key tiles (384 blocks in bf16, 97% of three waves; f32's 8 splits
    would leave some without a key tile); B=4, T'=125, hd 128: 64 blocks,
    2 splits; B=1, T'=1188, hd 128: 152 blocks, 4 splits."""
    assert RA.core_plan(1, 751, 8, 64, 4).splits == RA.core_plan(1, 751, 8, 64, 2).splits == 4
    assert RA.core_plan(1, 751, 8, 64, 2).tiles_per_split == 3
    assert RA.core_plan(4, 125, 8, 128, 4).splits == RA.core_plan(4, 125, 8, 128, 2).splits == 2
    assert RA.core_plan(1, 1188, 8, 128, 2).splits == RA.core_plan(1, 1188, 8, 128, 4).splits == 4
    # two key tiles of 64 cap the split at 2 in bf16; f32's 32-key tiles allow 4
    assert (RA.core_plan(2, 125, 8, 128, 2).splits, RA.core_plan(2, 125, 8, 128, 4).splits) == (2, 4)


@pytest.mark.parametrize("d", (512, 1024))
@pytest.mark.parametrize("t", (64, 126, 751, 1188))
def test_k1_hopper_plan_layer_norms_qkv_in_clusters(d, t):
    """bf16: QKV with the LayerNorm on its A path and the position GEMM in
    one launch, padded to whole clusters of column tiles (the position
    GEMM's blocks skip the LayerNorm); the out-projection a cluster of k
    slices."""
    b = 8 if t < 1000 else 1
    m, plan = b * t, RA.block_plan(b, t, d, 2)
    assert plan.hopper and plan.partials == 0
    qp, out = plan.qkv_pos, plan.out_proj
    rows, cols, extra = -(-m // 64), -(-3 * d // 128), -(-(2 * t - 1) // 64) * -(-d // 128)
    c = qp.cluster_cols
    assert qp.kind == "qkv_pos" and qp.splits == 1 and 1 <= c <= GP.MAX_CLUSTER
    assert qp.blocks == (rows * -(-cols // c) + -(-extra // c)) * c
    # the most column tiles of 8 that divide them (no block only LayerNorms), or 4 or 2 for one wave
    widest = max(w for w in range(1, GP.MAX_CLUSTER + 1) if cols % w == 0)
    assert cols % c == 0 and (c == widest or GP.hopper_waves(c, qp.blocks // c) == 1)
    assert out == GP.hopper_plan(m, d, d, "linear") and out.cluster_cols == 1
    assert plan.ints() == (1, c, 0, out.splits, plan.core.splits)
    with pytest.raises(ValueError, match="LayerNorm"):
        GP.hopper_plan(m, 3 * d, d, "qkv_pos", ln=True)  # the position GEMM's shape is needed


# ─── K2's cores (ops/rel_attention.py v1_core_plan) ──────────────────────────
KEPT_TILE = 64 * 64 * 4  # a key tile of f32 scores kept between the bf16 core's sweeps


def _v1_checks(plan, b: int, t: int, hd: int, itemsize: int, keep) -> None:
    """What every K2 plan holds: a block's shared memory fits; each split
    takes whole key tiles and none is empty; f32 is K1's f32 core planned
    as core_plan plans it; bf16 is K1's bf16 tiles with the kept score tiles
    (a split's tiles, where they fit; by default only where the kept grid
    is one wave of one block an SM) on top; the blocks an SM holds."""
    assert plan.smem <= LIMIT and plan.resident == SM_SHARED // (plan.smem + 1024) >= 1
    assert plan.blocks == -(-t // plan.rows) * b * 8 and plan.tiles == -(-t // plan.key_tile)
    tps = plan.tiles_per_split
    assert plan.splits in RA.CORE_SPLITS and tps * plan.splits >= plan.tiles > (plan.splits - 1) * tps
    base = RA.core_plan(b, t, 8, hd, itemsize)
    if itemsize == 4 or keep is False:
        assert plan == base and plan.kept == 0
        return
    if keep is None:
        forced = RA.v1_core_plan(b, t, 8, hd, itemsize, keep=True)
        one_wave = forced.kept and forced.blocks * forced.splits <= 132
        assert plan == (forced if one_wave else base)
        keep = bool(one_wave)
        if not keep:
            return
    assert (plan.rows, plan.key_tile, plan.threads) == (64, 64, 160)
    assert plan.smem == base.smem + plan.kept * KEPT_TILE
    most = (LIMIT - base.smem) // KEPT_TILE
    if plan.kept:
        assert plan.kept == tps <= most
    else:  # no split with none empty holds its tiles: the second sweep computes them again
        assert plan == base
        assert not [s for s in RA.CORE_SPLITS
                    if (s - 1) * -(-plan.tiles // s) < plan.tiles and -(-plan.tiles // s) <= most]


@pytest.mark.parametrize("keep", (True, False, None))
@pytest.mark.parametrize("hd", (32, 64, 128))
@pytest.mark.parametrize("itemsize", ITEMSIZES)
def test_v1_core_plan_for_every_length(itemsize, hd, keep):
    """T' from 1 to 6001 (a 60 s clip; B=1 past 1001): shared memory
    against the 232,448 B a block may take, splits of whole key tiles with
    none empty, the kept tiles a split's."""
    for t in range(1, 6002):
        b = 8 if t <= 1001 else 1
        _v1_checks(RA.v1_core_plan(b, t, 8, hd, itemsize, keep=keep), b, t, hd, itemsize, keep)


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("hd", (32, 64, 128))
@pytest.mark.parametrize("t", SEQ_LENS)
def test_v1_core_plan_splits_only_where_the_grid_underfills(t, hd, itemsize):
    """With the scores computed again, the fewest splits that fill 90% of
    the waves (K1's rule); kept, the fewest of those whose tiles fit, or the
    most that fit."""
    b = 8 if t <= 1001 else 1
    again, kept = RA.v1_core_plan(b, t, 8, hd, itemsize, keep=False), RA.v1_core_plan(b, t, 8, hd, itemsize, keep=True)
    _v1_checks(RA.v1_core_plan(b, t, 8, hd, itemsize), b, t, hd, itemsize, None)
    _v1_checks(kept, b, t, hd, itemsize, True)
    assert _fills(again.blocks) == (again.splits == 1) or again.splits == 8 or (
        (again.splits * 2 - 1) * -(-again.tiles // (again.splits * 2)) >= again.tiles)
    if kept.kept:
        fit = [s for s in RA.CORE_SPLITS if (s - 1) * -(-kept.tiles // s) < kept.tiles
               and -(-kept.tiles // s) * KEPT_TILE + again.smem <= LIMIT]
        assert kept.splits in fit and not any(_fills(kept.blocks * s) for s in fit if s < kept.splits)
        assert _fills(kept.blocks * kept.splits) or kept.splits == fit[-1]


def test_v1_core_plan_at_the_named_shapes():
    """B=8, T'=126, hd 64: bf16 in one split of 2 kept tiles (128 blocks,
    one wave), f32 in 2 (K1's 128-row tiles make 64 blocks); T'=751: bf16
    computes the scores again, unsplit (kept, 6 tiles a split in 2 splits),
    f32 does not split; the 600m shape (hd 128, T'=751) would keep 3 tiles
    in 4 splits; B=1, T'=6001 cannot keep."""
    assert (RA.v1_core_plan(8, 126, 8, 64, 2).splits, RA.v1_core_plan(8, 126, 8, 64, 2).kept) == (1, 2)
    assert RA.v1_core_plan(8, 126, 8, 64, 4).splits == 2 and RA.v1_core_plan(8, 126, 8, 64, 2, keep=False).splits == 1
    assert (RA.v1_core_plan(8, 751, 8, 64, 2).splits, RA.v1_core_plan(8, 751, 8, 64, 2).kept) == (1, 0)
    assert (RA.v1_core_plan(8, 751, 8, 64, 2, keep=True).splits, RA.v1_core_plan(8, 751, 8, 64, 2, keep=True).kept) \
        == (2, 6)
    assert RA.v1_core_plan(8, 751, 8, 64, 4).splits == 1
    assert RA.v1_core_plan(8, 751, 8, 128, 2).kept == 0
    assert (RA.v1_core_plan(8, 751, 8, 128, 2, keep=True).splits, RA.v1_core_plan(8, 751, 8, 128, 2, keep=True).kept) \
        == (4, 3)
    assert RA.v1_core_plan(1, 6001, 8, 64, 2, keep=True).kept == 0


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("b, t", SHAPES_600M)
def test_v1_core_plan_at_the_600m_shapes(b, t, itemsize):
    """hd 128 at the 600m presets' batches and the dense 95 s call."""
    for keep in (True, False, None):
        _v1_checks(RA.v1_core_plan(b, t, 8, 128, itemsize, keep=keep), b, t, 128, itemsize, keep)


def test_v1_core_kept_tile_is_the_sources():
    """The kept tile and the C entry's plan arguments as the wrapper passes
    them: splits, kept tiles, shared memory."""
    src = (_build._CSRC / "rel_attention_v1.cu").read_text()
    assert "constexpr int V1_KEPT_TILE = 64 * 64 * 4;" in src and RA.V1_KEPT_TILE == KEPT_TILE
    assert "int HD, int splits, int kept, int smem, void* stream)" in src
