"""Launch plans of the shared tiled GEMM (ops/gemm_plan.py gemm_plan, as
K6's ffn_plan, K1's block_plan, K5's conv_plan, K8's subsample_plan and
K3's dft_plan use it) and of K2 (ops/rel_attention.py v1_plan), computed
in Python and passed to the CUDA kernels as ints. A launch refused for too much shared memory never runs,
so these checks are the guard that runs without a card."""

import pytest
import torch

from parakeet_tpu_torch.ops import _build
from parakeet_tpu_torch.ops import conv_module as CM
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
    m = 8 * t
    plan = FF.ffn_plan(m, d, f, itemsize)
    assert plan.smem <= LIMIT
    steps = -(-f // FF.GEMM_K_STEP)
    assert steps % plan.splits == 0 and 1 <= plan.splits <= FF.MAX_SPLITS
    assert plan.scratch == (m * d + m * f) * itemsize + plan.splits * m * d * 4
    tiles = -(-m // 128) * -(-d // 128)

    def fills(s):  # every SM gets a block and the waves are at least 90% full
        blocks = tiles * s
        return blocks >= 132 and blocks >= 0.9 * 132 * -(-blocks // 132)

    divisors = [s for s in range(1, min(steps, FF.MAX_SPLITS) + 1) if steps % s == 0]
    if any(fills(s) for s in divisors):
        assert fills(plan.splits) and not any(fills(s) for s in divisors if s < plan.splits)
    else:
        assert plan.splits == divisors[-1]


@pytest.mark.parametrize("d, f", FFN_WIDTHS)
def test_ffn_plan_fills_the_card_at_ten_second_clips(d, f):
    """B=8, T'=126: fc2 (N = D) has too few 128x128 tiles alone."""
    m = 8 * 126
    for itemsize in ITEMSIZES:
        plan = FF.ffn_plan(m, d, f, itemsize)
        assert -(-m // 128) * -(-d // 128) * plan.splits >= 132
    assert FF.ffn_plan(m, 512, 2048).splits == 8


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
    """K1's position GEMM and out-projection share one f32 partials buffer
    (their closing passes run one after the other); K5's pw2 has its own."""
    b, d = 8, 512
    plan = RA.block_plan(b, t, d, itemsize)
    assert plan.qkv.splits == 1 and plan.ints() == (plan.qkv.rows, plan.pos.splits, plan.out.splits)
    assert plan.partials == max(plan.pos.splits * (2 * t - 1) * d, plan.out.splits * b * t * d)
    conv = CM.conv_plan(b * t, d, itemsize)
    assert conv.pw1.splits == 1 and conv.ints() == (conv.pw1.rows, conv.pw2.splits)
    assert conv.partials == conv.pw2.splits * b * t * d


def test_ffn_plan_is_the_shared_plan_of_fc2():
    for m, d, f in ((1008, 512, 2048), (6008, 512, 2048), (1008, 1024, 4096), (10, 36, 70)):
        for itemsize in ITEMSIZES:
            fc2 = GP.gemm_plan(m, d, f, itemsize)
            plan = FF.ffn_plan(m, d, f, itemsize)
            assert (plan.tile, plan.splits, plan.smem) == ((128, 128), fc2.splits, fc2.smem)


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("hd", (32, 64, 128))
@pytest.mark.parametrize("t", SEQ_LENS)
def test_v1_plan_fits_shared_memory(t, hd, itemsize):
    plan = RA.v1_plan(t, hd, itemsize)
    assert plan.smem <= LIMIT
    if plan.one_pass:
        bm, bn = plan.rows, plan.key_tile
        assert (bm, bn) in RA.V1_BLOCKS
        assert plan.threads == bm * bn // 16 and plan.threads % 32 == 0
        assert plan.smem == 4 * bm * (-(-t // 4) * 4) + itemsize * hd * (2 * bm + 2 * (2 * bn + bm - 1))
        # no larger block would have fit
        for bm2, bn2 in RA.V1_BLOCKS[: RA.V1_BLOCKS.index((bm, bn))]:
            assert 4 * bm2 * (-(-t // 4) * 4) + itemsize * hd * (2 * bm2 + 2 * (2 * bn2 + bm2 - 1)) > LIMIT


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("hd", (64, 128))
def test_v1_plan_runs_one_pass_to_sixty_second_clips_and_two_past_the_limit(hd, itemsize):
    for t in (126, 751, 1001):
        assert RA.v1_plan(t, hd, itemsize).one_pass, t
    for t in (3000, 6001):
        plan = RA.v1_plan(t, hd, itemsize)
        assert not plan.one_pass and plan.rows == 0
        assert plan.smem == (2 * 32 + 64 + 32 - 1) * (hd + 4) * 4


def test_v1_plan_shrinks_the_block_as_t_grows():
    rows = [RA.v1_plan(t, 64).rows for t in (126, 751, 1001, 2000, 3000)]
    assert rows == [64, 32, 32, 16, 0]


def test_plans_follow_the_dtype_itemsize():
    assert torch.empty((), dtype=torch.bfloat16).element_size() == 2
    assert RA.v1_plan(751, 64, 2).smem < RA.v1_plan(751, 64, 4).smem
    assert FF.ffn_plan(1008, 512, 2048, 2).smem < FF.ffn_plan(1008, 512, 2048, 4).smem


# K8's conv2 at B=8, mel T = 1001 and 6001 (10 s and 60 s), C = 256; the
# 600m presets' 128 mel bins too
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
@pytest.mark.parametrize("t", (126, 751, 1188))
def test_v1_plan_at_head_dim_128(t, itemsize):
    """K2 at hd=128 holds twice the position and key columns of hd=64: one
    pass to T'=751 (64 query rows at 126, 16 at 751 in f32), and at
    T'=1188 one pass in bf16 only (16 query rows), two in f32."""
    plan = RA.v1_plan(t, 128, itemsize)
    assert plan.smem <= LIMIT
    assert plan.one_pass == (t <= 751 or itemsize == 2)
    if plan.one_pass:
        assert plan.smem == 4 * plan.rows * (-(-t // 4) * 4) + itemsize * 128 * (
            2 * plan.rows + 2 * (2 * plan.key_tile + plan.rows - 1))
    assert [RA.v1_plan(tt, 128).rows for tt in (126, 751, 1188)] == [64, 16, 0]


@pytest.mark.parametrize("itemsize", ITEMSIZES)
@pytest.mark.parametrize("b, t", SHAPES_600M)
def test_k7_and_k4_plans_at_the_600m_widths(b, t, itemsize):
    """K7 runs ffn_plan then block_plan, K4 conv_plan then ffn_plan, at
    D=1024, F=4096: every GEMM fits a block and splits whole k steps."""
    d, f, m = 1024, 4096, b * t
    ffn = FF.ffn_plan(m, d, f, itemsize)
    attn = RA.block_plan(b, t, d, itemsize)
    conv = CM.conv_plan(m, d, itemsize)
    assert ffn.smem <= LIMIT and (f // GP.GEMM_K_STEP) % ffn.splits == 0
    for g, k in ((attn.qkv, d), (attn.pos, d), (attn.out, d), (conv.pw1, d), (conv.pw2, d)):
        assert g.smem <= LIMIT and g.smem == GP.gemm_smem(g.rows, itemsize)
        assert (k // GP.GEMM_K_STEP) % g.splits == 0 and 1 <= g.splits <= GP.MAX_SPLITS
    assert attn.qkv.splits == 1 and conv.pw1.splits == 1
    assert attn.partials == max(attn.pos.splits * (2 * t - 1) * d, attn.out.splits * m * d)
