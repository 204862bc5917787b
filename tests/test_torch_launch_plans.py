"""Launch plans of K6 (ops/feed_forward.py ffn_plan) and K2
(ops/rel_attention.py v1_plan), computed in Python and passed to the CUDA
kernels as ints. A launch refused for too much shared memory never runs,
so these checks are the guard that runs without a card."""

import pytest
import torch

from parakeet_tpu_torch.ops import _build
from parakeet_tpu_torch.ops import feed_forward as FF
from parakeet_tpu_torch.ops import rel_attention as RA

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
