"""The benchmark's roofline arithmetic reproduces the K1 bounds recorded in
PERF.md's table of kernels (B=8, 110m widths, chip_smoke.py's mixed key
lengths); the bound `k1_roofline` takes counts no padded row; and its
model FLOPs add up."""

import numpy as np
import pytest

from port_bench import roofline as RF


def _chip_smoke_lengths(t: int, b: int = 8, d: int = 512, heads: int = 8) -> np.ndarray:
    """The key lengths chip_smoke.py's K1 phase drew at T' = t (its seed
    t + 1 and its draws before the lengths: x, then the weights)."""
    rng = np.random.RandomState(t + 1)
    hd = d // heads
    rng.randn(b, t, d)
    for _ in range(3):
        rng.normal(0, 1 / np.sqrt(d), (d, d))
        rng.normal(0, 0.02, d)
    rng.normal(0, 0.02, (heads, hd))
    rng.normal(0, 0.02, (heads, hd))
    rng.normal(0, 1 / np.sqrt(d), (d, d))
    rng.normal(0, 1 / np.sqrt(d), (d, d))
    rng.normal(0, 0.02, d)
    lengths = rng.randint(max(1, t // 4), t + 1, size=b)
    lengths[0] = t
    return lengths


@pytest.mark.parametrize("t, itemsize, recorded", [(126, 2, 0.0026), (751, 2, 0.0219),
                                                   (126, 4, 0.0378), (751, 4, 0.3229)])
def test_k1_bounds_match_perf_md(t, itemsize, recorded):
    got = RF.k1_bound(8, t, 512, 8, _chip_smoke_lengths(t), itemsize)
    assert round(got["bound_ms"], 4) == recorded
    assert got["bound_by"] == "operations"


def test_bound_takes_the_larger_side():
    assert RF.bound(989e9, 0, RF.BF16_PEAK)["bound_ms"] == pytest.approx(1.0)
    by_bytes = RF.bound(1.0, 3.35e9, RF.BF16_PEAK)
    assert by_bytes["bound_ms"] == pytest.approx(1.0) and by_bytes["bound_by"] == "bytes"


def test_k1_call_bound_counts_each_clip_at_its_own_length():
    d, heads, lens = 512, 8, [126, 40, 90, 7]
    got = RF.k1_call_bound(lens, d, heads, 2)
    one = [RF.k1_call_bound([t], d, heads, 2) for t in lens]
    position = 2 * (2 * 126 - 1) * d * d
    assert got["gflop"] * 1e9 == pytest.approx(sum(o["gflop"] * 1e9 for o in one)
                                               - sum(2 * (2 * t - 1) * d * d for t in lens[1:]))
    assert got["gflop"] * 1e9 < RF.k1_bound(4, 126, d, heads, lens, 2)["gflop"] * 1e9
    assert RF.k1_flops([126], d, heads) - position == 2 * 126 * d * 4 * d + 6 * d * 126 * 126


@pytest.mark.parametrize("t, itemsize", [(126, 2), (751, 4)])
def test_k1_call_bound_is_the_table_bound_when_nothing_is_padded(t, itemsize):
    got = RF.k1_call_bound([t] * 8, 512, 8, itemsize)
    table = RF.k1_bound(8, t, 512, 8, [t] * 8, itemsize)
    assert got["bound_ms"] == pytest.approx(table["bound_ms"]) and got["mbyte"] == pytest.approx(table["mbyte"])


def test_encoder_flops_add_up():
    enc = {"subsampling_channels": 4, "mel_bins": 16, "hidden_size": 8, "num_heads": 2, "ffn_intermediate": 16,
           "conv_kernel_size": 3, "num_layers": 3}
    n = 64  # mel frames → 32, 16, 8 frames; 8, 4, 2 mel bins
    c, d, t = 4, 8, 8
    sub = (2 * 32 * 8 * c * 9 + 2 * 16 * 4 * c * 9 + 2 * 16 * 4 * c * c  # conv1, dw1, conv2
           + 2 * 8 * 2 * c * 9 + 2 * 8 * 2 * c * c + 2 * 8 * (c * 2) * d)  # dw2, conv3, proj
    ffn = 2 * (4 * t * d * 16)
    attn = 2 * t * d * 3 * d + 2 * (2 * t - 1) * d * d + 6 * (d // 2) * 2 * t * t + 2 * t * d * d
    conv = 2 * t * d * 2 * d + 2 * t * d * d + 2 * t * d * 3
    assert RF.encoder_flops(enc, [n]) == sub + 3 * (ffn + attn + conv)
    assert RF.subsampled_length(n) == t
    # two clips share one position projection, over the longer clip's positions
    assert RF.encoder_flops(enc, [n, n]) == 2 * (sub + 3 * (ffn + attn + conv)) - 3 * 2 * (2 * t - 1) * d * d


def test_transducer_flops_count_each_step():
    cfg = {"prediction": {"pred_hidden": 4, "num_lstm_layers": 2},
           "joint": {"joint_hidden": 3, "encoder_hidden": 5, "vocab_size": 7}, "durations": [0, 1]}
    per_step = 2 * 2 * 4 * 4 * 8 + 2 * 4 * 3 + 2 * 3 * 9
    assert RF.transducer_flops(cfg, 10, 0) == 2 * 10 * 5 * 3
    assert RF.transducer_flops(cfg, 10, 6) == 2 * 10 * 5 * 3 + 6 * per_step
