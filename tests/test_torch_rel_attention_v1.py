"""The port's v1 attention core (K2) against the reference's Pallas kernel
pallas_attention.fused_rel_attention in interpret mode, on the valid query
rows. On the CPU the port's dispatch runs the plain torch version; the CUDA
kernel itself is held against that plain version on the card (marked
`cuda`).

The card's cores as they compute, in plain torch (`v1_core` below), are
held to the reference's kernel too: bf16's two sweeps over each split's key
tiles (the running max and sum; the splits' maxima and sums merged in split
order; the probabilities normalised, rounded, and AV a tile at a time, the
splits' outputs summed in split order), and f32's one sweep of K1's core
(the unrounded e, normalised after AV)."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parakeet_tpu.ops.pallas_attention import fused_rel_attention as r_fused_rel_attention
from parakeet_tpu_torch.ops import rel_attention as TA

RTOL, ATOL = 2e-4, 2e-5  # tests/test_pallas_attention.py's v1-kernel tolerance
B, H, T = 3, 2, 37
LENGTHS = [37, 20, 3]  # a full item, a half one and a short one


def _inputs(hd: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    qu, qv, k, v = (rng.randn(B, H, T, hd).astype(np.float32) for _ in range(4))
    p = rng.randn(H, 2 * T - 1, hd).astype(np.float32)
    return qu, qv, k, v, p


def _assert_valid_close(got, ref, lengths, rtol=RTOL, atol=ATOL):
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(got[i, :, :n], ref[i, :, :n], rtol=rtol, atol=atol, err_msg=f"item {i}")


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("masked", [True, False])
def test_plain_version_matches_pallas_kernel(hd, masked):
    arrays = _inputs(hd, seed=hd)
    lengths = LENGTHS if masked else None
    ref = np.asarray(r_fused_rel_attention(
        *(jnp.asarray(a) for a in arrays),
        lengths=None if lengths is None else jnp.asarray(lengths, jnp.int32), interpret=True))
    got = TA.fused_rel_attention_reference(
        *(torch.from_numpy(a) for a in arrays),
        lengths=None if lengths is None else torch.tensor(lengths)).numpy()
    assert got.shape == ref.shape == (B, H, T, hd)
    _assert_valid_close(got, ref, lengths or [T] * B)


def test_bf16_plain_version_tracks_pallas_kernel():
    """bf16 operands: the probabilities round to bf16 before AV in both."""
    arrays = _inputs(32, seed=3)
    lengths = jnp.asarray(LENGTHS, jnp.int32)
    ref = np.asarray(r_fused_rel_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in arrays), lengths=lengths,
        interpret=True).astype(jnp.float32))
    got = TA.fused_rel_attention_reference(
        *(torch.from_numpy(a).bfloat16() for a in arrays), lengths=torch.tensor(LENGTHS))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    err = max(float(np.abs(got[i, :, :n] - ref[i, :, :n]).max()) for i, n in enumerate(LENGTHS))
    assert err <= 0.01 * float(np.abs(ref).max())


def test_scale_applies_after_the_sum_and_pad_keys_get_nothing():
    qu, qv, k, v, p = (torch.from_numpy(a) for a in _inputs(32, seed=5))
    got = TA.fused_rel_attention_reference(qu, qv, k, v, p, lengths=torch.tensor(LENGTHS))
    # keys at or past an item's length do not change its valid rows
    v2, k2 = v.clone(), k.clone()
    v2[2, :, LENGTHS[2]:] = 1e3
    k2[2, :, LENGTHS[2]:] = -1e3
    again = TA.fused_rel_attention_reference(qu, qv, k2, v2, p, lengths=torch.tensor(LENGTHS))
    assert torch.equal(got[2], again[2])
    # one item, direct formula: softmax((q_u·k + q_v·P[T−1−t+s]) / √hd)
    t, s = 4, torch.arange(T)
    score = (qu[0, 1, t] @ k[0, 1].T + qv[0, 1, t] @ p[1, T - 1 - t + s].T) / np.sqrt(32)
    want = torch.softmax(score, dim=-1) @ v[0, 1]
    np.testing.assert_allclose(got[0, 1, t].numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_cpu_dispatch_runs_plain_version_and_counts_nothing():
    arrays = [torch.from_numpy(a) for a in _inputs(32, seed=6)]
    before = TA.fused_rel_attention.launches
    got = TA.fused_rel_attention(*arrays, lengths=torch.tensor(LENGTHS))
    assert torch.equal(got, TA.fused_rel_attention_reference(*arrays, lengths=torch.tensor(LENGTHS)))
    assert TA.fused_rel_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_cuda_kernel_matches_plain_version(dtype, hd):
    """The hand-written kernel against its plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    from parakeet_tpu_torch.ops.layers import require_ieee_f32

    require_ieee_f32()
    dt = getattr(torch, dtype)
    arrays = [torch.from_numpy(a).to("cuda", dt) for a in _inputs(hd, seed=7)]
    lengths = torch.tensor(LENGTHS, device="cuda")
    before = TA.fused_rel_attention.launches
    got = TA.fused_rel_attention(*arrays, lengths=lengths).float().cpu().numpy()
    assert TA.fused_rel_attention.launches == before + 1
    ref = TA.fused_rel_attention_reference(*arrays, lengths=lengths).float().cpu().numpy()
    if dt == torch.float32:
        _assert_valid_close(got, ref, LENGTHS, rtol=1e-3, atol=1e-5)
    else:
        err = max(float(np.abs(got[i, :, :n] - ref[i, :, :n]).max()) for i, n in enumerate(LENGTHS))
        assert err <= 0.02 * float(np.abs(ref).max())



# ─── The cores' arithmetic (csrc/rel_attention_v1.cu), in plain torch ───────
KEY_TILE = 8  # 5 key tiles of T=37, the last one partial (the card's are 64)
EMU_LENGTHS = [37, 1, 21]  # a full item, one key, a length that is no multiple of the tile
BF16_SCALE_FRAC = 0.02  # bf16: the kernels' tolerance against their plain versions (chip_smoke.py)


def v1_core(qu, qv, k, v, p, lengths, splits: int, two_sweeps: bool, key_tile: int = KEY_TILE):
    """K2's cores in plain torch, (B, H, T, hd) in the inputs' dtype. Per
    item the keys in tiles of key_tile, split z taking tiles [z·tps,
    (z+1)·tps) (tps = ceil(tiles / splits)) cut at the item's key count
    (min(len, T); all T with no valid key, whose keys then score −1e9); a
    tile's scores (q_u·k + q_v·P[T−1−t+s]) · 1/√hd, keys past the count
    −inf. two_sweeps (bf16's wgmma core): sweep 1 the running max and
    rescaled sum; the splits' (max, sum) merged in split order; sweep 2
    round(exp(s − M) / L) to the dtype, AV in f32 a tile at a time, the
    splits' outputs summed in split order, rounded once. Otherwise (f32's
    K1 core): one sweep with the unrounded e, the running output rescaled,
    the splits merged by exp(m_z − max m) and normalised after AV."""
    b, heads, t, hd = qu.shape
    dt, f32 = qu.dtype, torch.float32
    scale = 1.0 / math.sqrt(hd)
    tiles = -(-t // key_tile)
    tps = -(-tiles // splits)
    rows = torch.arange(t)
    out = torch.empty(b, heads, t, hd, dtype=f32)

    def scores(i, it, kv_len, n_keys):
        keys = torch.arange(it * key_tile, min((it + 1) * key_tile, t))
        band = p[:, t - 1 - rows[:, None] + keys[None, :]].to(f32)  # (H, T, n, hd)
        content = qu[i].to(f32) @ k[i][:, keys].to(f32).transpose(-1, -2)
        position = (qv[i].to(f32)[:, :, None, :] * band).sum(-1)
        s = (content + position) * scale
        s = s.masked_fill((keys >= n_keys)[None, None, :], -math.inf)
        return keys, s.masked_fill(((keys >= kv_len) & (keys < n_keys))[None, None, :], -1e9)

    for i in range(b):
        kv_len = min(int(lengths[i]), t)
        n_keys = kv_len if kv_len > 0 else t
        ranges = [range(z * tps, min(-(-n_keys // key_tile), (z + 1) * tps)) for z in range(splits)]
        parts = []
        for its in ranges:
            m = torch.full((heads, t, 1), -math.inf)
            l = torch.zeros(heads, t, 1)
            acc = torch.zeros(heads, t, hd)
            for it in its:
                keys, s = scores(i, it, kv_len, n_keys)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                e = torch.exp(s - m_new)
                l = l * alpha + e.sum(-1, keepdim=True)
                if not two_sweeps:
                    acc = acc * alpha + e @ v[i][:, keys].to(f32)
                m = m_new
            parts.append((m, l, acc))
        top = torch.stack([q[0] for q in parts]).amax(0)
        den = torch.zeros(heads, t, 1)
        for m, l, _ in parts:  # in split order
            den = den + l * torch.exp(m - top)
        if two_sweeps:
            total = torch.zeros(heads, t, hd)
            for its in ranges:  # sweep 2 of each split, summed in split order
                acc = torch.zeros(heads, t, hd)
                for it in its:
                    keys, s = scores(i, it, kv_len, n_keys)
                    prob = (torch.exp(s - top) / den).to(dt).to(f32)
                    acc = acc + prob @ v[i][:, keys].to(f32)
                total = total + acc
            out[i] = total
        else:
            num = torch.zeros(heads, t, hd)
            for m, l, acc in parts:
                num = num + acc * torch.exp(m - top)
            out[i] = num / den
    return out.to(dt)


def _jax_v1(arrays, lengths, bf16: bool = False) -> np.ndarray:
    dt = jnp.bfloat16 if bf16 else jnp.float32
    out = r_fused_rel_attention(*(jnp.asarray(a).astype(dt) for a in arrays),
                                lengths=jnp.asarray(lengths, jnp.int32), interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("splits", [1, 2, 3])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_two_sweep_core_matches_pallas_kernel(hd, splits):
    """bf16's design in f32 arithmetic (rounding to f32 the identity): two
    sweeps, the split merge before AV, against the reference's kernel."""
    arrays = _inputs(hd, seed=20 + hd)
    got = v1_core(*(torch.from_numpy(a) for a in arrays), EMU_LENGTHS, splits, two_sweeps=True).numpy()
    _assert_valid_close(got, _jax_v1(arrays, EMU_LENGTHS), EMU_LENGTHS)


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_one_sweep_f32_core_matches_pallas_kernel(hd, splits):
    """f32's design, K1's core with the scale after the sum and P per head,
    normalised after AV: the same function as the reference's kernel, which
    normalises before AV, within its f32 tolerance."""
    arrays = _inputs(hd, seed=30 + hd)
    got = v1_core(*(torch.from_numpy(a) for a in arrays), EMU_LENGTHS, splits, two_sweeps=False).numpy()
    _assert_valid_close(got, _jax_v1(arrays, EMU_LENGTHS), EMU_LENGTHS)


@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_two_sweep_core_in_bf16_tracks_pallas_kernel_and_plain_version(hd, splits):
    """bf16 operands: the two-sweep core rounds the normalised
    probabilities to bf16 before AV, where the reference's kernel does;
    within 2% of the output's scale of the reference's kernel in bf16 and
    of the port's plain version."""
    arrays = _inputs(hd, seed=40 + hd)
    tensors = [torch.from_numpy(a).bfloat16() for a in arrays]
    got = v1_core(*tensors, EMU_LENGTHS, splits, two_sweeps=True)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    plain = TA.fused_rel_attention_reference(*tensors, lengths=torch.tensor(EMU_LENGTHS)).float().numpy()
    for ref in (_jax_v1(arrays, EMU_LENGTHS, bf16=True), plain):
        err = max(float(np.abs(got[i, :, :n] - ref[i, :, :n]).max()) for i, n in enumerate(EMU_LENGTHS))
        assert np.isfinite(got).all() and err <= BF16_SCALE_FRAC * float(np.abs(ref).max())


def test_splits_of_the_two_sweep_core_may_be_empty_and_an_item_without_keys_averages():
    """3 splits of 5 key tiles take 2, 2 and 1; an item of 1 key leaves the
    last two empty (max −inf, sum 0, no AV), and both designs give that
    key's values; an item with no valid key averages all T keys, as the
    plain version does."""
    arrays = [torch.from_numpy(a) for a in _inputs(32, seed=50)]
    for two in (True, False):
        one = v1_core(*arrays, [1, 0, 37], 3, two_sweeps=two)
        torch.testing.assert_close(v1_core(*arrays, [1, 0, 37], 1, two_sweeps=two), one, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(one[0], arrays[3][0, :, :1].expand_as(one[0]), rtol=1e-6, atol=1e-6)
        plain = TA.fused_rel_attention_reference(*arrays, lengths=torch.tensor([1, 0, 37]))
        torch.testing.assert_close(one[1], plain[1], rtol=RTOL, atol=ATOL)
