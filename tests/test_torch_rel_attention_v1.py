"""The port's v1 attention core (K2) against the reference's Pallas kernel
pallas_attention.fused_rel_attention in interpret mode, on the valid query
rows. On the CPU the port's dispatch runs the plain torch version; the CUDA
kernel itself is held against that plain version on the card (marked
`cuda`)."""

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
