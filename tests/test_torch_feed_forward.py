"""The port's fused feed-forward (K6) against the reference's Pallas kernel
pallas_ffn.fused_feed_forward in interpret mode. On the CPU the port's
dispatch runs the plain torch version; the CUDA kernel itself is held
against that plain version on the card (marked `cuda`)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parakeet_tpu import config as RC
from parakeet_tpu import params as RP
from parakeet_tpu.models import encoder as RE
from parakeet_tpu.ops.pallas_ffn import fused_feed_forward as r_fused_feed_forward
from parakeet_tpu_torch.models import encoder as TE
from parakeet_tpu_torch.ops import feed_forward as TF
from parakeet_tpu_torch.params import Params as TParams
from parakeet_tpu_torch.params import params_from_numpy

RTOL, ATOL = 2e-4, 1e-5  # tests/test_pallas_ffn.py's tolerance
BF16_SCALE_FRAC = 0.01  # bf16: max |diff| within 1% of the output scale
D, FF = 32, 64
PREFIX = "encoder_.layers_.0."


@pytest.fixture(scope="module")
def flat():
    cfg = RC.EncoderConfig(mel_bins=80, subsampling_channels=8, hidden_size=D, num_layers=1,
                           num_heads=4, ffn_intermediate=FF)
    out = {k: np.asarray(v) for k, v in RP.init_params(RP.encoder_spec(cfg, "encoder_"), seed=8).items()}
    rng = np.random.RandomState(1)
    for k in out:  # non-trivial norms and biases, so every term is exercised
        if k.endswith("norm_.weight"):
            out[k] = (1 + 0.1 * rng.randn(*out[k].shape)).astype(np.float32)
        elif k.endswith(".bias"):
            out[k] = (0.05 * rng.randn(*out[k].shape)).astype(np.float32)
    return out


def _args(p, final: bool):
    f = p.sub("ffn2_")
    args = (f["norm_.weight"], f["norm_.bias"], f["fc1_.weight"], f["fc1_.bias"],
            f["fc2_.weight"], f["fc2_.bias"])
    kw = dict(final_norm_w=p["final_norm_.weight"], final_norm_b=p["final_norm_.bias"]) if final else {}
    return args, kw


def _reference(flat, x: np.ndarray, final: bool, bf16: bool) -> np.ndarray:
    def cast(k, v):
        return jnp.asarray(v).astype(jnp.bfloat16) if bf16 and "norm" not in k else jnp.asarray(v)

    p = RP.Params({k: cast(k, v) for k, v in flat.items()}).sub(PREFIX[:-1])
    xj = jnp.asarray(x).astype(jnp.bfloat16 if bf16 else jnp.float32)
    args, kw = _args(p, final)
    return np.asarray(r_fused_feed_forward(xj, *args, eps=1e-5, interpret=True, **kw).astype(jnp.float32))


def _port(flat, x: np.ndarray, final: bool, bf16: bool, fn=TF.fused_feed_forward_reference, device="cpu"):
    dt = torch.bfloat16 if bf16 else torch.float32
    p = TParams(params_from_numpy(flat, device, dt)).sub(PREFIX[:-1])
    args, kw = _args(p, final)
    return fn(torch.from_numpy(x).to(device, dt), *args, eps=1e-5, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("t", [37, 64])
def test_plain_version_matches_pallas_kernel(flat, t, final, dtype):
    bf16 = dtype == "bfloat16"
    x = np.random.RandomState(t).randn(3, t, D).astype(np.float32)
    ref = _reference(flat, x, final, bf16)
    got = _port(flat, x, final, bf16)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    got = got.float().numpy()
    assert got.shape == ref.shape
    if bf16:
        assert np.abs(got - ref).max() <= BF16_SCALE_FRAC * np.abs(ref).max()
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_cpu_dispatch_runs_plain_version_and_counts_nothing(flat):
    x = np.random.RandomState(3).randn(2, 19, D).astype(np.float32)
    before = TF.fused_feed_forward.launches
    for final in (False, True):
        got = _port(flat, x, final, False, fn=TF.fused_feed_forward)
        assert torch.equal(got, _port(flat, x, final, False))
    assert TF.fused_feed_forward.launches == before


def _count_reference_kernel(monkeypatch):
    import parakeet_tpu.ops.pallas_ffn as PF

    orig, calls = PF.fused_feed_forward, []

    def interp(*a, **kw):
        calls.append(1)
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(PF, "fused_feed_forward", interp)
    return calls


@pytest.mark.parametrize("t", [40, 63])
def test_fused_route_below_the_guard_is_the_plain_route(flat, monkeypatch, t):
    """T' < 64: the reference's _ffn_fusable sends set_fused_ffn(True) to its
    XLA layers, and the port's fused route runs its plain layers, bit for
    bit, in bf16 (the kernel rounds LN(x) and h where they do not)."""
    calls = _count_reference_kernel(monkeypatch)
    x = np.random.RandomState(t).randn(3, t, D).astype(np.float32)
    rp = RP.Params({k: jnp.asarray(v).astype(jnp.bfloat16) if "norm" not in k else jnp.asarray(v)
                    for k, v in flat.items()}).sub(PREFIX[:-1])
    RE.set_fused_ffn(True)
    try:
        RE.feed_forward(rp.sub("ffn1_"), jnp.asarray(x).astype(jnp.bfloat16), 1e-5)
    finally:
        RE.set_fused_ffn(False)
    assert calls == [], "the reference ran its kernel below its guard"
    seen = []
    monkeypatch.setattr(TE, "fused_feed_forward", lambda *a, **kw: seen.append(1))
    tp = TParams(params_from_numpy(flat, "cpu", torch.bfloat16)).sub(PREFIX[:-1])
    xt = torch.from_numpy(x).to(torch.bfloat16)
    for final in (None, tp.sub("final_norm_")):
        got = TE.feed_forward(tp.sub("ffn2_"), xt, 1e-5, fused=True, final_norm=final)
        assert torch.equal(got, TE.feed_forward(tp.sub("ffn2_"), xt, 1e-5, final_norm=final))
    assert seen == []


def test_fused_route_at_the_guard_runs_the_kernel(flat, monkeypatch):
    calls = _count_reference_kernel(monkeypatch)
    x = np.random.RandomState(64).randn(2, 64, D).astype(np.float32)
    rp = RP.Params({k: jnp.asarray(v) for k, v in flat.items()}).sub(PREFIX[:-1])
    RE.set_fused_ffn(True)
    try:
        ref = np.asarray(RE.feed_forward(rp.sub("ffn1_"), jnp.asarray(x), 1e-5))
    finally:
        RE.set_fused_ffn(False)
    assert calls == [1]
    seen = []

    def spy(*a, **kw):
        seen.append(1)
        return TF.fused_feed_forward(*a, **kw)

    monkeypatch.setattr(TE, "fused_feed_forward", spy)
    tp = TParams(params_from_numpy(flat)).sub(PREFIX[:-1])
    got = TE.feed_forward(tp.sub("ffn1_"), torch.from_numpy(x), 1e-5, fused=True).numpy()
    assert seen == [1]
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_other_devices_raise(flat):
    x = np.zeros((1, 4, D), np.float32)
    with pytest.raises(ValueError, match="no implementation"):
        _port(flat, x, False, False, fn=TF.fused_feed_forward, device="meta")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(flat, dtype):
    """The hand-written kernel against its plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    from parakeet_tpu_torch.ops.layers import require_ieee_f32

    require_ieee_f32()
    bf16 = dtype == "bfloat16"
    x = np.random.RandomState(5).randn(3, 77, D).astype(np.float32)
    for final in (False, True):
        before = TF.fused_feed_forward.launches
        got = _port(flat, x, final, bf16, fn=TF.fused_feed_forward, device="cuda").float().cpu().numpy()
        assert TF.fused_feed_forward.launches == before + 1
        ref = _port(flat, x, final, bf16, device="cuda").float().cpu().numpy()
        if bf16:
            assert np.abs(got - ref).max() <= 0.02 * np.abs(ref).max()
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-5)
