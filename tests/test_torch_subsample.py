"""The port's fused subsampling front (K8: conv1 → dw1 → conv2) against the
reference's Pallas kernel pallas_subsample.fused_subsample_block1 in
interpret mode and against its XLA conv_subsampling_stages. The port's
kernel returns NCHW (B, C, T4, F4); the reference NHWC (B, T4, F4, C). On
the CPU the port's dispatch runs the plain torch version; the CUDA kernel
itself is held against that plain version on the card (marked `cuda`)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parakeet_tpu import config as RC
from parakeet_tpu import params as RP
from parakeet_tpu.models import encoder as RE
from parakeet_tpu.ops.pallas_subsample import fused_subsample_block1 as r_fused_subsample
from parakeet_tpu_torch.models import encoder as TE
from parakeet_tpu_torch.ops import subsample as TS
from parakeet_tpu_torch.params import Params as TParams
from parakeet_tpu_torch.params import params_from_numpy

RTOL, ATOL = 2e-5, 2e-5  # tests/test_pallas_subsample.py's tolerance
BF16_SCALE_FRAC = 0.01  # bf16: max |diff| within 1% of the output scale
C = 16
PREFIX = "encoder_.subsampling_"
WEIGHTS = ("conv1_.weight", "conv1_.bias", "dw1_.weight", "dw1_.bias", "conv2_.weight", "conv2_.bias")


def _flat(mel: int, seed: int = 5):
    cfg = RC.EncoderConfig(mel_bins=mel, subsampling_channels=C, hidden_size=32, num_layers=1,
                           num_heads=2, ffn_intermediate=64)
    out = {k: np.asarray(v) for k, v in RP.init_params(RP.encoder_spec(cfg, "encoder_"), seed=seed).items()}
    rng = np.random.RandomState(seed)
    for k in out:  # non-zero biases: the validity gate must not leak act(bias)
        if k.startswith(PREFIX) and k.endswith(".bias"):
            out[k] = (0.1 * rng.randn(*out[k].shape)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def flat80():
    return _flat(80)


def _rp(flat, bf16=False):
    def cast(k, v):
        return jnp.asarray(v).astype(jnp.bfloat16) if bf16 and "norm" not in k else jnp.asarray(v)

    return RP.Params({k: cast(k, v) for k, v in flat.items()}).sub(PREFIX)


def _tp(flat, bf16=False, device="cpu"):
    return TParams(params_from_numpy(flat, device, torch.bfloat16 if bf16 else torch.float32)).sub(PREFIX)


def _mel(b, t, f, seed):
    return np.random.RandomState(seed).randn(b, t, f).astype(np.float32)


def _nchw_to_nhwc(a: np.ndarray) -> np.ndarray:
    return np.transpose(a, (0, 2, 3, 1))


def _close(got: np.ndarray, ref: np.ndarray, bf16: bool):
    assert got.shape == ref.shape
    if bf16:
        assert np.abs(got - ref).max() <= BF16_SCALE_FRAC * np.abs(ref).max()
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def _port_block1(flat, x, activation, bf16=False, fn=TS.fused_subsample_block1_reference, device="cpu"):
    p = _tp(flat, bf16, device)
    dt = torch.bfloat16 if bf16 else torch.float32
    return fn(torch.from_numpy(x).to(device, dt), *(p[k] for k in WEIGHTS), activation=activation)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation,t", [("relu", 95), ("relu", 99), ("silu", 95)])
def test_plain_version_matches_pallas_kernel(flat80, activation, t, dtype):
    bf16 = dtype == "bfloat16"
    x = _mel(2, t, 80, seed=t)
    p = _rp(flat80, bf16)
    xj = jnp.asarray(x).astype(jnp.bfloat16 if bf16 else jnp.float32)
    ref = np.asarray(r_fused_subsample(xj, *(p[k] for k in WEIGHTS), activation=activation,
                                       t4_tile=4, interpret=True).astype(jnp.float32))
    got = _port_block1(flat80, x, activation, bf16)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    _close(_nchw_to_nhwc(got.float().numpy()), ref, bf16)


@pytest.mark.parametrize("activation,t,mel", [("relu", 95, 80), ("silu", 99, 80), ("relu", 61, 78)])
def test_plain_version_matches_xla_after_block1(activation, t, mel):
    """Against the reference's XLA stages, mel=78 included: F2 = 39 is odd,
    which the Pallas kernel's caller refuses and the port's kernel takes."""
    flat = _flat(mel)
    x = _mel(2, t, mel, seed=t + mel)
    ref = np.asarray(RE.conv_subsampling_stages(_rp(flat), jnp.asarray(x), activation)["after_block1"])
    got = _port_block1(flat, x, activation).numpy()
    _close(_nchw_to_nhwc(got), ref, False)


@pytest.mark.parametrize("activation", ["relu", "silu"])
def test_stages_match_reference(flat80, activation):
    x = _mel(2, 57, 80, seed=7)
    ref = RE.conv_subsampling_stages(_rp(flat80), jnp.asarray(x), activation)
    got = TE.conv_subsampling_stages(_tp(flat80), torch.from_numpy(x), activation)
    assert set(got) == set(ref)
    for name, r in ref.items():
        g = got[name].numpy()
        if g.ndim == 4:
            g = _nchw_to_nhwc(g)
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-4, atol=1e-5, err_msg=name)


def test_fused_conv_subsampling_matches_reference_toggle(monkeypatch):
    """The port's conv_subsampling(fused=True) against the reference's
    set_fused_subsample(True) (tests/test_pallas_subsample.py:71-99)."""
    import parakeet_tpu.ops.pallas_subsample as PS

    orig, calls = PS.fused_subsample_block1, []

    def interp(*a, **kw):
        calls.append(1)
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(PS, "fused_subsample_block1", interp)
    monkeypatch.setattr(RE, "_SUBSAMPLE_T4_TILE", 4)
    monkeypatch.setattr(TE, "_SUBSAMPLE_T4_TILE", 4)
    flat = _flat(80, seed=3)
    x = _mel(2, 99, 80, seed=3)
    RE.set_fused_subsample(True)
    try:
        ref = np.asarray(RE.conv_subsampling(_rp(flat), jnp.asarray(x)))
    finally:
        RE.set_fused_subsample(False)
    assert calls, "the reference subsampling kernel did not run"
    got = TE.conv_subsampling(_tp(flat), torch.from_numpy(x), fused=True).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    plain = TE.conv_subsampling(_tp(flat), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, plain, rtol=RTOL, atol=ATOL)


def _count_reference_kernel(monkeypatch):
    import parakeet_tpu.ops.pallas_subsample as PS

    orig, calls = PS.fused_subsample_block1, []

    def interp(*a, **kw):
        calls.append(1)
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(PS, "fused_subsample_block1", interp)
    return calls


@pytest.mark.parametrize("t,mel", [(99, 80), (61, 80), (200, 78)])
def test_fused_route_below_the_guard_is_the_plain_route(monkeypatch, t, mel):
    """T4 = 25 and 16 (< 32), or F2 = 39 (odd): the reference's guard sends
    set_fused_subsample(True) to its XLA layers, and the port's fused route
    runs its plain layers, bit for bit, in bf16, where the kernel's
    unrounded conv1 output would differ."""
    calls = _count_reference_kernel(monkeypatch)
    flat = _flat(mel, seed=3)
    x = _mel(2, t, mel, seed=t)
    RE.set_fused_subsample(True)
    try:
        RE.conv_subsampling(_rp(flat, bf16=True), jnp.asarray(x).astype(jnp.bfloat16))
    finally:
        RE.set_fused_subsample(False)
    assert calls == [], "the reference ran its kernel below its guard"
    seen = []
    monkeypatch.setattr(TE, "fused_subsample_block1", lambda *a, **kw: seen.append(1))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = TE.conv_subsampling(_tp(flat, bf16=True), xt, fused=True)
    assert seen == []
    assert torch.equal(got, TE.conv_subsampling(_tp(flat, bf16=True), xt))


def test_fused_route_at_the_guard_runs_the_kernel(monkeypatch):
    """T = 129: T4 = 33 ≥ 32 and F2 = 40 even, so both take the kernel."""
    calls = _count_reference_kernel(monkeypatch)
    flat = _flat(80, seed=3)
    x = _mel(1, 129, 80, seed=12)
    RE.set_fused_subsample(True)
    try:
        ref = np.asarray(RE.conv_subsampling(_rp(flat), jnp.asarray(x)))
    finally:
        RE.set_fused_subsample(False)
    assert calls == [1]
    seen = []

    def spy(*a, **kw):
        seen.append(1)
        return TS.fused_subsample_block1(*a, **kw)

    monkeypatch.setattr(TE, "fused_subsample_block1", spy)
    got = TE.conv_subsampling(_tp(flat), torch.from_numpy(x), fused=True).numpy()
    assert seen == [1]
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_cpu_dispatch_runs_plain_version_and_counts_nothing(flat80):
    x = _mel(1, 40, 80, seed=9)
    before = TS.fused_subsample_block1.launches
    got = _port_block1(flat80, x, "relu", fn=TS.fused_subsample_block1)
    assert torch.equal(got, _port_block1(flat80, x, "relu"))
    assert tuple(got.shape) == (1, C, 10, 20)
    assert TS.fused_subsample_block1.launches == before
    with pytest.raises(ValueError, match="activation"):
        _port_block1(flat80, x, "gelu", fn=TS.fused_subsample_block1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(flat80, dtype):
    """The hand-written kernel against its plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    from parakeet_tpu_torch.ops.layers import require_ieee_f32

    require_ieee_f32()
    bf16 = dtype == "bfloat16"
    for activation, t in (("relu", 95), ("silu", 100)):
        x = _mel(3, t, 80, seed=t)
        before = TS.fused_subsample_block1.launches
        got = _port_block1(flat80, x, activation, bf16, TS.fused_subsample_block1, "cuda")
        assert TS.fused_subsample_block1.launches == before + 1
        ref = _port_block1(flat80, x, activation, bf16, device="cuda")
        got, ref = got.float().cpu().numpy(), ref.float().cpu().numpy()
        if bf16:
            assert np.abs(got - ref).max() <= 0.02 * np.abs(ref).max()
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-5)
