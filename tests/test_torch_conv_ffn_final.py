"""The port's conv module + ffn2 + final LayerNorm (K4) against the
reference's Pallas kernel pallas_block.fused_conv_ffn_final in interpret
mode. On the CPU the port's dispatch runs the plain torch version; the
CUDA kernel itself is held against that plain version on the card (marked
`cuda`)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parakeet_tpu import config as RC
from parakeet_tpu import params as RP
from parakeet_tpu.ops.pallas_block import fused_conv_ffn_final as r_fused_conv_ffn_final
from parakeet_tpu_torch.ops import conv_ffn_final as TK
from parakeet_tpu_torch.ops import conv_module as TCM
from parakeet_tpu_torch.ops import feed_forward as TF
from parakeet_tpu_torch.params import Params as TParams
from parakeet_tpu_torch.params import params_from_numpy

RTOL, ATOL = 1e-3, 1e-5  # tests/test_pallas_block.py's tolerance
BF16_SCALE_FRAC = 0.01  # bf16: max |diff| within 1% of the output scale
D, K, T = 32, 9, 29
LENGTHS = [29, 21, 5]
PREFIX = "encoder_.layers_.0."
CONV_KEYS = ("norm_.weight", "norm_.bias", "pointwise_conv1_.weight", "pointwise_conv1_.bias",
             "depthwise_conv_.weight", "depthwise_conv_.bias", "batch_norm_.weight", "batch_norm_.bias",
             "batch_norm_.running_mean", "batch_norm_.running_var", "pointwise_conv2_.weight",
             "pointwise_conv2_.bias")
FFN_KEYS = ("norm_.weight", "norm_.bias", "fc1_.weight", "fc1_.bias", "fc2_.weight", "fc2_.bias")


@pytest.fixture(scope="module")
def flat():
    cfg = RC.EncoderConfig(mel_bins=80, subsampling_channels=8, hidden_size=D, num_layers=1,
                           num_heads=4, ffn_intermediate=64, conv_kernel_size=K)
    out = {k: np.asarray(v) for k, v in RP.init_params(RP.encoder_spec(cfg, "encoder_"), seed=13).items()}
    rng = np.random.RandomState(3)
    for k in out:  # non-trivial norms, BN statistics and biases
        if k.endswith(("norm_.weight", "running_var")):
            out[k] = (1 + 0.2 * np.abs(rng.randn(*out[k].shape))).astype(np.float32)
        elif k.endswith((".bias", "running_mean")):
            out[k] = (0.1 * rng.randn(*out[k].shape)).astype(np.float32)
    return out


def _port_args(p):
    c, f = p.sub("conv_"), p.sub("ffn2_")
    return (*(c[k] for k in CONV_KEYS), *(f[k] for k in FFN_KEYS),
            p["final_norm_.weight"], p["final_norm_.bias"])


def _reference(flat, x, lengths, bf16: bool) -> np.ndarray:
    def cast(k, v):
        return jnp.asarray(v).astype(jnp.bfloat16) if bf16 and "norm" not in k else jnp.asarray(v)

    p = RP.Params({k: cast(k, v) for k, v in flat.items()}).sub(PREFIX[:-1])
    c, f = p.sub("conv_"), p.sub("ffn2_")
    conv = dict(norm_w=c["norm_.weight"], norm_b=c["norm_.bias"],
                w1=c["pointwise_conv1_.weight"], b1=c["pointwise_conv1_.bias"],
                wd=c["depthwise_conv_.weight"], bd=c["depthwise_conv_.bias"],
                bn_w=c["batch_norm_.weight"], bn_b=c["batch_norm_.bias"],
                bn_mean=c["batch_norm_.running_mean"], bn_var=c["batch_norm_.running_var"],
                w2=c["pointwise_conv2_.weight"], b2=c["pointwise_conv2_.bias"])
    ffn = dict(norm_w=f["norm_.weight"], norm_b=f["norm_.bias"], fc1_w=f["fc1_.weight"],
               fc1_b=f["fc1_.bias"], fc2_w=f["fc2_.weight"], fc2_b=f["fc2_.bias"])
    xj = jnp.asarray(x).astype(jnp.bfloat16 if bf16 else jnp.float32)
    lj = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    out = r_fused_conv_ffn_final(xj, conv, ffn, p["final_norm_.weight"], p["final_norm_.bias"],
                                 kernel_size=K, lengths=lj, eps=1e-5, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port(flat, x, lengths, bf16: bool, fn=TK.fused_conv_ffn_final_reference, device="cpu"):
    dt = torch.bfloat16 if bf16 else torch.float32
    p = TParams(params_from_numpy(flat, device, dt)).sub(PREFIX[:-1])
    lt = None if lengths is None else torch.tensor(lengths, device=device)
    return fn(torch.from_numpy(x).to(device, dt), *_port_args(p), lengths=lt, eps=1e-5)


def _inputs(seed=4):
    return np.random.RandomState(seed).randn(len(LENGTHS), T, D).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [True, False])
def test_plain_version_matches_pallas_kernel(flat, masked, dtype):
    bf16 = dtype == "bfloat16"
    x = _inputs()
    lengths = LENGTHS if masked else None
    ref = _reference(flat, x, lengths, bf16)
    got = _port(flat, x, lengths, bf16)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    got = got.float().numpy()
    assert got.shape == ref.shape
    if bf16:
        assert np.abs(got - ref).max() <= BF16_SCALE_FRAC * np.abs(ref).max()
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_plain_version_is_conv_module_then_ffn_with_final_norm(flat):
    """K4 is K5 followed by K6 with the final LayerNorm, bit for bit."""
    x = _inputs(5)
    p = TParams(params_from_numpy(flat)).sub(PREFIX[:-1])
    args = _port_args(p)
    lt = torch.tensor(LENGTHS)
    x2 = TCM.fused_conv_module(torch.from_numpy(x), *args[:12], lengths=lt)
    want = TF.fused_feed_forward(x2, *args[12:18], final_norm_w=args[18], final_norm_b=args[19])
    assert torch.equal(_port(flat, x, LENGTHS, False), want)


def test_pad_rows_do_not_reach_valid_rows(flat):
    x = _inputs()
    noisy = x.copy()
    for i, n in enumerate(LENGTHS):
        noisy[i, n:] = 100.0 * np.random.RandomState(i).randn(T - n, D)
    a = _port(flat, x, LENGTHS, False, fn=TK.fused_conv_ffn_final).numpy()
    b = _port(flat, noisy, LENGTHS, False, fn=TK.fused_conv_ffn_final).numpy()
    for i, n in enumerate(LENGTHS):
        np.testing.assert_array_equal(a[i, :n], b[i, :n])


def test_cpu_dispatch_runs_plain_version_and_counts_nothing(flat):
    x = _inputs(6)
    before = TK.fused_conv_ffn_final.launches
    got = _port(flat, x, LENGTHS, False, fn=TK.fused_conv_ffn_final)
    assert torch.equal(got, _port(flat, x, LENGTHS, False))
    assert TK.fused_conv_ffn_final.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(flat, dtype):
    """The hand-written kernel against its plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    from parakeet_tpu_torch.ops.layers import require_ieee_f32

    require_ieee_f32()
    bf16 = dtype == "bfloat16"
    x = _inputs(7)
    for lengths in (LENGTHS, None):
        before = TK.fused_conv_ffn_final.launches
        got = _port(flat, x, lengths, bf16, fn=TK.fused_conv_ffn_final, device="cuda").float().cpu().numpy()
        assert TK.fused_conv_ffn_final.launches == before + 1
        ref = _port(flat, x, lengths, bf16, device="cuda").float().cpu().numpy()
        if bf16:
            assert np.abs(got - ref).max() <= 0.02 * np.abs(ref).max()
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-5)
