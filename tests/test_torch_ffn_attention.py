"""The port's ffn1 + attention sublayer (K7, "mega") against the reference's
Pallas kernel pallas_attention.fused_ffn_attention in interpret mode. On
the CPU the port's dispatch runs the plain torch version; the CUDA kernel
itself is held against that plain version on the card (marked `cuda`)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parakeet_tpu import config as RC
from parakeet_tpu import params as RP
from parakeet_tpu.ops.pallas_attention import fused_ffn_attention as r_fused_ffn_attention
from parakeet_tpu_torch.ops import feed_forward as TF
from parakeet_tpu_torch.ops import ffn_attention as TK
from parakeet_tpu_torch.ops import rel_attention as TA
from parakeet_tpu_torch.params import Params as TParams
from parakeet_tpu_torch.params import params_from_numpy

RTOL, ATOL = 1e-3, 1e-5  # tests/test_pallas_attention.py's fused-kernel tolerance
BF16_SCALE_FRAC = 0.02  # bf16: the two position-term forms round the table differently
B, T, D, H = 3, 37, 32, 4
LENGTHS = [37, 30, 12]
PREFIX = "encoder_.layers_.0"


@pytest.fixture(scope="module")
def flat():
    cfg = RC.EncoderConfig(mel_bins=80, subsampling_channels=8, hidden_size=D, num_layers=1,
                           num_heads=H, ffn_intermediate=64)
    out = {k: np.asarray(v) for k, v in RP.init_params(RP.encoder_spec(cfg, "encoder_"), seed=14).items()}
    rng = np.random.RandomState(4)
    for k in out:  # non-trivial norms and biases
        if k.endswith("norm_.weight"):
            out[k] = (1 + 0.1 * rng.randn(*out[k].shape)).astype(np.float32)
        elif k.endswith(".bias"):
            out[k] = (0.05 * rng.randn(*out[k].shape)).astype(np.float32)
    return out


def _port_args(p):
    f, a = p.sub("ffn1_"), p.sub("attn_")
    mha = a.sub("mha_")
    return (f["norm_.weight"], f["norm_.bias"], f["fc1_.weight"], f["fc1_.bias"],
            f["fc2_.weight"], f["fc2_.bias"], a["norm_.weight"], a["norm_.bias"],
            mha["q_proj.weight"], mha["q_proj.bias"], mha["k_proj.weight"], mha["k_proj.bias"],
            mha["v_proj.weight"], mha["v_proj.bias"], a["pos_bias_u_"], a["pos_bias_v_"],
            a["pos_proj_.weight"], mha["out_proj.weight"], mha["out_proj.bias"])


def _reference(flat, x, lengths, bf16: bool) -> np.ndarray:
    def cast(k, v):
        return jnp.asarray(v).astype(jnp.bfloat16) if bf16 and "norm" not in k else jnp.asarray(v)

    p = RP.Params({k: cast(k, v) for k, v in flat.items()}).sub(PREFIX)
    f, a = p.sub("ffn1_"), p.sub("attn_")
    mha = a.sub("mha_")
    xj = jnp.asarray(x).astype(jnp.bfloat16 if bf16 else jnp.float32)
    out = r_fused_ffn_attention(
        xj,
        ffn=dict(norm_w=f["norm_.weight"], norm_b=f["norm_.bias"], fc1_w=f["fc1_.weight"],
                 fc1_b=f["fc1_.bias"], fc2_w=f["fc2_.weight"], fc2_b=f["fc2_.bias"]),
        attn_norm_w=a["norm_.weight"], attn_norm_b=a["norm_.bias"],
        wq=mha["q_proj.weight"], bq=mha["q_proj.bias"], wk=mha["k_proj.weight"], bk=mha["k_proj.bias"],
        wv=mha["v_proj.weight"], bv=mha["v_proj.bias"],
        bias_u=a["pos_bias_u_"].astype(xj.dtype), bias_v=a["pos_bias_v_"].astype(xj.dtype),
        pos_w=a["pos_proj_.weight"], wo=mha["out_proj.weight"], bo=mha["out_proj.bias"],
        lengths=None if lengths is None else jnp.asarray(lengths, jnp.int32), eps=1e-5, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port(flat, x, lengths, bf16: bool, fn=TK.fused_ffn_attention_reference, device="cpu"):
    dt = torch.bfloat16 if bf16 else torch.float32
    p = TParams(params_from_numpy(flat, device, dt)).sub(PREFIX)
    lt = None if lengths is None else torch.tensor(lengths, device=device)
    return fn(torch.from_numpy(x).to(device, dt), *_port_args(p), lengths=lt, eps=1e-5)


def _inputs(seed=8):
    return (0.7 * np.random.RandomState(seed).randn(B, T, D)).astype(np.float32)


def _valid_max_diff(got, ref, lengths):
    return max(float(np.abs(got[i, :n] - ref[i, :n]).max()) for i, n in enumerate(lengths))


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
    valid = LENGTHS if masked else [T] * B
    if bf16:
        assert _valid_max_diff(got, ref, valid) <= BF16_SCALE_FRAC * np.abs(ref).max()
    else:
        for i, n in enumerate(valid):
            np.testing.assert_allclose(got[i, :n], ref[i, :n], rtol=RTOL, atol=ATOL, err_msg=f"item {i}")


def test_plain_version_is_ffn_then_attention_block(flat):
    """K7 is K6 (no final LayerNorm) followed by K1 with the fused pre-LN
    and the residual of x2, bit for bit."""
    x = torch.from_numpy(_inputs(9))
    args = _port_args(TParams(params_from_numpy(flat)).sub(PREFIX))
    lt = torch.tensor(LENGTHS)
    x2 = TF.fused_feed_forward(x, *args[:6])
    want = TA.rel_attention_block(x2, *args[8:], lengths=lt, norm_w=args[6], norm_b=args[7])
    assert torch.equal(TK.fused_ffn_attention(x, *args, lengths=lt), want)


def test_cpu_dispatch_runs_plain_version_and_counts_nothing(flat):
    x = _inputs(10)
    before = TK.fused_ffn_attention.launches
    got = _port(flat, x, LENGTHS, False, fn=TK.fused_ffn_attention)
    assert torch.equal(got, _port(flat, x, LENGTHS, False))
    assert TK.fused_ffn_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(flat, dtype):
    """The hand-written kernel against its plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    from parakeet_tpu_torch.ops.layers import require_ieee_f32

    require_ieee_f32()
    bf16 = dtype == "bfloat16"
    x = _inputs(11)
    before = TK.fused_ffn_attention.launches
    got = _port(flat, x, LENGTHS, bf16, fn=TK.fused_ffn_attention, device="cuda").float().cpu().numpy()
    assert TK.fused_ffn_attention.launches == before + 1
    ref = _port(flat, x, LENGTHS, bf16, device="cuda").float().cpu().numpy()
    if bf16:
        assert _valid_max_diff(got, ref, LENGTHS) <= 0.02 * np.abs(ref).max()
    else:
        for i, n in enumerate(LENGTHS):
            np.testing.assert_allclose(got[i, :n], ref[i, :n], rtol=1e-3, atol=1e-5)
