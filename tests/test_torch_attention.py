"""The port's fused rel-pos attention block against the JAX reference.

On the CPU the port's `rel_attention_block` runs its plain torch version;
it is held against the reference's Pallas block kernel (interpret mode, in
the block4hp form the reference's Transcriber(kernels=True) uses) and
against the reference's XLA attention path. The CUDA kernel itself is
compared with the plain version on the card (marked `cuda`)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parakeet_tpu import config as RC
from parakeet_tpu import params as RP
from parakeet_tpu.models import encoder as RE
from parakeet_tpu.ops.layers import layer_norm as r_layer_norm
from parakeet_tpu.ops.pallas_attention import fused_rel_attention_block
from parakeet_tpu.params import Params as RParams
from parakeet_tpu_torch.models import encoder as TE
from parakeet_tpu_torch.ops import rel_attention as TA
from parakeet_tpu_torch.params import Params as TParams
from parakeet_tpu_torch.params import params_from_numpy

RTOL, ATOL = 1e-3, 1e-5  # tests/test_pallas_attention.py's block-kernel tolerance
B, T, D, H = 3, 37, 32, 4
LENGTHS = [37, 30, 12]


@pytest.fixture(scope="module")
def layer():
    cfg = RC.EncoderConfig(mel_bins=80, subsampling_channels=8, hidden_size=D,
                           num_layers=1, num_heads=H, ffn_intermediate=64)
    flat = {k: np.asarray(v) for k, v in RP.init_params(RP.encoder_spec(cfg, "encoder_"), seed=3).items()}
    rng = np.random.RandomState(0)
    # non-trivial norm and bias parameters, so every term is exercised
    for k in flat:
        if k.endswith("norm_.weight"):
            flat[k] = (1 + 0.1 * rng.randn(*flat[k].shape)).astype(np.float32)
        elif k.endswith(".bias"):
            flat[k] = (0.05 * rng.randn(*flat[k].shape)).astype(np.float32)
    x = (rng.randn(B, T, D) * 0.7).astype(np.float32)
    prefix = "encoder_.layers_.0.attn_"
    return flat, prefix, x


def _args(p, x):
    """Argument order shared by the reference kernel and the port."""
    mha = p.sub("mha_")
    return (
        x,
        mha["q_proj.weight"], mha["q_proj.bias"],
        mha["k_proj.weight"], mha["k_proj.bias"],
        mha["v_proj.weight"], mha["v_proj.bias"],
        p["pos_bias_u_"], p["pos_bias_v_"],
        p["pos_proj_.weight"],
        mha["out_proj.weight"], mha["out_proj.bias"],
    )


def _assert_valid_close(got, ref, lengths=LENGTHS):
    for i, n in enumerate(lengths):
        np.testing.assert_allclose(got[i, :n], ref[i, :n], rtol=RTOL, atol=ATOL, err_msg=f"item {i}")


@pytest.mark.parametrize("fuse_norm", [False, True])
def test_reference_matches_pallas_block_kernel(layer, fuse_norm):
    flat, prefix, x = layer
    rp = RParams({k: jnp.asarray(v) for k, v in flat.items()}).sub(prefix)
    tp = TParams(params_from_numpy(flat)).sub(prefix)
    kw_r, kw_t = {}, {}
    if fuse_norm:
        kw_r = dict(norm_w=rp["norm_.weight"], norm_b=rp["norm_.bias"], eps=1e-5)
        kw_t = dict(norm_w=tp["norm_.weight"], norm_b=tp["norm_.bias"], eps=1e-5)
    ref = np.asarray(fused_rel_attention_block(
        *_args(rp, jnp.asarray(x)), lengths=jnp.asarray(LENGTHS, jnp.int32),
        batch_block=4, headpair=True, interpret=True, **kw_r))
    got = TA.rel_attention_block_reference(
        *_args(tp, torch.from_numpy(x)), lengths=torch.tensor(LENGTHS), **kw_t).numpy()
    _assert_valid_close(got, ref)


def test_reference_matches_xla_attention(layer):
    flat, prefix, x = layer
    rp = RParams({k: jnp.asarray(v) for k, v in flat.items()}).sub(prefix)
    tp = TParams(params_from_numpy(flat)).sub(prefix)
    lengths = jnp.asarray(LENGTHS, jnp.int32)
    ref = np.asarray(RE.rel_position_attention(
        rp, jnp.asarray(x), RE.sinusoidal_position_embedding(T, D), H,
        mask=RE.length_mask(lengths, T), lengths=lengths, xla_only=True))
    t_len = torch.tensor(LENGTHS)
    got = TE.rel_position_attention(tp, torch.from_numpy(x), TE.sinusoidal_position_embedding(T, D), H,
                                    TE.length_mask(t_len, T), t_len).numpy()
    _assert_valid_close(got, ref)

    # fused pre-LN + residual == XLA layer_norm → attention → + x
    normed = r_layer_norm(rp.sub("norm_"), jnp.asarray(x))
    ref_res = np.asarray(jnp.asarray(x) + RE.rel_position_attention(
        rp, normed, RE.sinusoidal_position_embedding(T, D), H,
        mask=RE.length_mask(lengths, T), lengths=lengths, xla_only=True))
    got_res = TA.rel_attention_block(
        *_args(tp, torch.from_numpy(x)), lengths=torch.tensor(LENGTHS),
        norm_w=tp["norm_.weight"], norm_b=tp["norm_.bias"]).numpy()
    _assert_valid_close(got_res, ref_res)


def test_no_lengths_attends_everywhere(layer):
    flat, prefix, x = layer
    rp = RParams({k: jnp.asarray(v) for k, v in flat.items()}).sub(prefix)
    tp = TParams(params_from_numpy(flat)).sub(prefix)
    ref = np.asarray(RE.rel_position_attention(
        rp, jnp.asarray(x), RE.sinusoidal_position_embedding(T, D), H, xla_only=True))
    got = TE.rel_position_attention(tp, torch.from_numpy(x), TE.sinusoidal_position_embedding(T, D), H).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_cpu_dispatch_runs_plain_version_and_counts_nothing(layer):
    flat, prefix, x = layer
    tp = TParams(params_from_numpy(flat)).sub(prefix)
    before = TA.rel_attention_block.launches
    args = _args(tp, torch.from_numpy(x))
    got = TA.rel_attention_block(*args, lengths=torch.tensor(LENGTHS))
    ref = TA.rel_attention_block_reference(*args, lengths=torch.tensor(LENGTHS))
    assert torch.equal(got, ref)
    assert TA.rel_attention_block.launches == before


def test_score_bf16_is_rejected(layer):
    flat, prefix, x = layer
    tp = TParams(params_from_numpy(flat)).sub(prefix)
    with pytest.raises(NotImplementedError, match="score_bf16"):
        TA.rel_attention_block(*_args(tp, torch.from_numpy(x)), score_bf16=True)


def test_bf16_reference_tracks_f32(layer):
    """bf16 weights and activations stay within bf16 noise of f32."""
    flat, prefix, x = layer
    tp32 = TParams(params_from_numpy(flat)).sub(prefix)
    tp16 = TParams(params_from_numpy(flat, dtype=torch.bfloat16)).sub(prefix)
    xt = torch.from_numpy(x)
    ref = TA.rel_attention_block_reference(*_args(tp32, xt), lengths=torch.tensor(LENGTHS))
    got = TA.rel_attention_block_reference(*_args(tp16, xt.bfloat16()), lengths=torch.tensor(LENGTHS))
    assert got.dtype == torch.bfloat16
    err = max(float((got.float() - ref)[i, :n].abs().max()) for i, n in enumerate(LENGTHS))
    assert err <= 0.05 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    """The hand-written kernel against its plain version on the card
    (head dim 64, as in the 110m model; the kernel takes 32, 64 and 128)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    d, h, t, lengths = 128, 2, 77, [77, 50, 9]
    cfg = RC.EncoderConfig(mel_bins=80, subsampling_channels=8, hidden_size=d,
                           num_layers=1, num_heads=h, ffn_intermediate=64)
    flat = {k: np.asarray(v) for k, v in RP.init_params(RP.encoder_spec(cfg, "encoder_"), seed=5).items()}
    dt = getattr(torch, dtype)
    tp = TParams(params_from_numpy(flat, "cuda", dt)).sub("encoder_.layers_.0.attn_")
    xt = torch.from_numpy(np.random.RandomState(1).randn(3, t, d).astype(np.float32)).to("cuda", dt)
    kw = dict(lengths=torch.tensor(lengths, device="cuda"),
              norm_w=tp["norm_.weight"], norm_b=tp["norm_.bias"])
    before = TA.rel_attention_block.launches
    got = TA.rel_attention_block(*_args(tp, xt), **kw).float().cpu().numpy()
    assert TA.rel_attention_block.launches == before + 1
    ref = TA.rel_attention_block_reference(*_args(tp, xt), **kw).float().cpu().numpy()
    if dt == torch.float32:
        _assert_valid_close(got, ref, lengths)
    else:
        err = max(float(np.abs(got[i, :n] - ref[i, :n]).max()) for i, n in enumerate(lengths))
        assert err <= 0.02 * float(np.abs(ref).max())
