"""The reference's call forms on the port: `rel_position_attention(p, x,
pos_emb, num_heads, mask, lengths)`, `conformer_block(p, x, pos_emb, cfg,
mask, pad_mask, lengths)` and `glu(x, axis)`, called with the reference's
positional arguments (a `sinusoidal_position_embedding` table, a
`length_mask` or another mask), against the JAX package's XLA path, at
tests/test_torch_attention.py's tolerance. A key-length mask takes the
port's attention kernel route (on the CPU its plain version); any other
mask takes the plain route, applied as the reference applies it."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parakeet_tpu import config as RC
from parakeet_tpu import params as RP
from parakeet_tpu.models import encoder as RE
from parakeet_tpu.ops.layers import glu as r_glu
from parakeet_tpu.params import Params as RParams
from parakeet_tpu_torch import config as TC
from parakeet_tpu_torch.models import encoder as TE
from parakeet_tpu_torch.models.encoder import EncoderSplit, FusedLayers
from parakeet_tpu_torch.ops import glu as t_glu
from parakeet_tpu_torch.parallel.mesh import AxisGroup
from parakeet_tpu_torch.params import Params as TParams
from parakeet_tpu_torch.params import params_from_numpy

RTOL, ATOL = 1e-3, 1e-5  # tests/test_torch_attention.py's (the reference's block-kernel tolerance)
B, T, D, H = 3, 37, 32, 4
LENGTHS = [37, 30, 12]
LAYER = "encoder_.layers_.0"


def _cfg(mod):
    return mod.EncoderConfig(mel_bins=80, subsampling_channels=8, hidden_size=D, num_layers=1, num_heads=H,
                             ffn_intermediate=64)


@pytest.fixture(scope="module")
def layer():
    flat = {k: np.asarray(v) for k, v in RP.init_params(RP.encoder_spec(_cfg(RC), "encoder_"), seed=23).items()}
    rng = np.random.RandomState(4)
    for k in flat:  # non-trivial norms, biases and BN statistics, so every term is exercised
        if k.endswith("norm_.weight") or k.endswith("running_var"):
            flat[k] = (1 + 0.1 * np.abs(rng.randn(*flat[k].shape))).astype(np.float32)
        elif k.endswith(".bias") or k.endswith("running_mean"):
            flat[k] = (0.05 * rng.randn(*flat[k].shape)).astype(np.float32)
    x = (rng.randn(B, T, D) * 0.7).astype(np.float32)
    return RParams({k: jnp.asarray(v) for k, v in flat.items()}), TParams(params_from_numpy(flat)), x


def _masks(kind):
    """(reference mask, port mask, lengths or None) of one kind."""
    lengths = np.asarray(LENGTHS, np.int32)
    if kind == "none":
        return None, None, None
    if kind == "length":
        return (RE.length_mask(jnp.asarray(lengths), T), TE.length_mask(torch.from_numpy(lengths), T),
                lengths)
    # causal on top of the key lengths: not a key-length mask
    causal = np.triu(np.ones((T, T), bool), k=1)[None, None]
    keys = np.arange(T)[None, :] >= lengths[:, None]
    mask = causal | keys[:, None, None, :]
    return jnp.asarray(mask), torch.from_numpy(mask), lengths


def _rows(kind):
    """The rows both packages define: every row without a key-length mask
    (the causal mask's pad rows too: both apply it as given), the valid
    rows with it (the kernel route leaves pad query rows unspecified)."""
    return LENGTHS if kind == "length" else [T] * B


def _assert_rows_close(got, ref, rows):
    for i, n in enumerate(rows):
        np.testing.assert_allclose(got[i, :n], ref[i, :n], rtol=RTOL, atol=ATOL, err_msg=f"item {i}")


def _count_plain(monkeypatch):
    calls = []
    inner = TE._masked_attention
    monkeypatch.setattr(TE, "_masked_attention", lambda *a: calls.append(1) or inner(*a))
    return calls


@pytest.mark.parametrize("kind", ["none", "length", "causal"])
def test_rel_position_attention_reference_arguments(layer, kind, monkeypatch):
    rp, tp, x = layer
    r_mask, t_mask, lengths = _masks(kind)
    plain = _count_plain(monkeypatch)
    ref = np.asarray(RE.rel_position_attention(
        rp.sub(LAYER + ".attn_"), jnp.asarray(x), RE.sinusoidal_position_embedding(T, D), H, r_mask,
        None if lengths is None else jnp.asarray(lengths)))
    got = TE.rel_position_attention(
        tp.sub(LAYER + ".attn_"), torch.from_numpy(x), TE.sinusoidal_position_embedding(T, D), H, t_mask,
        None if lengths is None else torch.from_numpy(lengths)).numpy()
    _assert_rows_close(got, ref, _rows(kind))
    assert len(plain) == (kind == "causal")


def test_rel_position_attention_plain_route_without_lengths(layer):
    """A mask with no lengths is never taken for a key-length mask, and a
    table the caller built is what the plain route projects."""
    rp, tp, x = layer
    r_mask, t_mask, _ = _masks("length")
    ref = np.asarray(RE.rel_position_attention(
        rp.sub(LAYER + ".attn_"), jnp.asarray(x), RE.sinusoidal_position_embedding(T, D), H, r_mask))
    got = TE.rel_position_attention(tp.sub(LAYER + ".attn_"), torch.from_numpy(x),
                                    TE.sinusoidal_position_embedding(T, D), H, t_mask).numpy()
    _assert_rows_close(got, ref, [T] * B)
    with pytest.raises(ValueError, match="num_heads"):
        TE.rel_position_attention(tp.sub(LAYER + ".attn_"), torch.from_numpy(x), None, H * 2)


def test_is_key_length_mask():
    lengths = torch.tensor(LENGTHS)
    assert TE._is_key_length_mask(TE.length_mask(lengths, T), lengths, T)
    keys_only = (torch.arange(T)[None, :] >= lengths[:, None])[:, None, None, :]  # (B, 1, 1, T)
    assert TE._is_key_length_mask(keys_only, lengths, T)
    assert not TE._is_key_length_mask(TE.length_mask(lengths, T), None, T)
    assert not TE._is_key_length_mask(_masks("causal")[1], lengths, T)
    assert not TE._is_key_length_mask(TE.length_mask(lengths - 1, T), lengths, T)


@pytest.mark.parametrize("kind", ["none", "length", "causal"])
@pytest.mark.parametrize("fused", [FusedLayers(), FusedLayers(attention="mega", block2=True)],
                         ids=["default", "whole-block"])
def test_conformer_block_reference_arguments(layer, kind, fused, monkeypatch):
    rp, tp, x = layer
    r_mask, t_mask, lengths = _masks(kind)
    pad = None if lengths is None else np.arange(T)[None, :] >= lengths[:, None]
    plain = _count_plain(monkeypatch)
    ref = np.asarray(RE.conformer_block(
        rp.sub(LAYER), jnp.asarray(x), RE.sinusoidal_position_embedding(T, D), _cfg(RC), r_mask,
        None if pad is None else jnp.asarray(pad), None if lengths is None else jnp.asarray(lengths)))
    got = TE.conformer_block(
        tp.sub(LAYER), torch.from_numpy(x), TE.sinusoidal_position_embedding(T, D), _cfg(TC), t_mask,
        None if pad is None else torch.from_numpy(pad), None if lengths is None else torch.from_numpy(lengths),
        fused=fused).numpy()
    # the conv module zeroes pad rows before its depthwise conv, so only the
    # valid rows of a padded batch are defined alike
    _assert_rows_close(got, ref, LENGTHS if lengths is not None else [T] * B)
    assert len(plain) == (kind == "causal")


def test_conformer_block_refuses_a_general_mask_on_a_split(layer):
    _, tp, x = layer
    _, t_mask, lengths = _masks("causal")
    split = EncoderSplit(model=AxisGroup(None, 2, 0), seq=AxisGroup.single())
    with pytest.raises(ValueError, match="key-length mask"):
        TE.conformer_block(tp.sub(LAYER), torch.from_numpy(x), None, _cfg(TC), t_mask, None,
                           torch.from_numpy(lengths), split=split)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_glu_takes_axis(axis):
    x = np.random.RandomState(axis + 5).randn(4, 6, 8).astype(np.float32)
    got = t_glu(torch.from_numpy(x), axis=axis).numpy()
    np.testing.assert_allclose(got, np.asarray(r_glu(jnp.asarray(x), axis=axis)), rtol=1e-6, atol=1e-7)
