"""The port's shared kernel numerics (ops/kernel_numerics.py) against the
reference's pallas_utils.py functions, called directly (they are plain jnp),
in float32 and bfloat16 on the same inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parakeet_tpu.ops import pallas_utils as RU
from parakeet_tpu_torch.ops import kernel_numerics as KN

D, F, T, K = 16, 40, 23, 9
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(np.ascontiguousarray(a)).to(td)


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.float().numpy()
    return np.asarray(v.astype(jnp.float32))


def _close(got, ref, dtype: str, f32_rtol=2e-5, f32_atol=1e-6):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=f32_rtol, atol=f32_atol)
    else:  # a bf16 rounding point may land one ulp apart: 1% of the output scale
        assert np.abs(got - ref).max() <= 0.01 * np.abs(ref).max()


@pytest.fixture(scope="module")
def rng():
    return np.random.RandomState(17)


def _vec(rng, n, center=0.0, scale=0.1):
    return (center + scale * rng.randn(n)).astype(np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_layer_norm(rng, dtype):
    x = (rng.randn(T, D) * 2 + 0.5).astype(np.float32)
    w, b = _vec(rng, D, 1.0), _vec(rng, D)
    xj, xt = _pair(x, dtype)
    ref = RU.kernel_layer_norm(xj, jnp.asarray(w), jnp.asarray(b), 1e-5)
    got = KN.kernel_layer_norm(xt, torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fn", ["sigmoid_f32", "silu_kernelside"])
def test_sigmoid_and_silu(rng, dtype, fn):
    x = (rng.randn(T, D) * 4).astype(np.float32)
    xj, xt = _pair(x, dtype)
    ref, got = getattr(RU, fn)(xj), getattr(KN, fn)(xt)
    if fn == "sigmoid_f32":
        assert got.dtype == torch.float32
    else:
        assert got.dtype == DTYPES[dtype][1]
    _close(got, ref, dtype, f32_rtol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fold_batch_norm(rng, dtype):
    w, b, mean = _vec(rng, D, 1.0), _vec(rng, D), _vec(rng, D)
    var = (1 + 0.3 * np.abs(rng.randn(D))).astype(np.float32)
    jd, td = DTYPES[dtype]
    ref = RU.fold_batch_norm(*(jnp.asarray(a) for a in (w, b, mean, var)), D, jd)
    got = KN.fold_batch_norm(*(torch.from_numpy(a) for a in (w, b, mean, var)), D, td)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == (1, D) and g.dtype == td
        _close(g, r, dtype, f32_rtol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ffn_body(rng, dtype):
    x = rng.randn(T, D).astype(np.float32)
    nw, nb = _vec(rng, D, 1.0), _vec(rng, D)
    w1 = (rng.randn(F, D) / np.sqrt(D)).astype(np.float32)
    w2 = (rng.randn(D, F) / np.sqrt(F)).astype(np.float32)
    b1, b2 = _vec(rng, F), _vec(rng, D)
    mats = [_pair(a, dtype) for a in (x, w1, b1, w2, b2)]
    ref = RU.ffn_body(mats[0][0], jnp.asarray(nw), jnp.asarray(nb), *(m[0] for m in mats[1:]), 1e-5)
    got = KN.ffn_body(mats[0][1], torch.from_numpy(nw), torch.from_numpy(nb), *(m[1] for m in mats[1:]), 1e-5)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, ref, dtype, f32_rtol=2e-4, f32_atol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_conv_module_body(rng, dtype):
    valid = [T, T - 6]
    x = rng.randn(len(valid), T, D).astype(np.float32)
    nw, nb = _vec(rng, D, 1.0), _vec(rng, D)
    w1 = (rng.randn(2 * D, D) / np.sqrt(D)).astype(np.float32)
    wd_taps = (rng.randn(K, D) / 3).astype(np.float32)
    w2 = (rng.randn(D, D) / np.sqrt(D)).astype(np.float32)
    b1, bd, b2 = _vec(rng, 2 * D), _vec(rng, D), _vec(rng, D)
    scale, bias = _vec(rng, D, 1.0), _vec(rng, D)
    jd, td = DTYPES[dtype]
    weights = [_pair(a, dtype) for a in (w1, b1, wd_taps, bd)]
    tail = [_pair(a, dtype) for a in (scale, bias, w2, b2)]
    got = KN.conv_module_body(
        _pair(x, dtype)[1], torch.tensor(valid), torch.from_numpy(nw), torch.from_numpy(nb),
        *(w[1] for w in weights), *(w[1] for w in tail), 1e-5, K)
    assert got.dtype == td
    for i, n in enumerate(valid):
        ref = RU.conv_module_body(
            _pair(x[i], dtype)[0], n, jnp.asarray(nw), jnp.asarray(nb),
            *(w[0] for w in weights), *(w[0] for w in tail), 1e-5, K)
        _close(got[i], ref, dtype, f32_rtol=2e-4, f32_atol=1e-5)
