"""K1's attention core as the kernels compute it, against the JAX reference.

The card's cores (csrc/rel_attention.cuh) walk the keys in tiles with an
online softmax and, where the plan splits the keys, run the splits of a
query tile as one thread-block cluster: each split keeps its rows' running
max, sum and unnormalised output, and the cluster merges them in split
order. The bf16 core rounds the unnormalised probabilities to bf16 before
AV and normalises after, as the reference kernel does
(parakeet_tpu/ops/pallas_attention.py); the port's plain version
(`rel_attention_block_reference`) takes the same rounding point. Here a
plain torch model of that arithmetic (`split_core` below) runs inside the
block's plain projections and is held against the reference's Pallas block
kernel in interpret mode, with 1, 2 and 3 splits, and the plain version in
bf16 against the reference kernel in bf16. An item with no valid key
averages all T' keys (the reference's XLA attention, and the port); the
reference's Pallas kernel averages its 128-lane padded keys there (zero
values past T'), so that item is held to the reference's XLA path. The
kernels themselves are held
to the plain version on the card (tests/test_torch_attention.py, marked
`cuda`, and chip_smoke.py)."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from parakeet_tpu import config as RC
from parakeet_tpu import params as RP
from parakeet_tpu.models import encoder as RE
from parakeet_tpu.ops.layers import layer_norm as r_layer_norm
from parakeet_tpu.ops.pallas_attention import fused_rel_attention_block
from parakeet_tpu.params import Params as RParams
from parakeet_tpu_torch.ops import rel_attention as TA
from parakeet_tpu_torch.params import Params as TParams
from parakeet_tpu_torch.params import params_from_numpy

RTOL, ATOL = 1e-3, 1e-5  # tests/test_pallas_attention.py's block-kernel tolerance
BF16_SCALE_FRAC = 0.02  # bf16: the kernels' tolerance against their plain versions (chip_smoke.py)
B, T, D, H = 4, 37, 32, 4
KEY_TILE = 8  # 5 key tiles of 37 keys, the last one partial
# a full item, one key, a length that is no multiple of the tile, no valid key
LENGTHS = [37, 1, 21, 0]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def layer():
    cfg = RC.EncoderConfig(mel_bins=80, subsampling_channels=8, hidden_size=D,
                           num_layers=1, num_heads=H, ffn_intermediate=64)
    flat = {k: np.asarray(v) for k, v in RP.init_params(RP.encoder_spec(cfg, "encoder_"), seed=11).items()}
    rng = np.random.RandomState(7)
    for k in flat:  # non-trivial norms and biases, so every term counts
        if k.endswith("norm_.weight"):
            flat[k] = (1 + 0.1 * rng.randn(*flat[k].shape)).astype(np.float32)
        elif k.endswith(".bias"):
            flat[k] = (0.05 * rng.randn(*flat[k].shape)).astype(np.float32)
    x = (rng.randn(B, T, D) * 0.7).astype(np.float32)
    return flat, "encoder_.layers_.0.attn_", x


def _args(p, x):
    mha = p.sub("mha_")
    return (x, mha["q_proj.weight"], mha["q_proj.bias"], mha["k_proj.weight"], mha["k_proj.bias"],
            mha["v_proj.weight"], mha["v_proj.bias"], p["pos_bias_u_"], p["pos_bias_v_"],
            p["pos_proj_.weight"], mha["out_proj.weight"], mha["out_proj.bias"])


def _jax_block(flat, prefix, x, bf16: bool = False) -> np.ndarray:
    def cast(k, v):
        return jnp.asarray(v).astype(jnp.bfloat16) if bf16 and "norm" not in k else jnp.asarray(v)

    rp = RParams({k: cast(k, v) for k, v in flat.items()}).sub(prefix)
    xj = jnp.asarray(x).astype(jnp.bfloat16 if bf16 else jnp.float32)
    out = fused_rel_attention_block(
        *_args(rp, xj), lengths=jnp.asarray(LENGTHS, jnp.int32), norm_w=rp["norm_.weight"],
        norm_b=rp["norm_.bias"], eps=1e-5, batch_block=4, headpair=True, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _jax_xla_block(flat, prefix, x) -> np.ndarray:
    """The reference's XLA attention with the pre-LN and the residual."""
    rp = RParams({k: jnp.asarray(v) for k, v in flat.items()}).sub(prefix)
    lengths = jnp.asarray(LENGTHS, jnp.int32)
    normed = r_layer_norm(rp.sub("norm_"), jnp.asarray(x))
    return np.asarray(jnp.asarray(x) + RE.rel_position_attention(
        rp, normed, RE.sinusoidal_position_embedding(T, D), H, mask=RE.length_mask(lengths, T),
        lengths=lengths, xla_only=True))


def split_core(qu, qv, k, v, pos, lengths, splits: int, key_tile: int = KEY_TILE):
    """The kernels' core in plain torch, (B, H, T, hd) f32 in and out: the
    keys in tiles of key_tile, split z taking tiles [z·tps, (z+1)·tps) (tps =
    ceil(tiles / splits)) cut at the item's key count (min(len, T); all T
    with no valid key, whose keys then score −1e9); per tile the content and
    position scores (q_v against P[T−1−t+s]), keys past the count −inf,
    the running max, sum (of the unrounded e) and output rescaled, e rounded
    to the dtype before AV; then the splits merged in order, weighted by
    exp(m_z − max m), and normalised after AV."""
    b, heads, t, hd = qu.shape
    dt = qu.dtype
    f32 = torch.float32
    tiles = -(-t // key_tile)
    tps = -(-tiles // splits)
    rows = torch.arange(t)
    out = torch.empty(b, heads, t, hd, dtype=f32)
    for i in range(b):
        kv_len = min(int(lengths[i]), t)
        n_keys = kv_len if kv_len > 0 else t
        parts = []
        for z in range(splits):
            m = torch.full((heads, t, 1), -math.inf)
            l = torch.zeros(heads, t, 1)
            acc = torch.zeros(heads, t, hd)
            for it in range(z * tps, min(-(-n_keys // key_tile), (z + 1) * tps)):
                keys = torch.arange(it * key_tile, min((it + 1) * key_tile, t))
                band = pos[:, t - 1 - rows[:, None] + keys[None, :]]  # (H, T, n, hd)
                s = qu[i].to(f32) @ k[i][:, keys].to(f32).transpose(-1, -2)
                s = s + (qv[i].to(f32)[:, :, None, :] * band.to(f32)).sum(-1)
                s = s.masked_fill((keys >= n_keys)[None, None, :], -math.inf)
                s = s.masked_fill(((keys >= kv_len) & (keys < n_keys))[None, None, :], TA._NEG_INF)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                e = torch.exp(s - m_new)
                l = l * alpha + e.sum(-1, keepdim=True)
                acc = acc * alpha + e.to(dt).to(f32) @ v[i][:, keys].to(f32)
                m = m_new
            parts.append((m, l, acc))
        top = torch.stack([p[0] for p in parts]).amax(0)
        num, den = torch.zeros(heads, t, hd), torch.zeros(heads, t, 1)
        for m, l, acc in parts:  # in split order
            w = torch.exp(m - top)
            num = num + acc * w
            den = den + l * w
        out[i] = num / den
    return out


def block_with_split_core(flat, prefix, x, splits: int) -> np.ndarray:
    """rel_attention_block_reference's projections (pre-LN, QKV with the
    1/√hd fold, P = pe Wposᵀ), `split_core`, then the out-projection and the
    residual, in f32."""
    p = TParams(params_from_numpy(flat)).sub(prefix)
    mha = p.sub("mha_")
    xt = torch.from_numpy(x)
    heads, hd = p["pos_bias_u_"].shape
    scale = 1.0 / math.sqrt(hd)
    xn = F.layer_norm(xt, (D,), p["norm_.weight"], p["norm_.bias"], 1e-5)

    def split(y):
        return y.view(B, T, heads, hd).transpose(1, 2)

    q = (xn @ mha["q_proj.weight"].T + mha["q_proj.bias"]) * scale
    k = xn @ mha["k_proj.weight"].T + mha["k_proj.bias"]
    v = xn @ mha["v_proj.weight"].T + mha["v_proj.bias"]
    qu = split(q + p["pos_bias_u_"].reshape(D) * scale)
    qv = split(q + p["pos_bias_v_"].reshape(D) * scale)
    pos = (TA.position_table(T, D, xt.device, torch.float32) @ p["pos_proj_.weight"].T).view(2 * T - 1, heads, hd)
    ctx = split_core(qu, qv, split(k), split(v), pos.permute(1, 0, 2), LENGTHS, splits)
    out = ctx.transpose(1, 2).reshape(B, T, D) @ mha["out_proj.weight"].T + mha["out_proj.bias"]
    return (xt + out).numpy()


def _valid(a, lengths=LENGTHS):
    """The rows a caller reads: t < length (every row of an item with no
    valid key, which averages all keys)."""
    return [a[i, : (n if n > 0 else T)] for i, n in enumerate(lengths)]


@pytest.mark.parametrize("splits", [1, 2, 3])
def test_split_core_matches_pallas_block_kernel(layer, splits):
    """Items with valid keys against the Pallas block kernel, the item with
    none against the XLA path (see the module's note)."""
    flat, prefix, x = layer
    ref, xla = _jax_block(flat, prefix, x), _jax_xla_block(flat, prefix, x)
    got = block_with_split_core(flat, prefix, x, splits)
    for i, (g, r, q) in enumerate(zip(_valid(got), _valid(ref), _valid(xla))):
        np.testing.assert_allclose(g, r if LENGTHS[i] > 0 else q, rtol=RTOL, atol=ATOL,
                                   err_msg=f"item {i}, {splits} splits")


def test_splits_cover_whole_key_tiles_and_may_be_empty():
    """3 splits of 5 key tiles take 2, 2 and 1; an item of 1 key leaves the
    last two empty (max −inf, sum 0, no weight in the merge)."""
    rng = np.random.RandomState(3)
    arrays = [torch.from_numpy(rng.randn(1, 2, T, 8).astype(np.float32)) for _ in range(4)]
    pos = torch.from_numpy(rng.randn(2, 2 * T - 1, 8).astype(np.float32))
    one = split_core(*arrays, pos, [1], 1)
    three = split_core(*arrays, pos, [1], 3)
    torch.testing.assert_close(three, one, rtol=0, atol=0)
    torch.testing.assert_close(one, arrays[3][:, :, :1].expand_as(one), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("splits", [1, 3])
def test_split_core_equals_the_plain_version(layer, splits):
    """The plain version (one softmax over all keys) and the tiled, split
    arithmetic agree in f32 at the kernels' tolerance, and on every row of
    an item with no valid key."""
    flat, prefix, x = layer
    tp = TParams(params_from_numpy(flat)).sub(prefix)
    plain = TA.rel_attention_block_reference(*_args(tp, torch.from_numpy(x)), lengths=torch.tensor(LENGTHS),
                                             norm_w=tp["norm_.weight"], norm_b=tp["norm_.bias"]).numpy()
    got = block_with_split_core(flat, prefix, x, splits)
    for g, r in zip(_valid(got), _valid(plain)):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)


def test_bf16_plain_version_rounds_e_and_tracks_the_pallas_kernel(layer):
    """The plain version in bf16, which rounds the unnormalised
    probabilities to bf16 before AV and normalises after (the reference
    kernel's rounding point), against the reference's block kernel in
    bf16: within 2% of the output's scale on the valid rows."""
    flat, prefix, x = layer
    ref = _jax_block(flat, prefix, x, bf16=True)
    tp = TParams(params_from_numpy(flat, dtype=torch.bfloat16)).sub(prefix)
    got = TA.rel_attention_block_reference(
        *_args(tp, torch.from_numpy(x).bfloat16()), lengths=torch.tensor(LENGTHS),
        norm_w=tp["norm_.weight"].float(), norm_b=tp["norm_.bias"].float())
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    scale = float(np.abs(ref).max())
    err = max(float(np.abs(g - r).max()) for n, g, r in zip(LENGTHS, _valid(got), _valid(ref)) if n > 0)
    assert np.isfinite(got).all() and err <= BF16_SCALE_FRAC * scale, (err, scale)
