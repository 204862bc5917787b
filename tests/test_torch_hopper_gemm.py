"""K6, K5, K7, K4 and K1 on the Hopper GEMM of csrc/ffn_gemm.cuh
(hopper_gemm_kernel, bf16), on its f32 tiled GEMM (TMA-fed, the LayerNorm
on the A path, k slices closed in a cluster) and on the bf16 tiled
sequences of rows wider than a cluster, K1's attention cores (bf16 wgmma,
f32 CUDA cores, split and unsplit), K2's (bf16's two sweeps with the
scores kept and computed again, f32 on K1's core; split and unsplit), and
the C entries of every kernel library against what their wrappers pass.

The ctypes checks run here without nvcc: each `extern "C"` entry of
csrc/*.cu is parsed and held to the `argtypes` its wrapper sets (a wrong
count truncates or shifts pointers silently). The kernels themselves are
held to their plain versions on the card (marked `cuda`; they skip inside
the test without one): f32 at the reference block kernels' tolerance, bf16
within 1% of the output's scale, at the 110m widths, at odd widths (row
strides that TMA cannot load, QKV segments of 96 rows), at D = 1280 (past
a cluster's column tiles) and with lengths below T'."""

import functools
import re
import types

import numpy as np
import pytest
import torch

from parakeet_tpu_torch.ops import _build
from parakeet_tpu_torch.ops import conv_ffn_final as K4
from parakeet_tpu_torch.ops import conv_module as CM
from parakeet_tpu_torch.ops import feed_forward as FF
from parakeet_tpu_torch.ops import ffn_attention as K7
from parakeet_tpu_torch.ops import log_mel as LM
from parakeet_tpu_torch.ops import rel_attention as RA
from parakeet_tpu_torch.ops import subsample as SS

RTOL, ATOL = 1e-3, 1e-5  # the reference's tests/test_pallas_block.py
BF16_SCALE_FRAC = 0.01

# library -> (wrapper module, the function that loads it and sets argtypes)
LIBRARIES = {
    "rel_attention": (RA, "_lib"), "rel_attention_v1": (RA, "_lib_v1"), "feed_forward": (FF, "_lib"),
    "conv_module": (CM, "_lib"), "subsample": (SS, "_lib"), "conv_ffn_final": (K4, "_lib"),
    "ffn_attention": (K7, "_lib"), "log_mel": (LM, "_lib"),
}


class _FakeLib:
    """Stands in for a loaded library: each attribute a function object
    whose argtypes the wrapper fills in."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return self.fns.setdefault(name, types.SimpleNamespace(argtypes=None, restype=None))


def c_entries(name: str) -> dict[str, list[str]]:
    """The `extern "C"` functions of csrc/<name>.cu, each with its parameter
    types (pointer, float or int)."""
    src = (_build._CSRC / f"{name}.cu").read_text()
    block = src[src.index('extern "C" {'):]
    out = {}
    for m in re.finditer(r"\bint (pk_\w+)\(([^)]*)\)\s*\{", block):
        kinds = []
        for param in m.group(2).split(","):
            param = " ".join(param.split())
            kinds.append("pointer" if "*" in param else param.rsplit(" ", 1)[0].replace("const ", ""))
        out[m.group(1)] = kinds
    return out


def test_every_kernel_library_is_checked():
    assert sorted(LIBRARIES) == sorted(p.stem for p in _build._CSRC.glob("*.cu"))


@pytest.mark.parametrize("name", sorted(LIBRARIES))
def test_c_entries_take_what_the_wrappers_pass(name, monkeypatch):
    module, loader = LIBRARIES[name]
    fake = _FakeLib()
    monkeypatch.setattr(module, "load", lambda lib: fake if lib == name else _FakeLib())
    getattr(module, loader)()
    entries = c_entries(name)
    assert entries and set(fake.fns) == set(entries)
    want = {"pointer": "c_void_p", "int": "c_int", "float": "c_float"}
    for fn, kinds in entries.items():
        got = [t.__name__ for t in fake.fns[fn].argtypes]
        assert got == [want[k] for k in kinds], fn
        assert fake.fns[fn].restype.__name__ == "c_int"


# ─── on the card ────────────────────────────────────────────────────────────

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    from parakeet_tpu_torch.ops.layers import require_ieee_f32

    require_ieee_f32()


def _dev(dtype):
    def dev(a, dt=dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to("cuda", dt)
    return dev


def _ffn(rng, dev, d, f):
    return [dev(1 + 0.1 * rng.randn(d), torch.float32), dev(0.1 * rng.randn(d), torch.float32),
            dev(rng.randn(f, d) / np.sqrt(d)), dev(0.05 * rng.randn(f)),
            dev(rng.randn(d, f) / np.sqrt(f)), dev(0.05 * rng.randn(d))]


def _k7_args(rng, dev, b, t, d, f, heads):
    attn = []
    for _ in range(3):
        attn += [dev(rng.normal(0, 1 / np.sqrt(d), (d, d))), dev(rng.normal(0, 0.02, d))]
    attn += [dev(rng.normal(0, 0.02, (heads, d // heads))), dev(rng.normal(0, 0.02, (heads, d // heads))),
             dev(rng.normal(0, 1 / np.sqrt(d), (d, d))), dev(rng.normal(0, 1 / np.sqrt(d), (d, d))),
             dev(rng.normal(0, 0.02, d))]
    return (dev(rng.randn(b, t, d)), *_ffn(rng, dev, d, f), dev(1 + 0.1 * rng.randn(d), torch.float32),
            dev(0.1 * rng.randn(d), torch.float32), *attn)


def _k4_args(rng, dev, b, t, d, f):
    f32 = torch.float32
    conv = [dev(1 + 0.1 * rng.randn(d), f32), dev(0.1 * rng.randn(d), f32),
            dev(rng.randn(2 * d, d, 1) / np.sqrt(d)), dev(0.05 * rng.randn(2 * d)),
            dev(rng.randn(d, 1, 9) / 3), dev(0.05 * rng.randn(d)),
            dev(1 + 0.1 * rng.randn(d), f32), dev(0.1 * rng.randn(d), f32),
            dev(0.1 * rng.randn(d), f32), dev(1 + 0.2 * np.abs(rng.randn(d)), f32),
            dev(rng.randn(d, d, 1) / np.sqrt(d)), dev(0.05 * rng.randn(d))]
    return (dev(rng.randn(b, t, d)), *conv, *_ffn(rng, dev, d, f),
            dev(1 + 0.1 * rng.randn(d), f32), dev(0.1 * rng.randn(d), f32))


def _hold(got, ref, rows, frac=BF16_SCALE_FRAC):
    g, r = got.float().cpu().numpy(), ref.float().cpu().numpy()
    assert np.isfinite(g).all()
    for i, n in enumerate(rows):
        if got.dtype == torch.float32:
            np.testing.assert_allclose(g[i, :n], r[i, :n], rtol=RTOL, atol=ATOL)
        else:
            assert np.abs(g[i, :n] - r[i, :n]).max() <= frac * np.abs(r).max()


# (B, T, D, F, H): the 110m widths at a short T, odd widths (K and lda of
# 100 and 36 values: TMA cannot load those rows; D = 96: QKV segments that
# are not whole 64-row boxes), lengths below T, and D = 1280 (10 column
# tiles: the tiled sequences in bf16 too)
SHAPES = [(2, 64, 512, 2048, 8), (3, 37, 96, 100, 3), (2, 20, 64, 128, 2), (2, 64, 1280, 1280, 10)]


@pytest.mark.cuda
@pytest.mark.parametrize("with_lengths", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_k7_kernel_matches_plain_version_on_the_card(shape, dtype, with_lengths):
    _need_card()
    b, t, d, f, heads = shape
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(sum(shape))
    args = _k7_args(rng, _dev(dt), b, t, d, f, heads)
    lengths = [t, *(max(1, t - 7 * i - 3) for i in range(1, b))] if with_lengths else [t] * b
    lt = torch.tensor(lengths, dtype=torch.int32, device="cuda") if with_lengths else None
    before = K7.fused_ffn_attention.launches
    with torch.inference_mode():
        got = K7.fused_ffn_attention(*args, lengths=lt)
        ref = K7.fused_ffn_attention_reference(*args, lengths=lt)
    assert K7.fused_ffn_attention.launches == before + 1
    _hold(got, ref, lengths)  # pad query rows are garbage in both, as in the reference


@pytest.mark.cuda
@pytest.mark.parametrize("with_lengths", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 64, 512, 2048), (3, 37, 36, 70), (3, 37, 96, 100), (2, 64, 1280, 1280)])
def test_k4_kernel_matches_plain_version_on_the_card(shape, dtype, with_lengths):
    _need_card()
    b, t, d, f = shape
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(sum(shape))
    args = _k4_args(rng, _dev(dt), b, t, d, f)
    lengths = [t, *(max(1, t - 9 * i - 2) for i in range(1, b))] if with_lengths else [t] * b
    lt = torch.tensor(lengths, dtype=torch.int32, device="cuda") if with_lengths else None
    before = K4.fused_conv_ffn_final.launches
    with torch.inference_mode():
        got = K4.fused_conv_ffn_final(*args, lengths=lt)
        ref = K4.fused_conv_ffn_final_reference(*args, lengths=lt)
    assert K4.fused_conv_ffn_final.launches == before + 1
    _hold(got, ref, [t] * b)  # every row: the conv half masks pad rows the same way in both


# K6 and K5 alone: (B, T, D, F) at the 110m widths, odd widths (rows of 36
# and 100 values, and 70: TMA cannot load those), D = 1280 (the bf16 wide
# route) and a short T
K6_K5_SHAPES = [(2, 64, 512, 2048), (3, 37, 36, 70), (3, 37, 96, 100), (2, 64, 1280, 1280), (2, 20, 64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("final", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", K6_K5_SHAPES)
def test_k6_kernel_matches_plain_version_on_the_card(shape, dtype, final):
    _need_card()
    b, t, d, f = shape
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(sum(shape) + final)
    dev = _dev(dt)
    args = (dev(rng.randn(b, t, d)), *_ffn(rng, dev, d, f))
    kw = dict(final_norm_w=dev(1 + 0.1 * rng.randn(d), torch.float32),
              final_norm_b=dev(0.1 * rng.randn(d), torch.float32)) if final else {}
    before = FF.fused_feed_forward.launches
    with torch.inference_mode():
        got = FF.fused_feed_forward(*args, **kw)
        ref = FF.fused_feed_forward_reference(*args, **kw)
    assert FF.fused_feed_forward.launches == before + 1
    _hold(got, ref, [t] * b)


@pytest.mark.cuda
@pytest.mark.parametrize("with_lengths", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", K6_K5_SHAPES)
def test_k5_kernel_matches_plain_version_on_the_card(shape, dtype, with_lengths):
    _need_card()
    b, t, d, _ = shape
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(sum(shape) + with_lengths)
    args = _k4_args(rng, _dev(dt), b, t, d, 4)[:13]  # x and the conv module's weights
    lengths = [t, *(max(1, t - 9 * i - 2) for i in range(1, b))] if with_lengths else [t] * b
    lt = torch.tensor(lengths, dtype=torch.int32, device="cuda") if with_lengths else None
    before = CM.fused_conv_module.launches
    with torch.inference_mode():
        got = CM.fused_conv_module(*args, lengths=lt)
        ref = CM.fused_conv_module_reference(*args, lengths=lt)
    assert CM.fused_conv_module.launches == before + 1
    _hold(got, ref, [t] * b)  # every row: pad rows are masked the same way in both


@pytest.mark.cuda
def test_hopper_clusters_held_at_once_on_the_card():
    """The Hopper GEMM's clusters of 1-8 blocks that the card holds at once
    (cudaOccupancyMaxActiveClusters): some of every size, and no more
    blocks than two an SM (shared memory holds no third). The plans'
    table is what an H100 SXM answered; a card whose GPCs differ answers
    otherwise, which changes a plan's speed, not its result."""
    _need_card()
    from parakeet_tpu_torch.ops import gemm_plan as GP

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n in range(1, GP.MAX_CLUSTER + 1):
        held = K7.hopper_active_clusters(n)
        assert 1 <= held and held * n <= 2 * sms, (n, held)


# ─── K1 on the card: every head dim, split and unsplit, both modes ──────────
K1_BF16_SCALE_FRAC = 0.02  # chip_smoke.py's bf16 tolerance for K1
# (B, T, D, H): hd 32 (D=96: rows TMA cannot load, QKV segments of 96 rows;
# D=256 at B=2, T=77: 2 key splits), hd 64 (B=8, T=126: no split; B=1,
# T=751: 4 splits), hd 128 (B=8, T=126: no split; B=1, T=300: key splits)
K1_SHAPES = [(3, 37, 96, 3), (2, 77, 256, 8), (8, 126, 512, 8), (1, 751, 512, 8), (8, 126, 1024, 8),
             (1, 300, 1024, 8)]


def _k1_args(rng, dev, b, t, d, heads, local=None):
    """x, then K1's weights over `local` of the layer's heads (all without
    it): wq, bq, wk, bk, wv, bv, bias_u, bias_v, pos_w, wo, and bo when
    whole."""
    hd = d // heads
    dl = (local or heads) * hd
    w = []
    for _ in range(3):
        w += [dev(rng.normal(0, 1 / np.sqrt(d), (dl, d))), dev(rng.normal(0, 0.02, dl))]
    w += [dev(rng.normal(0, 0.02, (dl // hd, hd))), dev(rng.normal(0, 0.02, (dl // hd, hd))),
          dev(rng.normal(0, 1 / np.sqrt(d), (dl, d))), dev(rng.normal(0, 1 / np.sqrt(dl), (d, dl)))]
    if local is None:
        w.append(dev(rng.normal(0, 0.02, d)))
    return (dev(rng.randn(b, t, d)), *w)


def _k1_lengths(b, t):
    return [t, *(max(1, t - 11 * i - 5) for i in range(1, b))]


@pytest.mark.cuda
@pytest.mark.parametrize("with_norm", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", K1_SHAPES)
def test_k1_kernel_matches_plain_version_on_the_card(shape, dtype, with_norm):
    _need_card()
    b, t, d, heads = shape
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(sum(shape))
    dev = _dev(dt)
    args = _k1_args(rng, dev, b, t, d, heads)
    lengths = _k1_lengths(b, t)
    kw = dict(lengths=torch.tensor(lengths, dtype=torch.int32, device="cuda"))
    if with_norm:
        kw.update(norm_w=dev(1 + 0.1 * rng.randn(d), torch.float32), norm_b=dev(0.1 * rng.randn(d), torch.float32))
    before = RA.rel_attention_block.launches
    with torch.inference_mode():
        got = RA.rel_attention_block(*args, **kw)
        ref = RA.rel_attention_block_reference(*args, **kw)
    assert RA.rel_attention_block.launches == before + 1
    _hold(got, ref, lengths, K1_BF16_SCALE_FRAC)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 126, 512, 8), (1, 300, 1024, 8)])
def test_k1_heads_kernel_matches_plain_version_on_the_card(shape, dtype):
    """Head-sharded: 4 of 8 heads, the tiled design with the dtype's core
    (split at B=1, T=300), an unrounded f32 partial."""
    _need_card()
    b, t, d, heads = shape
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(sum(shape) + 1)
    dev = _dev(dt)
    args = _k1_args(rng, dev, b, t, d, heads, local=4)
    lengths = _k1_lengths(b, t)
    kw = dict(lengths=torch.tensor(lengths, dtype=torch.int32, device="cuda"),
              norm_w=dev(1 + 0.1 * rng.randn(d), torch.float32), norm_b=dev(0.1 * rng.randn(d), torch.float32))
    before = RA.rel_attention_block_heads.launches
    with torch.inference_mode():
        got = RA.rel_attention_block_heads(*args, **kw)
        ref = RA.rel_attention_block_reference(*args, None, heads_partial=True, **kw)
    assert RA.rel_attention_block_heads.launches == before + 1 and got.dtype == torch.float32
    if dt == torch.float32:
        _hold(got, ref, lengths)
    else:
        g, r = got.cpu().numpy(), ref.cpu().numpy()
        assert np.isfinite(g).all()
        for i, n in enumerate(lengths):
            assert np.abs(g[i, :n] - r[i, :n]).max() <= K1_BF16_SCALE_FRAC * np.abs(r).max()


@pytest.mark.cuda
def test_k1_core_resident_blocks_on_the_card():
    """cudaOccupancyMaxActiveBlocksPerMultiprocessor answers what core_plan
    says: in f32 at least 8 warps an SM at hd 64 and 128."""
    _need_card()
    for itemsize in (4, 2):
        for hd in (32, 64, 128):
            plan = RA.core_plan(8, 126, 8, hd, itemsize)
            assert RA.core_resident(itemsize, hd) == plan.resident, (itemsize, hd)
            if itemsize == 4 and hd > 32:
                assert plan.warps >= 8


# K2 (B, T', hd, lengths): a ragged T' with one key and none, the 110m
# batch at 10 s, one item whose keys split over a cluster
K2_SHAPES = ((4, 37, 32, (37, 21, 1, 0)), (4, 37, 64, (37, 21, 1, 0)), (4, 37, 128, (37, 21, 1, 0)),
             (8, 126, 64, (126, 100, 64, 33, 126, 90, 1, 77)), (1, 300, 32, (211,)), (1, 300, 64, (211,)),
             (1, 300, 128, (211,)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, keep", [("float32", None), ("bfloat16", None), ("bfloat16", True),
                                         ("bfloat16", False)])
@pytest.mark.parametrize("shape", K2_SHAPES)
def test_k2_kernel_matches_plain_version_on_the_card(shape, dtype, keep, monkeypatch):
    """K2 against its plain version on the rows a caller reads (every row
    of an item with no valid key): f32 at rtol 1e-3 / atol 1e-5, bf16
    within 2% of the output's scale; in bf16 both designs (the scores kept
    between the sweeps, computed again) and the plan's; one launch a call,
    and the card holding the blocks an SM that the plan says."""
    _need_card()
    b, t, hd, lengths = shape
    monkeypatch.setattr(RA, "v1_core_plan", functools.partial(RA.v1_core_plan, keep=keep))
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(t + hd)
    dev = _dev(dt)
    heads = 8
    args = [dev(rng.randn(b, heads, t, hd)) for _ in range(4)] + [dev(rng.randn(heads, 2 * t - 1, hd))]
    lt = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    plan = RA.v1_core_plan(b, t, heads, hd, 4 if dtype == "float32" else 2)
    assert RA.v1_core_resident(4 if dtype == "float32" else 2, hd, plan.kept) == plan.resident
    before = RA.fused_rel_attention.launches
    with torch.inference_mode():
        got = RA.fused_rel_attention(*args, lengths=lt).float().transpose(1, 2).cpu().numpy()
        ref = RA.fused_rel_attention_reference(*args, lengths=lt).float().transpose(1, 2).cpu().numpy()
    assert RA.fused_rel_attention.launches == before + 1
    assert np.isfinite(got).all()
    for i, n in enumerate(lengths):
        g, r = got[i, : n or t], ref[i, : n or t]
        if dt == torch.float32:
            np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL, err_msg=f"item {i}")
        else:
            assert np.abs(g - r).max() <= K1_BF16_SCALE_FRAC * np.abs(ref).max(), i
