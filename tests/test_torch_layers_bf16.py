"""The plain layers' float products (parakeet_tpu_torch/ops/layers.py) by
route. On the CPU (tier-1): the route counters of the call's record add up
to the products run, nothing is counted with no call open, the CPU and
float32 forms are bit for bit the float32-upcast form, and
require_ieee_f32 keeps bf16 reductions in float32. On the card (marked
`cuda`): each bf16 product at the benchmark cells' shapes within one bf16
ulp of the float32 product rounded once, with no cast or copy kernel
around it."""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from parakeet_tpu_torch import config as TC
from parakeet_tpu_torch import trace
from parakeet_tpu_torch import transcribe as T
from parakeet_tpu_torch.models import encoder as TE
from parakeet_tpu_torch.ops import layers as L
from parakeet_tpu_torch.params import Params, encoder_spec, init_params

BF16, F32 = torch.bfloat16, torch.float32
PIECES = ["<unk>", "▁a", "b", "▁c", "d", ".", "▁e", "f"]  # + blank = vocab 9


# ─── the float32-upcast form (the CPU's, and every product's before bf16 ran natively) ──

def _up(t):
    return None if t is None else t.to(F32)


def upcast_linear(p, x, **_):
    w, b = p["weight"], p.get("bias")
    if x.dtype == F32 and w.dtype == F32:
        return F.linear(x, w, b)
    return F.linear(x.to(F32), w.to(F32), _up(b)).to(x.dtype)


def upcast_conv1d(p, x, *, stride=1, padding=0, groups=1):
    return F.conv1d(x.to(F32), p["weight"].to(F32), _up(p.get("bias")),
                    stride=stride, padding=padding, groups=groups).to(x.dtype)


def upcast_conv2d(p, x, *, stride=(1, 1), padding=(0, 0), groups=1):
    return F.conv2d(x.to(F32), p["weight"].to(F32), _up(p.get("bias")),
                    stride=stride, padding=padding, groups=groups).to(x.dtype)


UPCAST = {"linear": upcast_linear, "conv1d": upcast_conv1d, "conv2d": upcast_conv2d}


def spy_products(monkeypatch) -> list:
    """A list that gets (name, its input's dtype) of each float product
    layers.py runs from now on (while `monkeypatch` holds): each takes
    exactly one F.linear, F.conv1d or F.conv2d call, on bf16 operands when
    it runs natively and on float32 ones otherwise."""
    seen = []

    def wrap(name):
        fn = getattr(F, name)

        def call(*a, **kw):
            seen.append((name, a[0].dtype))
            return fn(*a, **kw)
        return call

    spy = types.SimpleNamespace(**{k: getattr(F, k) for k in dir(F) if not k.startswith("__")})
    for name in UPCAST:
        setattr(spy, name, wrap(name))
    monkeypatch.setattr(L, "F", spy)
    return seen


def _params(rng, shape, bias=True, device="cpu", dtype=F32):
    k = int(np.prod(shape[1:]))
    out = {"weight": torch.from_numpy(rng.randn(*shape).astype(np.float32) / np.sqrt(k))}
    if bias:
        out["bias"] = torch.from_numpy(0.1 * rng.randn(shape[0]).astype(np.float32))
    return Params({n: v.to(device, dtype) for n, v in out.items()})


def _x(rng, shape, device="cpu", dtype=F32):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device, dtype)


# (op, weight shape, input shape, keywords): a pointwise and a depthwise
# conv of each rank, the subsampling's 3×3 conv on one channel, linears
# with and without a bias, on 2-D and 3-D inputs
CASES = [
    ("linear", (24, 16), (5, 16), {}),
    ("linear", (24, 16), (2, 7, 16), {}),
    ("conv1d", (12, 8, 1), (2, 8, 11), {}),
    ("conv1d", (8, 1, 9), (2, 8, 11), dict(padding=4, groups=8)),
    ("conv2d", (6, 1, 3, 3), (2, 1, 13, 10), dict(stride=(2, 2), padding=(1, 1))),
    ("conv2d", (6, 1, 3, 3), (2, 6, 7, 5), dict(stride=(2, 2), padding=(1, 1), groups=6)),
    ("conv2d", (6, 6, 1, 1), (2, 6, 7, 5), {}),
]


def test_require_ieee_f32_keeps_bf16_reductions_in_float32():
    flags = torch.backends.cuda.matmul
    before = (flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction, torch.backends.cudnn.allow_tf32)
    try:
        flags.allow_bf16_reduced_precision_reduction = True
        flags.allow_tf32 = True
        L.require_ieee_f32()
        assert flags.allow_bf16_reduced_precision_reduction is False
        assert flags.allow_tf32 is False and torch.backends.cudnn.allow_tf32 is False
    finally:
        (flags.allow_tf32, flags.allow_bf16_reduced_precision_reduction, torch.backends.cudnn.allow_tf32) = before


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_cpu_forms_are_the_upcast_form_bit_for_bit(case, dtype, bias):
    op, wshape, xshape, kw = CASES[case]
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(case)
    p, x = _params(rng, wshape, bias, dtype=dt), _x(rng, xshape, dtype=dt)
    got = getattr(L, op)(p, x, **kw)
    want = UPCAST[op](p, x, **kw)
    assert got.dtype == dt and torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cpu_encoder_call_is_the_upcast_form_bit_for_bit(monkeypatch, dtype):
    dt = getattr(torch, dtype)
    cfg = TC.EncoderConfig(mel_bins=80, subsampling_channels=8, hidden_size=32, num_layers=2, num_heads=4,
                           ffn_intermediate=64)
    p = Params(init_params(encoder_spec(cfg, "encoder_"), seed=3, dtype=dt)).sub("encoder_")
    feats = _x(np.random.RandomState(4), (3, 90, 80), dtype=dt)
    lengths = [90, 61, 33]
    got = TE.fastconformer_encode(p, cfg, feats, lengths)
    for name, fn in UPCAST.items():
        monkeypatch.setattr(TE, name, fn)
    want = TE.fastconformer_encode(p, cfg, feats, lengths)
    assert got.dtype == dt and torch.equal(got, want)


def test_nothing_is_counted_with_no_call_open():
    rng = np.random.RandomState(0)
    p, x = _params(rng, (8, 4)), _x(rng, (3, 4))
    L.linear(p, x)  # no call open: nothing to count into, no error
    call = trace.CallTrace()
    with trace.stage(call):
        L.linear(p, x)
    L.conv1d(_params(rng, (8, 4, 1)), _x(rng, (1, 4, 5)))
    call.close()
    assert call.counts == {L.F32_PRODUCTS: 1}


def _on_card_here(x, w, b):
    """The card's route test without its device test: the CPU runs the bf16
    routes (its own bf16 kernels), so their layouts and counts show here."""
    return x.dtype == w.dtype == BF16 and (b is None or b.dtype == BF16)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_bf16_routes_keep_the_layout(monkeypatch, case):
    op, wshape, xshape, kw = CASES[case]
    rng = np.random.RandomState(case)
    p, x = _params(rng, wshape, dtype=BF16), _x(rng, xshape, dtype=BF16)
    want = UPCAST[op](p, x, **kw)
    monkeypatch.setattr(L, "_bf16_on_card", _on_card_here)
    got = getattr(L, op)(p, x, **kw)
    assert got.shape == want.shape and got.dtype == BF16
    # the CPU's bf16 kernels are not the card's: this holds the layout, not the rounding
    assert (got.float() - want.float()).abs().max() <= 0.02 * want.float().abs().max()


@pytest.fixture(scope="module")
def bf16_tr(tmp_path_factory):
    vocab = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    vocab.write_text("\n".join(f"{p}\t0" for p in PIECES), encoding="utf-8")
    cfg = TC.TDTCTCConfig(  # the 110m's shape: a hybrid TDT-CTC, one LSTM layer, at toy widths
        encoder=TC.EncoderConfig(mel_bins=80, subsampling_channels=8, hidden_size=32, num_layers=2, num_heads=4,
                                 ffn_intermediate=64),
        prediction=TC.PredictionConfig(vocab_size=9, pred_hidden=16, num_lstm_layers=1),
        joint=TC.JointConfig(encoder_hidden=32, pred_hidden=16, joint_hidden=16, vocab_size=9),
        ctc_vocab_size=9,
    )
    return T.Transcriber(None, str(vocab), cfg, seed=6, device="cpu", compute_dtype="bfloat16")


def _waves():
    rng = np.random.RandomState(6)
    return [(0.3 * np.sin(2 * np.pi * rng.uniform(100, 3000) * np.arange(n) / 16000)
             + 0.02 * rng.randn(n)).astype(np.float32) for n in (16000, 11000, 23456)]


def _counted_call(tr, monkeypatch, decoder):
    """One prepare_batch / decode_prepared call's counts, the products the
    spy saw in it by their operands' dtype, and its decode steps."""
    steps = []
    orig = T.transducer_greedy_decode

    def spy_decode(*a, **kw):
        res = orig(*a, **kw)
        steps.append(res.steps)
        return res

    monkeypatch.setattr(T, "transducer_greedy_decode", spy_decode)
    seen = spy_products(monkeypatch)
    handle = tr.prepare_batch(_waves(), T.TranscribeOptions(getattr(T.Decoder, decoder)))
    tr.decode_prepared(handle)
    by_dtype = {}
    for _, dt in seen:
        by_dtype[dt] = by_dtype.get(dt, 0) + 1
    return tr.traces[-1].counts, by_dtype, steps


@pytest.mark.parametrize("route", ["cpu", "card"])
@pytest.mark.parametrize("decoder", ["TDT", "CTC"])
def test_route_counts_add_up_on_a_bf16_call(bf16_tr, monkeypatch, decoder, route):
    if route == "card":
        monkeypatch.setattr(L, "_bf16_on_card", _on_card_here)
    counts, by_dtype, steps = _counted_call(bf16_tr, monkeypatch, decoder)
    assert counts.get(L.BF16_PRODUCTS, 0) == by_dtype.get(BF16, 0)
    assert counts.get(L.F32_PRODUCTS, 0) == by_dtype.get(F32, 0)
    total = sum(by_dtype.values())
    assert decoder == "CTC" or steps[0] > 0
    # subsampling 6, 7 a conformer block; the CTC head, or enc_proj and 5 a decode step
    assert total == 6 + 7 * 2 + (1 if decoder == "CTC" else 1 + 5 * steps[0])
    if route == "cpu":
        assert counts.get(L.BF16_PRODUCTS, 0) == 0
    else:
        # kept in float32: the subsampling's 3×3 conv on one channel, and each
        # step's products of the float32 LSTM state (hidden_proj, pred_proj,
        # then label_proj and duration_proj on the float32 joint hidden)
        assert counts[L.F32_PRODUCTS] == 1 + (0 if decoder == "CTC" else 4 * steps[0])


# ─── on the card ────────────────────────────────────────────────────────────

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bf16 routes run on the card only")
    L.require_ieee_f32()


def _ulps(got: torch.Tensor, y32: torch.Tensor) -> float:
    """The widest distance of bf16 `got` from y32 rounded once to bf16, in
    ulps of that rounded value, over chunks of the leading axis."""
    worst = 0.0
    for g, y in zip(got.split(4), y32.split(4)):
        r = y.to(BF16).float()
        _, e = torch.frexp(r)
        ulp = torch.ldexp(torch.ones_like(r), e - 8)  # bf16 keeps 8 significant bits
        worst = max(worst, ((g.float() - r).abs() / ulp).max().item())
    return worst


# (name, op, weight shape, input shape, keywords, layout of the input):
# the benchmark cells' shapes (600m: B=64, T'=475, D=1024, F=4096, 128 mels,
# T=3800; 110m: B=32, D=512, F=2048, 80 mels), the decode step's at B=64 and
# vocab 8193, and ragged ones. "cl": x is the transpose of a channel-last
# tensor, as the conv module's LayerNorm and GLU leave it.
CARD_CASES = [
    ("600m ffn fc1", "linear", (4096, 1024), (64, 475, 1024), {}, None),
    ("600m ffn fc2", "linear", (1024, 4096), (64, 475, 4096), {}, None),
    ("600m subsampling proj", "linear", (1024, 4096), (64, 475, 4096), {}, None),
    ("600m enc_proj", "linear", (640, 1024), (64, 475, 1024), {}, None),
    ("600m lstm input_proj", "linear", (2560, 640), (64, 640), {}, None),
    ("600m lstm hidden_proj", "linear", (2560, 640), (64, 640), {"bias": False}, None),
    ("600m joint label_proj", "linear", (8193, 640), (64, 640), {}, None),
    ("600m joint duration_proj", "linear", (5, 640), (64, 640), {}, None),
    ("110m ffn fc1", "linear", (2048, 512), (32, 475, 512), {}, None),
    ("ragged linear", "linear", (777, 1000), (37, 29, 1000), {}, None),
    ("one row", "linear", (8193, 640), (1, 640), {}, None),
    ("600m conv pw1", "conv1d", (2048, 1024, 1), (64, 1024, 475), {}, "cl"),
    ("600m conv depthwise", "conv1d", (1024, 1, 9), (64, 1024, 475), dict(padding=4, groups=1024), "cl"),
    ("600m conv pw2", "conv1d", (1024, 1024, 1), (64, 1024, 475), {}, None),
    ("110m ctc head", "conv1d", (1025, 512, 1), (32, 512, 475), {}, "cl"),
    ("ragged pointwise", "conv1d", (100, 36, 1), (3, 36, 37), {}, None),
    ("600m subsampling dw1", "conv2d", (256, 1, 3, 3), (64, 256, 1900, 64),
     dict(stride=(2, 2), padding=(1, 1), groups=256), None),
    ("600m subsampling conv2", "conv2d", (256, 256, 1, 1), (64, 256, 950, 32), {}, None),
    ("600m subsampling dw2", "conv2d", (256, 1, 3, 3), (64, 256, 950, 32),
     dict(stride=(2, 2), padding=(1, 1), groups=256), None),
    ("600m subsampling conv3", "conv2d", (256, 256, 1, 1), (64, 256, 475, 16), {}, None),
    ("110m subsampling conv2", "conv2d", (256, 256, 1, 1), (32, 256, 950, 20), {}, None),
]


def _card_inputs(case):
    name, op, wshape, xshape, kw, layout = case
    rng = np.random.RandomState(len(name))
    kw = dict(kw)
    p = _params(rng, wshape, kw.pop("bias", True), "cuda", BF16)
    if layout == "cl":  # (B, C, T) as the transpose of a contiguous (B, T, C)
        x = _x(rng, (xshape[0], xshape[2], xshape[1]), "cuda", BF16).transpose(1, 2)
    else:
        x = _x(rng, xshape, "cuda", BF16)
    return op, p, x, kw


def _float32_product(op, p, x, kw):
    """The upcast form's float32 product, before its one rounding."""
    w, b = p["weight"].to(F32), _up(p.get("bias"))
    if op == "linear":
        return F.linear(x.to(F32), w, b)
    return getattr(F, op)(x.to(F32), w, b, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_bf16_products_on_the_card_within_one_ulp(case):
    _need_card()
    op, p, x, kw = _card_inputs(case)
    call = trace.CallTrace()
    with trace.stage(call):
        got = getattr(L, op)(p, x, **kw)
    call.close()
    assert call.counts == {L.BF16_PRODUCTS: 1}
    y32 = _float32_product(op, p, x, kw)
    assert got.dtype == BF16 and got.shape == y32.shape
    assert _ulps(got, y32) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("batch, mels", [(64, 128), (32, 80)])
def test_subsampling_first_conv_keeps_the_float32_form_on_the_card(batch, mels):
    _need_card()
    rng = np.random.RandomState(mels)
    p, x = _params(rng, (256, 1, 3, 3), device="cuda", dtype=BF16), _x(rng, (batch, 1, 3800, mels), "cuda", BF16)
    kw = dict(stride=(2, 2), padding=(1, 1))
    call = trace.CallTrace()
    with trace.stage(call):
        got = L.conv2d(p, x, **kw)
    call.close()
    assert call.counts == {L.F32_PRODUCTS: 1}
    assert torch.equal(got, upcast_conv2d(p, x, **kw))


def _kernels(fn) -> list[str]:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["600m ffn fc1", "600m conv pw1", "600m joint label_proj", "600m conv depthwise"])
def test_a_bf16_product_launches_no_cast_or_copy(name):
    _need_card()
    op, p, x, kw = _card_inputs(next(c for c in CARD_CASES if c[0] == name))
    if name == "600m conv depthwise":
        x = x.contiguous()  # as the conv module's GLU leaves it once made contiguous
    kernels = _kernels(lambda: getattr(L, op)(p, x, **kw))
    assert kernels, "no kernel seen on the card"
    for k in kernels:  # no cast or copy of an operand, no float32 GEMM (a split-K reduction may follow)
        assert not any(s in k for s in ("f32f32", "elementwise", "copy")), kernels
    if "depthwise" in name:
        assert kernels == [k for k in kernels if "conv_depthwise2d" in k] and len(kernels) == 1, kernels
