"""The port's offline FastConformer encoder against the JAX reference, with
the reference's attention both as its Pallas block kernel (block4hp,
interpret mode) and as the XLA path."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parakeet_tpu import config as RC
from parakeet_tpu import params as RP
from parakeet_tpu.models import encoder as RE
from parakeet_tpu.params import Params as RParams
from parakeet_tpu_torch import config as TC
from parakeet_tpu_torch.models import encoder as TE
from parakeet_tpu_torch.ops import rel_attention as TA
from parakeet_tpu_torch.params import Params as TParams
from parakeet_tpu_torch.params import params_from_numpy

RTOL, ATOL = 1e-3, 1e-5  # the reference's block-kernel tolerance
MEL_LENGTHS = [64, 80, 41]


def _cfgs():
    kw = dict(mel_bins=80, subsampling_channels=8, hidden_size=32, num_layers=2,
              num_heads=4, ffn_intermediate=64, conv_kernel_size=9)
    return RC.EncoderConfig(**kw), TC.EncoderConfig(**kw)


@pytest.fixture(scope="module")
def model():
    rcfg, tcfg = _cfgs()
    flat = {k: np.asarray(v) for k, v in RP.init_params(RP.encoder_spec(rcfg, "encoder_"), seed=11).items()}
    rng = np.random.RandomState(2)
    for k in flat:  # non-trivial norms, BN stats and biases
        if k.endswith(("norm_.weight", "running_var")):
            flat[k] = (1 + 0.1 * np.abs(rng.randn(*flat[k].shape))).astype(np.float32)
        elif k.endswith((".bias", "running_mean")):
            flat[k] = (0.05 * rng.randn(*flat[k].shape)).astype(np.float32)
    mel = np.zeros((3, 80, 80), np.float32)
    for i, n in enumerate(MEL_LENGTHS):
        mel[i, :n] = rng.randn(n, 80)
    rp = RParams({k: jnp.asarray(v) for k, v in flat.items()}).sub("encoder_")
    tp = TParams(params_from_numpy(flat)).sub("encoder_")
    return rcfg, tcfg, rp, tp, mel


def _valid_close(got, ref):
    for i, n in enumerate(MEL_LENGTHS):
        tv = RE.subsample_length(n)
        np.testing.assert_allclose(got[i, :tv], ref[i, :tv], rtol=RTOL, atol=ATOL, err_msg=f"item {i}")


def test_encoder_matches_reference_block_kernel(model, monkeypatch):
    import parakeet_tpu.ops.pallas_attention as PA

    orig = PA.fused_rel_attention_block
    calls = []

    def interp(*args, **kw):
        calls.append(kw.get("batch_block"))
        kw["interpret"] = True
        return orig(*args, **kw)

    monkeypatch.setattr(PA, "fused_rel_attention_block", interp)
    rcfg, tcfg, rp, tp, mel = model
    RE.set_fused_attention("block4hp")
    try:
        ref = np.asarray(RE.fastconformer_encode(rp, rcfg, jnp.asarray(mel), jnp.asarray(MEL_LENGTHS)))
    finally:
        RE.set_fused_attention(False)
    assert calls, "the reference block kernel did not run"
    got = TE.fastconformer_encode(tp, tcfg, torch.from_numpy(mel), torch.tensor(MEL_LENGTHS)).numpy()
    assert got.shape == ref.shape
    _valid_close(got, ref)


def test_encoder_matches_reference_xla_path(model):
    rcfg, tcfg, rp, tp, mel = model
    ref = np.asarray(RE.fastconformer_encode(rp, rcfg, jnp.asarray(mel), jnp.asarray(MEL_LENGTHS)))
    got = TE.fastconformer_encode(tp, tcfg, torch.from_numpy(mel), torch.tensor(MEL_LENGTHS)).numpy()
    _valid_close(got, ref)
    # no lengths: nothing masked, every frame valid
    ref_full = np.asarray(RE.fastconformer_encode(rp, rcfg, jnp.asarray(mel[1:2])))
    got_full = TE.fastconformer_encode(tp, tcfg, torch.from_numpy(mel[1:2])).numpy()
    np.testing.assert_allclose(got_full, ref_full, rtol=RTOL, atol=ATOL)


def test_encoder_runs_attention_once_per_block(model, monkeypatch):
    rcfg, tcfg, rp, tp, mel = model
    seen = []
    orig = TE.rel_attention_block

    def spy(*args, **kw):
        seen.append(kw.get("norm_w") is not None)
        return orig(*args, **kw)

    monkeypatch.setattr(TE, "rel_attention_block", spy)
    TE.fastconformer_encode(tp, tcfg, torch.from_numpy(mel), torch.tensor(MEL_LENGTHS))
    assert seen == [True] * tcfg.num_layers  # pre-LN + residual fused every block


@pytest.mark.parametrize("stage", ["subsampling", "ffn", "conv"])
def test_block_pieces_match_reference(model, stage):
    rcfg, tcfg, rp, tp, mel = model
    if stage == "subsampling":
        ref = np.asarray(RE.conv_subsampling(rp.sub("subsampling_"), jnp.asarray(mel)))
        got = TE.conv_subsampling(tp.sub("subsampling_"), torch.from_numpy(mel)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
        return
    x = np.random.RandomState(4).randn(3, 10, 32).astype(np.float32)
    layer_r, layer_t = rp.sub("layers_").sub("0"), tp.sub("layers_").sub("0")
    if stage == "ffn":
        ref = np.asarray(RE.feed_forward(layer_r.sub("ffn1_"), jnp.asarray(x), 1e-5, xla_only=True))
        got = TE.feed_forward(layer_t.sub("ffn1_"), torch.from_numpy(x), 1e-5).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
        return
    pad = np.zeros((3, 10), bool)
    pad[1, 7:] = pad[2, 4:] = True
    ref = np.asarray(RE.conv_module(layer_r.sub("conv_"), jnp.asarray(x), 9, 1e-5,
                                    jnp.asarray(pad), xla_only=True))
    got = TE.conv_module(layer_t.sub("conv_"), torch.from_numpy(x), 9, 1e-5, torch.from_numpy(pad)).numpy()
    for i, n in enumerate([10, 7, 4]):
        np.testing.assert_allclose(got[i, :n], ref[i, :n], rtol=1e-4, atol=1e-5)


def test_lengths_masks_and_position_table_match_reference():
    lens = np.array([1, 7, 80, 1001, 6001])
    np.testing.assert_array_equal(TE.encoded_lengths(torch.from_numpy(lens)).numpy(),
                                  np.asarray(RE.encoded_lengths(jnp.asarray(lens))))
    assert [TE.subsample_length(int(n)) for n in lens] == [RE.subsample_length(int(n)) for n in lens]
    np.testing.assert_array_equal(TE.sinusoidal_position_embedding(13, 32).numpy(),
                                  np.asarray(RE.sinusoidal_position_embedding(13, 32)))
    assert TA.position_table_np(5, 8).shape == (9, 8)
    enc_lens = np.array([5, 2, 0])
    np.testing.assert_array_equal(TE.length_mask(torch.from_numpy(enc_lens), 5).numpy(),
                                  np.asarray(RE.length_mask(jnp.asarray(enc_lens), 5)))


FUSED_MEL_LENGTHS = [520, 397, 233]  # T' = 65 ≥ 64, so the reference's FFN guard passes


def _interpret_wrappers(monkeypatch, extra: bool = False):
    """Run each reference Pallas kernel in interpret mode and count its
    calls; with `extra`, also the whole-block and v1 kernels."""
    import parakeet_tpu.ops.pallas_attention as PA
    import parakeet_tpu.ops.pallas_block as PB
    import parakeet_tpu.ops.pallas_conv as PC
    import parakeet_tpu.ops.pallas_ffn as PF
    import parakeet_tpu.ops.pallas_subsample as PS

    kernels = [(PA, "fused_rel_attention_block"), (PF, "fused_feed_forward"),
               (PC, "fused_conv_module"), (PS, "fused_subsample_block1")]
    if extra:
        kernels += [(PA, "fused_ffn_attention"), (PB, "fused_conv_ffn_final"), (PA, "fused_rel_attention")]
    calls = {}
    for mod, name in kernels:
        orig = getattr(mod, name)
        calls[name] = 0

        def interp(*args, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            kw["interpret"] = True
            return _orig(*args, **kw)

        monkeypatch.setattr(mod, name, interp)
    monkeypatch.setattr(RE, "_SUBSAMPLE_T4_TILE", 4)
    monkeypatch.setattr(TE, "_SUBSAMPLE_T4_TILE", 4)
    return calls


def set_reference_fused(on: bool) -> None:
    """The reference's process globals for bench.py --fused-mode block4hp
    --fused-ffn --conv-layout pallas --fused-subsample (all off: defaults)."""
    RE.set_fused_attention("block4hp" if on else False)
    RE.set_fused_ffn(on)
    RE.set_conv_layout("pallas" if on else "nch")
    RE.set_fused_subsample(on)


def test_fused_encoder_matches_reference_fused_kernels(model, monkeypatch):
    rcfg, tcfg, rp, tp, _ = model
    rng = np.random.RandomState(21)
    mel = np.zeros((3, max(FUSED_MEL_LENGTHS), 80), np.float32)
    for i, n in enumerate(FUSED_MEL_LENGTHS):
        mel[i, :n] = rng.randn(n, 80)
    calls = _interpret_wrappers(monkeypatch)
    set_reference_fused(True)
    try:
        ref = np.asarray(RE.fastconformer_encode(rp, rcfg, jnp.asarray(mel), jnp.asarray(FUSED_MEL_LENGTHS)))
    finally:
        set_reference_fused(False)
    layers = rcfg.num_layers
    assert calls == {"fused_rel_attention_block": layers, "fused_feed_forward": 2 * layers,
                     "fused_conv_module": layers, "fused_subsample_block1": 1}, calls
    fused = TE.FusedLayers(ffn=True, conv=True, subsample=True)
    got = TE.fastconformer_encode(tp, tcfg, torch.from_numpy(mel), torch.tensor(FUSED_MEL_LENGTHS), fused=fused)
    assert got.shape == ref.shape
    for i, n in enumerate(FUSED_MEL_LENGTHS):
        tv = RE.subsample_length(n)
        np.testing.assert_allclose(got[i, :tv].numpy(), ref[i, :tv], rtol=RTOL, atol=ATOL, err_msg=f"item {i}")


@pytest.mark.parametrize("field", ["ffn", "conv", "subsample"])
def test_each_fused_layer_dispatches_its_kernel(model, monkeypatch, field):
    """One field on sends exactly its sublayer through its dispatch function,
    and the result stays within the kernel tolerance of the plain path."""
    from parakeet_tpu_torch.ops import conv_module as TCM
    from parakeet_tpu_torch.ops import feed_forward as TF
    from parakeet_tpu_torch.ops import subsample as TS

    rcfg, tcfg, rp, tp, mel = model
    seen = {"ffn": [], "conv": [], "subsample": []}
    spies = {"ffn": (TE, "fused_feed_forward", TF.fused_feed_forward),
             "conv": (TE, "fused_conv_module", TCM.fused_conv_module),
             "subsample": (TE, "fused_subsample_block1", TS.fused_subsample_block1)}
    for key, (mod, name, orig) in spies.items():
        def spy(*args, _orig=orig, _key=key, **kw):
            seen[_key].append(kw.get("final_norm_w") is not None)
            return _orig(*args, **kw)

        monkeypatch.setattr(mod, name, spy)
    # MEL_LENGTHS give T4 = 20 and T' = 10: below the reference's guards
    monkeypatch.setattr(TE, "_SUBSAMPLE_T4_TILE", 4)
    monkeypatch.setattr(TE, "_FFN_MIN_FRAMES", 1)
    lengths = torch.tensor(MEL_LENGTHS)
    got = TE.fastconformer_encode(tp, tcfg, torch.from_numpy(mel), lengths,
                                  fused=TE.FusedLayers(**{field: True})).numpy()
    want = {"ffn": [False, True] * tcfg.num_layers, "conv": [False] * tcfg.num_layers,
            "subsample": [False]}
    assert seen == {k: (want[k] if k == field else []) for k in seen}
    plain = TE.fastconformer_encode(tp, tcfg, torch.from_numpy(mel), lengths).numpy()
    _valid_close(got, plain)


def _fused_mel():
    rng = np.random.RandomState(21)
    mel = np.zeros((3, max(FUSED_MEL_LENGTHS), 80), np.float32)
    for i, n in enumerate(FUSED_MEL_LENGTHS):
        mel[i, :n] = rng.randn(n, 80)
    return mel


def _reference_encode(rcfg, rp, mel, attention, block2=False, subsample=False):
    """The reference encoder under bench.py --fused-mode <attention>
    [--fused-block2] [--fused-subsample]; every process global reset after."""
    RE.set_fused_attention(attention)
    RE.set_fused_block2(block2)
    RE.set_fused_subsample(subsample)
    try:
        return np.asarray(RE.fastconformer_encode(rp, rcfg, jnp.asarray(mel), jnp.asarray(FUSED_MEL_LENGTHS)))
    finally:
        RE.set_fused_attention(False)
        RE.set_fused_block2(False)
        RE.set_fused_subsample(False)


def _assert_fused_valid_close(got, ref):
    assert got.shape == ref.shape
    for i, n in enumerate(FUSED_MEL_LENGTHS):
        tv = RE.subsample_length(n)
        np.testing.assert_allclose(got[i, :tv], ref[i, :tv], rtol=RTOL, atol=ATOL, err_msg=f"item {i}")


def test_whole_block_encoder_matches_reference_mega_block2(model, monkeypatch):
    """FusedLayers(attention="mega", block2=True, subsample=True) against
    the reference's --fused-mode mega --fused-block2 --fused-subsample:
    two kernels per block (K7, K4) and K8 once."""
    rcfg, tcfg, rp, tp, _ = model
    mel = _fused_mel()
    calls = _interpret_wrappers(monkeypatch, extra=True)
    ref = _reference_encode(rcfg, rp, mel, "mega", block2=True, subsample=True)
    layers = rcfg.num_layers
    assert calls == {"fused_rel_attention_block": 0, "fused_feed_forward": 0, "fused_conv_module": 0,
                     "fused_subsample_block1": 1, "fused_ffn_attention": layers,
                     "fused_conv_ffn_final": layers, "fused_rel_attention": 0}, calls
    fused = TE.FusedLayers(attention="mega", block2=True, subsample=True)
    got = TE.fastconformer_encode(tp, tcfg, torch.from_numpy(mel), torch.tensor(FUSED_MEL_LENGTHS), fused=fused)
    _assert_fused_valid_close(got.numpy(), ref)


def test_v1_encoder_matches_reference_v1(model, monkeypatch):
    """FusedLayers(attention="v1") against the reference's --fused-mode v1:
    the attention core as K2 once per block, projections outside."""
    rcfg, tcfg, rp, tp, _ = model
    mel = _fused_mel()
    calls = _interpret_wrappers(monkeypatch, extra=True)
    ref = _reference_encode(rcfg, rp, mel, "v1")
    assert calls["fused_rel_attention"] == rcfg.num_layers
    assert sum(calls.values()) == rcfg.num_layers, calls
    got = TE.fastconformer_encode(tp, tcfg, torch.from_numpy(mel), torch.tensor(FUSED_MEL_LENGTHS),
                                  fused=TE.FusedLayers(attention="v1"))
    _assert_fused_valid_close(got.numpy(), ref)


PRECEDENCE = {
    # FusedLayers fields → calls of each kernel's dispatch per block
    "mega+block2 over ffn+conv": (dict(ffn=True, conv=True, attention="mega", block2=True),
                                  dict(ffn_attention=1, conv_ffn_final=1)),
    "mega, ffn2 and conv as fields say": (dict(ffn=True, attention="mega"),
                                          dict(ffn_attention=1, feed_forward=1)),
    "block2, ffn1 and K1 as fields say": (dict(ffn=True, conv=True, block2=True),
                                          dict(feed_forward=1, attention_block=1, conv_ffn_final=1)),
    "v1 with fused FFNs": (dict(ffn=True, attention="v1"),
                           dict(feed_forward=2, rel_attention_v1=1)),
    "v1 with block2": (dict(conv=True, attention="v1", block2=True),
                       dict(rel_attention_v1=1, conv_ffn_final=1)),
}


@pytest.mark.parametrize("case", sorted(PRECEDENCE))
def test_fused_layers_precedence(model, monkeypatch, case):
    """mega takes ffn1 and the attention whatever ffn says; block2 takes the
    conv module, ffn2 and the final LayerNorm whatever ffn and conv say."""
    rcfg, tcfg, rp, tp, mel = model
    fields, want = PRECEDENCE[case]
    names = dict(ffn_attention="fused_ffn_attention", conv_ffn_final="fused_conv_ffn_final",
                 feed_forward="fused_feed_forward", conv_module="fused_conv_module",
                 attention_block="rel_attention_block", rel_attention_v1="fused_rel_attention")
    seen = dict.fromkeys(names, 0)
    for key, name in names.items():
        def spy(*args, _orig=getattr(TE, name), _key=key, **kw):
            seen[_key] += 1
            return _orig(*args, **kw)

        monkeypatch.setattr(TE, name, spy)
    monkeypatch.setattr(TE, "_FFN_MIN_FRAMES", 1)  # T' = 10: below the reference's FFN guard
    lengths = torch.tensor(MEL_LENGTHS)
    got = TE.fastconformer_encode(tp, tcfg, torch.from_numpy(mel), lengths, fused=TE.FusedLayers(**fields))
    assert seen == {k: want.get(k, 0) * tcfg.num_layers for k in names}
    plain = TE.fastconformer_encode(tp, tcfg, torch.from_numpy(mel), lengths).numpy()
    _valid_close(got.numpy(), plain)


BELOW_GUARDS = {
    # FusedLayers fields → the reference's globals; MEL_LENGTHS give T4 = 20
    # (< 32) and T' = 10 (< 64), so every guarded kernel gives way, and
    # "mega" falls back to the attention block kernel in both packages
    "ffn+subsample": (dict(ffn=True, subsample=True), dict(attention="block4hp", ffn=True)),
    "whole-block": (dict(attention="mega", block2=True, subsample=True), dict(attention="mega", block2=True)),
}


@pytest.mark.parametrize("case", sorted(BELOW_GUARDS))
def test_fused_encoder_below_the_guards_is_the_plain_encoder(model, monkeypatch, case):
    """bf16 below the reference's input guards: its fused globals run no
    guarded Pallas kernel (only the attention block), and the port's fused
    encoder is bit for bit its default encoder."""
    import parakeet_tpu.ops.pallas_attention as PA
    import parakeet_tpu.ops.pallas_block as PB
    import parakeet_tpu.ops.pallas_ffn as PF
    import parakeet_tpu.ops.pallas_subsample as PS

    rcfg, tcfg, rp, tp, mel = model
    fields, ref_globals = BELOW_GUARDS[case]
    calls = {}
    for mod, name in ((PA, "fused_rel_attention_block"), (PF, "fused_feed_forward"),
                      (PS, "fused_subsample_block1"), (PA, "fused_ffn_attention"),
                      (PB, "fused_conv_ffn_final")):
        calls[name] = 0

        def interp(*args, _orig=getattr(mod, name), _name=name, **kw):
            calls[_name] += 1
            kw["interpret"] = True
            return _orig(*args, **kw)

        monkeypatch.setattr(mod, name, interp)
    rp16 = RParams({k: v if "norm" in k else v.astype(jnp.bfloat16) for k, v in rp.data.items()}).sub("encoder_")
    RE.set_fused_attention(ref_globals["attention"])
    RE.set_fused_ffn(ref_globals.get("ffn", False))
    RE.set_fused_block2(ref_globals.get("block2", False))
    RE.set_fused_subsample(True)
    try:
        RE.fastconformer_encode(rp16, rcfg, jnp.asarray(mel).astype(jnp.bfloat16), jnp.asarray(MEL_LENGTHS))
    finally:
        RE.set_fused_attention(False)
        RE.set_fused_ffn(False)
        RE.set_fused_block2(False)
        RE.set_fused_subsample(False)
    assert calls == dict.fromkeys(calls, 0) | {"fused_rel_attention_block": rcfg.num_layers}, calls
    tp16 = TParams({k: v if "norm" in k else v.to(torch.bfloat16) for k, v in tp.data.items()}).sub("encoder_")
    x = torch.from_numpy(mel).to(torch.bfloat16)
    lengths = torch.tensor(MEL_LENGTHS)
    got = TE.fastconformer_encode(tp16, tcfg, x, lengths, fused=TE.FusedLayers(**fields))
    assert torch.equal(got, TE.fastconformer_encode(tp16, tcfg, x, lengths))


def test_unknown_attention_mode_is_rejected():
    with pytest.raises(ValueError, match="attention"):
        TE.FusedLayers(attention="block4hp")
