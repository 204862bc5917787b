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


def _interpret_wrappers(monkeypatch):
    """Run each reference Pallas kernel in interpret mode and count its calls."""
    import parakeet_tpu.ops.pallas_attention as PA
    import parakeet_tpu.ops.pallas_conv as PC
    import parakeet_tpu.ops.pallas_ffn as PF
    import parakeet_tpu.ops.pallas_subsample as PS

    calls = {}
    for mod, name in ((PA, "fused_rel_attention_block"), (PF, "fused_feed_forward"),
                      (PC, "fused_conv_module"), (PS, "fused_subsample_block1")):
        orig = getattr(mod, name)
        calls[name] = 0

        def interp(*args, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            kw["interpret"] = True
            return _orig(*args, **kw)

        monkeypatch.setattr(mod, name, interp)
    monkeypatch.setattr(RE, "_SUBSAMPLE_T4_TILE", 4)
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
    lengths = torch.tensor(MEL_LENGTHS)
    got = TE.fastconformer_encode(tp, tcfg, torch.from_numpy(mel), lengths,
                                  fused=TE.FusedLayers(**{field: True})).numpy()
    want = {"ffn": [False, True] * tcfg.num_layers, "conv": [False] * tcfg.num_layers,
            "subsample": [False]}
    assert seen == {k: (want[k] if k == field else []) for k in seen}
    plain = TE.fastconformer_encode(tp, tcfg, torch.from_numpy(mel), lengths).numpy()
    _valid_close(got, plain)
