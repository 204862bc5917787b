"""The port's weight-only quantization (int8, packed int4) and W8A8 against
the JAX package: the numpy pack and dequant helpers, quantize_params'
selection, the quantized linear, the quantized encoder and the sublayer
routing under partial quantization, the facades' tokens, quantized
checkpoints and the offline quantizer, and quantized streaming."""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parakeet_tpu import config as RC
from parakeet_tpu import params as RP
from parakeet_tpu import quantize as RQ
from parakeet_tpu.models import encoder as RE
from parakeet_tpu.ops import layers as RL
from parakeet_tpu.params import Params as RParams
from parakeet_tpu_torch import config as TC
from parakeet_tpu_torch import params as TP
from parakeet_tpu_torch import quantize as TQ
from parakeet_tpu_torch.models import encoder as TE
from parakeet_tpu_torch.ops import layers as TL
from parakeet_tpu_torch.params import Params as TParams

LIN_RTOL, LIN_ATOL = 1e-5, 1e-6  # float paths of linear
ENC_RTOL, ENC_ATOL = 1e-3, 1e-5  # the reference's kernel tolerance
MODES = ("int8", "int4")


def _cfg(C):
    """The smallest tdt-ctc whose matrices reach quantize_params' default
    min_elems (4096): d=64, FFN 128, LSTM 32, joint 64."""
    return C.TDTCTCConfig(
        encoder=C.EncoderConfig(mel_bins=80, subsampling_channels=8, hidden_size=64, num_layers=2, num_heads=4,
                                ffn_intermediate=128, conv_kernel_size=9),
        prediction=C.PredictionConfig(vocab_size=9, pred_hidden=32, num_lstm_layers=1),
        joint=C.JointConfig(encoder_hidden=64, pred_hidden=32, joint_hidden=64, vocab_size=9),
        ctc_vocab_size=9,
    )


def _flat(spec, seed):
    return {k: np.asarray(v) for k, v in RP.init_params(spec, seed=seed).items()}


def _waves(rng, sizes=(16000, 11000, 23456)):
    out = []
    for n in sizes:
        t = np.arange(n) / 16000
        f = rng.uniform(100, 3000) * (1 + 2 * t)
        gate = (np.sin(2 * np.pi * rng.uniform(1, 4) * t) > 0).astype(np.float32)
        out.append((0.3 * gate * np.sin(2 * np.pi * f * t) + 0.02 * rng.randn(n)).astype(np.float32))
    return out


def _spans(res):
    return [(t.token_id, t.start_frame, t.end_frame) for t in res.timestamped_tokens]


# ─── numpy helpers ───────────────────────────────────────────────────────────


@pytest.mark.parametrize("shape, group", [((16, 40), 64), ((12, 96), 32), ((5, 30), 7)])
def test_pack_unpack_and_dequant_exact(shape, group):
    w = np.random.RandomState(0).randn(*shape).astype(np.float32)
    for got, ref in zip(TQ.quantize_tensor(w), RQ.quantize_tensor(w)):
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == ref.dtype
    q, s = RQ.quantize_tensor(w)
    np.testing.assert_array_equal(TQ.dequantize_tensor(q, s), RQ.dequantize_tensor(q, s))
    packed, s4 = TQ.quantize_tensor_int4(w, group_size=group)
    r_packed, r_s4 = RQ.quantize_tensor_int4(w, group_size=group)
    np.testing.assert_array_equal(packed, r_packed)
    np.testing.assert_array_equal(s4, r_s4)
    assert packed.dtype == np.uint8 and packed.shape == (shape[0], shape[1] // 2)
    np.testing.assert_array_equal(TQ.unpack_int4(packed), RQ.unpack_int4(packed))
    np.testing.assert_array_equal(TQ.dequantize_tensor_int4(packed, s4), RQ.dequantize_tensor_int4(packed, s4))
    for tdt, rdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = TQ.dequantize_int4_torch(torch.from_numpy(packed), torch.from_numpy(s4), tdt)
        ref = RQ.dequantize_int4_jnp(jnp.asarray(packed), jnp.asarray(s4), rdt)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    with pytest.raises(ValueError, match="even in-dim"):
        TQ.quantize_tensor_int4(w[:, :-1])


def _mixed_dict():
    rng = np.random.RandomState(1)
    return {
        "a.fc1_.weight": rng.randn(64, 96).astype(np.float32),
        "a.fc2_.weight": rng.randn(96, 64).astype(np.float32),
        "a.odd_.weight": rng.randn(64, 65).astype(np.float32),  # odd in-dim: stays float under int4
        "a.small_.weight": rng.randn(8, 8).astype(np.float32),  # under min_elems
        "a.fc1_.bias": rng.randn(64).astype(np.float32),
        "a.norm_.weight": rng.randn(64, 96).astype(np.float32),
        "prediction_.embed_.weight": rng.randn(100, 64).astype(np.float32),
        "a.conv_.weight": rng.randn(32, 16, 9).astype(np.float32),
        "a.pre_.weight": np.ones((64, 96), np.int8),  # already quantized: never again
        "a.pre_.weight##scale": np.ones(64, np.float32),
    }


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("include", [None, "fc1"])
def test_quantize_params_selection_and_fraction(mode, include):
    flat = _mixed_dict()
    got = TQ.quantize_params(flat, mode=mode, include=include)
    ref = RQ.quantize_params(flat, mode=mode, include=include, as_numpy=True)
    assert list(got) == list(ref)
    for k in ref:
        assert np.asarray(got[k]).dtype == np.asarray(ref[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
    assert TQ.quantized_fraction(got) == RQ.quantized_fraction({k: jnp.asarray(v) for k, v in ref.items()})
    on_device = TP.params_from_numpy(got, "cpu", torch.bfloat16)
    assert TQ.quantized_fraction(on_device) == TQ.quantized_fraction(got)
    with pytest.raises(ValueError, match="unsupported quantize mode"):
        TQ.quantize_params(flat, mode="int2")


@pytest.mark.parametrize("mode", ["int8", "int4", "w8a8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_matches_reference(mode, dtype):
    """int8 (scale after the product, bias after the scale), int4 (dequant to
    x.dtype first) and W8A8 (set_int8_compute in both packages) against
    JAX's linear on the same codes. W8A8's integer sums are exact in both,
    so it holds to the float tolerance too."""
    rng = np.random.RandomState(3)
    # fan-in scaled weights, as init_params draws them: outputs of order 1
    flat = {"l.weight": (rng.randn(40, 96) / np.sqrt(96)).astype(np.float32),
            "l.bias": rng.randn(40).astype(np.float32)}
    x = rng.randn(2, 7, 96).astype(np.float32)
    q = RQ.quantize_params(flat, mode="int4" if mode == "int4" else "int8", min_elems=0, as_numpy=True)
    tdt, rdt = (torch.float32, jnp.float32) if dtype == "float32" else (torch.bfloat16, jnp.bfloat16)
    rp = RParams({k: (jnp.asarray(v).astype(rdt) if k == "l.bias" else jnp.asarray(v)) for k, v in q.items()})
    tp = TParams(TP.params_from_numpy(q, "cpu", tdt))
    RL.set_int8_compute(mode == "w8a8")
    TL.set_int8_compute(mode == "w8a8")
    try:
        ref = RL.linear(rp.sub("l"), jnp.asarray(x).astype(rdt))
        got = TL.linear(tp.sub("l"), torch.from_numpy(x).to(tdt))
        hoisted = TL.linear(TParams(TL.hoist_dequant(tp.data, ("l.",))).sub("l"), torch.from_numpy(x).to(tdt))
    finally:
        RL.set_int8_compute(False)
        TL.set_int8_compute(False)
    assert got.dtype == tdt
    ref32 = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref32, rtol=LIN_RTOL, atol=LIN_ATOL)
    else:  # one bf16 rounding of the same f32 value, or the neighbouring bf16 value
        np.testing.assert_allclose(got.float().numpy(), ref32, rtol=2 ** -7, atol=LIN_ATOL)
    torch.testing.assert_close(hoisted, got, rtol=0, atol=0)


def test_int8_matmul_exact_on_the_cpu():
    rng = np.random.RandomState(4)
    a = rng.randint(-127, 128, size=(5, 4096)).astype(np.int8)
    b = rng.randint(-127, 128, size=(3, 4096)).astype(np.int8)
    got = TL.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    want = a.astype(np.int64) @ b.astype(np.int64).T
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


# ─── encoder ─────────────────────────────────────────────────────────────────

MEL_LENGTHS = [560, 480, 300]  # T' = 70, 60, 38: past the FFN kernels' 64-frame guard


@pytest.fixture(scope="module")
def encoder_model():
    cfg = _cfg(RC).encoder
    flat = _flat(RP.encoder_spec(cfg, "encoder_"), seed=12)
    rng = np.random.RandomState(5)
    mel = np.zeros((3, max(MEL_LENGTHS), 80), np.float32)
    for i, n in enumerate(MEL_LENGTHS):
        mel[i, :n] = rng.randn(n, 80)
    return flat, mel


def _encode_both(flat, mel, mode, include=None, fused=TE.FusedLayers()):
    q = RQ.quantize_params(flat, mode=mode, include=include, as_numpy=True)
    lengths = np.asarray(MEL_LENGTHS)
    ref = RE.fastconformer_encode(RParams({k: jnp.asarray(v) for k, v in q.items()}).sub("encoder_"),
                                  _cfg(RC).encoder, jnp.asarray(mel), jnp.asarray(lengths))
    got = TE.fastconformer_encode(TParams(TP.params_from_numpy(q)).sub("encoder_"), _cfg(TC).encoder,
                                  torch.from_numpy(mel), torch.from_numpy(lengths), fused)
    return got.numpy(), np.asarray(ref)


def _valid_close(got, ref):
    for i, n in enumerate(MEL_LENGTHS):
        tv = RE.subsample_length(n)
        np.testing.assert_allclose(got[i, :tv], ref[i, :tv], rtol=ENC_RTOL, atol=ENC_ATOL, err_msg=f"item {i}")


@pytest.mark.parametrize("mode", MODES)
def test_quantized_encoder_matches_reference(encoder_model, mode):
    flat, mel = encoder_model
    got, ref = _encode_both(flat, mel, mode)
    _valid_close(got, ref)


class _Counts:
    """Counts calls of the port's kernel wrappers as the encoder module
    reaches them (on the CPU each runs its plain version)."""

    NAMES = ("rel_attention_block", "fused_rel_attention", "fused_feed_forward", "fused_conv_module",
             "fused_subsample_block1", "fused_conv_ffn_final", "fused_ffn_attention")

    def __init__(self, monkeypatch):
        import parakeet_tpu_torch.models.encoder as enc

        self.calls = dict.fromkeys(self.NAMES, 0)
        for name in self.NAMES:
            real = getattr(enc, name)

            def counted(*a, _real=real, _name=name, **kw):
                self.calls[_name] += 1
                return _real(*a, **kw)

            monkeypatch.setattr(enc, name, counted)


ALL_FUSED = TE.FusedLayers(ffn=True, conv=True, subsample=True)
WHOLE = TE.FusedLayers(attention="mega", block2=True, subsample=True)


@pytest.mark.parametrize("fused, include, want", [
    # a fully quantized model at 2 layers: K2 every layer, K8 and K5 when fused
    (TE.FusedLayers(), None, dict(fused_rel_attention=2)),
    (ALL_FUSED, None, dict(fused_subsample_block1=1, fused_conv_module=2, fused_rel_attention=2)),
    (WHOLE, None, dict(fused_subsample_block1=1, fused_rel_attention=2)),
    (TE.FusedLayers(attention="v1"), None, dict(fused_rel_attention=2)),
    # partial quantization routes sublayer by sublayer
    (ALL_FUSED, r"ffn1_\.fc1", dict(fused_subsample_block1=1, fused_feed_forward=2, fused_conv_module=2,
                                     rel_attention_block=2)),
    (ALL_FUSED, r"layers_\.0\.attn_\.mha_\.v_proj", dict(fused_subsample_block1=1, fused_feed_forward=4,
                                                          fused_conv_module=2, rel_attention_block=1,
                                                          fused_rel_attention=1)),
    (WHOLE, r"layers_\.1\.ffn2_", dict(fused_subsample_block1=1, fused_ffn_attention=2, fused_conv_ffn_final=1)),
    (WHOLE, r"layers_\.0\.attn_\.pos_proj_", dict(fused_subsample_block1=1, fused_ffn_attention=1,
                                                  rel_attention_block=0, fused_rel_attention=1,
                                                  fused_conv_ffn_final=2)),
], ids=["default", "fused", "whole-block", "v1", "ffn1-fc1", "layer0-v", "layer1-ffn2", "layer0-pos"])
def test_partial_quantization_routes_per_sublayer(encoder_model, monkeypatch, fused, include, want):
    """Each sublayer with integer weights runs plain (its attention through
    the v1 core), the others through their kernels; outputs hold to the
    JAX encoder (its XLA layers) at the kernel tolerance."""
    flat, mel = encoder_model
    counts = _Counts(monkeypatch)
    got, ref = _encode_both(flat, mel, "int8", include=include, fused=fused)
    assert counts.calls == {k: want.get(k, 0) for k in _Counts.NAMES}
    _valid_close(got, ref)


# ─── facades, checkpoints, the offline tool ──────────────────────────────────


@pytest.fixture(scope="module")
def facade_setup():
    return _flat(RP.tdt_ctc_spec(_cfg(RC)), seed=6), _waves(np.random.RandomState(6))


@pytest.mark.parametrize("mode", ["int8", "int4", "w8a8"])
def test_facade_tokens_match_reference(facade_setup, mode):
    """Transcriber(quantize=...) in f32: TDT and CTC tokens and frames
    identical to the JAX Transcriber's; W8A8 on int8 with set_int8_compute
    in both, reset in finally."""
    from parakeet_tpu.transcribe import Decoder, TranscribeOptions, Transcriber
    from parakeet_tpu_torch.transcribe import Decoder as TDecoder
    from parakeet_tpu_torch.transcribe import TranscribeOptions as TOptions
    from parakeet_tpu_torch.transcribe import Transcriber as TTranscriber

    flat, waves = facade_setup
    quantize = "int8" if mode == "w8a8" else mode
    RL.set_int8_compute(mode == "w8a8")
    TL.set_int8_compute(mode == "w8a8")
    try:
        ref_tr = Transcriber(None, None, _cfg(RC), params=flat, quantize=quantize)
        tr = TTranscriber(None, None, _cfg(TC), params=flat, quantize=quantize, device="cpu")
        assert TQ.quantized_fraction(tr.params) == RQ.quantized_fraction(ref_tr.params) > 0.5
        for dec in ("TDT", "CTC"):
            ref = ref_tr.transcribe_batch(waves, TranscribeOptions(getattr(Decoder, dec), timestamps=True))
            got = tr.transcribe_batch(waves, TOptions(getattr(TDecoder, dec), timestamps=True))
            assert sum(len(r.token_ids) for r in ref) > 3, "degenerate case: few tokens"
            for g, r in zip(got, ref):
                assert g.token_ids == r.token_ids and _spans(g) == _spans(r)
    finally:
        RL.set_int8_compute(False)
        TL.set_int8_compute(False)


@pytest.mark.parametrize("mode", MODES)
def test_quantized_checkpoint_loads_like_reference(tmp_path, mode):
    """A quantized safetensors file dequantises on load, before the shape
    check, as JAX load_params does; a missing sidecar raises its
    ValueError."""
    from parakeet_tpu.io.safetensors import save_safetensors

    cfg = _cfg(RC)
    flat = _flat(RP.tdt_ctc_spec(cfg), seed=8)
    q = RQ.quantize_params(flat, mode=mode, as_numpy=True)
    path = tmp_path / "q.safetensors"
    save_safetensors(q, path)
    spec = TP.tdt_ctc_spec(_cfg(TC))
    got = TP.load_params_numpy(spec, str(path))
    ref = RP.load_params(RP.tdt_ctc_spec(cfg), str(path))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    key = next(k for k in q if k.endswith(TQ.SCALE4_SUFFIX if mode == "int4" else TQ.SCALE_SUFFIX))
    save_safetensors({k: v for k, v in q.items() if k != key}, path)
    with pytest.raises(ValueError, match="sidecar"):
        TP.load_params_numpy(spec, str(path))


@pytest.mark.parametrize("args", [["--mode", "int8"], ["--mode", "int4", "--group-size", "32"],
                                  ["--mode", "int8", "--include", "ffn", "--min-elems", "0"]])
def test_quantize_ckpt_output_byte_identical(tmp_path, args):
    from parakeet_tpu.io.safetensors import save_safetensors
    from parakeet_tpu.tools import quantize_ckpt as ref_tool
    from parakeet_tpu_torch.tools import quantize_ckpt as tool

    src = tmp_path / "in.safetensors"
    save_safetensors(_flat(RP.tdt_ctc_spec(_cfg(RC)), seed=9), src)
    outs = {}
    for name, mod in (("ref", ref_tool), ("port", tool)):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert mod.main([str(src), str(tmp_path / f"{name}.safetensors"), *args]) == 0
        outs[name] = buf.getvalue().replace(str(tmp_path / f"{name}.safetensors"), "OUT")
    assert (tmp_path / "port.safetensors").read_bytes() == (tmp_path / "ref.safetensors").read_bytes()
    assert outs["port"] == outs["ref"]
    assert tool.main([str(tmp_path / "port.safetensors"), str(tmp_path / "again.safetensors")]) == 1


# ─── streaming ───────────────────────────────────────────────────────────────


def _eou_cfg(C):
    return C.EOUConfig(
        encoder=C.StreamingEncoderConfig(mel_bins=80, subsampling_channels=8, hidden_size=64, num_layers=2,
                                         num_heads=2, ffn_intermediate=128, conv_kernel_size=5, att_context_left=6,
                                         att_context_right=1, chunk_size=2),
        prediction=C.PredictionConfig(vocab_size=13, pred_hidden=32, num_lstm_layers=1),
        joint=C.JointConfig(encoder_hidden=64, pred_hidden=32, joint_hidden=64, vocab_size=13),
        ctc_vocab_size=13,
    )


@pytest.mark.parametrize("mode", MODES)
def test_quantized_streaming_matches_reference(mode):
    """eou StreamingTranscriber(quantize=...) chunk by chunk: each push's
    delta, the tokens and their frames identical to the JAX facade's; the
    lockstep batch takes the option too."""
    import parakeet_tpu.streaming as RS
    from parakeet_tpu_torch import streaming as TS

    flat = _flat(RP.eou_spec(_eou_cfg(RC)), seed=15)
    ref = RS.StreamingTranscriber(None, None, _eou_cfg(RC), params=flat, quantize=mode)
    port = TS.StreamingTranscriber(None, None, _eou_cfg(TC), params=flat, quantize=mode, device="cpu")
    assert TQ.quantized_fraction(port.params) == RQ.quantized_fraction(ref.params) > 0.5
    audio = _waves(np.random.RandomState(16), (16000,))[0]
    for lo in range(0, len(audio), 2560):
        assert port.transcribe_chunk(audio[lo: lo + 2560]) == ref.transcribe_chunk(audio[lo: lo + 2560])
        assert port.get_tokens() == ref.get_tokens()
    assert len(port.get_tokens()) > 3, "degenerate case: few tokens"
    assert [(t.token_id, t.start_frame, t.end_frame) for t in port.get_timestamped_tokens()] == [
        (t.token_id, t.start_frame, t.end_frame) for t in ref.get_timestamped_tokens()]
    bt = TS.StreamingBatchTranscriber(1, None, None, _eou_cfg(TC), params=flat, quantize=mode, device="cpu")
    assert TQ.quantized_fraction(bt.params) == TQ.quantized_fraction(port.params)
