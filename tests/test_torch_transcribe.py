"""The port's Transcriber end to end against the JAX reference Transcriber
(kernels on, the Pallas block kernel in interpret mode): same tiny model
weights, same waveforms, identical TDT and CTC tokens and timestamps."""

import numpy as np
import pytest

from parakeet_tpu import config as RC
from parakeet_tpu import params as RP
from parakeet_tpu.audio.io import write_wav
from parakeet_tpu_torch import config as TC
from parakeet_tpu_torch.transcribe import Decoder as TDecoder
from parakeet_tpu_torch.transcribe import TranscribeOptions as TOptions
from parakeet_tpu_torch.transcribe import Transcriber as TTranscriber

PIECES = ["<unk>", "▁a", "b", "▁c", "d", ".", "▁e", "f"]  # + blank = vocab 9


def _cfg(C):
    return C.TDTCTCConfig(
        encoder=C.EncoderConfig(mel_bins=80, subsampling_channels=8, hidden_size=32,
                                num_layers=2, num_heads=4, ffn_intermediate=64),
        prediction=C.PredictionConfig(vocab_size=9, pred_hidden=16, num_lstm_layers=1),
        joint=C.JointConfig(encoder_hidden=32, pred_hidden=16, joint_hidden=16, vocab_size=9),
        ctc_vocab_size=9,
    )


def _waves(rng):
    """Gated chirps: frame-to-frame variation a random model can tell apart."""
    out = []
    for n in (16000, 11000, 23456):
        t = np.arange(n) / 16000
        f = rng.uniform(100, 3000) * (1 + 2 * t)
        gate = (np.sin(2 * np.pi * rng.uniform(1, 4) * t) > 0).astype(np.float32)
        out.append((0.3 * gate * np.sin(2 * np.pi * f * t) + 0.02 * rng.randn(n)).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    flat = {k: np.asarray(v) for k, v in RP.init_params(RP.tdt_ctc_spec(_cfg(RC)), seed=6).items()}
    waves = _waves(np.random.RandomState(6))
    vocab = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    vocab.write_text("\n".join(f"{p}\t0" for p in PIECES), encoding="utf-8")
    return flat, waves, str(vocab)


@pytest.fixture(scope="module")
def reference_results(setup):
    """The JAX Transcriber with kernels="block4hp" (what kernels=True picks
    at d_model < 1024), its Pallas kernel in interpret mode."""
    import parakeet_tpu.ops.pallas_attention as PA
    from parakeet_tpu.models import encoder as RE
    from parakeet_tpu.transcribe import Decoder, TranscribeOptions, Transcriber

    flat, waves, vocab = setup
    mp = pytest.MonkeyPatch()
    orig = PA.fused_rel_attention_block
    calls = []

    def interp(*args, **kw):
        calls.append(1)
        kw["interpret"] = True
        return orig(*args, **kw)

    mp.setattr(PA, "fused_rel_attention_block", interp)
    try:
        tr = Transcriber(None, vocab, _cfg(RC), params=flat, kernels="block4hp")
        out = {
            dec: tr.transcribe_batch(waves, TranscribeOptions(getattr(Decoder, dec), timestamps=True))
            for dec in ("TDT", "CTC")
        }
    finally:
        RE.set_fused_attention(False)
        mp.undo()
    assert calls, "the reference block kernel did not run"
    return out


def _spans(result):
    return [(t.token_id, t.start_frame, t.end_frame) for t in result.timestamped_tokens]


@pytest.mark.parametrize("decoder", ["TDT", "CTC"])
def test_tokens_and_timestamps_identical_to_reference(setup, reference_results, decoder):
    flat, waves, vocab = setup
    tr = TTranscriber(None, vocab, _cfg(TC), params=flat, device="cpu")
    got = tr.transcribe_batch(waves, TOptions(getattr(TDecoder, decoder), timestamps=True))
    ref = reference_results[decoder]
    assert len({t for r in ref for t in r.token_ids}) >= 2, "degenerate case: one token type"
    for g, r in zip(got, ref):
        assert g.token_ids == r.token_ids
        assert _spans(g) == _spans(r)
        np.testing.assert_allclose([t.confidence for t in g.timestamped_tokens],
                                   [t.confidence for t in r.timestamped_tokens], rtol=1e-4)
        assert g.text == r.text
        assert [(w.word, w.start, w.end) for w in g.word_timestamps] == [
            (w.word, w.start, w.end) for w in r.word_timestamps]


def test_single_clip_wav_features_and_no_timestamps_agree(setup, reference_results, tmp_path):
    flat, waves, vocab = setup
    tr = TTranscriber(None, vocab, _cfg(TC), params=flat, device="cpu")
    path = tmp_path / "clip.wav"
    write_wav(path, waves[0])
    from parakeet_tpu_torch.audio.io import read_audio

    samples = read_audio(path).samples
    by_path = tr.transcribe(path, TDecoder.CTC)
    assert by_path.token_ids == tr.transcribe(samples, TDecoder.CTC).token_ids
    plain = tr.transcribe_batch(waves, TOptions(TDecoder.TDT))
    assert [r.token_ids for r in plain] == [r.token_ids for r in reference_results["TDT"]]
    assert all(not r.timestamped_tokens for r in plain)

    from parakeet_tpu_torch.audio.frontend import preprocess_audio

    feats = preprocess_audio(waves[1], device="cpu").numpy()[0]
    assert tr.transcribe_features(feats).token_ids == reference_results["TDT"][1].token_ids


def test_prepare_decode_split_and_progress(setup):
    flat, waves, vocab = setup
    tr = TTranscriber(None, vocab, _cfg(TC), params=flat, device="cpu")
    stages = []
    opts = TOptions(TDecoder.CTC, on_progress=lambda s, d, n: stages.append((s, d, n)))
    got = tr.decode_prepared(tr.prepare_batch(waves, opts))
    assert [r.token_ids for r in got] == [r.token_ids for r in tr.transcribe_batch(waves, TOptions(TDecoder.CTC))]
    assert stages == [("load", 1, 3), ("load", 2, 3), ("load", 3, 3), ("preprocess", 1, 1), ("decode", 1, 1)]
    assert tr.transcribe_batch([]) == []


@pytest.mark.parametrize("bad", ["beam_size", "lm", "boost_phrases", "mesh", "quantize", "long_clip"])
def test_unsupported_options_raise(setup, bad):
    """mesh= takes a parallel.Mesh now (tests/test_torch_parallel.py runs
    it); anything else raises TypeError. The options the port once refused
    now run as in the JAX Transcriber (its XLA path): beam search, an LM with a
    greedy decode (ignored, and the call stays dense), phrase boosting and
    quantize=, each with the reference's own ValueError; a long clip routes
    through the windowed decode."""
    from parakeet_tpu.transcribe import Decoder, Transcriber

    flat, waves, vocab = setup
    if bad == "mesh":
        with pytest.raises(TypeError, match=bad):
            TTranscriber(None, None, _cfg(TC), params=flat, device="cpu", mesh="int8")
        return
    if bad == "quantize":
        tr = TTranscriber(None, None, _cfg(TC), params=flat, device="cpu", quantize="int8")
        ref = Transcriber(None, None, _cfg(RC), params=flat, quantize="int8")
        assert tr.transcribe(waves[1], TDecoder.TDT, True).token_ids == ref.transcribe(waves[1]).token_ids
        for make in (lambda: TTranscriber(None, None, _cfg(TC), params=flat, device="cpu", quantize="int3"),
                     lambda: Transcriber(None, None, _cfg(RC), params=flat, quantize="int3")):
            with pytest.raises(ValueError, match="unsupported quantize mode"):
                make()
        return
    tr = TTranscriber(None, vocab, _cfg(TC), params=flat, device="cpu", long_threshold_s=1.0)
    if bad == "long_clip":
        # no longer refused: a clip past long_threshold_s (1.47 s > 1 s) routes
        # through the windowed decode; it fits one 10 s window, so it decodes
        # as the dense route does, with timestamps
        routed = []
        real = tr.transcribe_long_batch
        tr.transcribe_long_batch = lambda clips, *a, **k: routed.append(len(clips)) or real(clips, *a, **k)
        got = tr.transcribe(waves[2])
        dense = TTranscriber(None, None, _cfg(TC), params=flat, device="cpu", long_audio="dense",
                             long_threshold_s=1.0)
        want = dense.transcribe(waves[2], timestamps=True)
        assert routed == [1] and got.timestamped_tokens
        assert got.token_ids == want.token_ids and _spans(got) == _spans(want)
        return
    ref = Transcriber(None, vocab, _cfg(RC), params=flat, long_threshold_s=1.0)
    if bad == "beam_size":
        for dec in (TDecoder.TDT, TDecoder.CTC):
            kw = dict(decoder=dec, timestamps=True, beam_size=4)
            got, want = tr.transcribe(waves[2], **kw), ref.transcribe(waves[2], **{**kw, "decoder": Decoder[dec.name]})
            assert got.token_ids == want.token_ids and _spans(got) == _spans(want)
        for t in (tr, ref):
            with pytest.raises(ValueError, match="greedy decode only"):
                t.transcribe(waves[1], beam_size=4, boost_phrases=["a b"])
    elif bad == "lm":
        # a greedy decode ignores the LM, and the 1.47 s clip stays dense
        routed = []
        tr.transcribe_long_batch = lambda clips, *a, **k: routed.append(len(clips))
        got = tr.transcribe(waves[2], timestamps=True, lm=object(), lm_weight=0.5)
        want = ref.transcribe(waves[2], timestamps=True, lm=object(), lm_weight=0.5)
        assert routed == [] and got.token_ids == want.token_ids and _spans(got) == _spans(want)
    else:
        for dec in (TDecoder.TDT, TDecoder.CTC):
            kw = dict(timestamps=True, boost_phrases=["a b", "c d"], boost_score=3.0)
            got, want = tr.transcribe(waves[1], dec, **kw), ref.transcribe(waves[1], Decoder[dec.name], **kw)
            assert got.token_ids == want.token_ids and _spans(got) == _spans(want)


@pytest.fixture(scope="module")
def fused_setup(setup):
    """Longer clips: the padded batch reaches T' ≥ 64, past the reference's
    FFN-kernel guard, so every reference kernel runs."""
    flat, _, vocab = setup
    rng = np.random.RandomState(9)
    waves = _waves(rng)
    waves[0] = np.concatenate([_waves(rng)[2] for _ in range(4)])  # 5.86 s: T' = 74
    return flat, waves, vocab


@pytest.fixture(scope="module")
def fused_reference_results(fused_setup):
    """The JAX Transcriber with every encoder sublayer on its Pallas kernel
    (block4hp attention, fused FFN, pallas conv layout, fused subsampling),
    each kernel in interpret mode, with its calls counted."""
    import parakeet_tpu.ops.pallas_attention as PA
    import parakeet_tpu.ops.pallas_conv as PC
    import parakeet_tpu.ops.pallas_ffn as PF
    import parakeet_tpu.ops.pallas_subsample as PS
    from parakeet_tpu.models import encoder as RE
    from parakeet_tpu.transcribe import Decoder, TranscribeOptions, Transcriber

    flat, waves, vocab = fused_setup
    mp = pytest.MonkeyPatch()
    calls = {}
    for mod, name in ((PA, "fused_rel_attention_block"), (PF, "fused_feed_forward"),
                      (PC, "fused_conv_module"), (PS, "fused_subsample_block1")):
        calls[name] = 0

        def interp(*args, _orig=getattr(mod, name), _name=name, **kw):
            calls[_name] += 1
            kw["interpret"] = True
            return _orig(*args, **kw)

        mp.setattr(mod, name, interp)
    mp.setattr(RE, "_SUBSAMPLE_T4_TILE", 4)
    try:
        tr = Transcriber(None, vocab, _cfg(RC), params=flat, kernels="block4hp")
        RE.set_fused_ffn(True)
        RE.set_conv_layout("pallas")
        RE.set_fused_subsample(True)
        out = {
            dec: tr.transcribe_batch(waves, TranscribeOptions(getattr(Decoder, dec), timestamps=True))
            for dec in ("TDT", "CTC")
        }
    finally:
        RE.set_fused_attention(False)
        RE.set_fused_ffn(False)
        RE.set_conv_layout("nch")
        RE.set_fused_subsample(False)
        mp.undo()
    layers = _cfg(RC).encoder.num_layers
    assert calls == {"fused_rel_attention_block": 2 * layers, "fused_feed_forward": 4 * layers,
                     "fused_conv_module": 2 * layers, "fused_subsample_block1": 2}, calls
    return out


@pytest.mark.parametrize("decoder", ["TDT", "CTC"])
def test_fused_layers_tokens_identical_to_reference_kernels(fused_setup, fused_reference_results, decoder,
                                                            monkeypatch):
    from parakeet_tpu_torch import FusedLayers
    from parakeet_tpu_torch.models import encoder as TE

    monkeypatch.setattr(TE, "_SUBSAMPLE_T4_TILE", 4)  # as the reference run above
    flat, waves, vocab = fused_setup
    tr = TTranscriber(None, vocab, _cfg(TC), params=flat, device="cpu",
                      fused=FusedLayers(ffn=True, conv=True, subsample=True))
    got = tr.transcribe_batch(waves, TOptions(getattr(TDecoder, decoder), timestamps=True))
    ref = fused_reference_results[decoder]
    assert len({t for r in ref for t in r.token_ids}) >= 2, "degenerate case: one token type"
    for g, r in zip(got, ref):
        assert g.token_ids == r.token_ids
        assert _spans(g) == _spans(r)
        np.testing.assert_allclose([t.confidence for t in g.timestamped_tokens],
                                   [t.confidence for t in r.timestamped_tokens], rtol=1e-4)
        assert g.text == r.text
