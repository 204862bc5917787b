"""The port's TDT-only and RNNT facades against the JAX reference's
(TDTTranscriber, RNNTTranscriber) on tiny models: same weights, same
waveforms, identical tokens, timestamps and text; and the facade options
(CTC without a CTC head, kernels=, to_gpu, long_*, the default device)."""

import numpy as np
import pytest
import torch

from parakeet_tpu import config as RC
from parakeet_tpu import params as RP
from parakeet_tpu_torch import FusedLayers
from parakeet_tpu_torch import config as TC
from parakeet_tpu_torch import transcribe as TT

PIECES = ["<unk>", "▁a", "b", "▁c", "d", ".", "▁e", "f"]  # + blank = vocab 9


def _enc(C, mel):
    return C.EncoderConfig(mel_bins=mel, subsampling_channels=8, hidden_size=32,
                           num_layers=2, num_heads=4, ffn_intermediate=64)


def _tdt_cfg(C):
    """tdt-600m's shape in small: 128 mel bins, two LSTM layers."""
    return C.TDTConfig(
        encoder=_enc(C, 128),
        prediction=C.PredictionConfig(vocab_size=9, pred_hidden=16, num_lstm_layers=2),
        joint=C.JointConfig(encoder_hidden=32, pred_hidden=16, joint_hidden=16, vocab_size=9),
    )


def _rnnt_cfg(C):
    """rnnt-600m's shape in small: 80 mel bins, two LSTM layers."""
    return C.RNNTConfig(
        encoder=_enc(C, 80),
        prediction=C.PredictionConfig(vocab_size=9, pred_hidden=16, num_lstm_layers=2),
        joint=C.JointConfig(encoder_hidden=32, pred_hidden=16, joint_hidden=16, vocab_size=9),
    )


FACADES = {"tdt": ("TDTTranscriber", _tdt_cfg, "tdt_spec"), "rnnt": ("RNNTTranscriber", _rnnt_cfg, "rnnt_spec")}


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
def vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(f"{p}\t0" for p in PIECES), encoding="utf-8")
    return str(path)


@pytest.fixture(scope="module")
def flats():
    return {kind: {k: np.asarray(v) for k, v in RP.init_params(getattr(RP, spec)(cfg(RC)), seed=7).items()}
            for kind, (_, cfg, spec) in FACADES.items()}


def _port(kind, flats, vocab=None, **kw):
    name, cfg, _ = FACADES[kind]
    return getattr(TT, name)(None, vocab, cfg(TC), params=flats[kind], device="cpu", **kw)


@pytest.fixture(scope="module")
def reference_results(flats, vocab):
    """The JAX facades (XLA encoder path), TDT decode with timestamps."""
    import parakeet_tpu.transcribe as R

    waves = _waves(np.random.RandomState(12))
    out = {}
    for kind, (name, cfg, _) in FACADES.items():
        tr = getattr(R, name)(None, vocab, cfg(RC), params=flats[kind])
        out[kind] = tr.transcribe_batch(waves, R.TranscribeOptions(R.Decoder.TDT, timestamps=True))
    return waves, out


def _spans(result):
    return [(t.token_id, t.start_frame, t.end_frame) for t in result.timestamped_tokens]


@pytest.mark.parametrize("kind", ["tdt", "rnnt"])
def test_tokens_and_timestamps_identical_to_reference(flats, vocab, reference_results, kind):
    waves, ref = reference_results
    tr = _port(kind, flats, vocab)
    assert tr.has_ctc is False and tr.joint_prefix == "joint_" and tr.is_tdt == (kind == "tdt")
    got = tr.transcribe_batch(waves, TT.TranscribeOptions(TT.Decoder.TDT, timestamps=True))
    assert len({t for r in ref[kind] for t in r.token_ids}) >= 2, "degenerate case: one token type"
    for g, r in zip(got, ref[kind]):
        assert g.token_ids == r.token_ids
        assert _spans(g) == _spans(r)
        np.testing.assert_allclose([t.confidence for t in g.timestamped_tokens],
                                   [t.confidence for t in r.timestamped_tokens], rtol=1e-4)
        assert g.text == r.text
        assert [(w.word, w.start, w.end) for w in g.word_timestamps] == [
            (w.word, w.start, w.end) for w in r.word_timestamps]
    plain = tr.transcribe_batch(waves)  # no timestamps: the same tokens
    assert [p.token_ids for p in plain] == [r.token_ids for r in ref[kind]]


def test_rnnt_advances_one_frame_per_blank(flats, reference_results):
    """RNNT is TDT with durations (0,): every token spans one frame."""
    waves, _ = reference_results
    res = _port("rnnt", flats).transcribe(waves[0], timestamps=True)
    assert res.timestamped_tokens and all(t.start_frame == t.end_frame for t in res.timestamped_tokens)


@pytest.mark.parametrize("kind", ["tdt", "rnnt"])
@pytest.mark.parametrize("entry", ["transcribe", "transcribe_batch", "transcribe_features", "prepare_batch"])
def test_ctc_without_ctc_head_raises_before_device_work(flats, kind, entry, monkeypatch):
    tr = _port(kind, flats)

    def no_device_work(*a, **k):
        raise AssertionError("device work before the option check")

    monkeypatch.setattr(TT, "preprocess_audio_batch", no_device_work)
    monkeypatch.setattr(TT, "fastconformer_encode", no_device_work)
    wave = np.zeros(8000, np.float32)
    opts = TT.TranscribeOptions(TT.Decoder.CTC)
    with pytest.raises(ValueError, match="no CTC head"):
        if entry == "transcribe":
            tr.transcribe(wave, TT.Decoder.CTC)
        elif entry == "transcribe_features":
            tr.transcribe_features(np.zeros((64, tr.config.encoder.mel_bins), np.float32), opts)
        else:
            getattr(tr, entry)([wave], opts)


@pytest.mark.parametrize("kernels, fused, want", [
    (None, None, FusedLayers()),
    (True, None, FusedLayers()),
    ("block", None, FusedLayers()),
    ("block4hp", None, FusedLayers()),
    ("bd4", None, FusedLayers()),
    ("mega", None, FusedLayers(attention="mega")),
    ("v1", None, FusedLayers(attention="v1")),
    (None, FusedLayers(ffn=True, attention="v1"), FusedLayers(ffn=True, attention="v1")),
    ("block8hp", FusedLayers(conv=True), FusedLayers(conv=True)),
    ("mega", FusedLayers(block2=True, attention="mega"), FusedLayers(block2=True, attention="mega")),
])
def test_kernels_maps_onto_fused_layers(flats, kernels, fused, want):
    assert TT.fused_layers_for(kernels, fused) == want
    assert _port("tdt", flats, kernels=kernels, fused=fused).fused == want


@pytest.mark.parametrize("kernels, fused, match", [
    (False, None, "kernel-free"),
    ("off", None, "kernel-free"),
    ("auto", None, "unknown kernels mode"),
    ("v1", FusedLayers(), "disagree|selects attention"),
    (True, FusedLayers(attention="mega"), "selects attention"),
    ("block4hp", FusedLayers(attention="v1"), "selects attention"),
])
def test_kernels_errors(flats, kernels, fused, match):
    with pytest.raises(ValueError, match=match):
        _port("rnnt", flats, kernels=kernels, fused=fused)


def test_to_gpu_is_a_no_op(flats):
    tr = _port("tdt", flats)
    before = {k: v.clone() for k, v in tr.params.items()}
    assert tr.to_gpu() is None
    assert tr.device == torch.device("cpu")
    assert all(torch.equal(tr.params[k], v) for k, v in before.items())


@pytest.mark.parametrize("kw, match", [
    (dict(long_audio="auto"), "long_audio"),
    (dict(long_overlap_s=10.0), "long_overlap_s"),
    (dict(long_window_s=4.0, long_overlap_s=5.0), "long_overlap_s"),
    (dict(long_overlap_s=-1.0), "long_overlap_s"),
])
def test_long_options_validated(flats, kw, match):
    with pytest.raises(ValueError, match=match):
        _port("tdt", flats, **kw)


def _ctc_cfg(C):
    return C.TDTCTCConfig(
        encoder=_enc(C, 80),
        prediction=C.PredictionConfig(vocab_size=9, pred_hidden=16, num_lstm_layers=1),
        joint=C.JointConfig(encoder_hidden=32, pred_hidden=16, joint_hidden=16, vocab_size=9),
        ctc_vocab_size=9,
    )


@pytest.mark.parametrize("name", ["Transcriber", "TDTTranscriber", "RNNTTranscriber"])
def test_no_card_raises_unless_cpu_is_asked_for(name, monkeypatch):
    """Every facade defaults to the card; with none it raises and says to
    pass device="cpu", and nothing goes on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cls = getattr(TT, name)
    cfg = {"Transcriber": _ctc_cfg, "TDTTranscriber": _tdt_cfg, "RNNTTranscriber": _rnnt_cfg}[name](TC)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cls(None, None, cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cls(None, None, cfg, device="cuda:0")
    assert cls(None, None, cfg, device="cpu").device == torch.device("cpu")


def test_facades_exported_with_the_600m_presets():
    import parakeet_tpu_torch as pkg

    assert pkg.TDTTranscriber is TT.TDTTranscriber and pkg.RNNTTranscriber is TT.RNNTTranscriber
    assert pkg.make_tdt_600m_config() == TC.make_tdt_600m_config()
    tdt, rnnt = TC.make_tdt_600m_config(), TC.make_rnnt_600m_config()
    assert (tdt.encoder.mel_bins, tdt.encoder.num_layers, tdt.encoder.hidden_size, tdt.joint.vocab_size,
            tdt.prediction.num_lstm_layers) == (128, 24, 1024, 8193, 2)
    assert (rnnt.encoder.mel_bins, rnnt.joint.vocab_size) == (80, 1025)
