"""The port's forced alignment and VAD against the JAX reference's:
ctc_forced_align, stitch_frame_ownership, vad_segments and speech_ratio
on the same inputs, and the facade methods align, align_batch, align_long
and transcribe_vad on a tiny tdt-ctc model with the same weights."""

import dataclasses

import numpy as np
import pytest

from parakeet_tpu import config as RC
from parakeet_tpu import params as RP
from parakeet_tpu.audio import vad as RV
from parakeet_tpu.decode import align as RA
from parakeet_tpu_torch import config as TC
from parakeet_tpu_torch import transcribe as TT
from parakeet_tpu_torch.audio import vad as TV
from parakeet_tpu_torch.decode import align as TA

PIECES = ["<unk>", "▁a", "b", "▁c", "d", ".", "▁e", "f"]  # + blank = vocab 9
SR = 16000


def _tuples(tokens):
    return [dataclasses.astuple(t) for t in tokens]


def _log_probs(rng, t, v):
    x = rng.randn(t, v).astype(np.float32) * 3
    return x - np.log(np.exp(x).sum(-1, keepdims=True))


@pytest.mark.parametrize("seed", range(6))
def test_ctc_forced_align_identical(seed):
    rng = np.random.RandomState(seed)
    t, v = int(rng.randint(20, 80)), 12
    lp = _log_probs(rng, t, v)
    tokens = list(rng.randint(0, v - 1, size=int(rng.randint(1, 8))))
    tokens[-1:] = tokens[-1:] * 2  # a repeated label needs a blank between
    length = int(rng.randint(2 * len(tokens) + 1, t + 1))
    for kw in ({}, dict(length=length)):
        got = TA.ctc_forced_align(lp, tokens, v - 1, **kw)
        want = RA.ctc_forced_align(lp, tokens, v - 1, **kw)
        assert _tuples(got) == _tuples(want) and len(got) == len(tokens)


@pytest.mark.parametrize("args, match", [
    ((np.zeros((3, 4), np.float32), [1, 1, 1], 3), "frames cannot emit"),
    ((np.zeros((5, 4), np.float32), [], 3), "non-empty"),
    ((np.zeros((5, 4), np.float32), [3], 3), "blank id"),
    ((np.zeros((5, 4), np.float32), [7], 3), "out of range"),
    ((np.zeros((5,), np.float32), [1], 3), "expected"),
])
def test_ctc_forced_align_errors_identical(args, match):
    for fn in (TA.ctc_forced_align, RA.ctc_forced_align):
        with pytest.raises(ValueError, match=match):
            fn(*args)


def test_stitch_frame_ownership_identical():
    rng = np.random.RandomState(4)
    for _ in range(200):
        n = int(rng.randint(1, 7))
        hop = int(rng.randint(1, 50))
        starts = [i * hop for i in range(n)]
        lens = [int(rng.randint(1, 80)) for _ in range(n)]
        overlap = int(rng.randint(0, 60))
        assert TA.stitch_frame_ownership(starts, lens, overlap) == RA.stitch_frame_ownership(starts, lens, overlap)
    for fn in (TA.stitch_frame_ownership, RA.stitch_frame_ownership):
        with pytest.raises(ValueError, match="one start per window"):
            fn([0, 10], [5], 2)


def _speechy(seed, seconds, bursts):
    """Noise floor with tone bursts at (start_s, end_s)."""
    rng = np.random.RandomState(seed)
    x = 0.002 * rng.randn(int(seconds * SR))
    t = np.arange(x.size) / SR
    for lo, hi in bursts:
        m = (t >= lo) & (t < hi)
        x[m] += 0.3 * np.sin(2 * np.pi * rng.uniform(150, 400) * t[m]) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t[m]))
    return x.astype(np.float32)


VAD_CASES = [
    (_speechy(1, 4.0, [(0.5, 1.2), (1.35, 1.6), (2.5, 2.55), (3.0, 3.8)]), None),
    (_speechy(2, 3.0, [(0.2, 2.8)]), None),
    (_speechy(3, 2.0, []), None),
    (_speechy(4, 4.0, [(0.5, 1.0), (2.0, 3.5)]), dict(margin_db=6.0, max_gap_ms=100.0, pad_ms=50.0)),
    (_speechy(5, 0.01, [(0.0, 0.01)]), None),
    (np.zeros(0, np.float32), None),
]


@pytest.mark.parametrize("case", range(len(VAD_CASES)))
def test_vad_segments_and_speech_ratio_identical(case):
    x, cfg = VAD_CASES[case]
    tcfg, rcfg = (TV.VadConfig(**cfg), RV.VadConfig(**cfg)) if cfg else (None, None)
    assert TV.vad_segments(x, SR, tcfg) == RV.vad_segments(x, SR, rcfg)
    assert TV.speech_ratio(x, SR, tcfg) == RV.speech_ratio(x, SR, rcfg)
    assert dataclasses.astuple(TV.VadConfig()) == dataclasses.astuple(RV.VadConfig())


def _cfg(C):
    return C.TDTCTCConfig(
        encoder=C.EncoderConfig(mel_bins=80, subsampling_channels=8, hidden_size=16,
                                num_layers=1, num_heads=2, ffn_intermediate=32),
        prediction=C.PredictionConfig(vocab_size=9, pred_hidden=8, num_lstm_layers=1),
        joint=C.JointConfig(encoder_hidden=16, pred_hidden=8, joint_hidden=8, vocab_size=9),
        ctc_vocab_size=9,
    )


@pytest.fixture(scope="module")
def facades(tmp_path_factory):
    from parakeet_tpu.transcribe import Transcriber

    flat = {k: np.asarray(v) for k, v in RP.init_params(RP.tdt_ctc_spec(_cfg(RC)), seed=7).items()}
    vocab = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    vocab.write_text("\n".join(f"{p}\t0" for p in PIECES), encoding="utf-8")
    return (Transcriber(None, str(vocab), _cfg(RC), params=flat),
            TT.Transcriber(None, str(vocab), _cfg(TC), params=flat, device="cpu"), flat)


def _key(result):
    return (_tuples(result.timestamped_tokens), result.text,
            [(w.word, w.start, w.end) for w in result.word_timestamps])


def _close(got, want):
    """Same tokens and frames; confidences (exp of mean log-probs) to f32
    rounding, since the two encoders sum in different orders."""
    assert [t[:3] for t in _key(got)[0]] == [t[:3] for t in _key(want)[0]] and _key(got)[1:] == _key(want)[1:]
    np.testing.assert_allclose([t.confidence for t in got.timestamped_tokens],
                               [t.confidence for t in want.timestamped_tokens], rtol=1e-4)


TEXTS = ["a b c", "ab c.", "e f a"]


def test_align_and_align_batch_identical(facades):
    ref, port, _ = facades
    clips = [_speechy(10 + i, s, [(0.1, s - 0.1)]) for i, s in enumerate((1.0, 1.6, 0.8))]
    got = port.align_batch(clips, TEXTS)
    want = ref.align_batch(clips, TEXTS)
    for g, w, text in zip(got, want, TEXTS):
        assert len(g.timestamped_tokens) == len(port.tokenizer.encode(text))
        _close(g, w)
    _close(port.align(clips[1], TEXTS[1]), ref.align(clips[1], TEXTS[1]))
    padded = port.align_batch(clips, TEXTS, pad_to_multiple=64)
    assert [_key(p)[0] for p in padded] == [_key(g)[0] for g in got]


def test_align_long_identical(facades):
    """Windows of 2 s overlapping by 0.5 s, the hop snapped to the 0.08 s
    frame grid, stitched frames aligned in one pass."""
    ref, port, _ = facades
    clip = _speechy(20, 5.3, [(0.2, 5.1)])
    text = "a b c d e f a b c"
    got = port.align_long(clip, text, window_s=2.0, overlap_s=0.5)
    want = ref.align_long(clip, text, window_s=2.0, overlap_s=0.5)
    _close(got, want)
    frames = [t.start_frame for t in got.timestamped_tokens]
    assert frames == sorted(frames) and len(frames) == len(port.tokenizer.encode(text))
    short = _speechy(21, 1.5, [(0.1, 1.4)])
    _close(port.align_long(short, "a b", window_s=2.0, overlap_s=0.5), ref.align(short, "a b"))


def test_align_errors(facades):
    ref, port, flat = facades
    no_vocab = TT.Transcriber(None, None, _cfg(TC), params=flat, device="cpu")
    clip = np.zeros(SR, np.float32)
    with pytest.raises(ValueError, match="vocab"):
        no_vocab.align(clip, "a")
    with pytest.raises(ValueError, match="sources vs"):
        port.align_batch([clip], ["a", "b"])
    with pytest.raises(ValueError, match="zero tokens"):
        port.align(clip, "")
    with pytest.raises(ValueError, match="frames cannot emit"):
        port.align(np.zeros(800, np.float32), "a b c d e f a b c")
    with pytest.raises(ValueError, match="overlap_s"):
        port.align_long(clip, "a", window_s=1.0, overlap_s=1.0)
    tdt = TT.TDTTranscriber(None, None, TC.TDTConfig(encoder=_cfg(TC).encoder, prediction=_cfg(TC).prediction,
                                                    joint=_cfg(TC).joint), device="cpu")
    with pytest.raises(ValueError, match="CTC head"):
        tdt.align(clip, "a")


@pytest.mark.parametrize("decoder", ["TDT", "CTC"])
def test_transcribe_vad_identical(facades, decoder):
    import parakeet_tpu.transcribe as R

    ref, port, _ = facades
    clip = _speechy(30, 4.0, [(0.4, 1.4), (2.2, 3.5)])
    got = port.transcribe_vad(clip, getattr(TT.Decoder, decoder))
    want = ref.transcribe_vad(clip, getattr(R.Decoder, decoder))
    assert got.timestamped_tokens, "no speech decoded"
    assert min(t.start_frame for t in got.timestamped_tokens) >= int(0.4 / 0.08) - 3
    _close(got, want)
    opts = TT.TranscribeOptions(getattr(TT.Decoder, decoder), timestamp_mode=TT.TimestampMode.SENTENCES)
    _close(port.transcribe_vad(clip, opts=opts),
           ref.transcribe_vad(clip, opts=R.TranscribeOptions(getattr(R.Decoder, decoder),
                                                             timestamp_mode=R.TimestampMode.SENTENCES)))
    silent = np.zeros(2 * SR, np.float32)
    assert port.transcribe_vad(silent).token_ids == ref.transcribe_vad(silent).token_ids == []
