"""The port's long-audio decode against the JAX reference's on a tiny
tdt-ctc model (as tests/test_longform.py): window starts, transcribe_long,
transcribe_long_batch, the ownership merge, the mixed short-and-long
auto-route and the dense opt-out give the same tokens, frames, order and
progress calls."""

import dataclasses

import numpy as np
import pytest

from parakeet_tpu import config as RC
from parakeet_tpu import params as RP
from parakeet_tpu_torch import config as TC
from parakeet_tpu_torch import transcribe as TT

PIECES = ["<unk>", "▁a", "b", "▁c", "d", ".", "▁e", "f"]  # + blank = vocab 9
SR = 16000


def _cfg(C):
    return C.TDTCTCConfig(
        encoder=C.EncoderConfig(mel_bins=80, subsampling_channels=8, hidden_size=16,
                                num_layers=1, num_heads=2, ffn_intermediate=32),
        prediction=C.PredictionConfig(vocab_size=9, pred_hidden=8, num_lstm_layers=1),
        joint=C.JointConfig(encoder_hidden=16, pred_hidden=8, joint_hidden=8, vocab_size=9),
        ctc_vocab_size=9,
    )


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    flat = {k: np.asarray(v) for k, v in RP.init_params(RP.tdt_ctc_spec(_cfg(RC)), seed=7).items()}
    vocab = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    vocab.write_text("\n".join(f"{p}\t0" for p in PIECES), encoding="utf-8")
    return flat, str(vocab)


def _pair(setup, with_vocab=True, **kw):
    """(reference, port) facades on the same weights and options."""
    from parakeet_tpu.transcribe import Transcriber

    flat, vocab = setup
    vocab = vocab if with_vocab else None
    return (Transcriber(None, vocab, _cfg(RC), params=flat, **kw),
            TT.Transcriber(None, vocab, _cfg(TC), params=flat, device="cpu", **kw))


def _clip(seed, seconds):
    rng = np.random.RandomState(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    gate = (np.sin(2 * np.pi * rng.uniform(1, 3) * t) > 0).astype(np.float32)
    return (0.3 * gate * np.sin(2 * np.pi * rng.uniform(200, 2000) * (1 + t) * t) + 0.05 * rng.randn(n)).astype(
        np.float32)


def _key(result):
    return ([(t.token_id, t.start_frame, t.end_frame) for t in result.timestamped_tokens], result.token_ids,
            result.text, [(w.word, w.start, w.end) for w in result.word_timestamps])


def _decoder(module, name):
    return getattr(module.Decoder, name)


@pytest.mark.parametrize("window_s, overlap_s", [(2.0, 1.0), (10.0, 2.0), (3.0, 0.0), (60.0, 10.0), (2.5, 0.7)])
def test_long_window_starts_equal_reference(setup, window_s, overlap_s):
    ref, port = _pair(setup, with_vocab=False)
    win, hop = int(window_s * SR), int((window_s - overlap_s) * SR)
    lengths = set(range(1, 6 * win, 997))
    for k in range(1, 12):  # around every hop boundary, slivers under 0.25 s included
        for d in (-1, 0, 1, SR // 8, SR // 4 - 1, SR // 4, SR // 4 + 1, SR // 2):
            lengths.add(max(1, k * hop + win - hop + d))
            lengths.add(max(1, k * hop + d))
    for n in sorted(lengths):
        assert port._long_window_starts(n, win, hop) == ref._long_window_starts(n, win, hop), n


@pytest.mark.parametrize("vocab", [True, False])
def test_merge_owns_words_as_the_reference(setup, vocab):
    """Synthetic window decodes, a word straddling each seam and windows
    that disagree: the same owned tokens with and without a vocab."""
    import parakeet_tpu.transcribe as R
    from parakeet_tpu.decode.timestamp import TimestampedToken as RTok
    from parakeet_tpu_torch.decode.timestamp import TimestampedToken as TTok

    ref, port = _pair(setup, with_vocab=vocab)
    rng = np.random.RandomState(3)
    n_samples, win, window_s, overlap_s = 7 * SR, 2 * SR, 2.0, 1.0
    starts = ref._long_window_starts(n_samples, win, SR)
    windows = []
    for _ in starts:
        frames = np.sort(rng.choice(25, size=8, replace=False))
        windows.append([(int(rng.randint(0, 8)), int(f), int(f) + int(rng.randint(0, 2)), float(rng.rand()))
                        for f in frames])
    got = port._merge_long_results(n_samples, starts, [TT.TranscribeResult(timestamped_tokens=[TTok(*t) for t in w])
                                                       for w in windows], win, window_s, overlap_s,
                                   TT.TimestampMode.WORDS)
    want = ref._merge_long_results(n_samples, starts, [R.TranscribeResult(timestamped_tokens=[RTok(*t) for t in w])
                                                       for w in windows], win, window_s, overlap_s,
                                   R.TimestampMode.WORDS)
    assert got.timestamped_tokens and _key(got) == _key(want)


@pytest.mark.parametrize("decoder", ["CTC", "TDT"])
@pytest.mark.parametrize("progress", [False, True])
def test_transcribe_long_identical(setup, decoder, progress):
    ref, port = _pair(setup)
    audio = _clip(1, 5.3)
    out = {}
    for name, tr, mod in (("ref", ref, _ref_module()), ("port", port, TT)):
        events = []
        kw = dict(on_progress=lambda *e: events.append(e), progress_batch=2) if progress else {}
        res = tr.transcribe_long(audio, _decoder(mod, decoder), window_s=2.0, overlap_s=1.0, **kw)
        out[name] = (_key(res), events)
    assert out["port"][0][0], "no tokens"
    assert out["port"] == out["ref"]


def test_transcribe_long_short_clip_decodes_densely(setup):
    ref, port = _pair(setup)
    audio = _clip(2, 1.5)
    got = port.transcribe_long(audio, TT.Decoder.TDT, window_s=2.0, overlap_s=1.0)
    want = ref.transcribe_long(audio, _decoder(_ref_module(), "TDT"), window_s=2.0, overlap_s=1.0)
    assert _key(got) == _key(want)


def _ref_module():
    import parakeet_tpu.transcribe as R

    return R


@pytest.mark.parametrize("max_batch", [192, 3])
def test_transcribe_long_batch_identical(setup, max_batch):
    ref, port = _pair(setup)
    clips = [_clip(3, 5.0), _clip(4, 3.5), _clip(5, 0.5)]
    out = {}
    for name, tr, mod in (("ref", ref, _ref_module()), ("port", port, TT)):
        events = []
        opts = mod.TranscribeOptions(mod.Decoder.TDT, on_progress=lambda *e: events.append(e))
        res = tr.transcribe_long_batch(clips, window_s=2.0, overlap_s=1.0, max_batch=max_batch, opts=opts)
        out[name] = ([_key(r) for r in res], events)
    assert all(k[0] for k in out["port"][0]), "a clip decoded to no tokens"
    assert out["port"] == out["ref"]
    windows = [e for e in out["port"][1] if e[0] == "window"]
    assert windows[-1] == ("window", 8, 8) and len(windows) == (1 if max_batch == 192 else 3)


@pytest.mark.parametrize("decoder", ["CTC", "TDT"])
def test_auto_route_mixed_batch_identical(setup, decoder):
    """Clips past long_threshold_s go through the windows, the short ones
    decode densely together, the order is kept, and every progress call
    is the reference's."""
    kw = dict(long_threshold_s=2.5, long_window_s=2.0, long_overlap_s=1.0)
    ref, port = _pair(setup, **kw)
    clips = [_clip(6, 1.0), _clip(7, 5.0), _clip(8, 0.7), _clip(9, 3.5)]
    out = {}
    for name, tr, mod in (("ref", ref, _ref_module()), ("port", port, TT)):
        events = []
        opts = mod.TranscribeOptions(_decoder(mod, decoder), on_progress=lambda *e: events.append(e))
        out[name] = ([_key(r) for r in tr.transcribe_batch(clips, opts)], events)
    assert out["port"] == out["ref"]
    keys = out["port"][0]
    assert keys[1][0] and keys[3][0], "long clips carry timestamps"
    assert not keys[0][0] and not keys[2][0], "short clips keep the caller's timestamps=False"


def test_dense_long_audio_decodes_any_length_in_one_call(setup):
    ref, port = _pair(setup, long_audio="dense", long_threshold_s=2.5)
    clips = [_clip(10, 5.0), _clip(11, 1.0)]
    calls = []
    real = port._transcribe_batch_dense
    port._transcribe_batch_dense = lambda s, o=None, **k: calls.append(len(s)) or real(s, o, **k)
    opts = TT.TranscribeOptions(TT.Decoder.TDT, timestamps=True)
    got = port.transcribe_batch(clips, opts)
    R = _ref_module()
    want = ref.transcribe_batch(clips, R.TranscribeOptions(R.Decoder.TDT, timestamps=True))
    assert calls == [2]
    assert [_key(g) for g in got] == [_key(w) for w in want]


def test_window_options_validated(setup):
    _, port = _pair(setup, with_vocab=False)
    audio = np.zeros(SR, np.float32)
    for kw in (dict(window_s=2.0, overlap_s=2.0), dict(window_s=2.0, overlap_s=-1.0)):
        with pytest.raises(ValueError, match="overlap_s"):
            port.transcribe_long(audio, **kw)
        with pytest.raises(ValueError, match="overlap_s"):
            port.transcribe_long_batch([audio], **kw)


def test_results_are_plain_dataclasses(setup):
    """The merged result is the facade's own TranscribeResult."""
    _, port = _pair(setup)
    res = port.transcribe_long(_clip(12, 4.0), TT.Decoder.CTC, window_s=2.0, overlap_s=1.0)
    assert dataclasses.is_dataclass(res) and isinstance(res, TT.TranscribeResult)


@pytest.mark.parametrize("with_pieces", [True, False])
def test_group_token_words_identical(with_pieces):
    """The merge's word grouping: ▁ starts a word, out-of-range ids continue
    one, pieces=None makes every token a word."""
    from parakeet_tpu.decode import timestamp as RTS
    from parakeet_tpu_torch.decode import timestamp as TTS

    rng = np.random.RandomState(5)
    toks = [(int(rng.randint(-1, 11)), i, i + 1, float(rng.rand())) for i in range(40)]
    pieces = PIECES if with_pieces else None
    got = TTS.group_token_words([TTS.TimestampedToken(*t) for t in toks], pieces)
    want = RTS.group_token_words([RTS.TimestampedToken(*t) for t in toks], pieces)
    assert [[dataclasses.astuple(t) for t in w] for w in got] == [[dataclasses.astuple(t) for t in w] for w in want]
    assert sum(len(w) for w in got) == len(toks) and (with_pieces or len(got) == len(toks))
