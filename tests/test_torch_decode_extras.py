"""The port's decode extras against the JAX package on the same seeded
inputs: the phrase-boost trie and the boosted TDT, RNNT and CTC greedy
decodes, the transducer beam (n-best tokens, frames and scores; beam 1 is
greedy), the CTC prefix beam with and without an LM, the ARPA n-gram LM
and n-best rescoring, the neural LM, keyword spotting and the hotword
detector, SRT and VTT subtitles, WER and CER, and boost, beam and LM
options through the Transcriber."""

from dataclasses import astuple

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parakeet_tpu import config as RC
from parakeet_tpu import params as RP
from parakeet_tpu.text.tokenizer import Tokenizer as RTokenizer
from parakeet_tpu_torch import config as TC
from parakeet_tpu_torch.params import params_from_numpy
from parakeet_tpu_torch.text.tokenizer import Tokenizer as TTokenizer

SCORE_RTOL = 1e-5  # beam path scores and LM scores
VOCAB, PRED_H, ENC_H, JOINT_H = 12, 16, 20, 16
BLANK = VOCAB - 1
PIECES = ["<unk>", "▁a", "b", "▁c", "d", ".", "▁e", "f"]  # + blank = vocab 9

ARPA = """\\data\\
ngram 1=10
ngram 2=4

\\1-grams:
-1.0 <unk>
-0.9 <s> -0.30
-0.5 ▁a -0.20
-0.7 b -0.10
-0.8 ▁c -0.25
-1.2 d
-1.1 . -0.05
-1.3 ▁e
-1.4 f
-1.5 </s>

\\2-grams:
-0.1 <s> ▁a
-0.4 ▁a b
-0.6 b ▁c
-0.3 ▁c d

\\end\\
"""


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(f"{p}\t0" for p in PIECES), encoding="utf-8")
    return str(path)


def _model(seed, is_tdt=True, lstm_layers=1, durations=(0, 1, 2, 3, 4)):
    pcfg = RC.PredictionConfig(vocab_size=VOCAB, pred_hidden=PRED_H, num_lstm_layers=lstm_layers)
    jcfg = RC.JointConfig(encoder_hidden=ENC_H, pred_hidden=PRED_H, joint_hidden=JOINT_H, vocab_size=VOCAB)
    spec = RP.prediction_spec(pcfg, "prediction_")
    if is_tdt:
        spec.update(RP.tdt_joint_spec(jcfg, len(durations), "tdt_joint_"))
    else:
        spec.update(RP.rnnt_joint_spec(jcfg, "joint_"))
    flat = {k: np.asarray(v) for k, v in RP.init_params(spec, seed=seed).items()}
    rng = np.random.RandomState(seed + 1)
    for k in flat:  # a non-zero merged LSTM bias and joint biases
        if k.endswith(".bias"):
            flat[k] = (0.3 * rng.randn(*flat[k].shape)).astype(np.float32)
    return flat


def _enc(seed, b=3, t=24):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, ENC_H) * 2).astype(np.float32), np.asarray([t, t - 5, t - 11])


def _spans(ts):
    return [(t.token_id, t.start_frame, t.end_frame) for t in ts]


def _same_ts(got, ref):
    assert _spans(got) == _spans(ref)
    np.testing.assert_allclose([t.confidence for t in got], [t.confidence for t in ref], rtol=1e-5)


def _tries(phrases):
    from parakeet_tpu.decode.phrase_boost import ContextTrie as RTrie
    from parakeet_tpu_torch.decode.phrase_boost import ContextTrie as TTrie

    ref, port = RTrie(), TTrie()
    for ids in phrases:
        ref.insert(ids)
        port.insert(ids)
    return ref, port


PHRASES = [[3, 5, 7], [3, 6], [8, 8, 2], [10]]


# ─── phrase boosting ─────────────────────────────────────────────────────────


def test_trie_arrays_and_set_semantics(vocab):
    ref, port = _tries(PHRASES)
    assert port.num_nodes == ref.num_nodes and not port.empty()
    np.testing.assert_array_equal(port.to_arrays(VOCAB), ref.to_arrays(VOCAB))
    np.testing.assert_array_equal(port.to_arrays(6), ref.to_arrays(6))  # ids past the vocab dropped
    states = {0, 1, 4}
    assert port.get_boosted_tokens(states) == ref.get_boosted_tokens(states)
    for tok in (3, 5, 6, 9):
        assert port.advance(states, tok) == ref.advance(states, tok)
    trans, active0, score = port.device_boost(VOCAB, 2, 2.5)
    r_trans, r_active0, r_score = ref.device_boost(VOCAB, 2, 2.5)
    np.testing.assert_array_equal(trans.numpy(), np.asarray(r_trans))
    np.testing.assert_array_equal(active0.numpy(), np.asarray(r_active0))
    assert score == r_score
    built = _tries([])[1]
    built.build(["▁a b", "▁c d .", "zzz"], TTokenizer(vocab))
    r_built = _tries([])[0]
    r_built.build(["▁a b", "▁c d .", "zzz"], RTokenizer(vocab))
    np.testing.assert_array_equal(built.to_arrays(9), r_built.to_arrays(9))
    assert _tries([])[1].empty()


@pytest.mark.parametrize("is_tdt", [True, False], ids=["tdt", "rnnt"])
def test_boosted_transducer_greedy_matches_reference(is_tdt):
    """Tokens, frames, unboosted confidences and the final trie states equal
    the JAX loop's; the boost changes the decode."""
    from parakeet_tpu.decode.transducer import transducer_greedy_decode as r_decode
    from parakeet_tpu_torch.decode.transducer import transducer_greedy_decode as t_decode

    durations = (0, 1, 2, 3, 4) if is_tdt else (0,)
    flat = _model(21, is_tdt, durations=durations)
    enc, lens = _enc(22)
    ref_trie, trie = _tries(PHRASES)
    kw = dict(pred_hidden=PRED_H, num_lstm_layers=1, durations=durations, blank_id=BLANK, is_tdt=is_tdt,
              joint_prefix="tdt_joint_" if is_tdt else "joint_", enc_lengths=lens)
    ref = r_decode({k: jnp.asarray(v) for k, v in flat.items()}, jnp.asarray(enc),
                   boost=ref_trie.device_boost(VOCAB, 3, 2.0), **kw)
    got = t_decode(params_from_numpy(flat), torch.from_numpy(enc), boost=trie.device_boost(VOCAB, 3, 2.0), **kw)
    plain = t_decode(params_from_numpy(flat), torch.from_numpy(enc), **kw)
    assert got.tokens == ref.tokens
    for g, r in zip(got.timestamped, ref.timestamped):
        _same_ts(g, r)
    np.testing.assert_array_equal(got.boost_active.numpy(), np.asarray(ref.boost_active))
    assert got.tokens != plain.tokens, "degenerate case: the boost changed nothing"
    assert plain.boost_active is None


@pytest.mark.parametrize("timestamps", [False, True])
def test_boosted_ctc_greedy_matches_reference(timestamps):
    from parakeet_tpu.decode import phrase_boost as RPB
    from parakeet_tpu_torch.decode import phrase_boost as TPB

    rng = np.random.RandomState(31)
    lp = torch.log_softmax(torch.from_numpy(rng.randn(3, 40, VOCAB).astype(np.float32) * 2), -1).numpy()
    lens = [40, 33, 17]
    ref_trie, trie = _tries(PHRASES)
    name = "ctc_greedy_decode_with_timestamps_boosted" if timestamps else "ctc_greedy_decode_boosted"
    ref = getattr(RPB, name)(jnp.asarray(lp), ref_trie, 1.5, BLANK, lens)
    got = getattr(TPB, name)(torch.from_numpy(lp), trie, 1.5, BLANK, lens)
    plain = getattr(TPB, name)(torch.from_numpy(lp), trie, 0.0, BLANK, lens)
    if timestamps:
        for g, r in zip(got, ref):
            _same_ts(g, r)
        assert [_spans(g) for g in got] != [_spans(p) for p in plain]
    else:
        assert got == ref and got != plain
    with pytest.raises(ValueError, match="boost_score must be >= 0"):
        getattr(TPB, name)(torch.from_numpy(lp), trie, -1.0, BLANK, lens)


# ─── beam search ─────────────────────────────────────────────────────────────


@pytest.mark.parametrize("is_tdt, beam", [(True, 1), (True, 4), (False, 1), (False, 4), (True, 8)],
                         ids=["tdt-1", "tdt-4", "rnnt-1", "rnnt-4", "tdt-8"])
def test_transducer_beam_matches_reference(is_tdt, beam):
    """n-best tokens, emission frames and raw log-probs identical, path
    scores within SCORE_RTOL; beam 1 is the greedy decode."""
    from parakeet_tpu.decode.beam_transducer import transducer_beam_decode as r_beam
    from parakeet_tpu_torch.decode.beam_transducer import transducer_beam_decode as t_beam
    from parakeet_tpu_torch.decode.transducer import transducer_greedy_decode as t_decode

    durations = (0, 1, 2, 3, 4) if is_tdt else (0,)
    flat = _model(41, is_tdt, lstm_layers=2, durations=durations)
    enc, lens = _enc(42)
    kw = dict(num_lstm_layers=2, durations=durations, blank_id=BLANK, is_tdt=is_tdt,
              joint_prefix="tdt_joint_" if is_tdt else "joint_", enc_lengths=lens, beam_size=beam, n_best=beam)
    ref = r_beam({k: jnp.asarray(v) for k, v in flat.items()}, jnp.asarray(enc), **kw)
    got = t_beam(params_from_numpy(flat), torch.from_numpy(enc), **kw)
    assert [len(h) for h in got] == [len(h) for h in ref]
    for g_list, r_list in zip(got, ref):
        for g, r in zip(g_list, r_list):
            assert g.tokens == r.tokens and g.frames == r.frames
            np.testing.assert_allclose(g.token_logprobs, r.token_logprobs, rtol=SCORE_RTOL, atol=1e-6)
            np.testing.assert_allclose(g.score, r.score, rtol=SCORE_RTOL)
    assert sum(len(h[0].tokens) for h in got) > 5, "degenerate case: few tokens"
    if beam == 1:
        greedy = t_decode(params_from_numpy(flat), torch.from_numpy(enc), pred_hidden=PRED_H,
                          **{k: v for k, v in kw.items() if k not in ("beam_size", "n_best")})
        assert [h[0].tokens for h in got] == greedy.tokens
        assert [h[0].frames for h in got] == [[t.start_frame for t in ts] for ts in greedy.timestamped]


def _ngram(pkg):
    from importlib import import_module

    return import_module(f"{pkg}.text.ngram_lm").NgramLM.from_arpa(ARPA)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "lm"])
def test_ctc_beam_matches_reference(fused):
    from parakeet_tpu.decode.ctc_beam import ctc_beam_search as r_search
    from parakeet_tpu_torch.decode.ctc_beam import ctc_beam_search as t_search

    rng = np.random.RandomState(51)
    lp = torch.log_softmax(torch.from_numpy(rng.randn(30, 9).astype(np.float32) * 2), -1).numpy()
    kw = dict(beam_size=6, n_best=4, token_top_k=5)
    r_kw, t_kw = dict(kw), dict(kw)
    if fused:
        r_kw.update(lm=_ngram("parakeet_tpu").bind(PIECES), lm_weight=0.7, length_bonus=0.5)
        t_kw.update(lm=_ngram("parakeet_tpu_torch").bind(PIECES), lm_weight=0.7, length_bonus=0.5)
    ref, got = r_search(lp, 8, **r_kw), t_search(lp, 8, **t_kw)
    assert [(h.tokens, h.frames) for h in got] == [(h.tokens, h.frames) for h in ref]
    np.testing.assert_allclose([h.score for h in got], [h.score for h in ref], rtol=SCORE_RTOL)
    if fused:
        plain = t_search(lp, 8, **kw)
        assert [h.score for h in plain] != [h.score for h in got]


# ─── language models ─────────────────────────────────────────────────────────


def test_arpa_parse_scores_and_rescoring():
    from parakeet_tpu.text import ngram_lm as RN
    from parakeet_tpu_torch.text import ngram_lm as TN

    ref, port = _ngram("parakeet_tpu"), _ngram("parakeet_tpu_torch")
    assert port.order == ref.order == 2
    assert port.probs == ref.probs and port.backoffs == ref.backoffs
    for ctx, tok in [(("<s>",), "▁a"), (("▁a",), "▁c"), (("zz",), "b"), ((), "qq"), (("d",), "</s>")]:
        assert port.score(ctx, tok) == ref.score(ctx, tok)
    seq = ["▁a", "b", "▁c", "d", "."]
    for kw in (dict(), dict(eos=True), dict(bos=False)):
        assert port.score_sequence(seq, **kw) == ref.score_sequence(seq, **kw)
    bound, r_bound = port.bind(PIECES), ref.bind(PIECES)
    assert bound.advance(bound.start_state(), 3) == r_bound.advance(r_bound.start_state(), 3)
    assert bound.score_sequence([1, 2, 3, 99]) == r_bound.score_sequence([1, 2, 3, 99])

    class H:
        def __init__(self, tokens, score):
            self.tokens, self.score = tokens, score

    hyps = [H([1, 2], -3.0), H([3, 4, 5], -2.5), H([6, 7], -2.9), H([], -4.0)]
    for w in (0.0, 0.5, 2.0):
        got = TN.rescore_nbest(hyps, bound, w, eos=True)
        want = RN.rescore_nbest(hyps, r_bound, w, eos=True)
        assert [h.tokens for h in got] == [h.tokens for h in want]
    with pytest.raises(ValueError, match="no n-gram sections"):
        TN.NgramLM.from_arpa("hello\nworld\n")


def test_neural_lm_matches_reference(tmp_path):
    """NeuralLM.random draws the JAX package's parameters; save and load
    round-trip across the two packages; batch, sequence and incremental
    scores within SCORE_RTOL; training raises."""
    from parakeet_tpu.text import neural_lm as RNL
    from parakeet_tpu_torch.text import neural_lm as TNL

    kw = dict(vocab_size=9, hidden=32, num_layers=2, num_heads=4, ffn_intermediate=64, max_len=32)
    ref, port = RNL.NeuralLM.random(RNL.NeuralLMConfig(**kw), seed=3), TNL.NeuralLM.random(
        TNL.NeuralLMConfig(**kw), seed=3, device="cpu")
    assert port.params.keys() == ref.params.keys()
    for k in ref.params:
        np.testing.assert_array_equal(port.params[k].numpy(), np.asarray(ref.params[k]), err_msg=k)
    seqs = [[1, 2, 3], [], [4, 5, 6, 7, 8, 2, 1, 3, 5, 7, 2, 4, 6, 1, 2, 3, 4], [12]]
    for eos in (False, True):
        np.testing.assert_allclose(port.score_batch(seqs, eos=eos), ref.score_batch(seqs, eos=eos), rtol=SCORE_RTOL)
    np.testing.assert_allclose(port.score_sequence([3, 1]), ref.score_sequence([3, 1]), rtol=SCORE_RTOL)
    st, r_st = port.start_state(), ref.start_state()
    for tok in (1, 4, 2):
        (st, lp), (r_st, r_lp) = port.advance(st, tok), ref.advance(r_st, tok)
        assert st == r_st
        np.testing.assert_allclose(lp, r_lp, rtol=SCORE_RTOL)
    port.save(tmp_path / "port.safetensors")
    loaded = RNL.NeuralLM.load(tmp_path / "port.safetensors")
    assert loaded.cfg == ref.cfg
    ref.save(tmp_path / "ref.safetensors")
    back = TNL.NeuralLM.load(tmp_path / "ref.safetensors", device="cpu")
    assert back.cfg == port.cfg
    np.testing.assert_allclose(back.score_batch(seqs), ref.score_batch(seqs), rtol=SCORE_RTOL)
    assert (tmp_path / "port.safetensors").read_bytes() == (tmp_path / "ref.safetensors").read_bytes()
    # training runs on the card unless given the CPU (held to the reference
    # in tests/test_torch_train.py)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TNL.train_neural_lm([[1, 2]], port.cfg, steps=1)
    assert np.isfinite(TNL.train_neural_lm([[1, 2]], port.cfg, steps=1, device="cpu").final_loss)


# ─── keyword spotting ────────────────────────────────────────────────────────


def test_keyword_log_odds_matches_reference():
    from parakeet_tpu.decode.keyword import keyword_log_odds as r_odds
    from parakeet_tpu_torch.decode.keyword import keyword_log_odds as t_odds

    rng = np.random.RandomState(61)
    lp = torch.log_softmax(torch.from_numpy(rng.randn(50, 10).astype(np.float32) * 3), -1).numpy()
    for kw in ([2, 5], [4, 4, 1], [7], []):
        assert t_odds(lp, kw, 9) == r_odds(lp, kw, 9)
    with pytest.raises(ValueError, match="non-blank"):
        t_odds(lp, [9], 9)


def _tiny_transcriber_cfg(C):
    return C.TDTCTCConfig(
        encoder=C.EncoderConfig(mel_bins=80, subsampling_channels=8, hidden_size=32, num_layers=2, num_heads=4,
                                ffn_intermediate=64),
        prediction=C.PredictionConfig(vocab_size=9, pred_hidden=16, num_lstm_layers=1),
        joint=C.JointConfig(encoder_hidden=32, pred_hidden=16, joint_hidden=16, vocab_size=9),
        ctc_vocab_size=9,
    )


@pytest.fixture(scope="module")
def transcribers(vocab):
    from parakeet_tpu.transcribe import Transcriber
    from parakeet_tpu_torch.transcribe import Transcriber as TTranscriber

    flat = {k: np.asarray(v) for k, v in RP.init_params(RP.tdt_ctc_spec(_tiny_transcriber_cfg(RC)), seed=6).items()}
    return (Transcriber(None, vocab, _tiny_transcriber_cfg(RC), params=flat),
            TTranscriber(None, vocab, _tiny_transcriber_cfg(TC), params=flat, device="cpu"))


def _waves(seed, sizes=(16000, 11000, 23456)):
    rng = np.random.RandomState(seed)
    out = []
    for n in sizes:
        t = np.arange(n) / 16000
        f = rng.uniform(100, 3000) * (1 + 2 * t)
        gate = (np.sin(2 * np.pi * rng.uniform(1, 4) * t) > 0).astype(np.float32)
        out.append((0.3 * gate * np.sin(2 * np.pi * f * t) + 0.02 * rng.randn(n)).astype(np.float32))
    return out


def test_hotword_detector_matches_reference(transcribers):
    """The same pushes give the same triggers (a threshold every window
    clears, so each evaluated hop fires and rearms), scores within 1e-4."""
    from parakeet_tpu.decode.keyword import HotwordDetector as RDet
    from parakeet_tpu_torch.decode.keyword import HotwordDetector as TDet

    ref_tr, tr = transcribers
    ref = RDet(ref_tr, "▁a b", threshold=-1e9, window_s=1.0, hop_s=0.25)
    port = TDet(tr, "▁a b", threshold=-1e9, window_s=1.0, hop_s=0.25)
    assert port.keyword == ref.keyword == [1, 2]
    audio = np.concatenate(_waves(71))
    fired = []
    for lo in range(0, 24000, 3000):
        got, want = port.feed(audio[lo: lo + 3000]), ref.feed(audio[lo: lo + 3000])
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_allclose(got, want, rtol=1e-4)
            fired.append(got)
    assert len(fired) >= 3
    np.testing.assert_allclose(port.score_window(audio[:16000]), ref.score_window(audio[:16000]), rtol=1e-4)
    with pytest.raises(ValueError, match="tokenizes to nothing"):
        TDet(tr, "")


# ─── subtitles and metrics ───────────────────────────────────────────────────


def test_subtitles_match_reference():
    from parakeet_tpu.decode.timestamp import WordTimestamp as RW
    from parakeet_tpu.text import subtitles as RS
    from parakeet_tpu_torch.decode.timestamp import WordTimestamp as TW
    from parakeet_tpu_torch.text import subtitles as TS

    words = [("Hello", 0.0, 0.4), ("there,", 0.5, 0.9), ("general", 1.0, 1.3), ("Kenobi.", 1.4, 2.0),
             ("A", 4.0, 4.1), ("supercalifragilisticexpialidocious", 4.2, 5.5), ("word", 5.6, 5.8),
             ("that", 5.9, 6.2), ("runs", 6.3, 9.9), ("", 10.0, 10.1), ("on", 10.5, 10.6)]
    for kw in (dict(), dict(max_line_chars=12, max_lines=1, max_duration=3.0, min_duration=1.0)):
        for fn in ("format_srt", "format_vtt"):
            got = getattr(TS, fn)([TW(*w) for w in words], **kw)
            assert got == getattr(RS, fn)([RW(*w) for w in words], **kw)
            assert "-->" in got
    assert TS.format_srt([]) == RS.format_srt([]) and TS.format_vtt([]) == RS.format_vtt([])


def test_wer_cer_match_reference():
    from parakeet_tpu import metrics as RM
    from parakeet_tpu_torch import metrics as TM

    pairs = [("the cat sat on the mat", "the cat sat on mat"), ("a b c", "a x c d"), ("", "extra words"),
             ("Hello World", "hello world"), ("one two", "")]
    for ref, hyp in pairs:
        assert astuple(TM.word_error_rate(ref, hyp)) == astuple(RM.word_error_rate(ref, hyp))
        assert TM.character_error_rate(ref, hyp) == RM.character_error_rate(ref, hyp)
    assert astuple(TM.corpus_wer(pairs)) == astuple(RM.corpus_wer(pairs))
    assert str(TM.corpus_wer(pairs)) == str(RM.corpus_wer(pairs))


# ─── through the Transcriber ─────────────────────────────────────────────────


def _lm(pkg, kind, tokenizer):
    if kind == "ngram":
        return _ngram(pkg).bind(tokenizer.pieces)
    from importlib import import_module

    nl = import_module(f"{pkg}.text.neural_lm")
    cfg = nl.NeuralLMConfig(vocab_size=9, hidden=32, num_layers=1, num_heads=4, ffn_intermediate=64, max_len=64)
    return nl.NeuralLM.random(cfg, seed=4) if pkg == "parakeet_tpu" else nl.NeuralLM.random(cfg, seed=4, device="cpu")


@pytest.mark.parametrize("case", ["tdt-boost", "ctc-boost", "tdt-beam", "tdt-beam-ngram", "tdt-beam-neural",
                                  "ctc-beam", "ctc-beam-ngram"])
def test_transcriber_options_match_reference(transcribers, case):
    """boost_phrases, beam_size and lm through transcribe_batch: tokens,
    frames and word times identical to the JAX Transcriber's."""
    from parakeet_tpu.transcribe import Decoder, TranscribeOptions
    from parakeet_tpu_torch.transcribe import Decoder as TDecoder
    from parakeet_tpu_torch.transcribe import TranscribeOptions as TOptions

    ref_tr, tr = transcribers
    dec, rest = case.split("-", 1)
    kw = dict(timestamps=True)
    if rest == "boost":
        kw.update(boost_phrases=["▁a b", "▁c d", "f"], boost_score=2.0)
    else:
        kw.update(beam_size=4)
    r_kw, t_kw = dict(kw), dict(kw)
    for lm_kind in ("ngram", "neural"):
        if rest.endswith(lm_kind):
            r_kw.update(lm=_lm("parakeet_tpu", lm_kind, ref_tr.tokenizer), lm_weight=0.6)
            t_kw.update(lm=_lm("parakeet_tpu_torch", lm_kind, tr.tokenizer), lm_weight=0.6)
    waves = _waves(81)
    ref = ref_tr.transcribe_batch(waves, TranscribeOptions(getattr(Decoder, dec.upper()), **r_kw))
    got = tr.transcribe_batch(waves, TOptions(getattr(TDecoder, dec.upper()), **t_kw))
    assert sum(len(r.token_ids) for r in ref) > 3, "degenerate case: few tokens"
    for g, r in zip(got, ref):
        assert g.token_ids == r.token_ids and _spans(g.timestamped_tokens) == _spans(r.timestamped_tokens)
        np.testing.assert_allclose([t.confidence for t in g.timestamped_tokens],
                                   [t.confidence for t in r.timestamped_tokens], rtol=1e-4)
        assert g.text == r.text
        assert [(w.word, w.start, w.end) for w in g.word_timestamps] == [
            (w.word, w.start, w.end) for w in r.word_timestamps]
