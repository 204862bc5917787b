"""The port's Sortformer diarization against the JAX reference on tiny
models: the post-norm transformer head, sortformer_forward and
sortformer_states, speaker_embeddings, probs_to_segments, the AOSC cache,
streaming diarize_chunk, and DiarizedTranscriber.transcribe / align (dense
and windowed). The same weights and features give probabilities within
1e-4, and segments and speakers identical except at frames whose
probability lies within 1e-4 of the threshold. Also the no-card
RuntimeError and what is not ported."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parakeet_tpu import config as RC
from parakeet_tpu import params as RP
from parakeet_tpu_torch import config as TC
from parakeet_tpu_torch import diarize as TD
from parakeet_tpu_torch.models import sortformer as TSF
from parakeet_tpu_torch.models import transformer as TTR
from parakeet_tpu_torch.params import Params as TParams
from parakeet_tpu_torch.params import params_from_numpy

PROB_ATOL = 1e-4
PIECES = ["<unk>", "▁a", "b", "▁c", "d", ".", "▁e", "f"]  # + blank = vocab 9


def _sf_cfg(C):
    """tests/test_sortformer.py's tiny Sortformer (128 mel, ReLU subsampling,
    xscaling, post-norm head)."""
    return C.SortformerConfig(
        nest_encoder=C.StreamingEncoderConfig(
            mel_bins=128, subsampling_channels=8, hidden_size=24, num_layers=2, num_heads=2,
            ffn_intermediate=32, conv_kernel_size=5, att_context_left=6, att_context_right=0,
            subsampling_activation="relu", xscaling=True,
        ),
        encoder_hidden=24,
        transformer_hidden=12,
        transformer=C.TransformerConfig(hidden_size=12, num_layers=2, num_heads=2, ffn_intermediate=24,
                                        pre_ln=False, has_final_norm=False),
        max_speakers=4,
    )


def _asr_cfg(C):
    return C.TDTCTCConfig(
        encoder=C.EncoderConfig(mel_bins=80, subsampling_channels=8, hidden_size=16, num_layers=1, num_heads=2,
                                ffn_intermediate=32),
        prediction=C.PredictionConfig(vocab_size=9, pred_hidden=8, num_lstm_layers=1),
        joint=C.JointConfig(encoder_hidden=16, pred_hidden=8, joint_hidden=8, vocab_size=9),
        ctc_vocab_size=9,
    )


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def sf_flat():
    flat = _np(RP.init_params(RP.sortformer_spec(_sf_cfg(RC)), seed=21))
    # larger speaker-head weights spread the probabilities away from 0.5
    rng = np.random.RandomState(22)
    flat["output_proj_.weight"] = (4 * rng.randn(*flat["output_proj_.weight"].shape)).astype(np.float32)
    flat["output_proj_.bias"] = rng.randn(4).astype(np.float32)
    return flat


@pytest.fixture(scope="module")
def models(sf_flat):
    from parakeet_tpu.models.sortformer import Sortformer as RSortformer

    return RSortformer(None, _sf_cfg(RC), params={k: jnp.asarray(v) for k, v in sf_flat.items()}), \
        TSF.Sortformer(None, _sf_cfg(TC), params=sf_flat, device="cpu")


def _feats(seed, t):
    return np.random.RandomState(seed).randn(1, t, 128).astype(np.float32)


def assert_segments_match(got_probs, ref_probs, got_segs, ref_segs, thr=0.5):
    """Probabilities within PROB_ATOL; active frames identical except where
    the reference lies within PROB_ATOL of the threshold; the segments
    identical when no frame lies there."""
    got_probs, ref_probs = np.asarray(got_probs), np.asarray(ref_probs)
    np.testing.assert_allclose(got_probs, ref_probs, atol=PROB_ATOL, rtol=0)
    near = np.abs(ref_probs - thr) < PROB_ATOL
    assert np.array_equal((got_probs > thr)[~near], (ref_probs > thr)[~near])
    if not near.any():
        assert [(s.speaker_id, s.start, s.end) for s in got_segs] == [
            (s.speaker_id, s.start, s.end) for s in ref_segs]


@pytest.mark.parametrize("pre_ln, final_norm", [(False, False), (True, True)])
def test_transformer_encode_matches_reference(pre_ln, final_norm):
    from parakeet_tpu.models.transformer import transformer_encode as r_encode
    from parakeet_tpu.params import Params as RParams

    cfgs = [C.TransformerConfig(hidden_size=12, num_layers=2, num_heads=2, ffn_intermediate=24, pre_ln=pre_ln,
                                has_final_norm=final_norm) for C in (RC, TC)]
    flat = _np(RP.init_params(RP.transformer_spec(cfgs[0], "transformer_"), seed=5))
    rng = np.random.RandomState(6)
    for k in flat:
        if "norm" in k:  # non-trivial norm parameters
            flat[k] = (flat[k] + 0.1 * rng.randn(*flat[k].shape)).astype(np.float32)
    x = rng.randn(2, 9, 12).astype(np.float32)
    valid = np.arange(9)[None] < np.array([9, 5])[:, None]
    mask = ~(valid[:, None, :] & valid[:, :, None])[:, None]
    for m in (None, mask):
        ref = r_encode(RParams({k: jnp.asarray(v) for k, v in flat.items()}).sub("transformer_"), cfgs[0],
                       jnp.asarray(x), None if m is None else jnp.asarray(m))
        got = TTR.transformer_encode(TParams(params_from_numpy(flat)).sub("transformer_"), cfgs[1],
                                     torch.from_numpy(x), None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_forward_states_and_segments_match_reference(models):
    from parakeet_tpu.models.sortformer import sortformer_states as r_states

    ref, port = models
    feats = _feats(1, 400)
    r_hidden, r_probs = r_states(ref.params, jnp.asarray(feats), cfg=ref.config)
    t_hidden, t_probs = TSF.sortformer_states(port.params, torch.from_numpy(feats), cfg=port.config)
    assert t_probs.shape == (1, 50, 4) and bool(((t_probs >= 0) & (t_probs <= 1)).all())
    np.testing.assert_allclose(t_hidden.numpy(), np.asarray(r_hidden), rtol=1e-4, atol=1e-4)
    probs = port.forward(feats)
    np.testing.assert_array_equal(probs.numpy(), t_probs.numpy())
    segs = port.diarize(feats)
    assert segs, "degenerate case: no speaker active"
    assert_segments_match(probs[0], np.asarray(ref.forward(feats))[0], segs, ref.diarize(feats))

    emb, active = port.extract_embeddings(torch.from_numpy(feats))
    r_emb, r_active = ref.extract_embeddings(feats)
    assert active == r_active and any(active)
    np.testing.assert_allclose(emb, r_emb, rtol=1e-4, atol=1e-4)


def test_host_helpers_match_reference():
    from parakeet_tpu.models import sortformer as RSF

    rng = np.random.RandomState(3)
    probs = rng.uniform(0, 1, (40, 4)).astype(np.float32)
    probs[10:20, 1] = 0.9
    probs[-3:, 2] = 0.8  # a run reaching the last frame
    hidden = rng.randn(40, 6).astype(np.float32)
    for thr in (0.5, 0.7):
        assert TSF.probs_to_segments(probs, thr) == [
            TSF.DiarizationSegment(s.speaker_id, s.start, s.end) for s in RSF.probs_to_segments(probs, thr)]
        emb, active = TSF.speaker_embeddings(hidden, probs, activity_threshold=thr, min_frames=3)
        r_emb, r_active = RSF.speaker_embeddings(hidden, probs, activity_threshold=thr, min_frames=3)
        np.testing.assert_array_equal(emb, r_emb)
        assert active == r_active
    aosc, r_aosc = TSF.AOSCCache(4), RSF.AOSCCache(4)
    for lo in (0, 20):
        aosc.update(probs[lo: lo + 20])
        r_aosc.update(probs[lo: lo + 20])
        assert aosc.speaker_order() == r_aosc.speaker_order()
    aosc.reset()
    assert aosc.speaker_order() == []


def test_diarize_chunk_matches_reference(models):
    """The streaming NEST encoder session (nest_encoder_ prefix) chunk by
    chunk: odd chunk sizes (a chunk under 8 frames gives no segments),
    segments and the arrival order as in the reference; reset_stream
    starts over."""
    from parakeet_tpu.models.sortformer import AOSCCache as RAOSC

    ref, port = models
    feats = _feats(2, 200)
    ref.reset_stream()
    port.reset_stream()
    aosc, r_aosc = TSF.AOSCCache(4), RAOSC(4)
    bounds = [0, 5, 21, 37, 53, 69, 120, 160, 200]
    n_segs = 0
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        segs = port.diarize_chunk(feats[:, lo:hi], aosc)
        r_segs = ref.diarize_chunk(feats[:, lo:hi], r_aosc)
        assert [(s.speaker_id, s.start, s.end) for s in segs] == [(s.speaker_id, s.start, s.end) for s in r_segs]
        n_segs += len(segs)
    assert n_segs and aosc.speaker_order() == r_aosc.speaker_order()
    assert port._stream_session.prefix == "nest_encoder_" and port._stream_session.frames_seen == 25
    port.reset_stream()
    assert port._stream_session is None


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(f"{p}\t0" for p in PIECES), encoding="utf-8")
    return str(path)


def _speech(seed, n):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000
    gate = (np.sin(2 * np.pi * rng.uniform(1, 3) * t) > 0).astype(np.float32)
    return (0.3 * gate * np.sin(2 * np.pi * rng.uniform(100, 1500) * (1 + t) * t)
            + 0.02 * rng.randn(n)).astype(np.float32)


def test_diarized_transcriber_matches_reference(sf_flat, vocab):
    """transcribe, align and windowed align: text, words, word times,
    segments and each word's speaker as the reference's."""
    import parakeet_tpu.diarize as RD

    asr_flat = _np(RP.init_params(RP.tdt_ctc_spec(_asr_cfg(RC)), seed=8))
    ref = RD.DiarizedTranscriber(None, None, vocab, _asr_cfg(RC), _sf_cfg(RC), asr_params=asr_flat,
                                 sortformer_params=sf_flat)
    port = TD.DiarizedTranscriber(None, None, vocab, _asr_cfg(TC), _sf_cfg(TC), asr_params=asr_flat,
                                  sortformer_params=sf_flat, device="cpu")
    audio = _speech(9, 40000)
    ref_res = ref.transcribe(audio)
    res = port.transcribe(audio)
    assert res.words, "degenerate case: no words"
    text = ref_res.text
    results = [(res, ref_res), (port.align(audio, text), ref.align(audio, text)),
               (port.align(audio, text, window_s=1.5, overlap_s=0.5),
                ref.align(audio, text, window_s=1.5, overlap_s=0.5))]
    for got, want in results:
        assert got.text == want.text
        assert [(w.word, w.start, w.end) for w in got.word_timestamps] == [
            (w.word, w.start, w.end) for w in want.word_timestamps]
        assert [(s.speaker_id, s.start, s.end) for s in got.segments] == [
            (s.speaker_id, s.start, s.end) for s in want.segments]
        assert [(w.word, w.speaker_id) for w in got.words] == [(w.word, w.speaker_id) for w in want.words]
    assert any(w.speaker_id >= 0 for w in res.words)
    assert port.to_gpu() is None


def test_diarize_transcription_rule():
    from parakeet_tpu_torch.decode.timestamp import WordTimestamp

    words = [WordTimestamp("a", 0.0, 1.0, 0.9), WordTimestamp("b", 2.0, 3.0, 0.8), WordTimestamp("c", 5.0, 6.0)]
    segs = [TSF.DiarizationSegment(0, 0.0, 2.4), TSF.DiarizationSegment(1, 2.2, 3.0),
            TSF.DiarizationSegment(1, 0.5, 0.6)]
    out = TD.diarize_transcription(words, segs)
    assert [(w.word, w.speaker_id) for w in out] == [("a", 0), ("b", 1), ("c", -1)]
    assert out[0].confidence == 0.9


def test_no_card_raises_and_unported_paths(monkeypatch, sf_flat):
    # the training forward: pre-sigmoid logits of the inference probabilities
    feats = torch.from_numpy(np.random.RandomState(23).randn(1, 96, 128).astype(np.float32))
    params = {k: torch.from_numpy(v) for k, v in sf_flat.items()}
    logits = TSF.sortformer_logits(params, feats, cfg=_sf_cfg(TC))
    probs = TSF.sortformer_forward(params, feats, cfg=_sf_cfg(TC))
    torch.testing.assert_close(torch.sigmoid(logits), probs, rtol=1e-6, atol=1e-6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **kw: TSF.Sortformer(None, _sf_cfg(TC), params=sf_flat, **kw),
                 lambda **kw: TD.DiarizedTranscriber(None, None, None, _asr_cfg(TC), _sf_cfg(TC),
                                                     sortformer_params=sf_flat, **kw)):
        for kw in ({}, dict(device="cuda:0")):
            with pytest.raises(RuntimeError, match='device="cpu"'):
                make(**kw)
        assert make(device="cpu").device == torch.device("cpu")


def test_diarization_names_exported():
    import parakeet_tpu_torch as pkg

    assert pkg.Sortformer is TSF.Sortformer and pkg.DiarizedTranscriber is TD.DiarizedTranscriber
    cfg = pkg.make_sortformer_117m_config()
    assert (cfg.nest_encoder.mel_bins, cfg.nest_encoder.num_layers, cfg.nest_encoder.xscaling,
            cfg.transformer.num_layers, cfg.transformer.pre_ln) == (128, 17, True, 18, False)
