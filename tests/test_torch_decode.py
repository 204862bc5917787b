"""The port's prediction LSTM, joints, greedy TDT/RNNT decode and CTC decode
against the JAX reference on fixed encoder outputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parakeet_tpu import config as RC
from parakeet_tpu import params as RP
from parakeet_tpu.decode.transducer import transducer_greedy_decode as r_decode
from parakeet_tpu.models import ctc as RCTC
from parakeet_tpu.models import rnnt as RR
from parakeet_tpu.ops import lstm as RL
from parakeet_tpu.params import Params as RParams
from parakeet_tpu_torch.decode.transducer import transducer_greedy_decode as t_decode
from parakeet_tpu_torch.models import ctc as TCTC
from parakeet_tpu_torch.models import rnnt as TR
from parakeet_tpu_torch.ops import lstm as TL
from parakeet_tpu_torch.params import Params as TParams
from parakeet_tpu_torch.params import params_from_numpy

VOCAB, PRED_H, ENC_H, JOINT_H = 12, 16, 20, 16
BLANK = VOCAB - 1


def _model(seed, lstm_layers=1, durations=(0, 1, 2, 3, 4), is_tdt=True):
    pcfg = RC.PredictionConfig(vocab_size=VOCAB, pred_hidden=PRED_H, num_lstm_layers=lstm_layers)
    jcfg = RC.JointConfig(encoder_hidden=ENC_H, pred_hidden=PRED_H, joint_hidden=JOINT_H, vocab_size=VOCAB)
    spec = RP.prediction_spec(pcfg, "prediction_")
    if is_tdt:
        spec.update(RP.tdt_joint_spec(jcfg, len(durations), "tdt_joint_"))
    else:
        spec.update(RP.rnnt_joint_spec(jcfg, "joint_"))
    flat = {k: np.asarray(v) for k, v in RP.init_params(spec, seed=seed).items()}
    # a non-zero merged LSTM bias and joint biases exercise every term
    rng = np.random.RandomState(seed + 1)
    for k in flat:
        if k.endswith(".bias"):
            flat[k] = (0.3 * rng.randn(*flat[k].shape)).astype(np.float32)
    return flat


def test_lstm_step_matches_reference():
    flat = _model(0, lstm_layers=2)
    rng = np.random.RandomState(3)
    x = rng.randn(4, PRED_H).astype(np.float32)
    state = rng.randn(2, 2, 4, PRED_H).astype(np.float32)
    rp = RParams({k: jnp.asarray(v) for k, v in flat.items()}).sub("prediction_").sub("lstm_")
    tp = TParams(params_from_numpy(flat)).sub("prediction_").sub("lstm_")
    r_out, r_state = RL.lstm_step(rp, jnp.asarray(x), jnp.asarray(state), 2)
    t_out, t_state = TL.lstm_step(tp, torch.from_numpy(x), torch.from_numpy(state), 2)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(r_out), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t_state.numpy(), np.asarray(r_state), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("is_tdt", [True, False])
def test_prediction_and_joint_match_reference(is_tdt):
    flat = _model(1, is_tdt=is_tdt)
    prefix = "tdt_joint_" if is_tdt else "joint_"
    rroot = RParams({k: jnp.asarray(v) for k, v in flat.items()})
    troot = TParams(params_from_numpy(flat))
    tokens = np.array([BLANK, 0, 5, 3])
    state = np.zeros((1, 2, 4, PRED_H), np.float32)
    r_pred, _ = RR.prediction_step(rroot.sub("prediction_"), jnp.asarray(tokens), jnp.asarray(state), 1)
    t_pred, _ = TR.prediction_step(troot.sub("prediction_"), torch.from_numpy(tokens), torch.from_numpy(state), 1)
    np.testing.assert_allclose(t_pred.numpy(), np.asarray(r_pred), rtol=1e-5, atol=1e-6)

    enc = np.random.RandomState(2).randn(4, ENC_H).astype(np.float32)
    r_pre = RR.joint_encoder_projection(rroot.sub(prefix), jnp.asarray(enc))
    t_pre = TR.joint_encoder_projection(troot.sub(prefix), torch.from_numpy(enc))
    np.testing.assert_allclose(t_pre.numpy(), np.asarray(r_pre), rtol=1e-5, atol=1e-6)
    if is_tdt:
        r_out = RR.tdt_joint_precomputed(rroot.sub(prefix), r_pre, r_pred)
        t_out = TR.tdt_joint_precomputed(troot.sub(prefix), t_pre, t_pred)
    else:
        r_out = (RR.rnnt_joint_precomputed(rroot.sub(prefix), r_pre, r_pred),)
        t_out = (TR.rnnt_joint_precomputed(troot.sub(prefix), t_pre, t_pred),)
    for t, r in zip(t_out, r_out):
        np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


def _decode_both(flat, enc, lengths, **kw):
    ref = r_decode({k: jnp.asarray(v) for k, v in flat.items()}, jnp.asarray(enc),
                   pred_hidden=PRED_H, enc_lengths=lengths, **kw)
    got = t_decode(params_from_numpy(flat), torch.from_numpy(enc), pred_hidden=PRED_H,
                   enc_lengths=lengths, **kw)
    _assert_same_decode(got, ref)
    return got


def _assert_same_decode(got, ref):
    """Two greedy decodes agree (either package's result, or one carried
    back from a rank): tokens, start and end frames identical, confidences
    within rtol 1e-5, the last token and the boost state equal, the LSTM
    state within rtol 1e-5, atol 1e-6."""
    assert got.tokens == ref.tokens
    assert len(got.timestamped) == len(ref.timestamped)
    for g_item, r_item in zip(got.timestamped, ref.timestamped):
        assert [(t.token_id, t.start_frame, t.end_frame) for t in g_item] == [
            (t.token_id, t.start_frame, t.end_frame) for t in r_item]
        np.testing.assert_allclose([t.confidence for t in g_item], [t.confidence for t in r_item],
                                   rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(got.last_token), np.asarray(ref.last_token))
    np.testing.assert_allclose(np.asarray(got.lstm_state), np.asarray(ref.lstm_state), rtol=1e-5, atol=1e-6)
    assert (got.boost_active is None) == (ref.boost_active is None)
    if ref.boost_active is not None:
        np.testing.assert_array_equal(np.asarray(got.boost_active), np.asarray(ref.boost_active))


CASES = {
    # mixed enc_lengths, the 110m durations
    "tdt_mixed_lengths": dict(seed=0, lengths=[25, 20, 7], kw=dict(durations=(0, 1, 2, 3, 4))),
    # two LSTM layers, no clamp of end frames
    "tdt_two_layers_noclamp": dict(seed=4, lengths=[18, 18, 3], layers=2,
                                   kw=dict(durations=(0, 1, 2, 3, 4), clamp_end=False)),
    # every emission is zero-duration: max_symbols forces t += 1
    "tdt_max_symbols": dict(seed=5, lengths=[12, 9, 4], kw=dict(durations=(0,), max_symbols=3)),
    # RNNT: blank advances one frame, non-blank stays
    "rnnt": dict(seed=2, lengths=[25, 11, 1], is_tdt=False, kw=dict(durations=(0,))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_decode_matches_reference(case):
    c = CASES[case]
    is_tdt = c.get("is_tdt", True)
    layers = c.get("layers", 1)
    flat = _model(c["seed"], layers, c["kw"]["durations"], is_tdt)
    enc = np.random.RandomState(c["seed"] + 100).randn(3, 25, ENC_H).astype(np.float32) * 2
    got = _decode_both(flat, enc, c["lengths"], num_lstm_layers=layers, blank_id=BLANK,
                       is_tdt=is_tdt, joint_prefix="tdt_joint_" if is_tdt else "joint_", **c["kw"])
    assert any(got.tokens), "degenerate case: nothing was emitted"
    if case == "tdt_max_symbols":
        for item in got.timestamped:  # every item reaches the 3-emission cap
            frames = [t.start_frame for t in item]
            assert max(frames.count(f) for f in set(frames)) == 3


def test_decode_check_interval_does_not_change_results(monkeypatch):
    import parakeet_tpu_torch.decode.transducer as TD

    flat = _model(0)
    enc = torch.from_numpy(np.random.RandomState(9).randn(2, 19, ENC_H).astype(np.float32))
    runs = []
    for n in (1, 8):
        monkeypatch.setattr(TD, "CHECK_EVERY", n)
        runs.append(t_decode(params_from_numpy(flat), enc, pred_hidden=PRED_H, num_lstm_layers=1,
                             blank_id=BLANK, enc_lengths=[19, 6]))
    assert runs[0].tokens == runs[1].tokens
    assert runs[0].timestamped == runs[1].timestamped
    assert runs[0].steps <= runs[1].steps  # masked tail steps are no-ops
    assert runs[1].steps % 8 == 0


@pytest.mark.parametrize("timestamps", [False, True])
def test_ctc_log_probs_and_greedy_match_reference(timestamps):
    spec = RP.ctc_spec(VOCAB, ENC_H)
    flat = {k: np.asarray(v) for k, v in RP.init_params(spec, seed=8).items()}
    enc = np.random.RandomState(8).randn(3, 30, ENC_H).astype(np.float32) * 3
    r_lp = RCTC.ctc_log_probs(RParams({k: jnp.asarray(v) for k, v in flat.items()}).sub("ctc_decoder_"),
                              jnp.asarray(enc))
    t_lp = TCTC.ctc_log_probs(TParams(params_from_numpy(flat)).sub("ctc_decoder_"), torch.from_numpy(enc))
    np.testing.assert_allclose(t_lp.numpy(), np.asarray(r_lp), rtol=1e-5, atol=1e-5)
    lengths = [30, 17, 2]
    if timestamps:
        ref = RCTC.ctc_greedy_decode_with_timestamps(r_lp, BLANK, lengths)
        got = TCTC.ctc_greedy_decode_with_timestamps(t_lp, BLANK, lengths)
        assert [[(t.token_id, t.start_frame, t.end_frame) for t in i] for i in got] == [
            [(t.token_id, t.start_frame, t.end_frame) for t in i] for i in ref]
        np.testing.assert_allclose([t.confidence for i in got for t in i],
                                   [t.confidence for i in ref for t in i], rtol=1e-5)
    else:
        assert TCTC.ctc_greedy_decode(t_lp, BLANK, lengths) == RCTC.ctc_greedy_decode(r_lp, BLANK, lengths)


def test_ctc_collapse_and_first_max_ties():
    lp = np.full((1, 6, 4), -5.0, np.float32)
    for t, w in enumerate([1, 1, 3, 2, 2, 1]):
        lp[0, t, w] = 0.0
    lp[0, 5, 0] = 0.0  # tie at the last frame: the first max (0) wins
    assert TCTC.ctc_greedy_decode(torch.from_numpy(lp), blank_id=3) == [[1, 2, 0]]
    ts = TCTC.ctc_greedy_decode_with_timestamps(torch.from_numpy(lp), blank_id=3)[0]
    assert [(t.token_id, t.start_frame, t.end_frame) for t in ts] == [(1, 0, 1), (2, 3, 4), (0, 5, 5)]
