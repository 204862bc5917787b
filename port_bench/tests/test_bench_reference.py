"""The benchmark's plain reference against the port on the CPU, at toy
widths in float32: the log-mel, the encoder (each clip alone, padded as
its batch), the CTC log-probs and the greedy TDT decode; and the judge,
which reads 0 on a decode that follows the reference's own choices."""

import numpy as np
import pytest
import torch

from port_bench import traffic as TR
from port_bench import weights as W
from port_bench.drivers.offline import build_config
from port_bench.reference import judge
from port_bench.reference import torch_ref as R
from port_bench.reference.pipeline import Reference, subsampled_length
from port_bench.tests.tiny import tiny_config


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    from parakeet_tpu_torch import config as C
    from parakeet_tpu_torch import params as P
    from parakeet_tpu_torch.transcribe import Transcriber

    conf = tiny_config("float32")
    cfg = build_config(C.TDTCTCConfig, conf["config"])
    blank = cfg.joint.vocab_size - 1
    weights = W.make_weights(P.tdt_ctc_spec(cfg), 7, "cpu", torch.float32, blank, {})
    for key in ("tdt_joint_.label_proj_.bias", "ctc_decoder_.proj_.bias"):
        weights[key][blank] += 1.0
    tr = Transcriber(config=cfg, params=W.host_copy(weights), compute_dtype="float32", device="cpu")
    mix = {"pool": 4, "batch": 4, "lengths": {"median_s": 1.5, "sigma": 0.5, "min_s": 0.8, "max_s": 3.0}}
    clips = TR.make_pool(mix, 11, "cpu")
    ref = Reference(weights, conf["config"], conf["audio"], "cpu")
    return conf, cfg, tr, ref, clips, blank


def test_log_mel_matches_the_port(setup):
    _, _, tr, ref, clips, _ = setup
    feats, n_frames = tr.prepare_batch(clips)[3:]
    for i, c in enumerate(clips):
        want = ref.mel(c)
        assert want.shape[0] == n_frames[i]
        np.testing.assert_allclose(feats[i, : n_frames[i]].numpy(), want.numpy(), atol=2e-4)
        assert not feats[i, n_frames[i]:].any()


def test_encoder_and_ctc_match_the_port(setup):
    _, _, tr, ref, clips, _ = setup
    feats, n_frames = tr.prepare_batch(clips)[3:]
    enc = tr.encode(feats, n_frames)
    lp = tr.ctc_log_probs(enc)
    for i, c in enumerate(clips):
        want = ref.encode(ref.mel(c), feats.shape[1])
        t = subsampled_length(n_frames[i])
        assert want.shape[0] == t
        assert float((enc[i, :t] - want).norm() / want.norm()) < 1e-4
        np.testing.assert_allclose(lp[i, :t].numpy(), ref.ctc_log_probs(want).numpy(), atol=1e-3)


def test_greedy_tdt_matches_the_port_and_judges_zero(setup):
    conf, cfg, tr, ref, clips, blank = setup
    from parakeet_tpu_torch.decode.transducer import transducer_greedy_decode

    feats, n_frames = tr.prepare_batch(clips)[3:]
    enc = tr.encode(feats, n_frames)
    lens = [subsampled_length(n) for n in n_frames]
    got = transducer_greedy_decode(tr.params, enc, pred_hidden=32, num_lstm_layers=1, blank_id=blank,
                                   enc_lengths=lens)
    emitted = 0
    for i in range(len(clips)):
        port = [(t.token_id, t.start_frame, t.end_frame) for t in got.timestamped[i]]
        mine = R.greedy_tdt(ref.params, enc[i, : lens[i]], durations=cfg.durations, blank_id=blank,
                            joint_prefix="tdt_joint_")
        assert port == mine
        emitted += len(port)
        gap = judge.tdt_gap(ref.params, enc[i, : lens[i]], port, blank=blank, durations=cfg.durations,
                            joint_prefix="tdt_joint_")
        assert gap == pytest.approx(0.0, abs=1e-5)
    assert emitted > 0


def test_judges_read_a_changed_transcript(setup):
    _, cfg, tr, ref, clips, blank = setup
    feats, n_frames = tr.prepare_batch(clips)[3:]
    enc = tr.encode(feats, n_frames)
    t = subsampled_length(n_frames[0])
    lp = ref.ctc_log_probs(enc[0, :t]).double().numpy()
    best = lp.argmax(-1)
    tokens = [int(x) for j, x in enumerate(best) if x != blank and (j == 0 or best[j - 1] != x)]
    assert judge.ctc_gap(lp, tokens, blank) == pytest.approx(0.0)
    assert tokens, "the toy weights emit nothing"
    wrong = [(tokens[0] + 1) % blank] + tokens[1:]
    assert judge.ctc_gap(lp, wrong, blank) > 0.0
    assert judge.ctc_gap(lp, [], blank) > 0.0
    assert judge.ctc_gap(lp, tokens * (t + 1), blank) == judge.UNREACHABLE
    path = R.greedy_tdt(ref.params, enc[0, :t], durations=cfg.durations, blank_id=blank, joint_prefix="tdt_joint_")
    assert path
    kw = dict(blank=blank, durations=cfg.durations, joint_prefix="tdt_joint_")
    tok, s, e = path[0]
    assert judge.tdt_gap(ref.params, enc[0, :t], [((tok + 1) % blank, s, e)] + path[1:], **kw) > 0.0
    assert judge.tdt_gap(ref.params, enc[0, :t], [], **kw) > 0.0
    assert judge.tdt_gap(ref.params, enc[0, :t], [(tok, t + 5, t + 5)], **kw) == judge.UNREACHABLE
