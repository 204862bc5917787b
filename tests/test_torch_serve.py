"""The port's serving layer (parakeet_tpu_torch/serve.py) on the CPU: the
cases of tests/test_serve.py and tests/test_serve_streaming.py, with
tokens identical to the JAX package's services on the same tiny models
(same seed, so the same weights) and the same clips. The DP-sharded
streaming case stays out: the port has no mesh."""

import threading
import time

import numpy as np
import pytest

from parakeet_tpu import config as RC
from parakeet_tpu_torch import config as TC
from parakeet_tpu_torch.serve import StreamingService, TranscriptionService
from parakeet_tpu_torch.streaming import StreamingBatchTranscriber
from parakeet_tpu_torch.transcribe import Transcriber

MEL_STEP = 16
HOP = 160
FLUSH = (MEL_STEP + 8) * HOP  # silence StreamingService pushes at close


def offline_cfg(C):
    return C.TDTCTCConfig(
        encoder=C.EncoderConfig(mel_bins=80, subsampling_channels=16, hidden_size=32,
                                num_layers=2, num_heads=4, ffn_intermediate=64),
        prediction=C.PredictionConfig(vocab_size=21, pred_hidden=16, num_lstm_layers=1),
        joint=C.JointConfig(encoder_hidden=32, pred_hidden=16, joint_hidden=16, vocab_size=21),
        ctc_vocab_size=21,
    )


def stream_cfg(C):
    return C.EOUConfig(
        encoder=C.StreamingEncoderConfig(
            mel_bins=80, subsampling_channels=8, hidden_size=16, num_layers=1,
            num_heads=2, ffn_intermediate=32, conv_kernel_size=9,
            att_context_left=4, att_context_right=0, chunk_size=2,
        ),
        prediction=C.PredictionConfig(vocab_size=13, pred_hidden=8, num_lstm_layers=1),
        joint=C.JointConfig(encoder_hidden=16, pred_hidden=8, joint_hidden=8, vocab_size=13),
        ctc_vocab_size=13,
    )


@pytest.fixture(scope="module")
def tr():
    return Transcriber(None, None, offline_cfg(TC), seed=42, device="cpu")


@pytest.fixture(scope="module")
def ref_tr():
    from parakeet_tpu.transcribe import Transcriber as RTranscriber

    return RTranscriber(None, None, offline_cfg(RC), seed=42)


def _clips(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(0.1 * rng.randn(8000 + 1600 * i)).astype(np.float32) for i in range(n)]


@pytest.mark.parametrize("pipeline", [True, False])
def test_results_match_direct_and_reference_service(tr, ref_tr, pipeline):
    from parakeet_tpu.serve import TranscriptionService as RService

    clips = _clips(5)
    direct = tr.transcribe_batch(clips, pad_to_multiple=200)
    with TranscriptionService(tr, max_batch=8, max_wait_ms=50, pipeline=pipeline) as svc:
        assert svc._pipeline == pipeline
        got = [f.result(timeout=120) for f in [svc.submit(c) for c in clips]]
    with RService(ref_tr, max_batch=8, max_wait_ms=50, pipeline=pipeline) as svc:
        ref = [f.result(timeout=300) for f in [svc.submit(c) for c in clips]]
    assert [g.token_ids for g in got] == [d.token_ids for d in direct]
    assert [g.token_ids for g in got] == [r.token_ids for r in ref]
    assert any(g.token_ids for g in got)


@pytest.mark.parametrize("pipeline", [True, False])
def test_concurrent_submitters_coalesce(tr, pipeline):
    clips = _clips(8, seed=1)
    svc = TranscriptionService(tr, max_batch=8, max_wait_ms=200, pipeline=pipeline)
    results = [None] * len(clips)

    def worker(i):
        results[i] = svc.submit(clips[i]).result(timeout=120)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(clips))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    svc.close()
    assert all(r is not None for r in results)
    assert svc.stats.requests == 8
    assert svc.stats.batches < 8, svc.stats
    assert svc.stats.mean_batch > 1.0
    direct = tr.transcribe_batch(clips, pad_to_multiple=200)
    assert [r.token_ids for r in results] == [d.token_ids for d in direct]


@pytest.mark.parametrize("pipeline", [True, False])
def test_max_batch_respected(tr, pipeline):
    svc = TranscriptionService(tr, max_batch=2, max_wait_ms=200, pipeline=pipeline)
    futs = [svc.submit(c) for c in _clips(5, seed=2)]
    for f in futs:
        f.result(timeout=120)
    svc.close()
    assert max(svc.stats.batch_sizes) <= 2
    assert sum(svc.stats.batch_sizes) == 5


@pytest.mark.parametrize("pipeline", [True, False])
def test_error_fans_out(tr, pipeline):
    svc = TranscriptionService(tr, max_batch=4, max_wait_ms=100, pipeline=pipeline)
    f1 = svc.submit("/nonexistent/file.wav")
    with pytest.raises(FileNotFoundError):
        f1.result(timeout=60)
    good = svc.submit(_clips(1, seed=3)[0]).result(timeout=120)
    assert isinstance(good.token_ids, list)
    svc.close()
    assert svc.stats.errors >= 1


@pytest.mark.parametrize("pipeline", [True, False])
def test_close_rejects_new_work(tr, pipeline):
    svc = TranscriptionService(tr, pipeline=pipeline)
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(_clips(1)[0])
    svc.close()  # idempotent


def test_pipelined_matches_unpipelined(tr):
    """FIFO results across cohorts of 3, identical with and without the
    prepare/decode pipeline; a bad source fails only its own future."""
    rng = np.random.RandomState(9)
    clips = [rng.randn(6000 + 800 * i).astype(np.float32) * 0.1 for i in range(6)]
    with TranscriptionService(tr, max_batch=3, max_wait_ms=5, pipeline=False) as svc:
        ref = [svc.submit(c).result(timeout=300) for c in clips]
    with TranscriptionService(tr, max_batch=3, max_wait_ms=5, pipeline=True) as svc:
        got = [f.result(timeout=300) for f in [svc.submit(c) for c in clips]]
    assert [r.token_ids for r in got] == [r.token_ids for r in ref]
    with TranscriptionService(tr, max_batch=2, max_wait_ms=5, pipeline=True) as svc:
        bad = svc.submit("/nonexistent/clip.wav")
        with pytest.raises(FileNotFoundError):
            bad.result(timeout=300)
        assert svc.submit(clips[0]).result(timeout=300).token_ids == ref[0].token_ids


# ── StreamingService ─────────────────────────────────────────────────────


def _bt(batch, seed=31, **kw):
    return StreamingBatchTranscriber(batch, None, None, stream_cfg(TC), seed=seed,
                                     mel_frames_per_step=MEL_STEP, device="cpu", **kw)


def reference_tokens(audio, seed=31, chunk=3200):
    """Single-stream ground truth (the port's lockstep batch at B=1) with
    the close-flush silence, pushed at the session's cadence."""
    bt = _bt(1, seed)
    for i in range(0, len(audio), chunk):
        bt.push(0, audio[i : i + chunk])
    bt.push(0, np.zeros(FLUSH, np.float32))
    while bt.ready():
        bt.step()
    return list(bt._tokens[0])


def wait_until(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _jax_session_tokens(audio_by_session, **bt_kw):
    """Tokens of the JAX StreamingService fed the same sessions in turn."""
    from parakeet_tpu.serve import StreamingService as RService
    from parakeet_tpu.streaming import StreamingBatchTranscriber as RBatch

    bt = RBatch(len(audio_by_session), None, None, stream_cfg(RC), seed=31,
                mel_frames_per_step=MEL_STEP, **bt_kw)
    out = []
    with RService(bt, poll_ms=1.0) as svc:
        for audio in audio_by_session:
            s = svc.open()
            for i in range(0, len(audio), 3200):
                s.feed(audio[i : i + 3200])
            s.close()
            out.append(s.tokens())
    return out


def test_streaming_service_matches_direct_run_and_reference():
    rng = np.random.RandomState(3)
    audio_a = (rng.randn(12800) * 0.1).astype(np.float32)
    audio_b = (rng.randn(9600) * 0.1).astype(np.float32)
    ref_a, ref_b = reference_tokens(audio_a), reference_tokens(audio_b)

    partials = []
    with StreamingService(_bt(2), poll_ms=1.0) as svc:
        s_a = svc.open(on_partial=lambda s, d: partials.append((s.slot, d)))
        for i in range(0, 12800, 3200):
            s_a.feed(audio_a[i : i + 3200])
        s_b = svc.open()  # opens late and feeds slowly: must not block A
        for i in range(0, 9600, 3200):
            s_b.feed(audio_b[i : i + 3200])
            time.sleep(0.05)
        final_a, final_b = s_a.close(), s_b.close()
        assert s_a.closed and s_b.closed
        assert svc.free_slots == 2
        assert s_a.tokens() == ref_a and ref_a
        assert s_b.tokens() == ref_b and ref_b
        assert final_a == "" and final_b == ""  # random weights: no vocab

        audio_c = (rng.randn(6400) * 0.1).astype(np.float32)
        s_c = svc.open()  # slot reuse after close
        s_c.feed(audio_c)
        s_c.close()
        assert s_c.tokens() == reference_tokens(audio_c, chunk=len(audio_c))
    assert svc.stats.requests == 3
    assert partials and all(d == "" for _, d in partials)
    assert _jax_session_tokens([audio_a, audio_b]) == [ref_a, ref_b]


def test_streaming_service_slot_exhaustion():
    with StreamingService(_bt(1, seed=5)) as svc:
        s = svc.open()
        with pytest.raises(RuntimeError, match="slots busy"):
            svc.open()
        s.close()
        svc.open()  # freed slot is reusable


def test_streaming_service_stall_eviction():
    audio = (np.random.RandomState(9).randn(6400) * 0.1).astype(np.float32)
    ref = reference_tokens(audio, chunk=len(audio))
    with StreamingService(_bt(1), poll_ms=1.0, stall_timeout_s=0.3) as svc:
        s = svc.open()
        s.feed(audio)
        assert wait_until(lambda: s.closed, timeout=30.0), "stalled session not evicted"
        assert s.tokens() == ref
        assert svc.free_slots == 1
        with pytest.raises(RuntimeError, match="closed"):
            s.feed(audio)


def test_streaming_service_close_flushes_all():
    audio = (np.random.RandomState(11).randn(6400) * 0.1).astype(np.float32)
    svc = StreamingService(_bt(2), poll_ms=1.0)
    s = svc.open()
    s.feed(audio)
    svc.close()
    assert s.closed
    assert s.tokens() == reference_tokens(audio, chunk=len(audio))


def test_streaming_service_fused_int16_production_config():
    """The serving configuration serve_http builds (fused frontend, int16
    wire) through open / feed int16 / close-flush, against a direct fused
    run and the JAX service."""
    pcm = (np.random.RandomState(23).randn(12800) * 3000).astype(np.int16)
    kw = dict(frontend="fused", wire_dtype="int16")
    ref = _bt(1, **kw)
    ref.push(0, pcm)
    ref.push(0, np.zeros(FLUSH, np.float32))
    while ref.ready():
        ref.step()
    ref_tokens = list(ref._tokens[0])
    with StreamingService(_bt(2, **kw), poll_ms=1.0) as svc:
        s = svc.open()
        for i in range(0, len(pcm), 3200):
            s.feed(pcm[i : i + 3200])
        assert s.close() == ""
        assert s.tokens() == ref_tokens and ref_tokens
        assert [(t.token_id, t.start_frame) for t in s.timestamped_tokens()] == [
            (t.token_id, t.start_frame) for t in ref.get_timestamped_tokens(0)]
        assert svc.free_slots == 2
    assert _jax_session_tokens([pcm], **kw) == [ref_tokens]
