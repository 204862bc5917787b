"""The port's streaming ASR against the JAX reference on tiny models: the
streaming encoder chunk by chunk (outputs and caches, every latency mode),
the causal conv cache, the session's mel remainder, the streaming mel
frontend, the decode with carried state, the StreamingTranscriber and
NemotronTranscriber facades, and the lockstep StreamingBatchTranscriber
(per_push, fused, int16 wire, hold, deactivate_slot, reset_slot); the same
weights and pushes give identical tokens and timestamps. Also bf16
sessions, the compute-dtype guard, the reference's validation errors,
commit-at-fetch, and the entry points' no-card RuntimeError."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parakeet_tpu import config as RC
from parakeet_tpu import params as RP
from parakeet_tpu_torch import config as TC
from parakeet_tpu_torch import params as TP
from parakeet_tpu_torch import streaming as TS
from parakeet_tpu_torch.audio import frontend as TF
from parakeet_tpu_torch.models import streaming_encoder as TSE
from parakeet_tpu_torch.params import Params as TParams

ENC_RTOL, ENC_ATOL = 2e-4, 1e-5  # test_static_cache_attention_matches_dynamic_oracle's
MEL_RTOL, MEL_ATOL = 1e-4, 1e-5  # tests/test_frontend.py's frontend tolerance
LATENCY_MODES = (0, 1, 6, 13)


def _scfg(C, **kw):
    """tests/test_streaming.py's tiny streaming encoder."""
    base = dict(mel_bins=80, subsampling_channels=8, hidden_size=16, num_layers=2, num_heads=2,
                ffn_intermediate=32, conv_kernel_size=5, att_context_left=6, att_context_right=1, chunk_size=2)
    base.update(kw)
    return C.StreamingEncoderConfig(**base)


def _eou_cfg(C, right=0):
    return C.EOUConfig(
        encoder=_scfg(C, att_context_right=right),
        prediction=C.PredictionConfig(vocab_size=13, pred_hidden=8, num_lstm_layers=1),
        joint=C.JointConfig(encoder_hidden=16, pred_hidden=8, joint_hidden=8, vocab_size=13),
        ctc_vocab_size=13,
    )


def _nemotron_cfg(C, right):
    return C.NemotronConfig(
        encoder=_scfg(C, att_context_right=right),
        prediction=C.PredictionConfig(vocab_size=11, pred_hidden=8, num_lstm_layers=2),
        joint=C.JointConfig(encoder_hidden=16, pred_hidden=8, joint_hidden=8, vocab_size=11),
        latency_frames=right,
    )


def _flat(spec, seed):
    return {k: np.asarray(v) for k, v in RP.init_params(spec, seed=seed).items()}


def _audio(seed, n):
    """Gated chirp plus noise: frame-to-frame variation a random model tells apart."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000
    gate = (np.sin(2 * np.pi * rng.uniform(1, 4) * t) > 0).astype(np.float32)
    return (0.3 * gate * np.sin(2 * np.pi * rng.uniform(100, 1500) * (1 + 2 * t) * t)
            + 0.05 * rng.randn(n)).astype(np.float32)


def _spans(ts):
    return [(t.token_id, t.start_frame, t.end_frame) for t in ts]


def _same_timestamps(got, ref):
    assert _spans(got) == _spans(ref)
    np.testing.assert_allclose([t.confidence for t in got], [t.confidence for t in ref], rtol=1e-4)


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("".join(f"▁w{i}\n" for i in range(13)), encoding="utf-8")
    return str(path)


@pytest.fixture(scope="module")
def encoder_flat():
    return _flat(RP.encoder_spec(_scfg(RC), "encoder_"), seed=7)


# ─── Streaming encoder ───────────────────────────────────────────────────────


@pytest.mark.parametrize("right", LATENCY_MODES)
@pytest.mark.parametrize("chunk", [2, 20])
def test_streaming_encoder_chunk_matches_reference(encoder_flat, right, chunk):
    """Outputs and every cache, chunk by chunk, through warm-up past the
    left context, in each latency mode at the tiny and the production chunk
    size (20 encoder frames)."""
    from parakeet_tpu.models import streaming_encoder as RSE

    rcfg, tcfg = _scfg(RC, att_context_right=right), _scfg(TC, att_context_right=right)
    rparams = {k: jnp.asarray(v) for k, v in encoder_flat.items()}
    tparams = TP.params_from_numpy(encoder_flat)
    rcache, tcache = RSE.init_encoder_cache(rcfg, 2), TSE.init_encoder_cache(tcfg, 2)
    rng = np.random.RandomState(right + chunk)
    n_chunks = max(2, (rcfg.att_context_left * 2) // chunk + 2)
    for i in range(n_chunks):
        mel = rng.randn(2, 8 * chunk, 80).astype(np.float32)
        r_out, rcache = RSE.streaming_encoder_chunk(rparams, jnp.asarray(mel), rcache, cfg=rcfg)
        t_out, tcache = TSE.streaming_encoder_chunk(tparams, torch.from_numpy(mel), tcache, cfg=tcfg)
        msg = f"chunk {i} (right={right}, chunk={chunk})"
        np.testing.assert_allclose(t_out.numpy(), np.asarray(r_out), rtol=ENC_RTOL, atol=ENC_ATOL, err_msg=msg)
        for key in ("conv", "key", "value"):
            np.testing.assert_allclose(tcache[key].numpy(), np.asarray(rcache[key]), rtol=ENC_RTOL,
                                       atol=ENC_ATOL, err_msg=f"{key} cache, {msg}")
        np.testing.assert_array_equal(tcache["valid"].numpy(), np.asarray(rcache["valid"]))
    assert int(tcache["valid"][0]) == rcfg.att_context_left


def test_causal_conv_cache_continuity(encoder_flat):
    """The chunked causal conv equals the one-shot conv over the whole input,
    and each chunk equals the reference's."""
    from parakeet_tpu.models.streaming_encoder import _causal_conv_module as r_conv
    from parakeet_tpu.params import Params as RParams

    cfg = _scfg(TC)
    k, d = cfg.conv_kernel_size, cfg.hidden_size
    tp = TParams(TP.params_from_numpy(encoder_flat)).sub("encoder_").sub("layers_").sub("0").sub("conv_")
    rp = RParams({kk: jnp.asarray(v) for kk, v in encoder_flat.items()}).sub("encoder_").sub("layers_").sub(
        "0").sub("conv_")
    x = np.random.RandomState(4).randn(1, 8, d).astype(np.float32)
    full, _ = TSE._causal_conv_module(tp, torch.from_numpy(x), torch.zeros(1, d, k - 1), k, 1e-5)
    cache, rcache, parts = torch.zeros(1, d, k - 1), jnp.zeros((1, d, k - 1)), []
    for lo, hi in ((0, 3), (3, 8)):
        out, cache = TSE._causal_conv_module(tp, torch.from_numpy(x[:, lo:hi]), cache, k, 1e-5)
        r_out, rcache = r_conv(rp, jnp.asarray(x[:, lo:hi]), rcache, k, 1e-5)
        np.testing.assert_allclose(out.numpy(), np.asarray(r_out), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(cache.numpy(), np.asarray(rcache), rtol=1e-5, atol=1e-6)
        parts.append(out)
    np.testing.assert_allclose(torch.cat(parts, dim=1).numpy(), full.numpy(), rtol=1e-4, atol=1e-6)


def test_session_mel_remainder(encoder_flat):
    from parakeet_tpu.models.streaming_encoder import StreamingEncoderSession as RSession

    cfg = _scfg(TC)
    sess = TSE.StreamingEncoderSession(TP.params_from_numpy(encoder_flat), cfg, batch=1)
    ref = RSession({k: jnp.asarray(v) for k, v in encoder_flat.items()}, _scfg(RC), batch=1)
    rng = np.random.RandomState(8)
    first = rng.randn(1, 5, 80).astype(np.float32)
    assert sess.forward_chunk(first) is None and ref.forward_chunk(first) is None  # 5 frames: under 8
    second = rng.randn(1, 5, 80).astype(np.float32)
    out, r_out = sess.forward_chunk(second), ref.forward_chunk(second)  # 10: consume 8, keep 2
    assert out.shape == (1, 1, cfg.hidden_size) and sess._mel_rem.shape[1] == 2 == ref._mel_rem.shape[1]
    np.testing.assert_allclose(out.numpy(), np.asarray(r_out), rtol=ENC_RTOL, atol=ENC_ATOL)
    np.testing.assert_array_equal(sess._mel_rem, np.asarray(ref._mel_rem))
    assert sess.frames_seen == ref.frames_seen == 1
    sess.reset()
    assert sess.frames_seen == 0 and sess._mel_rem.shape[1] == 0 and int(sess.cache["valid"][0]) == 0


# ─── Streaming mel frontend ──────────────────────────────────────────────────


def test_streaming_preprocessor_matches_reference():
    """Pushes shorter than a window (None), odd sizes and an empty push: the
    same carry, overlap buffer and log-mel as the reference."""
    from parakeet_tpu.audio.frontend import StreamingAudioPreprocessor as RPre

    cfg = TC.AudioConfig()
    port, ref = TF.StreamingAudioPreprocessor(cfg, "cpu"), RPre(RC.AudioConfig())
    audio = _audio(3, 12000)
    bounds = np.cumsum([0, 100, 250, 2560, 0, 999, 4000, 2000])
    frames = 0
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        got, want = port.process_chunk(audio[lo:hi]), ref.process_chunk(audio[lo:hi])
        assert (got is None) == (want is None)
        np.testing.assert_array_equal(port._overlap, ref._overlap)
        if got is not None:
            assert got.shape[0] == 1 and got.shape[2] == cfg.n_mels
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MEL_RTOL, atol=MEL_ATOL)
            frames += got.shape[1]
    assert frames > 40
    port.reset()
    assert port._preemph_last == 0.0 and port._overlap.size == 0
    assert port.process_chunk(audio[:300]) is None


def test_streaming_log_mel_batch_matches_reference():
    from parakeet_tpu.audio.frontend import streaming_log_mel_batch as r_batch

    cfg, n_frames = TC.AudioConfig(), 16
    need = (n_frames - 1) * cfg.hop_length + cfg.win_length
    x = np.stack([_audio(s, need) for s in (1, 2, 3)])
    prev = np.array([0.0, 0.25, -0.5], np.float32)
    got = TF.streaming_log_mel_batch(torch.from_numpy(x), torch.from_numpy(prev), cfg, n_frames)
    want = r_batch(jnp.asarray(x), jnp.asarray(prev), RC.AudioConfig(), n_frames)
    assert got.shape == (3, n_frames, cfg.n_mels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MEL_RTOL, atol=MEL_ATOL)
    # one row equals the per-push preprocessor fed the same samples after the same carry
    pre = TF.StreamingAudioPreprocessor(cfg, "cpu")
    pre._preemph_last = float(prev[1])
    np.testing.assert_allclose(pre.process_chunk(x[1])[0].numpy(), got[1].numpy(), rtol=1e-5, atol=1e-5)
    for short in (need - 1, need + 160):
        with pytest.raises(ValueError, match="exactly"):
            TF.streaming_log_mel_batch(torch.zeros(1, short), torch.zeros(1), cfg, n_frames)
        with pytest.raises(ValueError, match="exactly"):
            r_batch(jnp.zeros((1, short)), jnp.zeros((1,)), RC.AudioConfig(), n_frames)


# ─── Decode with carried state ───────────────────────────────────────────────


def test_decode_carries_state_and_offsets_frames():
    """Two chunks decoded with the first chunk's last token and LSTM state
    carried in, frame_offset and max_out, unclamped ends: identical to the
    reference chunk by chunk."""
    from parakeet_tpu.decode.transducer import transducer_greedy_decode as r_decode
    from parakeet_tpu_torch.decode.transducer import transducer_greedy_decode as t_decode

    cfg = _nemotron_cfg(RC, 0)
    spec = RP.prediction_spec(cfg.prediction, "prediction_")
    spec.update(RP.tdt_joint_spec(cfg.joint, len(cfg.durations), "joint_"))
    flat = _flat(spec, seed=3)
    rparams = {k: jnp.asarray(v) for k, v in flat.items()}
    tparams = TP.params_from_numpy(flat)
    kw = dict(pred_hidden=8, num_lstm_layers=2, blank_id=10, joint_prefix="joint_", clamp_end=False,
              max_out=30)
    enc = np.random.RandomState(9).randn(2, 6, 16).astype(np.float32) * 2
    r_tok = r_lstm = t_tok = t_lstm = None
    emitted = 0
    for lo, hi in ((0, 3), (3, 6)):
        ref = r_decode(rparams, jnp.asarray(enc[:, lo:hi]), init_token=r_tok, init_lstm=r_lstm,
                       frame_offset=lo, **kw)
        got = t_decode(tparams, torch.from_numpy(enc[:, lo:hi]), init_token=t_tok, init_lstm=t_lstm,
                       frame_offset=lo, **kw)
        assert got.tokens == ref.tokens
        for g, r in zip(got.timestamped, ref.timestamped):
            _same_timestamps(g, r)
            assert all(lo <= t.start_frame < hi for t in g)
        np.testing.assert_array_equal(got.last_token.numpy(), np.asarray(ref.last_token))
        np.testing.assert_allclose(got.lstm_state.numpy(), np.asarray(ref.lstm_state), rtol=1e-5, atol=1e-6)
        r_tok, r_lstm, t_tok, t_lstm = ref.last_token, ref.lstm_state, got.last_token, got.lstm_state
        emitted += sum(map(len, got.tokens))
    assert emitted, "degenerate case: nothing was emitted"


# ─── Facades ─────────────────────────────────────────────────────────────────

FACADES = {"eou": ("StreamingTranscriber", lambda C: _eou_cfg(C, 1), "eou_spec")}
FACADES.update({f"nemotron-{r}": ("NemotronTranscriber", (lambda r: lambda C: _nemotron_cfg(C, r))(r),
                                  "nemotron_spec") for r in LATENCY_MODES})


def _push_facade(tr, audio, sink):
    for i, lo in enumerate(range(0, len(audio), 2560)):
        chunk = audio[lo: lo + 2560]
        if i == 2:  # one int16 push: scaled by 1/32768 on entry
            chunk = np.clip(chunk * 32768, -32768, 32767).astype(np.int16)
        sink.append(tr.transcribe_chunk(chunk))


@pytest.mark.parametrize("kind", sorted(FACADES))
def test_streaming_facades_match_reference(kind, vocab):
    """Tokens, timestamped tokens, text deltas and partial callbacks
    identical to the JAX facade for the same pushes, and identical again
    after reset()."""
    import parakeet_tpu.streaming as RS

    name, cfg, spec = FACADES[kind]
    flat = _flat(getattr(RP, spec)(cfg(RC)), seed=11)
    voc = vocab if kind == "eou" else None
    ref = getattr(RS, name)(None, voc, cfg(RC), params=flat)
    port = getattr(TS, name)(None, voc, cfg(TC), params=flat, device="cpu")
    assert port.joint_prefix == ref.joint_prefix
    audio = _audio(21, 12800)
    ref_deltas, deltas, partials = [], [], []
    port.set_partial_callback(partials.append)
    _push_facade(ref, audio, ref_deltas)
    _push_facade(port, audio, deltas)
    assert len(set(port.get_tokens())) >= 2, "degenerate case: one token type"
    assert port.get_tokens() == ref.get_tokens()
    _same_timestamps(port.get_timestamped_tokens(), ref.get_timestamped_tokens())
    assert deltas == ref_deltas and port.get_text() == ref.get_text()
    assert partials == [d for d in deltas if d] if voc else partials == []
    port.reset()
    assert port.get_tokens() == [] and port.get_text() == ""
    _push_facade(port, audio, [])
    assert port.get_tokens() == ref.get_tokens()
    _same_timestamps(port.get_timestamped_tokens(), ref.get_timestamped_tokens())
    assert port.to_gpu() is None


# ─── Lockstep batch ──────────────────────────────────────────────────────────


def _batch_scenario(mod, cfg, flat, frontend, wire, device_kw):
    """B=3: slot 2 vacant at first; slot 1's audio arrives late (held while
    slot 0 flows); slot 2 joins with reset_slot; odd push sizes; per-step
    outputs and the final per-slot timestamped tokens."""
    bt = mod.StreamingBatchTranscriber(3, None, None, cfg, params=flat, mel_frames_per_step=16, frontend=frontend,
                                       wire_dtype=wire, **device_kw)
    a, b, c = _audio(31, 9600), _audio(32, 9600), _audio(33, 6400)
    steps = []

    def drain():
        while bt.ready_any():
            steps.append(bt.step(hold=bt.lagging_slots()))

    bt.deactivate_slot(2)
    for lo in range(0, 4800, 1600):
        bt.push(0, a[lo: lo + 1600])
        drain()
    bt.reset_slot(2)
    bt.push(1, (b[:4800] * 32768).astype(np.int16))
    bt.push(2, c[:3001])
    for lo in range(4800, 9600, 1200):
        bt.push(0, a[lo: lo + 1200])
        bt.push(1, b[lo: lo + 1200])
        drain()
    bt.push(2, c[3001:])
    drain()
    return steps, [bt.get_timestamped_tokens(i) for i in range(3)], bt


@pytest.mark.parametrize("frontend, wire", [("per_push", "float32"), ("fused", "float32"), ("fused", "int16")])
def test_batch_transcriber_matches_reference(frontend, wire):
    """Every step's output and each slot's timestamped tokens identical to
    the JAX batch transcriber, with holds, a vacant slot and a reset_slot;
    slot 0 equal to a B=1 run of the port fed the same pushes."""
    import parakeet_tpu.streaming as RS

    flat = _flat(RP.eou_spec(_eou_cfg(RC)), seed=13)
    r_steps, r_ts, _ = _batch_scenario(RS, _eou_cfg(RC), flat, frontend, wire, {})
    t_steps, t_ts, bt = _batch_scenario(TS, _eou_cfg(TC), flat, frontend, wire, dict(device="cpu"))
    assert t_steps == r_steps
    assert sum(len(ts) for ts in t_ts) > 10, "degenerate case: few tokens"
    for got, want in zip(t_ts, r_ts):
        _same_timestamps(got, want)
    assert any(s[1] == [] and s[0] for s in t_steps), "slot 1 was never held"

    solo = TS.StreamingBatchTranscriber(1, None, None, _eou_cfg(TC), params=flat, mel_frames_per_step=16,
                                        frontend=frontend, wire_dtype=wire, device="cpu")
    a = _audio(31, 9600)
    for lo, hi in [(lo, lo + 1600) for lo in range(0, 4800, 1600)] + [(lo, lo + 1200) for lo in range(4800, 9600, 1200)]:
        solo.push(0, a[lo:hi])
        while solo.ready():
            solo.step()
    _same_timestamps(solo.get_timestamped_tokens(0), t_ts[0])
    assert bt._cache["key"].shape[1] == 3 and bt.get_text(0) == ""


def test_batch_nemotron_model_and_fused_cadence():
    """model="nemotron" takes the joint_ schema; the fused frontend does not
    depend on the push cadence."""
    cfg = _nemotron_cfg(TC, 6)
    flat = _flat(RP.nemotron_spec(_nemotron_cfg(RC, 6)), seed=17)
    runs = []
    for size in (999, 4000):
        bt = TS.StreamingBatchTranscriber(1, None, None, cfg, model="nemotron", params=flat, frontend="fused",
                                          device="cpu")
        audio = _audio(5, 12800)
        for lo in range(0, len(audio), size):
            bt.push(0, audio[lo: lo + size])
            while bt.ready():
                bt.step()
        runs.append(_spans(bt.get_timestamped_tokens(0)))
    assert bt._joint_prefix == "joint_" and any(k.startswith("joint_.") for k in bt.params)
    assert runs[0] == runs[1] and runs[0]


def test_failed_step_leaves_state_as_it_was(monkeypatch):
    """A step that raises after its encoder ran rebinds nothing: queues,
    caches, decode state and carries are as before, and the retried step
    gives what an uninterrupted run gives."""
    cfg = _eou_cfg(TC)
    flat = _flat(RP.eou_spec(_eou_cfg(RC)), seed=13)
    audio = _audio(40, 8000)

    def run(fail_at):
        bt = TS.StreamingBatchTranscriber(2, None, None, cfg, params=flat, frontend="fused", device="cpu")
        bt.push(0, audio)
        bt.push(1, audio[::-1].copy())
        n = 0
        while bt.ready():
            if n == fail_at:
                before = ([q.copy() for q in bt._queues], {k: v.clone() for k, v in bt._cache.items()},
                          bt._last_token.clone(), bt._lstm.clone(), bt._preemph_prev.copy(),
                          list(bt._frame_offset))
                real = TS.transducer_greedy_decode

                def boom(*a, **k):
                    real(*a, **k)
                    raise RuntimeError("device error at the fetch")

                monkeypatch.setattr(TS, "transducer_greedy_decode", boom)
                with pytest.raises(RuntimeError, match="device error"):
                    bt.step()
                monkeypatch.setattr(TS, "transducer_greedy_decode", real)
                queues, cache, last, lstm, prev, offsets = before
                assert all(np.array_equal(q, b) for q, b in zip(bt._queues, queues))
                assert all(torch.equal(bt._cache[k], v) for k, v in cache.items())
                assert torch.equal(bt._last_token, last) and torch.equal(bt._lstm, lstm)
                assert np.array_equal(bt._preemph_prev, prev) and bt._frame_offset == offsets
            bt.step()
            n += 1
        return [_spans(bt.get_timestamped_tokens(i)) for i in range(2)]

    assert run(fail_at=2) == run(fail_at=-1)


# ─── Options, dtypes, errors ─────────────────────────────────────────────────


def test_bf16_sessions_keep_bf16_caches():
    """compute_dtype="bfloat16": the f32 mel is cast to the weights' dtype,
    the KV and conv caches stay bf16 across steps, and tokens come out."""
    cfg = _eou_cfg(TC)
    flat = _flat(RP.eou_spec(_eou_cfg(RC)), seed=13)
    audio = _audio(11, 12800)
    for frontend in ("fused", "per_push"):
        bt = TS.StreamingBatchTranscriber(1, None, None, cfg, params=flat, frontend=frontend,
                                          compute_dtype="bfloat16", device="cpu")
        assert bt._cache["key"].dtype == torch.bfloat16 and bt._cache["conv"].dtype == torch.bfloat16
        for lo in range(0, len(audio), 3200):
            bt.push(0, audio[lo: lo + 3200])
            while bt.ready():
                bt.step()
        assert bt._cache["key"].dtype == torch.bfloat16 and bt._cache["value"].dtype == torch.bfloat16
        assert bt._tokens[0] and all(0 <= t < 12 for t in bt._tokens[0])
    st = TS.StreamingTranscriber(None, None, cfg, params=flat, compute_dtype="bfloat16", device="cpu")
    for lo in range(0, len(audio), 2560):
        st.transcribe_chunk(audio[lo: lo + 2560])
    assert st.encoder_session.cache["key"].dtype == torch.bfloat16
    assert all(0 <= t < 12 for t in st.get_tokens())


def test_compute_dtype_skips_sidecars_and_norms():
    """The reference's encoder_compute_dtype returns the first floating leaf;
    an f32 "##scale" sidecar (or a norm parameter, f32 under bf16) first
    under the prefix would make a bf16 session f32. The port skips both."""
    params = {
        "encoder_.layers_.0.ffn1_.fc1_.weight##scale": torch.ones(4),
        "encoder_.layers_.0.ffn1_.norm_.weight": torch.ones(4),
        "encoder_.layers_.0.attn_.pos_bias_u_": torch.zeros(2, 2, dtype=torch.int8),
        "encoder_.layers_.0.ffn1_.fc1_.weight": torch.ones(4, 4, dtype=torch.bfloat16),
        "other_.weight": torch.ones(2, dtype=torch.float16),
    }
    assert TSE.encoder_compute_dtype(params) == torch.bfloat16
    assert TSE.encoder_compute_dtype(params, "none_") == torch.float32
    cfg = _scfg(TC)
    cache = TSE.init_encoder_cache(cfg, 3, TSE.encoder_compute_dtype(params))
    assert cache["key"].dtype == torch.bfloat16 and cache["valid"].dtype == torch.int32
    assert cache["key"].shape == (2, 3, 2, cfg.att_context_left, 8) and cache["conv"].shape == (2, 3, 16, 4)


@pytest.mark.parametrize("kw, exc, match", [
    (dict(mel_frames_per_step=12), ValueError, "multiple of 8"),
    (dict(model="bogus"), ValueError, "model must be"),
    (dict(frontend="bogus"), ValueError, "frontend must be"),
    (dict(wire_dtype="int8"), ValueError, "wire_dtype must be"),
    (dict(wire_dtype="int16"), ValueError, "requires frontend"),
    (dict(quantize="int3"), ValueError, "quantize"),  # the reference's quantize_params error
    (dict(mesh=object()), TypeError, "mesh"),  # a parallel.Mesh runs (tests/test_torch_parallel_streaming.py)
    (dict(compute_dtype="float16"), ValueError, "compute_dtype"),
])
def test_batch_transcriber_rejects_options(kw, exc, match):
    with pytest.raises(exc, match=match):
        TS.StreamingBatchTranscriber(1, None, None, _eou_cfg(TC), device="cpu", **kw)


def test_step_errors():
    bt = TS.StreamingBatchTranscriber(2, None, None, _eou_cfg(TC), device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        bt.step(hold=[5])
    with pytest.raises(RuntimeError, match="no active"):
        bt.step(hold=[0, 1])
    with pytest.raises(RuntimeError, match="enough buffered"):
        bt.step()
    # quantize= is accepted as in the reference (tests/test_torch_quantize.py
    # holds the quantized session to it); a bad mode raises its ValueError
    import parakeet_tpu.streaming as RS

    assert TS.StreamingTranscriber(None, None, _eou_cfg(TC), quantize="int4", device="cpu").params
    for make in (lambda: TS.StreamingTranscriber(None, None, _eou_cfg(TC), quantize="int3", device="cpu"),
                 lambda: RS.StreamingTranscriber(None, None, _eou_cfg(RC), quantize="int3")):
        with pytest.raises(ValueError, match="unsupported quantize mode"):
            make()


@pytest.mark.parametrize("entry", ["StreamingTranscriber", "NemotronTranscriber", "StreamingBatchTranscriber",
                                   "StreamingAudioPreprocessor"])
def test_no_card_raises_unless_cpu_is_asked_for(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = {
        "StreamingTranscriber": lambda **kw: TS.StreamingTranscriber(None, None, _eou_cfg(TC), **kw),
        "NemotronTranscriber": lambda **kw: TS.NemotronTranscriber(None, None, _nemotron_cfg(TC, 1), **kw),
        "StreamingBatchTranscriber": lambda **kw: TS.StreamingBatchTranscriber(2, None, None, _eou_cfg(TC), **kw),
        "StreamingAudioPreprocessor": lambda **kw: TF.StreamingAudioPreprocessor(TC.AudioConfig(), **kw),
    }[entry]
    for kw in ({}, dict(device="cuda:0")):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make(**kw)
    assert make(device="cpu").device == torch.device("cpu")


def test_streaming_names_exported():
    import parakeet_tpu_torch as pkg

    assert pkg.StreamingTranscriber is TS.StreamingTranscriber
    assert pkg.NemotronTranscriber is TS.NemotronTranscriber
    assert pkg.StreamingBatchTranscriber is TS.StreamingBatchTranscriber
    eou, nemo = pkg.make_eou_120m_config(), pkg.make_nemotron_600m_config(13)
    assert (eou.encoder.num_layers, eou.encoder.hidden_size, eou.encoder.att_context_right) == (17, 512, 1)
    assert (nemo.encoder.num_layers, nemo.encoder.hidden_size, nemo.encoder.att_context_right) == (24, 1024, 13)
