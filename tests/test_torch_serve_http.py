"""The port's HTTP frontend (parakeet_tpu_torch/serve_http.py) on the CPU:
the endpoint cases of tests/test_serve_http.py against the port's server
on an ephemeral port, each response's status and JSON equal to the JAX
package's server on the same tiny weights (same seed) and the same body."""

import http.client
import io
import json
import threading
import wave

import numpy as np
import pytest

from parakeet_tpu import config as RC
from parakeet_tpu_torch import config as TC

PORT, REF = "port", "ref"
ALIGN_PIECES = ["<unk>", "▁a", "▁b", "a", "b"]


def offline_cfg(C, vocab=21):
    return C.TDTCTCConfig(
        encoder=C.EncoderConfig(mel_bins=80, subsampling_channels=16, hidden_size=32,
                                num_layers=2, num_heads=4, ffn_intermediate=64),
        prediction=C.PredictionConfig(vocab_size=vocab, pred_hidden=16, num_lstm_layers=1),
        joint=C.JointConfig(encoder_hidden=32, pred_hidden=16, joint_hidden=16, vocab_size=vocab),
        ctc_vocab_size=vocab,
    )


def stream_cfg(C):
    return C.EOUConfig(
        encoder=C.StreamingEncoderConfig(
            mel_bins=80, subsampling_channels=8, hidden_size=16, num_layers=1,
            num_heads=2, ffn_intermediate=32, conv_kernel_size=9,
            att_context_left=4, att_context_right=0, chunk_size=2),
        prediction=C.PredictionConfig(vocab_size=13, pred_hidden=8, num_lstm_layers=1),
        joint=C.JointConfig(encoder_hidden=16, pred_hidden=8, joint_hidden=8, vocab_size=13),
        ctc_vocab_size=13,
    )


def _start(kind, vocab_path=None, vocab=21, with_stream=True):
    """(server, services) of one package over tiny random models."""
    if kind == PORT:
        from parakeet_tpu_torch import serve, serve_http, streaming, transcribe
        C, dev = TC, {"device": "cpu"}
    else:
        from parakeet_tpu import serve, serve_http, streaming, transcribe
        C, dev = RC, {}
    tr = transcribe.Transcriber(None, vocab_path, offline_cfg(C, vocab), seed=42, **dev)
    services = [serve.TranscriptionService(tr, max_batch=4, max_wait_ms=10.0)]
    stream = None
    if with_stream:
        bt = streaming.StreamingBatchTranscriber(2, None, None, stream_cfg(C), seed=7,
                                                 mel_frames_per_step=16, **dev)
        stream = serve.StreamingService(bt, poll_ms=1.0)
        services.append(stream)
    httpd = serve_http.make_server(services[0], stream, host="127.0.0.1", port=0, quiet=True)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, services


def _stop(httpd, services):
    httpd.shutdown()
    httpd.server_close()
    for s in services:
        s.close()


@pytest.fixture(scope="module")
def servers():
    started = {k: _start(k) for k in (PORT, REF)}
    yield {k: httpd.server_address for k, (httpd, _) in started.items()}
    for httpd, services in started.values():
        _stop(httpd, services)


@pytest.fixture(scope="module")
def align_servers(tmp_path_factory):
    vocab = tmp_path_factory.mktemp("align") / "vocab.txt"
    vocab.write_text("\n".join(ALIGN_PIECES) + "\n")
    started = {k: _start(k, str(vocab), vocab=6, with_stream=False) for k in (PORT, REF)}
    yield {k: httpd.server_address for k, (httpd, _) in started.items()}
    for httpd, services in started.values():
        _stop(httpd, services)


def _wav_bytes(samples: np.ndarray) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((samples * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def _request(addr, method, path, body=None, chunk=None):
    """(status, JSON payload or None); `chunk` sends the body with chunked
    transfer-encoding in pieces of that many bytes."""
    conn = http.client.HTTPConnection(*addr, timeout=300)
    try:
        if chunk is None:
            conn.request(method, path, body=body)
        else:
            conn.putrequest(method, path)
            conn.putheader("Transfer-Encoding", "chunked")
            conn.endheaders()
            for i in range(0, len(body), chunk):
                piece = body[i : i + chunk]
                conn.send(b"%x\r\n" % len(piece) + piece + b"\r\n")
            conn.send(b"0\r\n\r\n")
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, json.loads(data) if resp.status == 200 else None
    finally:
        conn.close()


def _confidences(payload):
    """Every "confidence" of a response (list of floats), and the response
    with them set to None."""
    found = []

    def strip(x):
        if isinstance(x, dict):
            if "confidence" in x:
                found.append(x["confidence"])
            return {k: None if k == "confidence" else strip(v) for k, v in x.items()}
        if isinstance(x, list):
            return [strip(v) for v in x]
        return x

    return found, strip(payload)


def _both(addrs, *args, **kw):
    """The same request to the port's and the JAX server: equal status and
    JSON; confidences (exp of mean log-probs) to f32 rounding, rtol 1e-4,
    as tests/test_torch_align_vad.py holds them."""
    (status, got), (ref_status, ref) = (_request(addrs[k], *args, **kw) for k in (PORT, REF))
    assert status == ref_status
    (got_conf, got_rest), (ref_conf, ref_rest) = _confidences(got), _confidences(ref)
    assert got_rest == ref_rest
    np.testing.assert_allclose(got_conf, ref_conf, rtol=1e-4)
    return status, got


@pytest.mark.parametrize("chunk", [None, 4096], ids=["content-length", "chunked"])
def test_transcribe_endpoint(servers, chunk):
    body = _wav_bytes((0.1 * np.random.RandomState(0).randn(8000)).astype(np.float32))
    status, payload = _both(servers, "POST", "/transcribe", body, chunk=chunk)
    assert status == 200
    assert set(payload) == {"text", "token_ids"}
    assert payload["token_ids"]


def test_transcribe_bad_audio_is_400(servers):
    assert _both(servers, "POST", "/transcribe", b"not audio at all")[0] == 400


@pytest.mark.parametrize("chunk", [None, 6400], ids=["content-length", "chunked"])
def test_stream_endpoint(servers, chunk):
    pcm = (0.1 * np.random.RandomState(1).randn(12800) * 32767).astype(np.int16).tobytes()
    status, payload = _both(servers, "POST", "/stream", pcm, chunk=chunk)
    assert status == 200
    assert set(payload) == {"text", "token_ids", "tokens"}
    assert payload["token_ids"]
    assert len(payload["tokens"]) == len(payload["token_ids"])
    frames = [(t["start_frame"], t["end_frame"]) for t in payload["tokens"]]
    assert frames == sorted(frames), "timestamps must be stream-absolute and monotone"


def test_stats_endpoint(servers):
    """The reference's keys, and the port's `stage_ms`: each span's mean ms
    a batch over the facade's kept records."""
    body = _wav_bytes((0.1 * np.random.RandomState(2).randn(8000)).astype(np.float32))
    assert _request(servers[PORT], "POST", "/transcribe", body)[0] == 200
    status, payload = _request(servers[PORT], "GET", "/stats")
    assert status == 200
    assert set(payload) == set(_request(servers[REF], "GET", "/stats")[1]) | {"stage_ms"}
    assert payload["requests"] >= 1
    assert payload["stream_free_slots"] == 2
    stages = payload["stage_ms"]
    assert {"batch", "frontend", "frontend.copy", "encoder", "decode", "decode.check", "results"} <= set(stages)
    assert all(v >= 0 for v in stages.values())
    assert stages["encoder"] <= stages["batch"] and stages["frontend"] <= stages["batch"]


@pytest.mark.parametrize("method", ["GET", "POST"])
def test_unknown_paths_404(servers, method):
    assert _both(servers, method, "/nope")[0] == 404


def test_stream_disabled_404():
    httpd, services = _start(PORT, with_stream=False)
    try:
        assert _request(httpd.server_address, "POST", "/stream", b"\x00\x00")[0] == 404
    finally:
        _stop(httpd, services)


def test_body_over_the_limit_is_413():
    from parakeet_tpu_torch import serve, serve_http, transcribe

    tr = transcribe.Transcriber(None, None, offline_cfg(TC), seed=42, device="cpu")
    service = serve.TranscriptionService(tr, max_batch=2, max_wait_ms=5.0)
    httpd = serve_http.make_server(service, None, host="127.0.0.1", port=0, quiet=True, max_body_bytes=1000)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        body = _wav_bytes(np.zeros(2000, np.float32))
        assert _request(httpd.server_address, "POST", "/transcribe", body)[0] == 413
        # one chunk past the cap: refused at its size line
        assert _request(httpd.server_address, "POST", "/transcribe", body, chunk=len(body))[0] == 413
    finally:
        _stop(httpd, [service])


def test_align_endpoint(align_servers):
    t = np.arange(24000) / 16000.0
    wav = _wav_bytes(0.4 * np.sin(2 * np.pi * 330 * t).astype(np.float32))
    status, payload = _both(align_servers, "POST", "/align?text=a%20b%20ab", wav)
    assert status == 200
    assert len(payload["words"]) == 3
    starts = [w["start"] for w in payload["words"]]
    assert starts == sorted(starts)
    assert _both(align_servers, "POST", "/align", wav)[0] == 400  # missing transcript
    # a transcript the clip can't emit → 400, not a hang or a crash
    assert _both(align_servers, "POST", "/align?text=" + "a%20b%20" * 300, wav)[0] == 400


def test_align_endpoint_needs_vocab(servers):
    wav = _wav_bytes(np.zeros(8000, np.float32))
    assert _both(servers, "POST", "/align?text=hello", wav)[0] == 400


def test_main_rejects_unknown_device():
    from parakeet_tpu_torch.serve_http import main

    with pytest.raises(SystemExit):
        main(["--device", "tpu"])
