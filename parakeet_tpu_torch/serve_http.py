"""Stdlib-only HTTP serving frontend (port of parakeet_tpu/serve_http.py;
the C++ original's CLI is one clip per process invocation).

Endpoints:
  POST /transcribe  whole-clip audio bytes (wav/flac/mp3/ogg); concurrent
                    requests are dynamically batched into single device
                    calls by serve.TranscriptionService
  POST /align       forced alignment: audio bytes + `?text=` transcript
                    (urlencoded) → word timings without decoding;
                    `&window_s=` switches to long-form window stitching
  POST /stream      raw s16le 16 kHz mono PCM; the body is fed into a
                    serve.StreamingService session AS IT ARRIVES (chunked
                    transfer-encoding or plain reads), so the model runs
                    concurrently with the upload; response carries the
                    final text + stream-absolute timestamped tokens
  GET  /stats       batching counters

Zero extra dependencies: http.server + the package. Run as
`python -m parakeet_tpu_torch.serve_http` (on the card; `--device cpu`
runs on the CPU). Endpoints, status codes and JSON are the reference's.
"""

from __future__ import annotations

import argparse
import json
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

#: bytes of s16le PCM fed to a streaming session per read (160 ms @ 16 kHz)
STREAM_READ_BYTES = 2560 * 2

#: default request-body cap: 256 MiB ≈ 2.3 h of s16le 16 kHz PCM
MAX_BODY_BYTES = 256 * 1024 * 1024


class BodyTooLarge(ValueError):
    """Request body exceeded the configured cap (→ HTTP 413)."""


def _read_body_chunks(handler, max_bytes: int = MAX_BODY_BYTES):
    """Yield request-body byte chunks, honoring chunked transfer-encoding
    (which BaseHTTPRequestHandler does not parse) or Content-Length.
    Raises BodyTooLarge once `max_bytes` total have been read — a single
    oversized upload must not exhaust host memory (the server binds
    0.0.0.0 by default)."""
    total = 0
    if handler.headers.get("Transfer-Encoding", "").lower() == "chunked":
        while True:
            size_line = handler.rfile.readline(1024).strip()
            size = int(size_line.split(b";")[0], 16)
            if size == 0:
                handler.rfile.readline(1024)  # trailing CRLF
                return
            total += size
            if total > max_bytes:
                raise BodyTooLarge(f"request body exceeds {max_bytes} bytes")
            remaining = size
            while remaining:
                piece = handler.rfile.read(min(remaining, STREAM_READ_BYTES))
                if not piece:
                    raise ConnectionError("truncated chunked body")
                remaining -= len(piece)
                yield piece
            handler.rfile.readline(1024)  # chunk-terminating CRLF
    else:
        n = int(handler.headers.get("Content-Length", 0))
        if n > max_bytes:
            raise BodyTooLarge(f"request body exceeds {max_bytes} bytes")
        while n > 0:
            piece = handler.rfile.read(min(n, STREAM_READ_BYTES))
            if not piece:
                raise ConnectionError("truncated body")
            n -= len(piece)
            yield piece


def make_server(service, stream_service=None, host="0.0.0.0", port=8077,
                quiet=False, request_timeout: float | None = 600.0,
                close_timeout: float = 600.0,
                max_body_bytes: int = MAX_BODY_BYTES):
    """Build a ThreadingHTTPServer over a TranscriptionService (+ optional
    StreamingService for /stream). Caller owns serve_forever()/shutdown()
    and closing the services.

    request_timeout: socket timeout for request reads — a client that goes
    silent mid-upload gets dropped (and its stream session closed) instead
    of pinning a handler thread and a stream slot forever.
    close_timeout: how long /stream waits for the session flush."""
    import numpy as np

    class Handler(BaseHTTPRequestHandler):
        timeout = request_timeout  # BaseRequestHandler applies it in setup()

        def _json(self, code: int, payload: dict) -> None:
            out = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(out)))
            self.end_headers()
            self.wfile.write(out)

        def do_POST(self):  # noqa: N802 — BaseHTTPRequestHandler API
            path = self.path.rstrip("/")
            if path == "/transcribe":
                try:
                    body = b"".join(_read_body_chunks(self, max_body_bytes))
                except BodyTooLarge as e:
                    self.send_error(413, explain=str(e))
                    return
                except (ConnectionError, ValueError, OSError) as e:
                    self.send_error(400, explain=str(e))
                    return
                try:
                    res = service.submit(bytes(body)).result(timeout=600)
                    self._json(200, {
                        "text": res.text,
                        "token_ids": [int(t) for t in res.token_ids],
                    })
                except Exception as e:  # noqa: BLE001 — fan out as HTTP 400
                    self.send_error(400, explain=str(e))
            elif path.startswith("/align"):
                # forced alignment: audio body + known transcript in the
                # `text` query param → word timings (no decoding). Runs on
                # the handler thread (rare path; it issues its device
                # work beside the batcher's, on the same default stream).
                from urllib.parse import parse_qs, urlparse

                q = parse_qs(urlparse(self.path).query)
                text = (q.get("text") or [""])[0]
                if not text:
                    self.send_error(400, explain="missing ?text= transcript")
                    return
                try:
                    body = b"".join(_read_body_chunks(self, max_body_bytes))
                except BodyTooLarge as e:
                    self.send_error(413, explain=str(e))
                    return
                except (ConnectionError, ValueError, OSError) as e:
                    self.send_error(400, explain=str(e))
                    return
                try:
                    window = float((q.get("window_s") or [0])[0])
                    res = (service.tr.align_long(bytes(body), text, window_s=window)
                           if window else service.tr.align(bytes(body), text))
                    self._json(200, {
                        "text": res.text,
                        "token_ids": [int(t) for t in res.token_ids],
                        "words": [
                            {"word": w.word, "start": w.start, "end": w.end,
                             "confidence": w.confidence}
                            for w in res.word_timestamps
                        ],
                    })
                except Exception as e:  # noqa: BLE001 — fan out as HTTP 400
                    self.send_error(400, explain=str(e))
            elif path == "/stream":
                if stream_service is None:
                    self.send_error(404, explain="streaming not enabled (--streaming)")
                    return
                try:
                    sess = stream_service.open()
                except RuntimeError as e:
                    self.send_error(503, explain=str(e))
                    return
                try:
                    leftover = b""
                    # no body cap here: live streams are legitimately long,
                    # and host memory is bounded by StreamingSession.feed's
                    # backpressure (blocks when the session buffer is full)
                    for piece in _read_body_chunks(self, float("inf")):
                        data = leftover + piece
                        usable = len(data) - (len(data) % 2)  # s16 alignment
                        leftover = data[usable:]
                        if usable:
                            sess.feed(np.frombuffer(data[:usable], np.int16))
                    text = sess.close(timeout=close_timeout)
                    self._json(200, {
                        "text": text,
                        "token_ids": sess.tokens(),
                        "tokens": [
                            {"id": int(t.token_id), "start_frame": int(t.start_frame),
                             "end_frame": int(t.end_frame), "confidence": float(t.confidence)}
                            for t in sess.timestamped_tokens()
                        ],
                    })
                except Exception as e:  # noqa: BLE001
                    if not sess.closed:
                        try:
                            sess.close(timeout=close_timeout)
                        except Exception:  # noqa: BLE001 — already reporting
                            pass
                    self.send_error(400, explain=str(e))
            else:
                self.send_error(404)

        def do_GET(self):  # noqa: N802
            if self.path.rstrip("/") == "/stats":
                s = service.stats
                payload = {"requests": s.requests, "batches": s.batches,
                           "errors": s.errors, "mean_batch": s.mean_batch}
                if stream_service is not None:
                    payload["stream_sessions"] = stream_service.stats.requests
                    payload["stream_free_slots"] = stream_service.free_slots
                self._json(200, payload)
            else:
                self.send_error(404)

        def log_message(self, fmt, *a):
            if not quiet:
                print("[serve]", fmt % a, file=sys.stderr)

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", default="models/model.safetensors")
    ap.add_argument("--vocab", default="models/vocab.txt")
    ap.add_argument("--port", type=int, default=8077)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-wait-ms", type=float, default=25.0)
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--quantize", default=None, choices=["int8", "int4"],
                    help="weight-only quantization for both the offline and "
                         "streaming transcribers")
    ap.add_argument("--device", default=None, choices=[None, "cpu", "cuda"],
                    help="where the models run (default: the CUDA card)")
    ap.add_argument("--random-weights", action="store_true")
    ap.add_argument("--streaming", action="store_true",
                    help="enable POST /stream (live chunked-PCM sessions)")
    ap.add_argument("--streaming-model", default="eou", choices=["eou", "nemotron"],
                    help="streaming model family for /stream")
    ap.add_argument("--stream-slots", type=int, default=8,
                    help="concurrent live streams for /stream")
    ap.add_argument("--streaming-weights", default="models/eou.safetensors")
    ap.add_argument("--stream-stall-s", type=float, default=300.0,
                    help="auto-close a live stream after this long without "
                         "audio so silent clients can't leak slots")
    ap.add_argument("--request-timeout", type=float, default=600.0,
                    help="socket timeout for request reads")
    ap.add_argument("--max-body-mb", type=int, default=MAX_BODY_BYTES // (1024 * 1024),
                    help="reject /transcribe bodies larger than this (HTTP 413); "
                         "/stream is instead bounded by feed backpressure")
    args = ap.parse_args(argv)

    from parakeet_tpu_torch.device import DEFAULT_DEVICE
    from parakeet_tpu_torch.serve import StreamingService, TranscriptionService
    from parakeet_tpu_torch.transcribe import Transcriber

    device = args.device or DEFAULT_DEVICE
    weights = None if args.random_weights else args.weights
    vocab = None if args.random_weights else args.vocab
    tr = Transcriber(weights, vocab, compute_dtype=args.dtype,
                     quantize=args.quantize, device=device)
    service = TranscriptionService(
        tr, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms
    )
    stream_service = None
    if args.streaming:
        from parakeet_tpu_torch.streaming import StreamingBatchTranscriber

        sweights = None if args.random_weights else args.streaming_weights
        bt = StreamingBatchTranscriber(args.stream_slots, sweights, vocab,
                                       model=args.streaming_model,
                                       frontend="fused", wire_dtype="int16",
                                       quantize=args.quantize, device=device)
        stream_service = StreamingService(bt, stall_timeout_s=args.stream_stall_s)

    httpd = make_server(service, stream_service, host=args.host, port=args.port,
                        request_timeout=args.request_timeout,
                        max_body_bytes=args.max_body_mb * 1024 * 1024)
    print(f"[serve] listening on {args.host}:{args.port} "
          f"(POST /transcribe{', POST /stream' if stream_service else ''}, GET /stats)",
          file=sys.stderr)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        service.close()
        if stream_service is not None:
            stream_service.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
