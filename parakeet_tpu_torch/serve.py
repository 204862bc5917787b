"""Dynamic-batching transcription service (port of parakeet_tpu/serve.py;
a copy, stdlib only).

A single worker owns the device: concurrent callers `submit()` audio, the
worker coalesces whatever is queued (up to `max_batch`, waiting at most
`max_wait_ms` for stragglers) into ONE batched device call —
`transcribe_batch` with `pad_to_multiple` bucketing, so padded shapes
come from a bounded set.

Batching is semantically free: batched inference is token-identical to
single-clip inference (masked normalization + length-masked encoder), so
callers can't observe whether they shared a batch.

With `pipeline=True` the facade's `prepare_batch` (audio load and the mel
frontend, on the card) runs on the "parakeet-serve-prep" thread and
`decode_prepared` (encoder and decode) on "parakeet-serve". Both threads
issue their CUDA work on the device's default stream (PyTorch's current
stream is per thread and starts as the default one), so the hand-off of
the features between them is ordered without an event.

    service = TranscriptionService(transcriber, max_batch=16)
    fut = service.submit("clip.wav")          # returns concurrent Future
    print(fut.result().text)
    service.close()
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field


@dataclass
class ServiceStats:
    requests: int = 0
    batches: int = 0
    errors: int = 0
    total_batched: int = 0  # sum of all recorded batch sizes
    #: recent batch sizes only — bounded so a long-running service (one
    #: append per device step) cannot grow memory without limit
    batch_sizes: deque = field(default_factory=lambda: deque(maxlen=1024))

    def record_batch(self, size: int) -> None:
        self.batches += 1
        self.total_batched += size
        self.batch_sizes.append(size)

    @property
    def mean_batch(self) -> float:
        return self.total_batched / self.batches if self.batches else 0.0


class TranscriptionService:
    """Thread-safe dynamic batcher over one Transcriber (one device).

    opts: a TranscribeOptions applied to every request — the decode
    configuration is per-service (uniform shapes/programs), not
    per-request; run one service per configuration.
    """

    def __init__(
        self,
        transcriber,
        *,
        max_batch: int = 16,
        max_wait_ms: float = 20.0,
        pad_to_multiple: int | None = 200,
        opts=None,
        pipeline: bool = True,
    ):
        """pipeline: run load/mel-frontend (prepare_batch) and
        encoder/decode (decode_prepared) in two stages with a 1-deep
        handoff, so cohort N+1's audio loading + frontend overlaps cohort
        N's device work — the facade split exists for exactly this
        (transcribe.prepare_batch docstring). Results are identical and
        stay FIFO; set False for the single-thread behavior."""
        self.tr = transcriber
        self.opts = opts
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.pad_to_multiple = pad_to_multiple
        self.stats = ServiceStats()
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._submit_lock = threading.Lock()
        self._pipeline = bool(pipeline) and hasattr(transcriber, "prepare_batch")
        if self._pipeline:
            self._prepared_q: queue.Queue = queue.Queue(maxsize=1)
            self._preparer = threading.Thread(
                target=self._prepare_run, daemon=True, name="parakeet-serve-prep"
            )
            self._worker = threading.Thread(
                target=self._decode_run, daemon=True, name="parakeet-serve"
            )
            self._preparer.start()
        else:
            self._worker = threading.Thread(target=self._run, daemon=True, name="parakeet-serve")
        self._worker.start()

    # ── Public API ───────────────────────────────────────────────────────

    def submit(self, source) -> Future:
        """Enqueue one clip (path / bytes / samples); resolves to a
        TranscribeResult."""
        fut: Future = Future()
        # closed-check + put are atomic with close()'s sentinel enqueue, so
        # an accepted item is always FIFO-ahead of the sentinel and will be
        # drained — its Future can never be silently abandoned
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("service is closed")
            self.stats.requests += 1
            self._q.put((source, fut))
        return fut

    def transcribe(self, source):
        """Synchronous convenience wrapper."""
        return self.submit(source).result()

    def close(self, timeout: float | None = 30.0) -> None:
        """Stop accepting work, drain the queue, join the worker."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)  # sentinel: drain-then-exit
        deadline = None if timeout is None else time.monotonic() + timeout
        if self._pipeline:
            self._preparer.join(timeout=timeout)
        left = None if deadline is None else max(0.0, deadline - time.monotonic())
        self._worker.join(timeout=left)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ── Worker ───────────────────────────────────────────────────────────

    def _collect(self) -> tuple[list, bool]:
        """Block for the first item, then coalesce until max_batch or the
        wait budget runs out. Returns (batch, saw_sentinel)."""
        first = self._q.get()
        if first is None:
            return [], True
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                # grab anything already queued, but don't wait further
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
            else:
                try:
                    item = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
            if item is None:
                return batch, True
            batch.append(item)
        return batch, False

    def _drain_after_stop(self) -> None:
        # drain whatever raced in after the sentinel
        try:
            while True:
                item = self._q.get_nowait()
                if item is not None:
                    item[1].set_exception(RuntimeError("service closed"))
        except queue.Empty:
            pass

    def _prepare_run(self) -> None:
        """Pipeline stage 1: coalesce cohorts and run load + mel frontend;
        hand prepared cohorts to the decode worker (1-deep, so at most one
        cohort is prepared ahead while the device is busy)."""
        while True:
            batch, stop = self._collect()
            # a cancelled Future must not join the device batch (see _run)
            batch = [
                (s, fut) for s, fut in batch if fut.set_running_or_notify_cancel()
            ]
            item = None
            if batch:
                try:
                    prepared = self.tr.prepare_batch(
                        [s for s, _ in batch], self.opts,
                        pad_to_multiple=self.pad_to_multiple,
                    )
                    item = (batch, prepared, None)
                except Exception as e:  # noqa: BLE001 — fan out, keep serving
                    item = (batch, None, e)
            self._prepared_q.put((item, stop))
            if stop:
                return

    def _decode_run(self) -> None:
        """Pipeline stage 2: device encoder/decode + result fan-out."""
        while True:
            item, stop = self._prepared_q.get()
            if item is not None:
                batch, prepared, err = item
                if err is None:
                    try:
                        results = self.tr.decode_prepared(prepared)
                        for (_, fut), res in zip(batch, results):
                            fut.set_result(res)
                    except Exception as e:  # noqa: BLE001
                        err = e
                if err is not None:
                    self.stats.errors += 1
                    for _, fut in batch:
                        if not fut.done():
                            fut.set_exception(err)
                self.stats.record_batch(len(batch))
            if stop:
                self._drain_after_stop()
                return

    def _run(self) -> None:
        while True:
            batch, stop = self._collect()
            # a cancelled Future must not join the device batch, and a
            # set_result on it would raise InvalidStateError mid-fan-out,
            # poisoning the other callers' results
            batch = [
                (s, fut) for s, fut in batch if fut.set_running_or_notify_cancel()
            ]
            if batch:
                sources = [s for s, _ in batch]
                try:
                    results = self.tr.transcribe_batch(
                        sources, self.opts, pad_to_multiple=self.pad_to_multiple
                    )
                    for (_, fut), res in zip(batch, results):
                        fut.set_result(res)
                except Exception as e:  # noqa: BLE001 — fan the error out to callers
                    self.stats.errors += 1
                    for _, fut in batch:
                        if not fut.done():
                            fut.set_exception(e)
                self.stats.record_batch(len(batch))
            if stop:
                self._drain_after_stop()
                return


class StreamingSession:
    """Handle for one live stream inside a StreamingService. Created by
    `service.open()`; not constructed directly.

    feed() is thread-safe and never blocks on the device: samples land in a
    host-side buffer that the service worker drains into the slot's mel
    frontend. Slow feeders never stall other sessions — the worker passes
    lagging slots as `hold` to StreamingBatchTranscriber.step(), which is a
    verified no-op for them (tests/test_torch_streaming.py).

    Backpressure: the host buffer is bounded (service `max_buffered_s`); a
    client uploading faster than the device drains BLOCKS in feed() until
    room frees up instead of growing host memory without limit."""

    def __init__(self, service: "StreamingService", slot: int, on_partial=None):
        self._service = service
        self.slot = slot
        self.on_partial = on_partial
        self._lock = threading.Lock()
        self._room = threading.Condition(self._lock)
        self._pending: list = []
        self._pending_samples = 0
        self._needs_reset = True  # slot state is initialized by the worker
        self._close_requested = False
        self._closed = threading.Event()
        self._error: Exception | None = None
        self._final_text = ""
        self._final_tokens: list[int] = []
        self._final_timestamped: list = []
        self.last_fed = time.monotonic()

    def feed(self, samples, timeout: float | None = 120.0) -> None:
        """Enqueue raw PCM (float32 in [-1,1] or int16) for transcription.

        The closed-check and the append share the session lock with the
        worker's finalize drain, so a feed either raises or its samples are
        guaranteed to be transcribed — never silently dropped. Blocks while
        the session's buffered-but-unprocessed audio exceeds the service's
        `max_buffered_s` bound; raises TimeoutError after `timeout` s (a
        wedged worker must not pin the caller forever)."""
        n = len(samples)
        deadline = None if timeout is None else time.monotonic() + timeout
        self.last_fed = time.monotonic()  # a feeder blocked in backpressure
        with self._room:                  # is ACTIVE — must not trip the
            while (                       # stall auto-close
                self._pending_samples + n > self._service._max_pending_samples
                and self._pending_samples > 0  # one oversized feed still lands
                and not (self._close_requested or self._closed.is_set())
            ):
                self.last_fed = time.monotonic()
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        "feed backpressure timeout: session buffer full "
                        f"({self._pending_samples} samples pending)"
                    )
                # bounded wait slices so last_fed keeps refreshing while
                # blocked (the stall timer must see this feeder as active)
                self._room.wait(5.0 if remaining is None else min(remaining, 5.0))
            if self._close_requested or self._closed.is_set():
                raise RuntimeError("session is closed")
            self._pending.append(samples)
            self._pending_samples += n
        self.last_fed = time.monotonic()
        self._service._wake.set()

    def text(self) -> str:
        if self._closed.is_set():
            return self._final_text
        if self._needs_reset:  # slot still holds the previous occupant's state
            return ""
        return self._service._bt.get_text(self.slot)

    def tokens(self) -> list[int]:
        if self._closed.is_set():
            return list(self._final_tokens)
        if self._needs_reset:
            return []
        return list(self._service._bt._tokens[self.slot])

    def timestamped_tokens(self):
        if self._closed.is_set():
            return list(self._final_timestamped)
        if self._needs_reset:
            return []
        return self._service._bt.get_timestamped_tokens(self.slot)

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def close(self, timeout: float | None = 30.0) -> str:
        """Flush buffered audio through the model, free the slot, return the
        final transcript. Re-raises the worker-side error if the flush
        failed (the slot was still reclaimed)."""
        with self._room:
            self._close_requested = True
            self._room.notify_all()  # unblock feeders waiting on backpressure
        self._service._wake.set()
        if not self._closed.wait(timeout):
            raise TimeoutError("session close timed out")
        if self._error is not None:
            raise RuntimeError("streaming session flush failed") from self._error
        return self._final_text

    # worker-side helpers ──────────────────────────────────────────────────
    def _request_close(self) -> None:
        with self._room:
            self._close_requested = True
            self._room.notify_all()  # unblock feeders stuck in backpressure

    def _drain_pending(self) -> list:
        with self._room:
            out, self._pending = self._pending, []
            self._pending_samples = 0
            self._room.notify_all()
        return out


class StreamingService:
    """Multiplex many live audio streams onto one device (the C++
    original serves exactly one stream per process).

    A single worker thread owns a StreamingBatchTranscriber with B slots.
    Sessions `open()`/`feed()`/`close()` concurrently; every device step is
    ONE batched step of fixed shape (encoder chunk + decode), so cost is
    amortized across all live streams. Slots
    whose clients lag are passed as `hold` — a verified per-slot no-op — so
    real-time streams are never blocked by slow ones (no head-of-line
    blocking).

    stall_timeout_s: a session that stops feeding for this long is closed
    automatically (flushing what it buffered) so its slot can be reused.

    max_buffered_s: per-session host-buffer bound, in seconds of audio, at
    each of the two buffering levels (session pending list; slot queue in
    the batch transcriber). Past the bound, feed() blocks (backpressure)
    rather than growing host memory without limit.

        service = StreamingService(StreamingBatchTranscriber(8, ...))
        s = service.open(on_partial=lambda sess, delta: print(delta))
        s.feed(chunk)          # 160 ms PCM chunks, any cadence
        print(s.close())       # final transcript
    """

    def __init__(self, batch_transcriber, *, poll_ms: float = 2.0,
                 stall_timeout_s: float | None = None,
                 max_buffered_s: float = 60.0):
        self._bt = batch_transcriber
        self._poll_s = poll_ms / 1e3
        self._stall_s = stall_timeout_s
        acfg = batch_transcriber._audio_cfg
        self._max_pending_samples = int(max_buffered_s * acfg.sample_rate)
        # slot-queue units differ by frontend: raw samples (fused) vs mel
        # frames (per_push, sample_rate/hop frames per second)
        units_per_s = (
            acfg.sample_rate
            if getattr(batch_transcriber, "_frontend", "per_push") == "fused"
            else acfg.sample_rate / acfg.hop_length
        )
        self._max_queue_units = int(max_buffered_s * units_per_s)
        self.stats = ServiceStats()
        self._lock = threading.Lock()
        self._sessions: dict[int, StreamingSession] = {}
        self._free = list(range(batch_transcriber.batch))
        for slot in self._free:
            self._bt.deactivate_slot(slot)
        self._wake = threading.Event()
        self._stop = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="parakeet-stream-serve")
        self._worker.start()

    @property
    def free_slots(self) -> int:
        with self._lock:
            return len(self._free)

    def open(self, on_partial=None) -> StreamingSession:
        """Claim a slot for a new stream. Raises RuntimeError when all
        slots are busy (size the batch for peak concurrency)."""
        if self._stop:
            raise RuntimeError("service is closed")
        with self._lock:
            if not self._free:
                raise RuntimeError(f"all {self._bt.batch} slots busy")
            slot = self._free.pop(0)
            # the worker thread owns ALL StreamingBatchTranscriber state;
            # it performs the slot reset (sess._needs_reset) before first use
            sess = StreamingSession(self, slot, on_partial)
            self._sessions[slot] = sess
        self.stats.requests += 1
        self._wake.set()
        return sess

    def close(self, timeout: float | None = 30.0) -> None:
        """Close all sessions (flushing them) and stop the worker."""
        if self._stop:
            return
        with self._lock:
            live = list(self._sessions.values())
        for sess in live:
            sess._request_close()
        self._stop = True
        self._wake.set()
        self._worker.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ── Worker ───────────────────────────────────────────────────────────

    def _finalize(self, sess: StreamingSession) -> None:
        """Flush a closing session: drain any audio still in its host
        buffer, pad with silence so the mel frontend and the mod-`mel_step`
        chunking emit everything buffered, step it through (holding lagging
        neighbors), then free the slot."""
        bt = self._bt
        # Atomically stop accepting feeds and take what was already fed:
        # feed() holds the same lock for its closed-check + append, so
        # nothing can slip in between and be silently lost.
        with sess._room:
            sess._close_requested = True
            pending, sess._pending = sess._pending, []
            sess._pending_samples = 0
            sess._room.notify_all()
        try:
            for chunk in pending:
                bt.push(sess.slot, chunk)
            hop = bt._audio_cfg.hop_length
            # enough silence to flush the STFT overlap buffer and reach the
            # next mel-step boundary regardless of current queue fill
            bt.push(sess.slot, [0.0] * ((bt._mel_step + 8) * hop))
            while bt._queues[sess.slot].shape[0] >= bt._step_units:
                hold = [i for i in bt.lagging_slots() if i != sess.slot]
                self._step_and_deliver(hold)
            sess._final_text = bt.get_text(sess.slot)
            sess._final_tokens = list(bt._tokens[sess.slot])
            sess._final_timestamped = bt.get_timestamped_tokens(sess.slot)
        except Exception as e:  # noqa: BLE001 — flush failed (device error)
            # record for close() to re-raise; the finally still reclaims the
            # slot, so a persistent device failure cannot leak slots one by
            # one until open() always 503s
            sess._error = e
            self.stats.errors += 1
        finally:
            try:
                bt.deactivate_slot(sess.slot)
            except Exception:  # noqa: BLE001 — already reporting via _error
                pass
            with self._lock:
                self._sessions.pop(sess.slot, None)
                self._free.append(sess.slot)
            sess._closed.set()

    def _step_and_deliver(self, hold) -> None:
        out = self._bt.step(hold=hold)
        self.stats.record_batch(
            sum(1 for i, toks in enumerate(out) if i not in hold and self._bt._active[i])
        )
        for slot, toks in enumerate(out):
            sess = self._sessions.get(slot)
            if sess is not None and toks and sess.on_partial is not None:
                try:
                    sess.on_partial(sess, self._bt.tokenizer.decode(toks)
                                    if self._bt.tokenizer.loaded else "")
                except Exception:  # noqa: BLE001 — a callback must not kill the worker
                    self.stats.errors += 1

    def _run(self) -> None:
        while True:
            with self._lock:
                live = list(self._sessions.values())
            progressed = False
            try:
                for sess in live:
                    if sess._needs_reset:
                        self._bt.reset_slot(sess.slot)
                        sess._needs_reset = False
                    # gate the drain on slot-queue fill: past the bound the
                    # pending list absorbs feeds until feed() itself blocks —
                    # both buffering levels stay bounded
                    if self._bt._queues[sess.slot].shape[0] < self._max_queue_units:
                        for chunk in sess._drain_pending():
                            self._bt.push(sess.slot, chunk)
                            progressed = True
                if self._bt.ready_any():
                    self._step_and_deliver(self._bt.lagging_slots())
                    progressed = True
                now = time.monotonic()
                for sess in live:
                    stalled = (self._stall_s is not None
                               and now - sess.last_fed > self._stall_s)
                    if sess._close_requested or stalled:
                        self._finalize(sess)
                        progressed = True
            except Exception:  # noqa: BLE001 — a dead worker bricks every session
                self.stats.errors += 1
                progressed = False  # back off to the poll wait, don't spin
            if self._stop:
                with self._lock:
                    remaining = list(self._sessions.values())
                if not remaining:
                    return
                for sess in remaining:
                    sess._request_close()
                continue
            if not progressed:
                self._wake.wait(self._poll_s)
                self._wake.clear()


__all__ = ["TranscriptionService", "StreamingService", "StreamingSession", "ServiceStats"]
