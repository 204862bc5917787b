"""The record of one offline call: host-clock spans at the pipeline's layer
boundaries and a few counts, kept on the facade (`traces`, the newest KEEP
calls).

`prepare_batch` opens a `CallTrace` and `decode_prepared` closes it
and appends it to the facade's deque. Between the two the record rides
on prepare_batch's handle, so the stages may run on two threads (serve.py's
pipeline). While a stage runs, its thread holds the record as its open call
(`stage`): `span(name)` and `count(name, n)` in deeper modules find it there,
and do nothing when no call is open (a decode or an encoder called directly,
`transcribe_features`, `align`).

The spans, each inside the one above it (`Span.parent` is an index into the
record's `spans`, -1 for the root):

    batch                      prepare_batch's start to decode_prepared's end
      frontend                 prepare_batch
        frontend.load          the sources read into samples
        frontend.host          preemphasis, reflect pad, the padded host array
        frontend.copy          the padded array to the device (pageable)
      encoder                  the facade's encode
      ctc_head, ctc_decode     the CTC head; the greedy collapse (its fetch too)
      decode                   transducer_greedy_decode
        decode.upload          the lengths and durations to the device: copies
                               the host waits for, and with them for the work
                               queued before the decode (the encoder's tail)
        decode.loop            the lockstep iterations
          decode.check         each host check of "any item still active"
        decode.fetch           the emissions to the host
        decode.unpack          the host token lists and TimestampedTokens
      results                  TranscribeResults from the decoded rows

Counts: `encoder.frames` (B × T' of the encoder's output),
`encoder.valid_frames` (the sum of the encoded lengths), `decode.steps`
(TransducerResult.steps).

A record costs host clock reads and list appends only: no synchronise, no
CUDA event, no device allocation, nothing inside a decode iteration. While a
torch profiler records (read once a span), each span also opens
`record_function("parakeet.<name>")`, so it lies on the profiler's timeline
beside the kernels and copies it launched.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from collections import deque, namedtuple
from contextlib import nullcontext

import torch

KEEP = 4096  # calls a facade keeps
RECENT = 64  # the newest calls that stage_ms averages
PREFIX = "parakeet."

Span = namedtuple("Span", "name parent t0 t1")  # host seconds on time.perf_counter


class _Local(threading.local):
    call = None  # this thread's open CallTrace


_local = _Local()
_ids = itertools.count()
_NULL = nullcontext()


class CallTrace:
    """One call's record, its batch span open from construction to
    `close`: `id`, `t0` / `t1` (the batch span's ends), `spans` (Spans in
    opening order; a span still open is None there until it closes) and
    `counts` {name: int}."""

    def __init__(self):
        self.id = next(_ids)
        self.spans: list[Span | None] = []
        self.counts: dict[str, int] = {}
        self.top = -1  # the innermost open span
        self._batch = _SpanScope(self, "batch").__enter__()
        self.t0 = self._batch.t0
        self.t1: float | None = None

    def close(self) -> None:
        """End the batch span (once)."""
        if self.t1 is None:
            self._batch.__exit__(None, None, None)
            self._batch = None
            self.t1 = self.spans[0].t1


class _SpanScope:
    __slots__ = ("call", "name", "parent", "index", "t0", "scope")

    def __init__(self, call: CallTrace, name: str):
        self.call = call
        self.name = name

    def __enter__(self):
        self.scope = None
        if torch.autograd.profiler._is_profiler_enabled:
            self.scope = torch.profiler.record_function(PREFIX + self.name)
            self.scope.__enter__()
        call = self.call
        self.parent, self.index = call.top, len(call.spans)
        call.spans.append(None)
        call.top = self.index
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        call = self.call
        call.spans[self.index] = Span(self.name, self.parent, self.t0, t1)
        call.top = self.parent
        if self.scope is not None:
            self.scope.__exit__(*exc)
        return False


class stage:  # noqa: N801 - used as a context, like a function
    """A context in which `call` is this thread's open call (None: no call
    is open). With `keep` (a deque), a block that ends normally closes the
    call and appends it to `keep`; a block that raises closes the call,
    unkept."""

    def __init__(self, call: CallTrace | None, keep: deque | None = None):
        self.call, self.keep = call, keep

    def __enter__(self):
        self.prev = _local.call
        _local.call = self.call
        return self.call

    def __exit__(self, exc_type, *exc):
        _local.call = self.prev
        if self.call is not None and (exc_type is not None or self.keep is not None):
            self.call.close()
            if exc_type is None:
                self.keep.append(self.call)
        return False


def span(name: str):
    """A span of the open call (a no-op context when none is open)."""
    call = _local.call
    return _NULL if call is None else _SpanScope(call, name)


def spanned(name: str):
    """Decorator: the function's body runs inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*a, **kw):
            with span(name):
                return fn(*a, **kw)
        return inner
    return wrap


def count(name: str, n: int) -> None:
    """Add n to the open call's count `name`."""
    call = _local.call
    if call is not None:
        call.counts[name] = call.counts.get(name, 0) + n


def stage_ms(records) -> dict[str, float]:
    """{span name: its mean ms a call} over the newest RECENT of `records`
    (a facade's `traces`): the name's summed duration in each record that
    has it, averaged over those records. Reading RECENT records at most, its
    cost does not grow with the records kept."""
    total: dict[str, float] = {}
    held: dict[str, int] = {}
    for rec in list(itertools.islice(reversed(records), RECENT)):
        names = set()
        for s in rec.spans:
            total[s.name] = total.get(s.name, 0.0) + (s.t1 - s.t0)
            names.add(s.name)
        for name in names:
            held[name] = held.get(name, 0) + 1
    return {name: total[name] / n * 1e3 for name, n in held.items()}


__all__ = ["CallTrace", "Span", "KEEP", "RECENT", "stage", "span", "spanned", "count", "stage_ms"]
