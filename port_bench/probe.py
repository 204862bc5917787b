"""The benchmark's spans and its hold on the timed path's outputs.

A `Probe` wraps the calls into each layer from outside the program: the
facade's `prepare_batch` (the frontend), `encode` (the encoder) and
`ctc_log_probs` (the CTC head) on the instance, and in
parakeet_tpu_torch.transcribe the greedy decodes it calls by module name
(`transducer_greedy_decode`, `ctc_greedy_decode`). Untraced, the wrappers
only keep what the check needs: every decode's tokens and frames, and the
designated call's features, encoder frames and log-probs, by reference
(no copy, no synchronisation). Traced, each span also records its host
clock (the frontend's ending in a synchronise), the encoder its CUDA
events, and each span and every K1 launch
(models.encoder.rel_attention_block) a profiler annotation named
"port_bench.<span>".
"""

from __future__ import annotations

import importlib
import time
from contextlib import nullcontext
from dataclasses import dataclass, field

import torch

@dataclass
class CallRecord:
    """One timed transcribe_batch call."""

    index: int
    batch: int  # index into the cell's batches
    clips: list[int]
    audio_s: float
    t0: float = 0.0
    t1: float = 0.0
    results: list | None = None
    error: str | None = None
    profiled: bool = False
    spans: dict = field(default_factory=dict)  # name → [(t0, t1)] host seconds
    enc_events: list = field(default_factory=list)  # [(start, end)] CUDA events
    decoded: list = field(default_factory=list)  # per clip its emissions, as the decode layer gave them

    @property
    def wall_s(self) -> float:
        return self.t1 - self.t0


class Probe:
    def __init__(self, trace: bool):
        self.trace = trace
        self.call: CallRecord | None = None
        self.keep_call = -1  # the index of the window call whose tensors the check compares
        self.kept: dict = {}
        self._undo: list = []

    # ── installation ─────────────────────────────────────────────────────

    def _patch(self, owner, name: str, make):
        orig = getattr(owner, name)
        setattr(owner, name, make(orig))
        self._undo.append((owner, name, orig, name in vars(owner)))

    def install(self, system, program: bool) -> None:
        self._patch(system, "prepare_batch", self._frontend)
        self._patch(system, "encode", self._encode)
        if hasattr(system, "ctc_log_probs"):
            self._patch(system, "ctc_log_probs", self._ctc_head)
        if program:
            tr = importlib.import_module("parakeet_tpu_torch.transcribe")
            self._patch(tr, "transducer_greedy_decode", self._decode)
            self._patch(tr, "ctc_greedy_decode", self._ctc_decode)
            if self.trace:
                enc = importlib.import_module("parakeet_tpu_torch.models.encoder")
                self._patch(enc, "rel_attention_block", self._k1)

    def uninstall(self) -> None:
        for owner, name, orig, own in reversed(self._undo):
            if own:
                setattr(owner, name, orig)
            else:  # a method wrapped on the instance: the class's is back
                delattr(owner, name)
        self._undo.clear()

    # ── spans ────────────────────────────────────────────────────────────

    def _span(self, name: str, fn, *a, sync: bool = False, **kw):
        if not self.trace or self.call is None:
            return fn(*a, **kw)
        with torch.profiler.record_function(f"port_bench.{name}"):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            self.call.spans.setdefault(name, []).append((t0, time.perf_counter()))
        return out

    def _keeping(self) -> bool:
        return self.call is not None and self.call.index == self.keep_call

    def _frontend(self, orig):
        def prepare_batch(*a, **kw):
            out = self._span("frontend", orig, *a, sync=True, **kw)
            if self._keeping():
                feats, n_frames = (out[3], out[4]) if len(out) == 5 else out
                self.kept.update(feats=feats, n_frames=list(n_frames))
            return out
        return prepare_batch

    def _encode(self, orig):
        def encode(*a, **kw):
            if self.trace and self.call is not None:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                out = self._span("encoder", orig, *a, **kw)
                end.record()
                self.call.enc_events.append((start, end))
            else:
                out = orig(*a, **kw)
            if self._keeping():
                self.kept["enc"] = out
            return out
        return encode

    def _ctc_head(self, orig):
        def ctc_log_probs(*a, **kw):
            out = self._span("ctc_head", orig, *a, **kw)
            if self._keeping():
                self.kept["log_probs"] = out
            return out
        return ctc_log_probs

    def _ctc_decode(self, orig):
        def ctc_greedy_decode(*a, **kw):
            return self._span("ctc_decode", orig, *a, **kw)
        return ctc_greedy_decode

    def _decode(self, orig):
        def transducer_greedy_decode(*a, **kw):
            res = self._span("decode", orig, *a, **kw)
            if self.call is not None:
                self.call.decoded.extend(res.timestamped)
            return res
        return transducer_greedy_decode

    def _k1(self, orig):
        def rel_attention_block(*a, **kw):
            scope = torch.profiler.record_function("port_bench.k1") if self.call is not None else nullcontext()
            with scope:
                return orig(*a, **kw)
        return rel_attention_block
