"""The readers of the program's own record (program_trace.py and the five
metrics that read it) on a traced run of the tiny cell on the CPU, its scratch
BENCHMARK.json listing the cell in the new metrics' workloads: each reads a
number, the host part of the frontend lies under the benchmark's frontend
span, and the decode's waits and steps under its decode span. A window call
with no record, or with two, is left out, not guessed.

The profiler records the CPU only here; the card's synchronise and events are
stood in for by host ones, which is all a CPU run can time."""

import json
import time
from dataclasses import dataclass
from types import SimpleNamespace

import pytest
import torch

from port_bench import devtrace, harness
from port_bench import program_trace as PT
from port_bench import roofline as RF
from port_bench.probe import CallRecord
from port_bench.tests.tiny import CELL, REPO, tiny_root
from parakeet_tpu_torch import trace as TRACE

LIMITS = {"tdt": "tdt600m.archive", "ctc": "tdt110m.ctc_archive"}  # the real cell of each decode
NEW = ("frontend_host_ms", "encoder_valid_share", "decode_wait_ms", "decode_step_us", "results_ms")
DECODE = ("decode_wait_ms", "decode_step_us")


class _HostEvent:
    """torch.cuda.Event's timing, on the host clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, *a):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


class _CPUWindow(devtrace.TraceWindow):
    def __init__(self):
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
        self._scope = None

    def stop(self):
        self._scope.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def traced_run(tmp_path, monkeypatch, decoder: str, timestamps: bool):
    """(result line, RunView with its pairs) of one traced tiny run."""
    limits = json.loads((REPO / "port_bench/limits" / f"{LIMITS[decoder]}.json").read_text())
    root = tiny_root(tmp_path, decoder=decoder, timestamps=timestamps, limits=limits)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] in NEW + ("decode_ms",):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(devtrace, "warm_profiler", lambda: None)
    monkeypatch.setattr(devtrace, "TraceWindow", _CPUWindow)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", _HostEvent)
    views = []

    @dataclass
    class View(harness.RunView):
        def __post_init__(self):
            self.pairs = PT.paired(self)  # before the run frees the facade
            views.append(self)

    monkeypatch.setattr(harness, "RunView", View)
    res = harness.run(root, CELL, 2**31 + 11, 1.0, True, time.perf_counter(), device="cpu")
    return res, views[0]


def test_tdt_readers_read_under_the_benchmark_spans(tmp_path, monkeypatch):
    res, view = traced_run(tmp_path, monkeypatch, "tdt", True)
    assert res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(NEW) <= set(m) and all(isinstance(m[k], float) for k in NEW), m
    unprofiled = [r for r in view.calls if not r.profiled]
    assert unprofiled and len(view.pairs) == len(unprofiled)
    assert 0 < m["frontend_host_ms"] < m["frontend_ms"]
    steps = sum(rec.counts["decode.steps"] for _, rec in view.pairs) / len(view.pairs)
    assert steps > 0
    assert m["decode_wait_ms"] > 0 and m["decode_step_us"] > 0
    assert m["decode_wait_ms"] + m["decode_step_us"] * steps / 1e3 <= m["decode_ms"]
    assert 0 < m["results_ms"]
    # the program's spans lie inside the benchmark's span of the same layer
    for call, rec in view.pairs:
        for name in ("frontend", "encoder", "decode"):
            (outer,) = call.spans[name] if name != "encoder" else [(e[0].t, e[1].t) for e in call.enc_events]
            (inner,) = [(s.t0, s.t1) for s in rec.spans if s.name == name]
            assert outer[0] <= inner[0] and inner[1] <= outer[1], name


@pytest.mark.parametrize("decoder, timestamps", [("tdt", True), ("ctc", False)])
def test_valid_share_counts_the_clips_own_lengths(tmp_path, monkeypatch, decoder, timestamps):
    res, view = traced_run(tmp_path, monkeypatch, decoder, timestamps)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    hop = view.cell.config["audio"]["hop_length"]
    valid = frames = 0
    for call, rec in view.pairs:
        lens = [RF.subsampled_length(len(view.driver.pool[c]) // hop + 1) for c in call.clips]
        assert rec.counts["encoder.valid_frames"] == sum(lens)
        assert rec.counts["encoder.frames"] == len(lens) * max(lens)
        valid, frames = valid + sum(lens), frames + len(lens) * max(lens)
    assert m["encoder_valid_share"] == pytest.approx(valid / frames * 100)
    assert m["encoder_valid_share"] < 100  # the tiny mix pads
    if decoder == "ctc":
        assert not set(DECODE) & set(m) and {"frontend_host_ms", "results_ms"} <= set(m)


def _record(t0: float, t1: float, steps: int = 4):
    """A closed record of a decoded call between t0 and t1, its spans at
    fixed offsets."""
    rec = TRACE.CallTrace()
    rec.t0, rec.t1 = t0, t1
    sp = TRACE.Span
    rec.spans = [sp("batch", -1, t0, t1), sp("frontend", 0, t0, t0 + 0.010),
                 sp("frontend.load", 1, t0, t0 + 0.001), sp("frontend.host", 1, t0 + 0.001, t0 + 0.003),
                 sp("frontend.copy", 1, t0 + 0.003, t0 + 0.004), sp("decode", 0, t0 + 0.015, t0 + 0.05),
                 sp("decode.upload", 5, t0 + 0.015, t0 + 0.018),
                 sp("decode.loop", 5, t0 + 0.02, t0 + 0.04), sp("decode.check", 7, t0 + 0.02, t0 + 0.03),
                 sp("decode.fetch", 5, t0 + 0.04, t0 + 0.045), sp("decode.unpack", 5, t0 + 0.045, t0 + 0.05),
                 sp("results", 0, t0 + 0.05, t0 + 0.06)]
    rec.counts = {"encoder.frames": 100, "encoder.valid_frames": 40, "decode.steps": steps}
    return rec


def _run(calls, traces, failed=()):
    system = SimpleNamespace() if traces is None else SimpleNamespace(traces=traces)
    return SimpleNamespace(calls=calls, driver=SimpleNamespace(system=system, failed=lambda r: r.index in failed))


def _call(i, t0, t1, profiled=False):
    return CallRecord(i, 0, [0], 1.0, t0=t0, t1=t1, profiled=profiled)


def test_a_call_without_exactly_one_record_is_left_out():
    calls = [_call(0, 0.0, 1.0), _call(1, 1.0, 2.0), _call(2, 2.0, 3.0), _call(3, 3.0, 4.0),
             _call(4, 4.0, 5.0, profiled=True), _call(5, 5.0, 6.0), _call(6, 6.0, 7.0)]
    kept = _record(0.1, 0.9, steps=4)
    traces = [kept,  # call 1 holds none
              _record(2.1, 2.4), _record(2.5, 2.9),  # call 2 holds two
              _record(3.5, 4.5),  # straddles calls 3 and 4: held by neither
              _record(4.1, 4.9),  # call 4 is profiled
              _record(5.1, 5.9),  # call 5 failed
              _record(6.1, 6.9, steps=8)]
    traces[-1].spans = [s._replace(t1=s.t0 + 2 * (s.t1 - s.t0)) if s.name == "decode.check" else s
                        for s in traces[-1].spans]
    run = _run(calls, traces, failed={5})
    assert [(c.index, r) for c, r in PT.paired(run)] == [(0, kept), (6, traces[-1])]
    read = {name: harness.Registry(REPO).reader(name) for name in NEW}
    assert read["frontend_host_ms"](run) == pytest.approx(4.0)
    assert read["encoder_valid_share"](run) == pytest.approx(40.0)
    assert read["decode_wait_ms"](run) == pytest.approx((0.003 + 0.010 + 0.005 + 0.003 + 0.020 + 0.005) / 2 * 1e3)
    assert read["decode_step_us"](run) == pytest.approx((0.010 + 0.0) / 12 * 1e6)
    assert read["results_ms"](run) == pytest.approx(15.0)
    for name in NEW:  # no record to read, or no record kept at all
        assert read[name](_run(calls[1:2], traces)) is None
        assert read[name](_run(calls, None)) is None
