"""The profiler over a short steady stretch of a traced run, reduced to
what the per-layer readers and the result's breakdown need.

The stretch is one profiler annotation, "port_bench.traced", that closes
after a synchronise, so every device event of its calls lies inside it.
Busy time is the union of the device's kernel, copy and set intervals
inside the stretch. K1's device time is the time of the kernels whose
launch (the runtime or driver call with the same correlation id) lies
inside a "port_bench.k1" annotation. Each idle gap is named by the
innermost benchmark annotation open on the host when it ended.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from dataclasses import dataclass, field

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    k1_s: float | None
    k1_calls: int
    device_ops: list = field(default_factory=list)  # [[name, seconds]], most first
    idle_gaps: list = field(default_factory=list)  # [[host span, seconds]], most first


def warm_profiler() -> None:
    """The profiler's first start loads and initialises CUPTI: done in
    set-up, on one small operation."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(8, device="cuda").sum().item()


class TraceWindow:
    def __init__(self):
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                       torch.profiler.ProfilerActivity.CUDA])
        self._scope = None

    def start(self) -> None:
        self.prof.__enter__()
        self._scope = torch.profiler.record_function("port_bench.traced")
        self._scope.__enter__()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._scope.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def summarize(self) -> TraceSummary:
        """Export the stopped profile (under TMPDIR, deleted after) and
        reduce it."""
        fd, path = tempfile.mkstemp(suffix=".json", prefix="port_bench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return summarize(events)


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(events: list[dict]) -> TraceSummary:
    """Reduce a chrome trace (timestamps in µs) to a TraceSummary."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in xs if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith("port_bench.")]
    traced = [e for e in spans if e["name"] == "port_bench.traced"]
    if not traced:
        raise RuntimeError("the trace holds no port_bench.traced annotation")
    w0, w1 = traced[0]["ts"], traced[0]["ts"] + traced[0]["dur"]
    device = [e for e in xs if e.get("cat") in DEVICE_CATS and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    busy = _union([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in device])

    by_name: dict[str, float] = {}
    for e in device:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    # K1: kernels launched inside a port_bench.k1 annotation
    k1 = sorted((e["ts"], e["ts"] + e["dur"]) for e in spans if e["name"] == "port_bench.k1")
    k1_starts = [a for a, _ in k1]
    launches = set()
    for e in xs:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            i = bisect.bisect_right(k1_starts, e["ts"]) - 1
            if i >= 0 and e["ts"] <= k1[i][1]:
                launches.add(e["args"]["correlation"])
    k1_dev = [e["dur"] for e in device if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in launches]

    # idle gaps, named by the innermost host span open when each ended (the
    # host work that launched the next device operation; the last gap by
    # the span open when it began)
    named = sorted(((e["ts"], e["ts"] + e["dur"], e["name"][len("port_bench."):]) for e in spans
                    if e["name"] not in ("port_bench.traced", "port_bench.k1")), key=lambda s: (s[0], -s[1]))
    gaps: dict[str, list[float]] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        at = b if b < w1 else a
        label = "between calls"
        for s0, s1, name in named:
            if s0 > at:
                break
            if at <= s1:
                label = name  # later-starting spans that still cover it are nested deeper
        gaps.setdefault(label, []).append((b - a) / 1e6)
    idle = sorted(([f"{k} ({len(v)} gaps, longest {max(v):.6f} s)", sum(v)] for k, v in gaps.items()),
                  key=lambda kv: -kv[1])[:10]
    return TraceSummary(
        window_s=(w1 - w0) / 1e6,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        k1_s=sum(k1_dev) / 1e6 if k1_dev else None,
        k1_calls=len(k1),
        device_ops=[[name, s] for name, s in ops],
        idle_gaps=idle,
    )
