"""The program's own record of each call (parakeet_tpu_torch/trace.py: the
facade's `traces`), paired with the window's calls, for the readers of
frontend_host_ms, encoder_valid_share, decode_wait_ms, decode_step_us and
results_ms.

A record pairs with the window call whose host interval [t0, t1] holds it
(both on time.perf_counter). A call counts when it is outside the profiled
stretch, did not fail and holds exactly one record; any other call is left
out, not guessed. A system with no `traces` (the control, the witness, a
program that keeps none) gives no pairs, and the readers return None.
"""

from __future__ import annotations

import bisect


def paired(run) -> list[tuple]:
    """[(CallRecord, its record)] of the window calls that count."""
    traces = getattr(run.driver.system, "traces", None)
    if traces is None:
        return []
    recs = sorted((r for r in list(traces) if r.t1 is not None), key=lambda r: r.t0)
    starts = [r.t0 for r in recs]
    out = []
    for call in run.calls:
        if call.profiled or run.driver.failed(call):
            continue
        lo, hi = bisect.bisect_left(starts, call.t0), bisect.bisect_right(starts, call.t1)
        inside = [r for r in recs[lo:hi] if r.t1 <= call.t1]
        if len(inside) == 1:
            out.append((call, inside[0]))
    return out


def seconds(rec, *names: str) -> float:
    """The summed duration of the record's spans of these names."""
    return sum(s.t1 - s.t0 for s in rec.spans if s.name in names)


def has(rec, name: str) -> bool:
    return any(s.name == name for s in rec.spans)
