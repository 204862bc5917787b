"""idle_share (%): the share of the profiled stretch's wall time in which
no kernel, copy or set ran on the device (the union of device intervals on
the profiler's timeline)."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return (1.0 - tr.busy_s / tr.window_s) * 100.0
