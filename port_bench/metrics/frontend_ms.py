"""frontend_ms (ms): the mean per batch of the host clock around the
facade's prepare_batch (host preemphasis and padding, the copy to the
card, the mel on the card), ending in a synchronise; the calls outside
the profiled stretch."""


def read(run):
    calls = [r for r in run.calls if not r.profiled and "frontend" in r.spans]
    if not calls:
        return None
    return sum(b - a for r in calls for a, b in r.spans["frontend"]) / len(calls) * 1e3
