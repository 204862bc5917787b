"""decode_ms (ms): the mean per batch of the host clock around the greedy
transducer decode (decode/transducer.py), which ends in its host fetch of
the emissions; the calls outside the profiled stretch."""


def read(run):
    calls = [r for r in run.calls if not r.profiled and "decode" in r.spans]
    if not calls:
        return None
    return sum(b - a for r in calls for a, b in r.spans["decode"]) / len(calls) * 1e3
