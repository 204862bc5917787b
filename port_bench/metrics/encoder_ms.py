"""encoder_ms (ms): the mean per batch of the CUDA-event time around the
facade's encode (subsampling and conformer blocks); the calls outside the
profiled stretch."""


def read(run):
    calls = [r for r in run.calls if not r.profiled and r.enc_events]
    if not calls:
        return None
    return sum(a.elapsed_time(b) for r in calls for a, b in r.enc_events) / len(calls)
