"""frontend_host_ms (ms): the mean per batch of the program's
`frontend.load` + `frontend.host` + `frontend.copy` spans (prepare_batch:
the sources read into samples, host preemphasis, reflect pad and the padded
array, its pageable copy to the card), the host's work before the mel's
first launch; the calls outside the profiled stretch that hold one record
(program_trace.py)."""

from port_bench.program_trace import paired, seconds


def read(run):
    pairs = paired(run)
    if not pairs:
        return None
    return sum(seconds(rec, "frontend.load", "frontend.host", "frontend.copy") for _, rec in pairs) / len(pairs) * 1e3
