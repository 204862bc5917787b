"""results_ms (ms): the mean per batch of the program's `decode.unpack`
span (the host token lists and TimestampedTokens of a transducer decode,
where there is one) and its `results` span (TranscribeResults: detokenising
and word grouping); the calls outside the profiled stretch that hold one
record (program_trace.py)."""

from port_bench.program_trace import paired, seconds


def read(run):
    pairs = paired(run)
    if not pairs:
        return None
    return sum(seconds(rec, "decode.unpack", "results") for _, rec in pairs) / len(pairs) * 1e3
