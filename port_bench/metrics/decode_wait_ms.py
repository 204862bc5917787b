"""decode_wait_ms (ms): the mean per batch of the program's `decode.upload`
(the lengths and durations copied to the card, which the host waits for:
the first copy waits out the encoder's unfinished kernels), its
`decode.check` spans (each host check of "any item still active") and its
`decode.fetch` (the emissions to the host): the host blocked on the card
inside the greedy transducer decode, the encoder's tail included; the calls
outside the profiled stretch that hold one record with a decode
(program_trace.py)."""

from port_bench.program_trace import has, paired, seconds


def read(run):
    recs = [rec for _, rec in paired(run) if has(rec, "decode.loop")]
    if not recs:
        return None
    return sum(seconds(rec, "decode.upload", "decode.check", "decode.fetch") for rec in recs) / len(recs) * 1e3
