"""decode_step_us (us): the program's `decode.loop` less its `decode.check`
spans, over its `decode.steps` (TransducerResult.steps), summed over the
calls outside the profiled stretch that hold one record with a decode
(program_trace.py): the host time to launch one lockstep iteration."""

from port_bench.program_trace import has, paired, seconds


def read(run):
    recs = [rec for _, rec in paired(run) if has(rec, "decode.loop")]
    steps = sum(rec.counts.get("decode.steps", 0) for rec in recs)
    if not steps:
        return None
    return sum(seconds(rec, "decode.loop") - seconds(rec, "decode.check") for rec in recs) / steps * 1e6
