"""encoder_valid_share (%): the program's `encoder.valid_frames` (the sum
of each clip's encoded length) over its `encoder.frames` (B × T' of the
encoder's output), summed over the calls outside the profiled stretch that
hold one record (program_trace.py): the share of the encoder's rows that
are not padding."""

from port_bench.program_trace import paired


def read(run):
    recs = [rec for _, rec in paired(run) if rec.counts.get("encoder.frames")]
    if not recs:
        return None
    return sum(r.counts["encoder.valid_frames"] for r in recs) / sum(r.counts["encoder.frames"] for r in recs) * 100.0
