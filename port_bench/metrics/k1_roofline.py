"""k1_roofline (%): K1's least time (roofline.py k1_call_bound at the bf16
or f32 peak and 3.35 TB/s: each clip's rows and keys at its own length,
no padded row, the weights once a call) over its device time in the
profiled stretch: the kernels launched inside the K1 entry
(models.encoder.rel_attention_block), summed over every layer of every
profiled call."""

from port_bench import roofline as RF


def read(run):
    tr = run.trace
    calls = [r for r in run.calls if r.profiled]
    enc = run.cell.config["config"]["encoder"]
    if tr is None or not tr.k1_s or tr.k1_calls != len(calls) * enc["num_layers"]:
        return None
    itemsize = 2 if run.cell.config["compute_dtype"] == "bfloat16" else 4
    hop = run.cell.config["audio"]["hop_length"]
    bound_ms = 0.0
    for r in calls:
        lens = [RF.subsampled_length(len(run.driver.pool[c]) // hop + 1) for c in r.clips]
        bound_ms += RF.k1_call_bound(lens, enc["hidden_size"], enc["num_heads"], itemsize)["bound_ms"]
    return bound_ms * enc["num_layers"] / (tr.k1_s * 1e3) * 100.0
