"""batch_mfu (%): the model FLOPs that the batches' valid frames need
(roofline.py, counted from the configuration's widths: the encoder, then
the CTC head or the joint and prediction LSTM for the decode steps taken)
over the calls' wall time and the bf16 peak of 989 TFLOP/s; the calls
outside the profiled stretch. The card's power limit is in the result's
device line."""

from port_bench import roofline as RF


def read(run):
    calls = [r for r in run.calls if not r.profiled and not run.driver.failed(r)]
    if not calls:
        return None
    return sum(run.driver.flops(r) for r in calls) / sum(r.wall_s for r in calls) / RF.BF16_PEAK * 100.0
