"""batch_p95_ms (ms): the 95th percentile (linear interpolation) of the
host wall time of every transcribe_batch call in the window."""

import numpy as np


def read(run):
    return float(np.percentile([r.wall_s * 1e3 for r in run.calls], 95))
