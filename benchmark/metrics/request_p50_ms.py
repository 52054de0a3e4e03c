"""request_p50_ms: median latency of every request due in the window, from
its due time to its answer on the host (a failed request: until it was
given up)."""

import numpy as np


def read(run):
    return float(np.percentile([1e3 * (d.end - d.due) for d in run.done], 50))
