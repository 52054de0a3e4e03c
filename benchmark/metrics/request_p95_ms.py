"""request_p95_ms: the 95th percentile of the same latencies, over every
request due in the window."""

import numpy as np


def read(run):
    return float(np.percentile([1e3 * (d.end - d.due) for d in run.done], 95))
