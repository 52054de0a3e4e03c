"""solve_ms.online: median of the span around each Solver.solve call in the
window: service time without the queue."""

import numpy as np


def read(run):
    return float(np.median([1e3 * (d.end - d.start) for d in run.done if d.ok]))
