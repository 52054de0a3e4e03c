"""resblock_roofline: the least time the residual-block kernels of the
traced requests could take (``counts.forward_resblock_bound_s`` for every
forward) over their measured device time (kernels named ``resblock_*``),
in percent."""

from benchmark.metrics import counts


def read(run):
    return counts.roofline_pct(run, "resblock_", counts.forward_resblock_bound_s)
