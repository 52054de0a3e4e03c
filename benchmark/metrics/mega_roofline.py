"""mega_roofline: the least time the whole-net kernel launches of the
traced requests could take (``counts.forward_mega_bound_s`` for every
forward, one launch a sampler step) over their measured device time
(``mega_kernel``), in percent."""

from benchmark.metrics import counts


def read(run):
    return counts.roofline_pct(run, "mega_kernel", counts.forward_mega_bound_s)
