"""resblock256_roofline: the residual-block kernels of the 256-wide output
class alone (the wide path's widest template, 32-row tiles only): the least
time their launches of the traced requests could take over their measured
device time, in percent. The bound sums ``counts.resblock_work`` over the
blocks whose output is 256 wide, at the CFG fold's 2 x rows rows, once a
sampler step, and takes the larger of operations over the float32 peak and
bytes over HBM bandwidth; the time is that of the device operations named
``resblock_wide`` with 256 as the output class."""

import re
import types

from benchmark.metrics import counts

#: The wide kernel's template arguments, tile rows and output class, in a
#: device operation's name: ``resblock_wide<32, 256>`` as the profiler names
#: it, ``resblock_wide_32__256_`` with the punctuation replaced.
WIDE = re.compile(r"resblock_wide(?:<\s*|_)(\d+)(?:,\s*|__)(\d+)")
OUT = 256


def output_class(name: str):
    m = WIDE.search(name)
    return int(m.group(2)) if m else None


def bound_s(model, rows):
    work = [counts.resblock_work(l, rows) for l in counts.layers(model)
            if l.kind == "block" and l.dout == OUT]
    return max(sum(w[0] for w in work) / counts.PEAK_F32_FLOPS,
               sum(w[1] for w in work) / counts.PEAK_HBM_BYTES)


def read(run):
    p = run.profile
    if p is None:
        return None
    wide = {n: v for n, v in p.device_ops.items() if output_class(n) == OUT}
    view = types.SimpleNamespace(**{**vars(run), "profile": p._replace(device_ops=wide)})
    return counts.roofline_pct(view, "resblock_wide", bound_s)
