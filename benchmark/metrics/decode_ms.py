"""decode_ms (``decode_ms.batch``): median over the traced requests of the
device time of the program's decoders, the ``device_decode_ms`` attribute
of each request's ``solve.wait`` span (the program's timing events between
sampling and the decode's end, read once the answer is on the host), in ms;
None where the program records no such attribute."""

import numpy as np

from benchmark.metrics import program_spans


def read(run):
    waits = [r.get("solve.wait") for r in program_spans.requests(run) or ()]
    got = [w.attrs["device_decode_ms"] for w in waits
           if w is not None and "device_decode_ms" in w.attrs]
    return float(np.median(got)) if got else None
