"""copy_ms (``copy_ms.online``, ``copy_ms.batch``): median over the traced
requests of the program's ``solve.copy`` span, the answer's copy to host
memory once the device has finished, in ms."""

from benchmark.metrics import program_spans


def read(run):
    return program_spans.median_ms(run, "solve.copy")
