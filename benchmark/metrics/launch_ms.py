"""launch_ms (``launch_ms.online``, ``launch_ms.batch``): median over the
traced requests of the program's ``solve.launch`` span, the graph's replay on
the host (or its capture, or the eager program's enqueue), in ms."""

from benchmark.metrics import program_spans


def read(run):
    return program_spans.median_ms(run, "solve.launch")
