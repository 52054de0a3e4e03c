"""stage_ms (``stage_ms.online``, ``stage_ms.batch``): median over the traced
requests of the program's ``solve.stage`` span, from ``Solver.solve``'s entry
to just before the program runs (checks, pad, unnormalize, mask, the pinned
copies in and the noise draw), in ms."""

from benchmark.metrics import program_spans


def read(run):
    return program_spans.median_ms(run, "solve.stage")
