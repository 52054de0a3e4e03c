"""load_s: seconds of the run's set-up in the program's ``load`` span
(``Solver.from_checkpoint``: the checkpoint's read, with the CUDA context
where it is the process's first, and the net's build on the device)."""

from benchmark.metrics import program_spans


def read(run):
    spans = program_spans.setup()
    if spans is None:
        return None
    return sum(program_spans.ms(s) for s in spans if s.name == "load") / 1e3
