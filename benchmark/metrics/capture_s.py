"""capture_s: seconds of the run's set-up spent capturing CUDA graphs: the
program's ``capture`` spans (the eager first runs and the capture), less any
``kernels.build`` (the nvcc build of a cold checkout) inside them; 0 where
nothing was captured (the CPU)."""

from benchmark.metrics import program_spans


def read(run):
    spans = program_spans.setup()
    if spans is None:
        return None
    captures = [s for s in spans if s.name == "capture"]
    builds = [b for b in spans if b.name == "kernels.build"
              and any(c.start_ns <= b.start_ns and b.end_ns <= c.end_ns for c in captures)]
    return (sum(map(program_spans.ms, captures)) - sum(map(program_spans.ms, builds))) / 1e3
