"""solutions_per_s: rows answered in the window over the window's seconds."""


def read(run):
    return sum(d.rows for d in run.done if d.ok) / run.window_s
