"""solve_s: the window's seconds over the solves completed in it, on the
host clock; the metric of a cell whose device is busy most of the window."""


def read(run):
    return run.window_s / run.solves if run.solves else None
