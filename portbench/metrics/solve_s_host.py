"""solve_s_host: the window's seconds over the solves completed in it, on
the host clock; the metric of a cell whose host loop paces the solve, kept
apart from solve_s so that host noise cannot widen solve_s's bound."""


def read(run):
    return run.window_s / run.solves if run.solves else None
