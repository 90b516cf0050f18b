"""newton.its: Newton iterations a solve (SOL_main plus SOL_feasibility),
the program's counters, averaged over the window's solves."""


def read(run):
    return run.per_solve(run.its)
