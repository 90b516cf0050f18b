"""newton.syncs: host syncs a solve (``solver.newton.SYNCS``), the
program's counter, averaged over the window's solves."""


def read(run):
    return run.per_solve(run.syncs)
