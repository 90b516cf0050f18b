"""linsolve.idle_ms: device idle milliseconds a solve while the host was
inside the linear solves' spans (``linsolve.nd_factor``, ``.nd_solve``,
``.cg``, ``.precondition``, ``.dense`` and their children): the host's
enqueue and loop around the ND factor and solve, from the trace."""
from portbench.records import idle_ms


def read(run):
    return idle_ms(run, "linsolve")
