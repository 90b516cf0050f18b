"""linsolve.device_ms: device milliseconds a solve launched inside the
linear-solve spans (the preconditioner's build and its nd_factor, the CG
refinement and its nd_solve, the dense solves), from the trace."""


def read(run):
    if run.traced is None or not run.solves:
        return None
    ms = run.traced.span_total("linsolve") * 1e3
    return ms / run.solves if ms > 0 else None
