"""linsolve.fronts_ms: device milliseconds a solve launched inside the
program's ``linsolve.nd_factor.fronts`` spans: the ND factor's front
assembly (the leaf scatter-add, the children's Schur gathers, the diagonal
shifts), apart from K5a's own kernels, from the trace."""
from portbench.records import program_trace


def read(run):
    if run.traced is None or not run.solves or program_trace() is None:
        return None
    return 1e3 * run.traced.span_total("linsolve.nd_factor.fronts") \
        / run.solves
