"""levelfn.device_ms: device milliseconds a solve launched inside the level
functions' spans (f0, f1, f2: K1, K2 or K6, K3, the node factors, the dense
Hessian), from the trace."""


def read(run):
    if run.traced is None or not run.solves:
        return None
    ms = run.traced.span_total("levelfn") * 1e3
    return ms / run.solves if ms > 0 else None
