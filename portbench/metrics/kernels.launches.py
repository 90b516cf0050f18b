"""kernels.launches: hand-kernel launches a solve, the program's counters
(``kernels.launches()``) over the window's solve records, all kernels."""
from portbench.records import window_records


def read(run):
    recs = window_records(run)
    if recs is None:
        return None
    return sum(sum(r["launches"].values()) for r in recs) / len(recs)
