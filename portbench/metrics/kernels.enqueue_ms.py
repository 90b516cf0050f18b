"""kernels.enqueue_ms: host milliseconds a solve inside the hand kernels'
wrappers (argument checks, allocation, the launch), the program's counter
``enqueue_ns`` of the window's solve records, all kernels."""
from portbench.records import window_records


def read(run):
    recs = window_records(run)
    if recs is None:
        return None
    return sum(sum(r["enqueue_ns"].values()) for r in recs) \
        / len(recs) / 1e6
