"""Shared pieces of the benchmark's CPU tests: the checkout's root on the
path, and the benchmark's own cells with their configurations cut to a
level that the CPU solves in about a second."""
import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

DATA = "portbench/tests/data"
TINY = {"fem3d_q3_L5": f"{DATA}/fem3d_q3_L2.json",
        "fem2d_p2_L7": f"{DATA}/fem2d_p2_L3.json"}


@pytest.fixture(scope="session")
def bench():
    from portbench import harness

    return harness.load_benchmark()


# a cell whose mix, limits and readings are committed under portbench/ but
# whose entry waits in PERF.md's Open questions; the tiny benchmark carries
# it so that the phase-I path of the harness stays tested
OPEN_CELL = {"name": "fem2d_p2_L7.phase1_stream", "config": "fem2d_p2_L7",
             "traffic": "phase1_stream", "chips": 1,
             "why": "as solve_stream from an infeasible start (s = 0)"}


@pytest.fixture(scope="session")
def tiny_bench(bench):
    """BENCHMARK.json with each configuration's file swapped for its tiny
    twin, and the open phase-I cell reporting what the fem2d cell does;
    cells, mixes, metrics and limits as committed."""
    out = copy.deepcopy(bench)
    for c in out["configs"]:
        c["file"] = TINY[c["name"]]
    out["workloads"].append(dict(OPEN_CELL))
    for m in out["end_to_end"] + out["per_layer"]:
        if "fem2d_p2_L7.solve_stream" in m.get("workloads", []):
            m["workloads"].append(OPEN_CELL["name"])
    return out
