"""The per-layer metrics that read the program's own spans and counters
(``mgbtpu_torch.utils.trace``): a traced tiny run of each cell reports
each of them as a float >= 0, an untraced run none, and a program without
them leaves them out without an error."""
import sys
import time
from types import SimpleNamespace

import pytest

from portbench import harness

NEW = ("driver.idle_ms", "linsolve.idle_ms", "linsolve.fronts_ms",
       "kernels.enqueue_ms", "kernels.launches")
CELLS = {"fem3d_q3_L5.solve_stream": ".dev",
         "fem2d_p2_L7.solve_stream": ".host"}


def _run(tiny_bench, workload, trace, seed=2 ** 31 + 29):
    cell = harness.find_cell(tiny_bench, workload)
    return harness.run(cell, seed, 0.5, trace, time.time(), device="cpu",
                       log=lambda *a: None)


@pytest.mark.parametrize("workload", sorted(CELLS))
@pytest.mark.parametrize("trace", [False, True])
def test_new_metrics_in_traced_runs_alone(tiny_bench, workload, trace):
    result, _ = _run(tiny_bench, workload, trace)
    assert result["correct"] is True
    names = [n + CELLS[workload] for n in NEW]
    got = result["metrics"]
    for name in names:
        if trace:
            assert isinstance(got[name]["value"], float), name
            assert got[name]["value"] >= 0, (name, got[name])
        else:
            assert name not in got


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_them_reports_none(monkeypatch, name):
    monkeypatch.setitem(sys.modules, "mgbtpu_torch.utils.trace", None)
    traced = SimpleNamespace(idle_s={"driver.main": 1.0}, span_s={},
                             span_total=lambda prefix: 0.0)
    run = harness.Run(solves=2, traced=traced)
    assert harness.reader(name)(run) is None
