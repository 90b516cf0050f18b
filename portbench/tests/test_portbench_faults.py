"""A whole run on the CPU with the timed path broken underneath: the
program's answers altered where ``mgb_solve`` returns them, or its t-ramp
stopped one step short. Each planted fault, and the float32 control, turns
``correct`` false; the sound run keeps it true."""
import time

import numpy as np
import pytest

from portbench import harness
from portbench.tools import readings as tool


def _run(tiny_bench, workload, monkeypatch, fault=None):
    import mgbtpu_torch as mt

    if fault is not None:
        solve = mt.mgb_solve

        def broken(prob, **kw):
            sol = solve(prob, **kw)
            g = np.asarray(prob.g_grid, dtype=np.float64)
            sol.z = tool.faults(disc, np.asarray(sol.z), g,
                                np.random.default_rng(1))[fault]
            return sol

        monkeypatch.setattr(mt, "mgb_solve", broken)
    cell = harness.find_cell(tiny_bench, workload)
    from portbench import reference

    disc = reference.build(cell.cfg)
    result, lines = harness.run(cell, 2 ** 31 + 99, 0.1, False, time.time(),
                                device="cpu", log=lambda *a: None)
    return result


WORKLOADS = ["fem3d_q3_L5.solve_stream", "fem2d_p2_L7.solve_stream",
             "fem2d_p2_L7.phase1_stream"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(tiny_bench, workload, monkeypatch):
    assert _run(tiny_bench, workload, monkeypatch)["correct"] is True


@pytest.mark.parametrize("fault", ["control", "unchanged", "half",
                                   "altered"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_broken_run_is_not_correct(tiny_bench, workload, fault,
                                   monkeypatch):
    result = _run(tiny_bench, workload, monkeypatch, fault)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("workload", WORKLOADS)
def test_ramp_one_step_short_is_not_correct(tiny_bench, workload,
                                            monkeypatch):
    """Every solve ends at t = 1/(6.5 tol), one t-step short of 1/tol: the
    approximate answer a solve that drops its last step would return."""
    import mgbtpu_torch as mt

    solve = mt.mgb_solve

    def short(prob, **kw):
        return solve(prob, **dict(kw, tol=tool.SHORT * kw["tol"]))

    monkeypatch.setattr(mt, "mgb_solve", short)
    cell = harness.find_cell(tiny_bench, workload)
    result, _ = harness.run(cell, 2 ** 31 + 99, 0.1, False, time.time(),
                            device="cpu", log=lambda *a: None)
    assert result["correct"] is False
    assert result["checks"]["s_gap"]["value"] > \
        result["checks"]["s_gap"]["limit"]
