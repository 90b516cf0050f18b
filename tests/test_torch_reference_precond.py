"""PyTorch port, the large-level preconditioners end to end: ``assemble``
-> ``mgb_solve`` of fem2d_P2 p=1 at L=3 with DENSE_MAX=50 and
DENSE_BASE=40 (the top level, n_J = 305, takes the preconditioner) under
each ``BIG_PRE`` choice, on the CPU, against the stored JAX x64 records
``mgbtpu_torch/data/ref_fem2d_p2_L3_<choice>.npz``
(``tools/derive_precond_records.py``; four JAX compiles of a full ramp
would cost minutes of tier-1 time).

The bars: the same accepted/attempted steps; z within 1e-8 relative; the
main ramp's Newton its on the steps but the last within 5 %, the last (the
exact-stopping polish) within +-4 (``PERF.md`` section 2's zoo bar). Many
of these CG solves stop at the 150-iteration cap, where a last-bit
difference steers the ramp: each record carries the same JAX solve three
times more under a last-bit change that leaves the method as it is (plain
f64 CG dots, f or g one ulp up). Where those runs move the reference
itself past a bar, the bar is twice the largest such move (``bars``): the
reference cannot be held to more than it holds itself. The CG totals are
printed beside the record's, not held.

``test_records_reproduce`` re-derives the records with JAX (minutes;
marked ``slow``).
"""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "mgbtpu_torch", "data")
CHOICES = ("vcycle", "fsai", "fsai2", "fsai2a")
PERTURBATIONS = ("plain_dots", "ulp_f", "ulp_g")
TOL_Z, TOL_ITS, FLOOR_ITS = 1e-8, 0.05, 4

torch.set_num_threads(1)


def _record(choice):
    return np.load(os.path.join(DATA, f"ref_fem2d_p2_L3_{choice}.npz"))


def bars(ref, tol_z=TOL_Z):
    """(z bar, bar on the steps but the last, bar on the last step): the
    issue's bars, or twice the largest move of the reference's own
    perturbed runs where that is larger. The perturbed runs keep the
    record's accepted/attempted steps at L=3 (held in the test)."""
    z, its = ref["z"], ref["its"].sum(axis=0)
    body, last = int(its[:-1].sum()), int(its[-1])
    dz = max(np.linalg.norm(ref[f"{n}/z"] - z) / np.linalg.norm(z)
             for n in PERTURBATIONS)
    db = max(abs(int(ref[f"{n}/its"].sum(axis=0)[:-1].sum()) - body)
             for n in PERTURBATIONS)
    dl = max(abs(int(ref[f"{n}/its"].sum(axis=0)[-1]) - last)
             for n in PERTURBATIONS)
    return max(tol_z, 2 * dz), max(TOL_ITS * body, 2 * db), \
        max(FLOOR_ITS, 2 * dl)


def _port_solve(choice, monkeypatch):
    import mgbtpu_torch
    from mgbtpu_torch.solver import mgb as MT
    from mgbtpu_torch.solver import newton as NT

    monkeypatch.setattr(MT.ProblemKernels, "DENSE_MAX", 50)
    monkeypatch.setattr(MT.ProblemKernels, "DENSE_BASE", 40)
    monkeypatch.setattr(NT, "BIG_PRE", choice)
    prob = mgbtpu_torch.assemble(mgbtpu_torch.amg(mgbtpu_torch.subdivide(
        mgbtpu_torch.fem2d_P2(), 3)), p=1.0, device="cpu")
    sol = mgbtpu_torch.mgb_solve(prob, device="cpu")
    top = prob.M[0].depth - 1
    ctx = MT._kernels_for(prob.M[0], prob.Q, None,
                          NT.linesearch_backtracking(),
                          torch.device("cpu")).ops(top).pcg_ctx
    return sol, ctx


@pytest.mark.parametrize("choice", CHOICES)
def test_l3_solve_matches_record(choice, monkeypatch):
    ref = _record(choice)
    sol, ctx = _port_solve(choice, monkeypatch)
    assert ctx.nd is None and ctx.n_levels >= 1
    S = sol.SOL_main
    its, its_ref = S["its"].sum(axis=0), ref["its"].sum(axis=0)
    zerr = np.linalg.norm(sol.z - ref["z"]) / np.linalg.norm(ref["z"])
    bz, bb, bl = bars(ref)
    for n in PERTURBATIONS:
        assert np.array_equal(ref[f"{n}/steps"], ref["steps"])
    print(f"{choice}: |z - z_ref|/|z_ref| {zerr!r} (bar {bz!r}); its "
          f"{its.tolist()} vs {its_ref.tolist()}; cg {int(S['cg'].sum())} "
          f"vs {int(ref['cg'].sum())}")
    assert [S["steps_accepted"], S["steps_attempted"]] == \
        ref["steps"].tolist()
    assert zerr <= bz
    assert abs(int(its[:-1].sum()) - int(its_ref[:-1].sum())) <= bb
    assert abs(int(its[-1]) - int(its_ref[-1])) <= bl


def test_vcycle_record_held_to_the_issue_bars():
    """Only the V-cycle's record is stable at the issue's bars under its own
    perturbations; the FSAI family's are not (ROADMAP Queue 3)."""
    assert bars(_record("vcycle"))[0] <= 2 * TOL_Z


@pytest.mark.slow
@pytest.mark.parametrize("choice", CHOICES)
def test_records_reproduce(choice):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import derive_precond_records as D

    ref = _record(choice)
    fresh = D.l3_record(choice)
    for key in ref.files:
        if key.endswith("seconds"):
            continue
        if key.endswith("z"):
            assert np.linalg.norm(fresh[key] - ref[key]) <= \
                1e-12 * np.linalg.norm(ref[key]), key
        else:
            np.testing.assert_array_equal(fresh[key], ref[key], err_msg=key)
