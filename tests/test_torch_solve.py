"""PyTorch port, end to end on the CPU: ``mgb_solve(device="cpu")`` on
fem2d_P2, p=1 matches the JAX x64 solve — at L=3 on the dense path and at
L=3 with ``DENSE_MAX`` lowered on BOTH sides so that the nested-dissection
CG path engages (same solution to 1e-8, identical Newton iterations per
level and per ramp step), and at L=2 (same solution, identical iterations
on every ramp step but the last; see ``test_l2``). It reproduces the
reference's fem2d_P2 golden vector and runs phase I from an infeasible
start as JAX does. The entry points default to the card and raise without
one."""
import numpy as np
import pytest
import torch

import mgbtpu
import mgbtpu_torch
from mgbtpu.solver.mgb import ProblemKernels as KernelsJ
from mgbtpu_torch.solver.mgb import ProblemKernels as KernelsT

torch.set_num_threads(1)
TOL_Z = 1e-8


def _solve_both(L):
    pj = mgbtpu.assemble(mgbtpu.amg(mgbtpu.subdivide(mgbtpu.fem2d_P2(), L)),
                         p=1.0)
    sj = mgbtpu.mgb_solve(pj)
    pt = mgbtpu_torch.assemble(
        mgbtpu_torch.amg(mgbtpu_torch.subdivide(mgbtpu_torch.fem2d_P2(), L)),
        p=1.0, device="cpu")
    st = mgbtpu_torch.mgb_solve(pt, device="cpu")
    assert st.z.shape == sj.z.shape
    assert np.linalg.norm(st.z - sj.z) <= TOL_Z * np.linalg.norm(sj.z)
    Sj, St = sj.SOL_main, st.SOL_main
    assert St["steps_accepted"] == Sj["steps_accepted"]
    assert St["steps_attempted"] == Sj["steps_attempted"]
    np.testing.assert_allclose(St["ts"], Sj["ts"], rtol=1e-12)
    return Sj, St


def test_l3_dense():
    Sj, St = _solve_both(3)
    np.testing.assert_array_equal(St["its"], Sj["its"])


def test_l3_nested_dissection(monkeypatch):
    monkeypatch.setattr(KernelsJ, "DENSE_MAX", 100)
    monkeypatch.setattr(KernelsT, "DENSE_MAX", 100)
    Sj, St = _solve_both(3)
    assert St["cg"].sum() > 0          # the ND-preconditioned CG ran
    np.testing.assert_array_equal(St["its"], Sj["its"])
    np.testing.assert_array_equal(St["cg"], Sj["cg"])


def test_l2():
    """Every ramp step but the last needs the same Newton iterations. The
    last one ends in the exact-stopping ``finalize`` polish, whose test
    compares objective values that differ from one another in their last
    bits (|f| ~ 3e8 at t = 1/tol, decrements ~ 1e-12): it counts roundoff,
    and XLA (which contracts the linear term's reduction into FMAs) and
    PyTorch round differently. The solutions agree to ~1e-12."""
    Sj, St = _solve_both(2)
    np.testing.assert_array_equal(St["its"][:, :-1], Sj["its"][:, :-1])
    assert abs(int(St["its"][:, -1].sum()) - int(Sj["its"][:, -1].sum())) <= 4


def test_illinois_line_search():
    """The exact (Illinois) line search, off the default path: same
    solution and the same Newton iterations on every ramp step at L=1."""
    pj = mgbtpu.assemble(mgbtpu.amg(mgbtpu.subdivide(mgbtpu.fem2d_P2(), 1)),
                         p=1.0)
    sj = mgbtpu.mgb_solve(pj, line_search=mgbtpu.linesearch_illinois())
    pt = mgbtpu_torch.assemble(
        mgbtpu_torch.amg(mgbtpu_torch.subdivide(mgbtpu_torch.fem2d_P2(), 1)),
        p=1.0, device="cpu")
    st = mgbtpu_torch.mgb_solve(
        pt, device="cpu", line_search=mgbtpu_torch.linesearch_illinois())
    assert np.linalg.norm(st.z - sj.z) <= TOL_Z * np.linalg.norm(sj.z)
    np.testing.assert_array_equal(st.SOL_main["its"], sj.SOL_main["its"])


def test_golden_fem2d_p2():
    """The reference's hard-coded fem2d_P2 p=1 vector (tests/test_golden.py
    ``test_fem2d_P2_p1``), to the same 1e-6."""
    gold = np.asarray([
        2.0, 1.0, 2.0, 1.0, 2.0, 1.0, 0.9629629615502254, 2.0, 1.0, 2.0, 1.0,
        2.0, 1.0, 0.9629629615502254, 2.8284271303696036, 0.0, 2.0, 0.0, 2.0,
        0.0, 0.0, 2.0, 0.0, 2.8284271303696036, 0.0, 2.0, 0.0, 0.0,
    ]).reshape(2, -1).T
    prob = mgbtpu_torch.assemble(mgbtpu_torch.amg(mgbtpu_torch.fem2d_P2()),
                                 p=1.0, device="cpu")
    sol = mgbtpu_torch.mgb_solve(prob, device="cpu")
    assert np.linalg.norm(sol.z - gold) < 1e-6
    assert "device" in sol.log


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    geom = mgbtpu_torch.subdivide(mgbtpu_torch.fem2d_P2(), 1)
    mg = mgbtpu_torch.amg(geom)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgbtpu_torch.assemble(mg, p=1.0)
    prob = mgbtpu_torch.assemble(mg, p=1.0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgbtpu_torch.mgb_solve(prob)


def test_phase_one_from_an_infeasible_start():
    """s = 0 at the start is outside the cone: both packages run phase I
    (the feasibility barrier with its bounding box), match the central
    point's t (``_matched_t``), then the main ramp."""
    L = 2

    def g(x):
        return np.array([float(x[0] ** 2 + x[1] ** 2), 0.0])

    pj = mgbtpu.assemble(mgbtpu.amg(mgbtpu.subdivide(mgbtpu.fem2d_P2(), L)),
                         p=1.0, g=g)
    sj = mgbtpu.mgb_solve(pj)
    pt = mgbtpu_torch.assemble(
        mgbtpu_torch.amg(mgbtpu_torch.subdivide(mgbtpu_torch.fem2d_P2(), L)),
        p=1.0, g=g, device="cpu")
    st = mgbtpu_torch.mgb_solve(pt, device="cpu")
    assert st.SOL_feasibility is not None and sj.SOL_feasibility is not None
    assert "entering phase I" in st.log
    np.testing.assert_array_equal(st.SOL_feasibility["its"],
                                  sj.SOL_feasibility["its"])
    np.testing.assert_allclose(st.SOL_main["ts"][0], sj.SOL_main["ts"][0],
                               rtol=1e-12)
    assert np.linalg.norm(st.z - sj.z) <= TOL_Z * np.linalg.norm(sj.z)
    # The last two ramp steps (t >= 1e7) run at the objective's roundoff
    # floor: the predicted decrease (~1e-10) is below one ulp of f (~7e-9),
    # so whether the line search sees "no decrease" and stops exactly is
    # decided by the last bits of f (see test_l2).
    Sj, St = sj.SOL_main, st.SOL_main
    assert St["steps_accepted"] == Sj["steps_accepted"]
    np.testing.assert_array_equal(St["its"][:, :-2], Sj["its"][:, :-2])
    assert abs(int(St["its"][:, -2:].sum()) - int(Sj["its"][:, -2:].sum())) <= 4
