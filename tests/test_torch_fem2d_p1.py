"""PyTorch port, fem2d_P1 on the CPU against JAX x64: the geometry, the
boundary, the AMG hierarchy and every level's panel plan equal the JAX
package's to 1e-14 (L = 2 and 3, and the geometric hierarchy), and the p=1
solve of ``tests/test_paths.py::test_fem2d_P1_solve`` matches the JAX x64
one to 1e-8 with the same Newton iterations on every ramp step but the
last (the exact-stopping polish, decided at the roundoff floor, +-4); so
does the port's p=1 L=5 solve against the stored x64 record that
``chip_smoke.py`` holds the card to (run with ``-s`` for its counts)."""
import os

import numpy as np
import pytest
import torch

import mgbtpu
import mgbtpu_torch
from port_parity import close, close_sparse, same_systems

torch.set_num_threads(1)
TOL_Z = 1e-8
REF_L5 = os.path.join(os.path.dirname(mgbtpu_torch.__file__), "data",
                      "ref_fem2d_p1_L5.npz")


@pytest.mark.parametrize("L", [2, 3])
def test_setup_matches_jax(L):
    gj = mgbtpu.subdivide(mgbtpu.fem2d_P1(), L)
    gt = mgbtpu_torch.subdivide(mgbtpu_torch.fem2d_P1(), L)
    close(gt.x, gj.x)
    close(gt.w, gj.w)
    np.testing.assert_array_equal(gt.t, gj.t)
    for key in ("id", "dx", "dy"):
        close(gt.operators[key].data, gj.operators[key].data)
    assert mgbtpu_torch.find_boundary(gt) == mgbtpu.find_boundary(gj)
    sv = [("u", "dirichlet"), ("s", "full")]
    pj = mgbtpu.prepare_amg(mgbtpu.amg(gj), state_variables=sv,
                            D=mgbtpu.default_D(2))
    pt = mgbtpu_torch.prepare_amg(mgbtpu_torch.amg(gt), state_variables=sv,
                                  D=mgbtpu_torch.default_D(2))
    same_systems(pj, pt, 3)


def test_geometric_hierarchy_matches_jax():
    """``geometric_mg`` (the subdivision hierarchy, not ``amg``): the
    composed Dirichlet, full and uniform prolongations per level."""
    mj = mgbtpu.geometric_mg(mgbtpu.fem2d_P1(), 3)
    mt = mgbtpu_torch.geometric_mg(mgbtpu_torch.fem2d_P1(), 3)
    close(mt.geometry.x, mj.geometry.x)
    np.testing.assert_array_equal(mt.geometry.t, mj.geometry.t)
    assert sorted(mt.R) == sorted(mj.R)
    for key in mj.R:
        assert len(mt.R[key]) == len(mj.R[key]) == 3
        for Aj, At in zip(mj.R[key], mt.R[key]):
            close_sparse(At, Aj)


@pytest.mark.parametrize("L", [2, 3])
def test_solve_matches_jax(L):
    sj = mgbtpu.mgb_solve(mgbtpu.assemble(
        mgbtpu.amg(mgbtpu.subdivide(mgbtpu.fem2d_P1(), L)), p=1.0), tol=1e-6)
    mt = mgbtpu_torch
    st = mt.mgb_solve(mt.assemble(mt.amg(mt.subdivide(mt.fem2d_P1(), L)),
                                  p=1.0, device="cpu"),
                      device="cpu", tol=1e-6)
    assert np.all(np.isfinite(st.z)) and st.z.shape == sj.z.shape
    assert np.linalg.norm(st.z - sj.z) <= TOL_Z * np.linalg.norm(sj.z)
    Sj, St = sj.SOL_main, st.SOL_main
    assert St["steps_accepted"] == Sj["steps_accepted"]
    assert St["steps_attempted"] == Sj["steps_attempted"]
    np.testing.assert_array_equal(St["its"][:, :-1], Sj["its"][:, :-1])
    assert abs(int(St["its"][:, -1].sum()) - int(Sj["its"][:, -1].sum())) <= 4


def test_l5_solve_matches_record():
    """The plain path's p=1 L=5 solve against ``ref_fem2d_p1_L5.npz``."""
    mt = mgbtpu_torch
    st = mt.mgb_solve(mt.assemble(mt.amg(mt.subdivide(mt.fem2d_P1(), 5)),
                                  p=1.0, device="cpu"), device="cpu")
    ref = np.load(REF_L5)
    its, its_ref = st.SOL_main["its"], ref["its"]
    print(f"fem2d_P1 L=5 on the CPU: its per ramp step "
          f"{its.sum(axis=0).tolist()} vs x64 {its_ref.sum(axis=0).tolist()}"
          f"; total {int(its.sum())} vs {int(its_ref.sum())}; cg "
          f"{int(st.SOL_main['cg'].sum())} vs {int(ref['cg'].sum())}")
    assert np.linalg.norm(st.z - ref["z"]) <= TOL_Z * np.linalg.norm(ref["z"])
    np.testing.assert_array_equal(its[:, :-1], its_ref[:, :-1])
    assert abs(int(its[:, -1].sum()) - int(its_ref[:, -1].sum())) <= 4
