"""PyTorch port, host setup: the port's own discretization, hierarchy and
panel plans reproduce the JAX package's arrays (fem2d_P2, L=2 and 3)."""
import numpy as np
import pytest
import torch

import mgbtpu
import mgbtpu_torch
from mgbtpu.solver.levelops import build_panel_ops as build_ref
from mgbtpu_torch.interop import from_reference_arrays
from mgbtpu_torch.solver.levelops import build_panel_ops

torch.set_num_threads(1)
TOL = 1e-14


def _pair(L):
    mj = mgbtpu.amg(mgbtpu.subdivide(mgbtpu.fem2d_P2(), L))
    mt = mgbtpu_torch.amg(mgbtpu_torch.subdivide(mgbtpu_torch.fem2d_P2(), L))
    return mj, mt


def _close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0.0) <= TOL * max(np.abs(b).max(initial=0.0), 1.0)


def _close_sparse(A, B):
    A, B = A.tocsr(), B.tocsr()
    assert A.shape == B.shape
    assert abs(A - B).max() <= TOL * max(abs(B).max(), 1.0)


@pytest.mark.parametrize("L", [2, 3])
def test_geometry_and_hierarchy_match(L):
    mj, mt = _pair(L)
    _close(mt.geometry.xflat(), mj.geometry.xflat())
    _close(mt.geometry.w, mj.geometry.w)
    M1j, M2j = mgbtpu.prepare_amg(mj, state_variables=[("u", "dirichlet"),
                                                      ("s", "full")],
                                  D=mgbtpu.default_D(2))
    M1t, M2t = mgbtpu_torch.prepare_amg(mt, state_variables=[
        ("u", "dirichlet"), ("s", "full")], D=mgbtpu_torch.default_D(2))
    for Mj, Mt in ((M1j, M1t), (M2j, M2t)):
        _close(Mt.w, Mj.w)
        _close(Mt.x, Mj.x)
        assert Mt.depth == Mj.depth
        for l in range(Mj.depth):
            _close_sparse(Mt.R_fine[l], Mj.R_fine[l])
        assert len(Mt.D_fine) == len(Mj.D_fine)
        for (opt, ct), (opj, cj) in zip(Mt.D_fine, Mj.D_fine):
            assert ct == cj
            _close(opt.data, opj.data)


@pytest.mark.parametrize("L", [2, 3])
def test_panel_plans_match(L):
    pj = mgbtpu.assemble(mgbtpu.amg(mgbtpu.subdivide(mgbtpu.fem2d_P2(), L)),
                         p=1.0)
    pt = mgbtpu_torch.assemble(
        mgbtpu_torch.amg(mgbtpu_torch.subdivide(mgbtpu_torch.fem2d_P2(), L)),
        p=1.0, device="cpu")
    Mj, Mt = pj.M[0], pt.M[0]
    _close(pt.f_grid, pj.f_grid)
    _close(pt.g_grid, pj.g_grid)
    for a_t, a_j in zip(pt.Q.args, pj.Q.args):
        _close(a_t, np.asarray(a_j))
    for l in range(Mj.depth):
        oj = build_ref(Mj.D_fine, Mj.nu, Mj.R_fine[l], 7, np.float64)
        ot = build_panel_ops(Mt.D_fine, Mt.nu, Mt.R_fine[l], 7, "cpu")
        assert (ot.n_J, ot.N, ot.C, ot.p, ot.nD) == (oj.n_J, oj.N, oj.C,
                                                    oj.p, oj.nD)
        np.testing.assert_array_equal(ot.cols.numpy(), np.asarray(oj.cols))
        _close(ot.panels.numpy(), np.asarray(oj.panels))


def test_interop_carries_reference_arrays():
    pj = mgbtpu.assemble(mgbtpu.amg(mgbtpu.subdivide(mgbtpu.fem2d_P2(), 2)),
                         p=1.0)
    Mj = pj.M[0]
    oj = build_ref(Mj.D_fine, Mj.nu, Mj.R_fine[-1], 7, np.float64)
    A, b, p, mu = (np.asarray(a) for a in pj.Q.args)
    got = from_reference_arrays(
        device="cpu",
        D_fine=[(op.data, c) for op, c in Mj.D_fine], R_fine=Mj.R_fine,
        w=Mj.w, f_grid=pj.f_grid, g_grid=pj.g_grid,
        convex=dict(A=A, b=b, p=p, mu=mu, idx=(1, 2, 3)),
        panel_ops=dict(cols=np.asarray(oj.cols), panels=np.asarray(oj.panels),
                       n_J=oj.n_J))
    ops = got["panel_ops"]
    assert (ops.n_J, ops.N, ops.C) == (oj.n_J, oj.N, oj.C)
    assert ops.cols.dtype == torch.int64 and ops.panels.dtype == torch.float64
    _close(got["convex"].args[3], mu)
    _close(got["D_fine"][1][0].data, Mj.D_fine[1][0].data)
    _close_sparse(got["R_fine"][0], Mj.R_fine[0])
    _close(got["w"], Mj.w)


def test_interop_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    cols = np.zeros((2, 3), np.int64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_reference_arrays(panel_ops=dict(
            cols=cols, panels=np.zeros((4, 2, 7, 3)), n_J=1))


def test_other_discretizations_raise():
    """The port dispatches on its own discretization classes: a geometry
    of another package (the JAX package's spectral ones) is refused by
    amg, geometric_mg and find_boundary, naming the discretization."""
    for geom in (mgbtpu.spectral1d(n=4), mgbtpu.spectral2d(n=4)):
        for fn in (mgbtpu_torch.amg, mgbtpu_torch.find_boundary,
                   lambda g: mgbtpu_torch.geometric_mg(g, 2)):
            with pytest.raises(TypeError, match="unsupported discretization"):
                fn(geom)
