"""PyTorch port, the tensor-product Q_k elements (fem1d, fem2d, fem3d) on
the CPU against JAX x64.

Setup: geometry (nodes, weights, operator blocks), the connectivity from
``tensor_dofmap``, the boundary, the AMG hierarchy (``R_fine``, ``D_fine``)
and every level's panel plan equal the JAX package's to 1e-14, for fem1d
at k = 1 and 2 and on an embedded circle, fem2d at k = 1 and 3, and fem3d
at k = 1 and 3 (L = 2). The reference's panel plans reach the port through
``interop.from_reference_arrays``.

Solves (``device="cpu"``): the fem1d golden vectors of
``tests/test_golden.py`` (elliptic and parabolic) to 1e-6, and every solve
equal to the JAX x64 one to 1e-8 with the same Newton iterations on every
ramp step but the last, whose exact-stopping polish is decided at the
roundoff floor (ROADMAP Queue 3) and is held to +-4: fem1d golden and
parabolic fem1d, fem3d k=1 L=2 at p = 1.5 (``tests/test_paths.py``), fem3d
k=3 L=2 at p = 1, the 1D zoo cases of ``tests/test_zoo.py`` and the four
fem1d phase-I cases of ``tests/test_feasibility.py``.
"""
import numpy as np
import pytest
import torch

import mgbtpu
import mgbtpu_torch
from port_parity import close, same_ramp, same_systems

torch.set_num_threads(1)
TOL_Z = 1e-8


def _circle(pkg, n, tilt3d):
    """The unit circle of ``tests/test_manifold.py`` as n Q2 arcs in R^2, or
    tilted into R^3."""
    th = np.linspace(0, 2 * np.pi, n + 1)
    pts = np.stack([np.cos(th), np.sin(th)], axis=1)
    if tilt3d:
        pts = np.stack([pts[:, 0], np.cos(0.7) * pts[:, 1],
                        np.sin(0.7) * pts[:, 1]], axis=1)
    K = np.empty((2, n, pts.shape[1]))
    K[0], K[1] = pts[:-1], pts[1:]
    return pkg.fem1d(K=K, ambient=pts.shape[1], k=2)


GEOMETRIES = {
    "fem1d_k1": lambda pkg: pkg.fem1d(nodes=np.linspace(-1, 1, 5)),
    "fem1d_k2": lambda pkg: pkg.subdivide(pkg.fem1d(k=2), 3),
    "circle_r2": lambda pkg: _circle(pkg, 8, False),
    "circle_r3": lambda pkg: _circle(pkg, 8, True),
    "fem2d_k1": lambda pkg: pkg.subdivide(pkg.fem2d(k=1), 3),
    "fem2d_k3": lambda pkg: pkg.subdivide(pkg.fem2d(k=3), 2),
    "fem3d_k1": lambda pkg: pkg.subdivide(pkg.fem3d(k=1), 2),
    "fem3d_k3": lambda pkg: pkg.subdivide(pkg.fem3d(k=3), 2),
}


def _hierarchies(gj, gt):
    """Both packages' (full-u, s) hierarchies on their own geometries, with
    the default D of the geometry's intrinsic dimension (the circle: its
    closed manifold has no boundary)."""
    dim = gj.discretization.dim
    kw = {}
    if isinstance(gj.discretization, mgbtpu.discretize.tensorfem.TensorFEM) \
            and gj.discretization.e > dim:
        kw = dict(dirichlet_nodes={"dirichlet": []})
    mj, mt = mgbtpu.amg(gj, **kw), mgbtpu_torch.amg(gt, **kw)
    sv = [("u", "dirichlet"), ("s", "full")]
    return (mgbtpu.prepare_amg(mj, state_variables=sv,
                               D=mgbtpu.default_D(dim)),
            mgbtpu_torch.prepare_amg(mt, state_variables=sv,
                                     D=mgbtpu_torch.default_D(dim)))


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_setup_matches_jax(name):
    gj, gt = GEOMETRIES[name](mgbtpu), GEOMETRIES[name](mgbtpu_torch)
    close(gt.x, gj.x)
    close(gt.w, gj.w)
    np.testing.assert_array_equal(gt.t, gj.t)
    assert sorted(gt.operators) == sorted(gj.operators)
    for key in gj.operators:
        close(gt.operators[key].data, gj.operators[key].data)
    assert mgbtpu_torch.find_boundary(gt) == mgbtpu.find_boundary(gj)
    same_systems(*_hierarchies(gj, gt), gj.x.shape[0])


@pytest.mark.parametrize("d,k", [(1, 3), (2, 2), (3, 2)])
def test_tensor_dofmap_and_refinement_match_jax(d, k):
    """Connectivity from corners alone, after two topological refinements
    of the reference cell, and the per-child interpolation."""
    from mgbtpu.discretize import tensorfem as tj
    from mgbtpu_torch.discretize import tensorfem as tt

    corners = np.arange(1 << d).reshape(-1, 1)
    for _ in range(2):
        full = tj.tensor_dofmap(corners, 1, d)
        corners = tj.refine_connectivity(full, 1, d)[
            [tj.corner_local(c, 2, d) for c in range(1 << d)]]
    np.testing.assert_array_equal(tt.tensor_dofmap(corners, k, d),
                                  tj.tensor_dofmap(corners, k, d))
    full = tj.tensor_dofmap(corners, k, d)
    np.testing.assert_array_equal(tt.refine_connectivity(full, k, d),
                                  tj.refine_connectivity(full, k, d))
    np.testing.assert_array_equal(mgbtpu_torch.tensor_dofmap(corners, k, d),
                                  mgbtpu.tensor_dofmap(corners, k, d))
    close(tt.refine_local(k, d), tj.refine_local(k, d))


def _solve_both(build, **kw):
    sj = mgbtpu.mgb_solve(build(mgbtpu, {}), **kw)
    st = mgbtpu_torch.mgb_solve(build(mgbtpu_torch, dict(device="cpu")),
                                device="cpu", **kw)
    return sj, st


def test_fem1d_golden():
    """On this 3-node mesh, from the 10th ramp step (t ~ 3e6) on, the
    whole Newton decrement of a step lies below one ulp of the objective
    (traced: 3.1e-11 against an ulp of 4.7e-10 at y ~ 3.1e6), so the
    exact-stopping test is decided by roundoff on those steps, not only on
    the last."""
    gold = np.asarray([-1, -1, -1, 1, 0, 0, 2, 2.0]).reshape(2, -1).T
    sj, st = _solve_both(lambda pkg, dev: pkg.assemble(
        pkg.amg(pkg.fem1d(nodes=np.linspace(-1, 1, 3))), p=1.0, **dev))
    assert np.linalg.norm(st.z - gold) < 1e-6
    same_ramp(sj, st, floor_from=9)


def test_parabolic_fem1d_golden():
    """``tests/test_golden.py::test_parabolic_fem1d``'s vectors."""
    gold = np.array([
        [[-1.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [1.0, 0.0, 0.0]],
        [[-1.0, 1.0000000112468264, 0.7500000142459804],
         [-0.24999999700084627, 0.06250000974724965, 0.7500000142459804],
         [-0.24999999700084627, 0.06250000974724965, 1.2500000082476728],
         [1.0, 1.0000000112468264, 1.2500000082476728]],
        [[-1.0, 1.00000002, 0.5000000363324867],
         [-0.4999999836675137, 0.2500000036675139, 0.5000000363324867],
         [-0.4999999836675137, 0.2500000036675139, 1.5000000036675138],
         [1.0, 1.00000002, 1.5000000036675138]]])
    sj = mgbtpu.parabolic_solve(
        mgbtpu.amg(mgbtpu.fem1d(nodes=np.linspace(-1, 1, 3))), h=0.5, p=1.0)
    st = mgbtpu_torch.parabolic_solve(
        mgbtpu_torch.amg(mgbtpu_torch.fem1d(nodes=np.linspace(-1, 1, 3))),
        h=0.5, p=1.0, device="cpu")
    assert np.linalg.norm(np.stack(st.u) - gold) < 1e-6
    assert len(st.u) == len(sj.u) == 3
    for uj, ut in zip(sj.u, st.u):
        assert np.linalg.norm(ut - uj) <= TOL_Z * np.linalg.norm(uj)


@pytest.mark.parametrize("k,p,tol", [(1, 1.5, 1e-6), (3, 1.0, 1e-8)])
def test_fem3d_solve_matches_jax(k, p, tol):
    sj, st = _solve_both(lambda pkg, dev: pkg.assemble(
        pkg.amg(pkg.subdivide(pkg.fem3d(k=k), 2)), p=p, **dev), tol=tol)
    same_ramp(sj, st)


ZOO_1D = ["rof", "two_sided_obstacle", "elastoplastic_torsion",
          "minimal_surface"]


@pytest.mark.parametrize("name", ZOO_1D)
def test_zoo_1d_matches_jax(name):
    """The 1D cases of ``tests/test_zoo.py`` (fem1d, 5 nodes, tol 1e-3),
    with their behavioural checks on the port's solution."""
    def build(pkg, dev):
        mg = pkg.amg(pkg.fem1d(nodes=np.linspace(-1, 1, 5)))
        return getattr(pkg.zoo, name)(mg, **dev)

    sj, st = _solve_both(build, tol=1e-3)
    same_ramp(sj, st)
    geom = mgbtpu_torch.fem1d(nodes=np.linspace(-1, 1, 5))
    u = st.z[:, 0]
    du = geom.operators["dx"].matvec(u)
    if name == "rof":
        assert u.max() <= 0.5 + 1e-6 and u.min() >= -0.5 - 1e-6
    elif name == "two_sided_obstacle":
        assert u.min() >= -0.1 - 1e-6 and u.max() <= 1.0 + 1e-6
        assert u.min() < -0.09
    elif name == "elastoplastic_torsion":
        assert np.abs(du).max() <= 1.0 + 1e-3
    else:
        assert np.all(st.z[:, 1] ** 2 >= du ** 2 + 1 - 1e-3)


def _lower_bound(pkg, dev, lower, upper=None):
    """``tests/test_feasibility.py``'s problem: minimize int u subject to
    u >= lower (and u <= upper), from the infeasible start u = 0."""
    mg = pkg.amg(pkg.fem1d(nodes=np.linspace(-1, 1, 5)))
    if upper is None:
        A, b = (lambda x: np.array([[1.0]])), (lambda x: np.array([-lower]))
    else:
        A = lambda x: np.array([[1.0], [-1.0]])  # noqa: E731
        b = lambda x: np.array([-lower, upper])  # noqa: E731
    Q = pkg.convex_linear(mg, idx=(0,), A=A, b=b)
    return pkg.assemble(mg, state_variables=[("u", "full")], D=[("u", "id")],
                        f=lambda x: np.array([1.0]),
                        g=lambda x: np.array([0.0]), Q=Q, **dev)


@pytest.mark.parametrize("lower", [50.0, -50.0])
def test_phase_one_matches_jax(lower):
    """Far feasible (phase I grows the box to R = 100) and a feasible start
    (no phase I): the same phase-I iterations and main ramp. The main
    problem is linear, so from its second ramp step on the start of every
    step is already centered to roundoff (traced decrements <= 1e-16 of
    the objective): every step but the first is a roundoff-floor step."""
    sj, st = _solve_both(lambda pkg, dev: _lower_bound(pkg, dev, lower))
    same_ramp(sj, st, floor_from=1)
    assert np.abs(st.z - lower).max() < 1e-3
    if lower > 0:
        assert "bounding box R=100" in st.log
        np.testing.assert_array_equal(st.SOL_feasibility["its"],
                                      sj.SOL_feasibility["its"])
    else:
        assert st.SOL_feasibility is None and sj.SOL_feasibility is None


@pytest.mark.parametrize("case", ["infeasible", "feasibility_Rmax"])
def test_phase_one_failures_match_jax(case):
    """Certified infeasible (u >= 1 and u <= 0) and feasible only beyond
    feasibility_Rmax: both packages fail with the same code."""
    if case == "infeasible":
        build, kw = (lambda pkg, dev: _lower_bound(pkg, dev, 1.0, 0.0)), {}
    else:
        build = lambda pkg, dev: _lower_bound(pkg, dev, 1.0e6)  # noqa: E731
        kw = dict(feasibility_Rmax=1000.0)
    with pytest.raises(mgbtpu.MGBConvergenceFailure) as ej:
        mgbtpu.mgb_solve(build(mgbtpu, {}), **kw)
    with pytest.raises(mgbtpu_torch.MGBConvergenceFailure) as et:
        mgbtpu_torch.mgb_solve(build(mgbtpu_torch, dict(device="cpu")),
                               device="cpu", **kw)
    assert et.value.code == ej.value.code == case
    if case == "infeasible":
        assert "inside the bounding box" in str(et.value)
