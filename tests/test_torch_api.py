"""PyTorch port, the rest of the public API on the CPU against the JAX
package: ``interpolate`` and ``chebfun`` (``utils/interpolate.py``), the
checkpoint helpers (``utils/checkpoint.py``), ``amg_smoothed_aggregation``
and ``amg_pyamg`` (``hierarchy/prolongators.py``) and ``mgb_cleanup``.

- interpolate: the cases of ``tests/test_interpolate_plot.py`` (the fem1d
  golden solve at 0.75 on a port solve; exact quadratics on fem1d k=2,
  spectral extrapolation on both sides, a spectral2d polynomial, each
  equal to the JAX package's answer to 1e-14 relative, with ``z`` as a
  numpy array and as a tensor);
- the checkpoint round trip of ``tests/test_interpolate_plot.py`` on a
  port solve, and its warm start;
- smoothed aggregation: its prolongations equal the JAX package's to
  1e-14 on fem2d_P2 L=2, and the p = 1.5 solve of
  ``tests/test_paths.py::test_prolongator_independence`` agrees with the
  Ruge-Stuben one to 1e-6 (no JAX solve: the file keeps tier-1 cheap);
- ``amg_pyamg`` through the stub pyamg module of
  ``tests/test_paths.py::test_pyamg_prolongator_adapter``;
- ``mgb_cleanup`` empties the per-system caches and the loaded kernel
  entries, and a solve after it gives the same result;
- the ``dtype=`` keyword the JAX package's entry points take (``assemble``,
  ``mgb_solve``/``Model.solve`` through ``mgb_driver``, ``parabolic_solve``),
  and ``assemble``'s ignored solver keywords, on fem1d: None and float64
  give the answer of the call without it; float32 raises ``ValueError``
  (the port computes in float64 only);
- the public names the port had lacked, each against the JAX function:
  ``map_rows``, ``extract_block_diag`` (the round trip of
  ``tests/test_paths.py``) with ``BlockDiagHost.nblocks``,
  ``AMGSystem.D_sparse`` and the ``find_boundary_tensorfem`` export; and
  ``set(mgbtpu.__all__) <= set(mgbtpu_torch.__all__)``.
"""
import sys
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import mgbtpu
import mgbtpu_torch
from port_parity import close, close_sparse

torch.set_num_threads(1)


def _cases():
    """(name, geometry builder, z of a geometry, points)."""
    g1 = lambda pkg: pkg.fem1d(nodes=np.linspace(-1, 1, 4), k=2)  # noqa: E731
    return {
        "fem1d_quadratic": (g1, lambda g: g.xflat()[:, 0] ** 2,
                            np.array([-0.9, -0.3, 0.1, 0.77, -1.2, 1.3])),
        "spectral1d_extrapolation": (
            lambda pkg: pkg.spectral1d(n=6), lambda g: g.xflat()[:, 0] ** 2,
            [-1.5, 1.5, 0.3]),
        "spectral1d_scalar": (lambda pkg: pkg.spectral1d(n=6),
                              lambda g: np.sin(g.xflat()[:, 0]), 0.4),
        "spectral2d": (lambda pkg: pkg.spectral2d(n=5),
                       lambda g: g.xflat()[:, 0] ** 2 + 2 * g.xflat()[:, 1],
                       np.array([[0.0, 0.0], [0.5, 0.5], [-0.5, 0.3]])),
    }


@pytest.mark.parametrize("name", list(_cases()))
def test_interpolate_matches_jax(name):
    build, zf, pts = _cases()[name]
    gj, gt = build(mgbtpu), build(mgbtpu_torch)
    ref = mgbtpu.interpolate(gj, zf(gj), pts)
    z = zf(gt)
    for zz in (z, torch.as_tensor(z)):
        got = mgbtpu_torch.interpolate(gt, zz, pts)
        assert np.shape(got) == np.shape(ref)
        close(got, ref)
    if name == "spectral1d_extrapolation":   # both sides of [-1, 1]
        np.testing.assert_allclose(got[:2], 2.25, atol=1e-10)
    if name == "spectral2d":
        np.testing.assert_allclose(got, pts[:, 0] ** 2 + 2 * pts[:, 1],
                                   atol=1e-10)


def test_interpolate_fem1d_golden_solve():
    """``tests/test_interpolate_plot.py``'s first case on a port solve."""
    mt = mgbtpu_torch
    mg = mt.amg(mt.fem1d(nodes=np.linspace(-1, 1, 3)))
    st = mt.mgb_solve(mt.assemble(mg, p=1.0, device="cpu"), device="cpu")
    v = mt.interpolate(st.geometry, st.z[:, 0], 0.75)
    assert abs(v - 0.5) < 1e-6


def test_chebfun_matches_jax():
    from mgbtpu.utils.interpolate import chebfun_coefficients as cj
    from mgbtpu_torch.utils.interpolate import chebfun_coefficients as ct

    nodes = mgbtpu_torch.spectral1d(n=9).xflat()[:, 0]
    vals = np.exp(nodes)
    c = ct(torch.as_tensor(vals), nodes)
    close(c, cj(vals, nodes))
    x = np.linspace(-1.3, 1.3, 11)
    close(mgbtpu_torch.chebfun(c, x), mgbtpu.chebfun(cj(vals, nodes), x))


def test_interpolate_refuses_other_discretizations():
    with pytest.raises(TypeError, match="unsupported discretization"):
        mgbtpu_torch.interpolate(mgbtpu_torch.fem2d_P2(), np.zeros(7), [0.0])


def test_checkpoint_roundtrip(tmp_path):
    mt = mgbtpu_torch
    mg = mt.amg(mt.fem1d(nodes=np.linspace(-1, 1, 3)))
    sol = mt.mgb_solve(mt.assemble(mg, p=1.5, device="cpu"), device="cpu")
    path = str(tmp_path / "sol.npz")
    mt.save_solution(path, sol)
    back = mt.load_solution(path)
    np.testing.assert_array_equal(back.z, sol.z)
    np.testing.assert_array_equal(back.SOL_main["its"], sol.SOL_main["its"])
    np.testing.assert_array_equal(back.SOL_main["ts"], sol.SOL_main["ts"])
    assert "mgb_solve" in back.log and back.SOL_feasibility is None
    # warm start: re-solving from the solution grid matches
    prob2 = mt.assemble(mg, p=1.5, g_grid=mt.warm_start_grid(back),
                        device="cpu")
    sol2 = mt.mgb_solve(prob2, device="cpu")
    assert np.abs(sol2.z - sol.z).max() < 1e-5
    # a tensor z is brought to the host
    sol.z = torch.as_tensor(sol.z)
    mt.save_solution(path, sol)
    np.testing.assert_array_equal(mt.load_solution(path).z, back.z)
    assert isinstance(mt.warm_start_grid(sol), np.ndarray)


def _p2_l2(pkg):
    return pkg.subdivide(pkg.fem2d_P2(), 2)


def test_smoothed_aggregation_matches_jax():
    from mgbtpu_torch.hierarchy.prolongators import amg_smoothed_aggregation

    mj = mgbtpu.amg(_p2_l2(mgbtpu),
                    prolongator=mgbtpu.amg_smoothed_aggregation(max_coarse=2))
    mt = mgbtpu_torch.amg(_p2_l2(mgbtpu_torch),
                          prolongator=amg_smoothed_aggregation(max_coarse=2))
    assert mgbtpu_torch.amg_smoothed_aggregation is amg_smoothed_aggregation
    assert sorted(mt.R) == sorted(mj.R)
    for key in mj.R:
        assert len(mt.R[key]) == len(mj.R[key])
        for Aj, At in zip(mj.R[key], mt.R[key]):
            close_sparse(At, Aj)


def _solve(pkg, prolongator, **dev):
    return pkg.mgb_solve(pkg.assemble(pkg.amg(_p2_l2(pkg),
                                              prolongator=prolongator),
                                      p=1.5, **dev), **dev).z


def test_prolongator_independence():
    """``tests/test_paths.py::test_prolongator_independence`` on the port
    (its prolongations are the JAX package's: the test above)."""
    mt, cpu = mgbtpu_torch, dict(device="cpu")
    z_rs = _solve(mt, mt.amg_ruge_stuben(max_coarse=2), **cpu)
    z_sa = _solve(mt, mt.amg_smoothed_aggregation(max_coarse=2), **cpu)
    assert np.abs(z_rs - z_sa).max() < 1e-6


def test_pyamg_prolongator_adapter(monkeypatch):
    """``tests/test_paths.py::test_pyamg_prolongator_adapter`` on the port:
    a stub pyamg whose solvers wrap the port's smoothed aggregation; the
    adapter dispatches by name, hands over a CSR matrix and extracts the
    levels' P; the solve equals the SA solve's."""
    from mgbtpu_torch.hierarchy.prolongators import (amg_pyamg,
                                                     amg_smoothed_aggregation)

    sa = amg_smoothed_aggregation(max_coarse=2)
    calls = {}

    def rootnode_solver(K, **kwargs):
        calls["K"] = K
        levels = [types.SimpleNamespace(P=sp.csr_matrix(P))
                  for P in sa(sp.csr_matrix(K))]
        levels.append(types.SimpleNamespace(P=None))   # coarsest level
        return types.SimpleNamespace(levels=levels)

    fake = types.ModuleType("pyamg")
    fake.rootnode_solver = rootnode_solver
    fake.smoothed_aggregation_solver = rootnode_solver
    fake.ruge_stuben_solver = rootnode_solver
    monkeypatch.setitem(sys.modules, "pyamg", fake)
    mt, cpu = mgbtpu_torch, dict(device="cpu")
    z_py = _solve(mt, amg_pyamg(solver="rootnode"), **cpu)
    z_sa = _solve(mt, amg_smoothed_aggregation(max_coarse=2), **cpu)
    assert sp.issparse(calls["K"])
    assert np.abs(z_py - z_sa).max() < 1e-6
    assert not hasattr(mgbtpu_torch, "amg_pyamg")


def test_pyamg_adapter_without_pyamg(monkeypatch):
    from mgbtpu_torch.hierarchy.prolongators import amg_pyamg

    monkeypatch.setitem(sys.modules, "pyamg", None)
    with pytest.raises(ImportError, match="pyamg is not available"):
        amg_pyamg()


def test_mgb_cleanup():
    """An MGBProblem's and an AMGSystem's solver caches (panel and ND
    plans per barrier) empty, the loaded kernel entries too, and a solve
    after each gives the same bits."""
    from mgbtpu_torch.kernels import _build

    mt, cpu = mgbtpu_torch, dict(device="cpu")
    prob = mt.assemble(mt.amg(mt.spectral2d(n=5)), p=1.0, **cpu)
    z0 = mt.mgb_solve(prob, **cpu).z
    main = prob.M[0]
    assert main._torch_kernel_cache
    assert any(k._ops for k in main._torch_kernel_cache.values())
    mt.mgb_cleanup(prob)
    assert all(not getattr(M, "_torch_kernel_cache", {}) for M in prob.M)
    np.testing.assert_array_equal(mt.mgb_solve(prob, **cpu).z, z0)
    mt.mgb_cleanup(main)
    assert not main._torch_kernel_cache
    np.testing.assert_array_equal(mt.mgb_solve(prob, **cpu).z, z0)
    _build._LIBS["stale"] = object()
    sys.modules["mgbtpu_torch.kernels.node_barrier"]._LAUNCH["fn"] = object()
    mt.mgb_cleanup()
    assert not _build._LIBS
    assert not sys.modules["mgbtpu_torch.kernels.node_barrier"]._LAUNCH
    with pytest.raises(TypeError, match="MGBProblem or an AMGSystem"):
        mt.mgb_cleanup(object())


# --- dtype= and the public names -------------------------------------------

def _fem1d(pkg):
    return pkg.amg(pkg.fem1d(nodes=np.linspace(-1, 1, 3)))


def _solve1d(**kw):
    mt = mgbtpu_torch
    prob = mt.assemble(_fem1d(mt), p=1.0, device="cpu",
                       **kw.pop("assemble", {}))
    return mt.mgb_solve(prob, device="cpu", **kw).z


def test_dtype_keyword_is_taken():
    base = _solve1d()
    for kw in (dict(assemble=dict(dtype=np.float64)),
               dict(assemble=dict(dtype=None)),
               dict(assemble=dict(tol=1e-6)),          # ignored, as in JAX
               dict(dtype=np.float64), dict(dtype=torch.float64),
               dict(dtype="float64")):
        assert np.array_equal(_solve1d(**kw), base), kw
    # the same keywords the JAX package's tests pass
    gold = np.asarray([-1, -1, -1, 1, 0, 0, 2, 2.0]).reshape(2, -1).T
    assert np.linalg.norm(base - gold) < 1e-6


def test_dtype_keyword_parabolic_and_model():
    mt = mgbtpu_torch
    mg = mt.amg(mt.fem1d(nodes=np.linspace(-1, 1, 5)))
    a = mt.parabolic_solve(mg, h=0.5, device="cpu")
    b = mt.parabolic_solve(mg, h=0.5, device="cpu", dtype=np.float64)
    assert all(np.array_equal(x, y) for x, y in zip(a.u, b.u))
    import port_models

    m, _ = port_models.torsion(mt, _fem1d(mt), device="cpu")
    z1 = np.asarray(m.solve().z)
    z2 = np.asarray(m.solve(dtype=np.float64).z)
    assert np.array_equal(z1, z2)
    with pytest.raises(ValueError, match="float64 only"):
        m.solve(dtype=np.float32)


@pytest.mark.parametrize("dtype", [np.float32, torch.float32, "float16"])
def test_float32_is_refused(dtype):
    mt = mgbtpu_torch
    mg = _fem1d(mt)
    with pytest.raises(ValueError, match="float64 only"):
        mt.assemble(mg, p=1.0, device="cpu", dtype=dtype)
    prob = mt.assemble(mg, p=1.0, device="cpu")
    with pytest.raises(ValueError, match="float64 only"):
        mt.mgb_solve(prob, device="cpu", dtype=dtype)
    with pytest.raises(ValueError, match="float64 only"):
        mt.parabolic_solve(mg, h=0.5, device="cpu", dtype=dtype)


def test_public_names_cover_the_jax_package():
    assert set(mgbtpu.__all__) <= set(mgbtpu_torch.__all__)
    from mgbtpu.discretize import __all__ as dj
    from mgbtpu.ops import __all__ as oj
    from mgbtpu_torch.discretize import __all__ as dt
    from mgbtpu_torch.ops import __all__ as ot

    assert set(oj) <= set(ot)
    assert "find_boundary_tensorfem" in set(dj) & set(dt)


def test_map_rows_matches_jax():
    rng = np.random.default_rng(7)
    a, b = rng.standard_normal((9, 3)), rng.standard_normal(9)
    for f in (lambda r, c: r * c, lambda r, c: float(r.sum() + c),
              lambda r, c: np.array([r[0], c, r @ r])):
        out = mgbtpu_torch.map_rows(f, a, b)
        ref = mgbtpu.map_rows(f, a, b)
        assert out.shape == ref.shape and out.dtype == ref.dtype
        assert np.array_equal(out, ref)


def test_extract_block_diag_roundtrip():
    """``tests/test_paths.py``'s round trip on every FEM geometry's
    operators, and the same blocks and ``nblocks`` as the JAX function."""
    from mgbtpu.ops import extract_block_diag as ej
    from mgbtpu_torch.ops import BlockDiagHost, extract_block_diag

    mt = mgbtpu_torch
    for g in (mt.fem1d(nodes=np.linspace(-1, 1, 3)), mt.fem2d_P1(),
              mt.fem2d_P2(), mt.fem3d(k=1)):
        for op in g.operators.values():
            assert isinstance(op, BlockDiagHost)
            A = op.to_sparse()
            bd = extract_block_diag(A, op.data.shape[1], op.data.shape[2])
            assert np.abs(bd.data - op.data).max() < 1e-12
            assert bd.nblocks == op.nblocks == op.data.shape[0]
            ref = ej(A, op.data.shape[1], op.data.shape[2])
            assert np.array_equal(bd.data, ref.data)
            assert ref.nblocks == bd.nblocks
            v = np.arange(op.shape[1], dtype=np.float64)
            assert np.array_equal(op @ v, op.matvec(v))
    with pytest.raises(ValueError, match="outside the block diagonal"):
        extract_block_diag(sp.csr_matrix(np.ones((4, 4))), 2)


def test_d_sparse_matches_jax():
    pj = mgbtpu.assemble(mgbtpu.amg(mgbtpu.fem2d_P2()), p=1.0)
    pt = mgbtpu_torch.assemble(mgbtpu_torch.amg(mgbtpu_torch.fem2d_P2()),
                               p=1.0, device="cpu")
    for Mj, Mt in zip(pj.M, pt.M):
        for k in range(len(Mj.D_fine)):
            close_sparse(Mt.D_sparse(k), Mj.D_sparse(k))


def test_find_boundary_tensorfem_export_matches_jax():
    from mgbtpu.discretize import find_boundary_tensorfem as fj
    from mgbtpu_torch.discretize import find_boundary_tensorfem as ft

    for k in (1, 2):
        gj, gt = mgbtpu.fem2d(k=k), mgbtpu_torch.fem2d(k=k)
        assert np.array_equal(np.asarray(ft(gt)), np.asarray(fj(gj)))
