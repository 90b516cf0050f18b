"""PyTorch port, the Chebyshev spectral discretizations (spectral1d,
spectral2d) on the CPU against JAX x64.

Setup: the geometry (nodes, weights, the id/dx/dy operator blocks), the
boundary, the hierarchy's prolongations R per subspace and level (``amg``
and ``geometric_mg``) and the prepared systems with every level's panel
plan equal the JAX package's to 1e-14, for spectral1d n = 5, 16 and
spectral2d n = 4, 5.

Solves (``device="cpu"``):
- the four spectral cases of ``tests/test_golden.py`` (elliptic n = 5,
  parabolic n = 4, h = 0.5), run by that file's own test functions with
  the port's entry points in place of the JAX package's, so the port is
  held to its vectors and its 1e-6;
- spectral2d n = 8 against a live JAX x64 solve, and the golden elliptic
  cases, spectral1d n = 128 and the parabolic cases against the stored
  x64 records of ``mgbtpu_torch/data/ref_spectral.npz`` (re-derived in
  ``tests/test_torch_reference_spectral.py``): z (or each step's u) to
  1e-8, and the Newton its of every ramp step equal but the last, the
  exact-stopping polish decided at the objective's roundoff floor
  (ROADMAP Queue 3), held to +-4 (it differs by one on the n = 5 cases).

Kernels: at the one-element levels (N = 1) of spectral1d n = 128 and
spectral2d n = 16, whose shapes take K1's and K3's spread forms on the
card, the plain versions equal JAX x64's ``apply_G``/``apply_Gt`` to
1e-13 on the main and the phase-I systems.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgbtpu
import mgbtpu_torch
import test_golden
from jax_references import record_of
from mgbtpu.solver import levelops as LJ
from mgbtpu_torch.interop import from_reference_arrays
from port_parity import close, close_sparse, same_ramp, same_systems

torch.set_num_threads(1)
TOL_Z = 1e-8
REF = os.path.join(os.path.dirname(mgbtpu_torch.__file__), "data",
                   "ref_spectral.npz")
SETUPS = [("spectral1d", 5), ("spectral1d", 16), ("spectral2d", 4),
          ("spectral2d", 5)]


@pytest.mark.parametrize("kind,n", SETUPS)
def test_setup_matches_jax(kind, n):
    gj = getattr(mgbtpu, kind)(n=n)
    gt = getattr(mgbtpu_torch, kind)(n=n)
    close(gt.x, gj.x)
    close(gt.w, gj.w)
    np.testing.assert_array_equal(gt.t, gj.t)
    assert sorted(gt.operators) == sorted(gj.operators)
    for key in gj.operators:
        close(gt.operators[key].data, gj.operators[key].data)
    assert mgbtpu_torch.find_boundary(gt) == mgbtpu.find_boundary(gj)
    for build in (lambda pkg, g: pkg.amg(g),
                  lambda pkg, g: pkg.geometric_mg(g, 3)):
        mj, mt = build(mgbtpu, gj), build(mgbtpu_torch, gt)
        assert sorted(mt.R) == sorted(mj.R)
        for key in mj.R:
            assert len(mt.R[key]) == len(mj.R[key])
            for Aj, At in zip(mj.R[key], mt.R[key]):
                close_sparse(At, Aj)
    dim = gj.discretization.dim
    sv = [("u", "dirichlet"), ("s", "full")]
    same_systems(mgbtpu.prepare_amg(mj, state_variables=sv,
                                    D=mgbtpu.default_D(dim)),
                 mgbtpu_torch.prepare_amg(mt, state_variables=sv,
                                          D=mgbtpu_torch.default_D(dim)),
                 gj.x.shape[0])


def _cpu(fn):
    return lambda *a, **kw: fn(*a, device="cpu", **kw)


GOLDEN = ["test_spectral1d_p1", "test_spectral2d_p1",
          "test_parabolic_spectral1d", "test_parabolic_spectral2d"]


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_vectors(name, monkeypatch):
    """``tests/test_golden.py``'s own spectral tests, run on the port."""
    for attr in ("amg", "spectral1d", "spectral2d"):
        monkeypatch.setattr(test_golden, attr, getattr(mgbtpu_torch, attr))
    for attr in ("assemble", "mgb_solve", "parabolic_solve"):
        monkeypatch.setattr(test_golden, attr,
                            _cpu(getattr(mgbtpu_torch, attr)))
    getattr(test_golden, name)()


def _port_solve(kind, n):
    mt = mgbtpu_torch
    return mt.mgb_solve(mt.assemble(mt.amg(getattr(mt, kind)(n=n)), p=1.0,
                                    device="cpu"), device="cpu")


def test_spectral2d_n8_matches_jax():
    sj = mgbtpu.mgb_solve(mgbtpu.assemble(
        mgbtpu.amg(mgbtpu.spectral2d(n=8)), p=1.0))
    same_ramp(sj, _port_solve("spectral2d", 8), tol_z=TOL_Z)


class _Stored:
    """A stored record in the shape ``same_ramp`` reads."""

    def __init__(self, rec):
        self.z = rec["z"]
        self.SOL_main = dict(its=rec["its"], steps_accepted=rec["steps"][0],
                             steps_attempted=rec["steps"][1])


@pytest.mark.parametrize("name,kind,n", [("spectral1d_n5", "spectral1d", 5),
                                         ("spectral2d_n5", "spectral2d", 5),
                                         ("spectral1d_n128", "spectral1d",
                                          128)])
def test_solve_matches_record(name, kind, n):
    rec = record_of(np.load(REF), name)
    st = _port_solve(kind, n)
    same_ramp(_Stored(rec), st, tol_z=TOL_Z)
    assert st.SOL_feasibility is None and rec["feas_its"].size == 0


def _same_steps(rec, st, floor_from):
    """z to 1e-8, the same accepted/attempted steps, the same Newton its on
    every ramp step before ``floor_from``; from there on the steps run at
    the roundoff floor: each within +-1 but the last (the exact-stopping
    polish), which is held to +-4."""
    z = rec["z"]
    assert np.linalg.norm(st.z - z) <= TOL_Z * np.linalg.norm(z)
    S = st.SOL_main
    assert [S["steps_accepted"], S["steps_attempted"]] == list(rec["steps"])
    np.testing.assert_array_equal(S["its"][:, :floor_from],
                                  rec["its"][:, :floor_from])
    d = S["its"].sum(axis=0) - rec["its"].sum(axis=0)
    assert np.abs(d[floor_from:-1]).max(initial=0) <= 1 and abs(d[-1]) <= 4


@pytest.mark.parametrize("kind,floor_from", [("spectral1d", -1),
                                             ("spectral2d", -2)])
def test_parabolic_matches_record(kind, floor_from):
    """Each implicit step's state u to 1e-8 and its main ramp by
    ``_same_steps``. On spectral2d n = 4 (16 nodes) the roundoff floor
    comes one ramp step earlier, as on the 3-node fem1d mesh: in the second
    implicit step the 12th of 13 ramp steps takes 2 its against 1, and the
    polish 6 against 3. Phase I (from the cones' walls) runs the same
    iterations."""
    data = record_of(np.load(REF), f"parabolic_{kind}_n4")
    steps = []
    solve = mgbtpu_torch.solver.parabolic.mgb_solve

    def recording(prob, **kw):
        steps.append(solve(prob, **kw))
        return steps[-1]

    mt = mgbtpu_torch
    orig, mt.solver.parabolic.mgb_solve = solve, recording
    try:
        sol = mt.parabolic_solve(mt.amg(getattr(mt, kind)(n=4)), h=0.5,
                                 p=1.0, device="cpu")
    finally:
        mt.solver.parabolic.mgb_solve = orig
    u = data["u"]
    assert np.stack(sol.u).shape == u.shape
    for uj, ut in zip(u, sol.u):
        assert np.linalg.norm(ut - uj) <= TOL_Z * max(np.linalg.norm(uj), 1)
    assert len(steps) == u.shape[0] - 1
    for j, st in enumerate(steps, 1):
        rec = record_of(data, f"step{j}")
        _same_steps(rec, st, floor_from)
        np.testing.assert_array_equal(st.SOL_feasibility["its"],
                                      rec["feas_its"])


@pytest.mark.parametrize("kind,n", [("spectral1d", 128), ("spectral2d", 16)])
def test_kernels_plain_versions_at_one_element(kind, n):
    """K1's and K3's plain versions (what the wrappers run on the CPU) at
    the top level of both prepared systems, against JAX x64's operators on
    the same seeded inputs; the launch counters stay 0."""
    import mgbtpu_torch.kernels as K

    prob = mgbtpu.assemble(mgbtpu.amg(getattr(mgbtpu, kind)(n=n)), p=1.0)
    rng = np.random.default_rng(n)
    K.reset_launches()
    for M in prob.M:
        l = M.depth - 1
        p = M.x.shape[0]
        oj = LJ.build_panel_ops(M.D_fine, M.nu, M.R_fine[l], p, np.float64)
        ot = from_reference_arrays(device="cpu", panel_ops=dict(
            cols=np.asarray(oj.cols), panels=np.asarray(oj.panels),
            n_J=oj.n_J))["panel_ops"]
        assert ot.N == 1 and ot.p == p and ot.p * ot.nD >= 384
        s = rng.standard_normal(oj.n_J)
        dz0 = rng.standard_normal((oj.n_nodes, oj.nD))
        ref = np.asarray(oj.apply_G(jnp.asarray(s)))
        got = ot.apply_G(torch.tensor(s), torch.tensor(dz0)).numpy()
        assert np.abs(got - (dz0 + ref)).max() <= 1e-13 * np.abs(ref).max()
        Y = rng.standard_normal((oj.n_nodes, oj.nD))
        ref = np.asarray(oj.apply_Gt(jnp.asarray(Y)))
        got = ot.apply_Gt(torch.tensor(Y)).numpy()
        assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()
    assert all(c == 0 for c in K.launches().values())
