"""PyTorch port, nested-dissection Cholesky: ``nd_factor``/``nd_solve``
match the JAX package's ``nd_factor``/``nd_solve`` and its numpy oracle
``nd_solve_ref`` on the dense-oracle shapes of tests/test_ndchol.py, to
1e-10; the port's symbolic plan is the reference's (int64 indices)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgbtpu.ops import ndchol as NJ
from mgbtpu_torch.ops import ndchol as NT

torch.set_num_threads(1)


def _grid_case(nx, ny, seed=0):
    rng = np.random.default_rng(seed)
    elems = []
    for i in range(nx):
        for j in range(ny):
            a = i * (ny + 1) + j
            b = (i + 1) * (ny + 1) + j
            elems.append([a, b, a + 1])
            elems.append([b, b + 1, a + 1])
    t = np.array(elems)
    xy = np.stack([(t // (ny + 1)).mean(axis=1),
                   (t % (ny + 1)).mean(axis=1)], axis=1)
    He = np.zeros((len(t), 3, 3))
    for e in range(len(t)):
        B = rng.standard_normal((5, 3))
        He[e] = B.T @ B + 0.1 * np.eye(3)
    return t, (nx + 1) * (ny + 1), xy, He


CASES = [(4, 4, 2), (13, 7, 3), (20, 20, 6)]


@jax.jit
def _jax_factor_solve(dp, He, rhs):
    fact = NJ.nd_factor(dp, He, 1e-12)
    return fact, NJ.nd_solve(dp, fact, rhs)


@pytest.mark.parametrize("nx,ny,leaf", CASES)
def test_plan_matches_reference(nx, ny, leaf):
    cols, n, xy, _ = _grid_case(nx, ny)
    pj = NJ.NDDevicePlan(NJ.NDPlan(cols, n, xy, leaf_elems=leaf))
    pt = NT.NDDevicePlan(NT.NDPlan(cols, n, xy, leaf_elems=leaf))
    dt = pt.to_device("cpu")
    assert dt.depth == pj.depth and len(dt.levels) == len(pj.levels)
    for Lt, Lj in zip(dt.levels, pj.levels):
        assert (Lt.nk, Lt.amax, Lt.bmax) == (Lj["nk"], Lj["amax"], Lj["bmax"])
        assert Lt.adofs.dtype == torch.int64
        np.testing.assert_array_equal(Lt.adofs.numpy(), Lj["adofs"])
        np.testing.assert_array_equal(Lt.bdofs.numpy(), Lj["bdofs"])
    np.testing.assert_array_equal(dt.leaf_loc.numpy(), pj.leaf_loc)
    for (a, b), (c, d) in zip(dt.parent_gather, pj.parent_gather):
        np.testing.assert_array_equal(a.numpy(), c)
        np.testing.assert_array_equal(b.numpy(), d)


@pytest.mark.parametrize("nx,ny,leaf", CASES)
def test_factor_and_solve_match_jax(nx, ny, leaf):
    cols, n, xy, He = _grid_case(nx, ny)
    rhs = np.random.default_rng(1).standard_normal(n)
    plan_j = NJ.NDPlan(cols, n, xy, leaf_elems=leaf)
    dj = NJ.NDDevicePlan(plan_j).to_device()
    fj, xj = _jax_factor_solve(dj, jnp.asarray(He), jnp.asarray(rhs))
    xj = np.asarray(xj)
    x_ref = NJ.nd_solve_ref(plan_j, NJ.nd_factor_ref(plan_j, He, jitter=1e-12),
                            rhs)
    dt = NT.NDDevicePlan(NT.NDPlan(cols, n, xy, leaf_elems=leaf)
                         ).to_device("cpu")
    ft = NT.nd_factor(dt, torch.tensor(He), 1e-12)
    assert NT.nd_finite(ft)
    for (Lt, Ut), (Lj, Uj) in zip(ft, fj):
        scale = max(np.abs(np.asarray(Lj)).max(), 1.0)
        assert np.abs(Lt.numpy() - np.asarray(Lj)).max() <= 1e-10 * scale
        if Uj.size:
            assert np.abs(Ut.numpy() - np.asarray(Uj)).max() <= 1e-10 * scale
    xt = NT.nd_solve(dt, ft, torch.tensor(rhs)).numpy()
    scale = np.abs(x_ref).max()
    assert np.abs(xt - xj).max() <= 1e-10 * scale
    assert np.abs(xt - x_ref).max() <= 1e-10 * scale
    # the port's own numpy oracle agrees as well
    plan_t = NT.NDPlan(cols, n, xy, leaf_elems=leaf)
    x_oracle = NT.nd_solve_ref(plan_t, NT.nd_factor_ref(plan_t, He,
                                                        jitter=1e-12), rhs)
    assert np.abs(x_oracle - x_ref).max() <= 1e-10 * scale


@pytest.mark.parametrize("nx,ny,leaf", CASES)
def test_boundary_incidence_matches_jax_and_scatter(nx, ny, leaf):
    """Each level's boundary inverse incidence holds the JAX dd solve's
    ``b_inc`` rows of its boundary dofs (every other row of ``b_inc`` is
    padding), and the fixed-order gather over it gives the bits of the
    sequential scatter-add ``r.index_add_(bdofs, -upd)`` exactly."""
    cols, n, xy, _ = _grid_case(nx, ny)
    pj = NJ.NDDevicePlan(NJ.NDPlan(cols, n, xy, leaf_elems=leaf))
    pt = NT.NDDevicePlan(NT.NDPlan(cols, n, xy, leaf_elems=leaf))
    dt = pt.to_device("cpu")
    rng = np.random.default_rng(nx * ny)
    for L, b_inc in zip(dt.levels, pj.b_inc):
        rows, inc = L.b_rows.numpy(), L.b_inc.numpy()
        np.testing.assert_array_equal(inc, b_inc[rows])
        rest = np.ones(len(b_inc), bool)
        rest[rows] = False
        assert (b_inc[rest] == L.nk * L.bmax).all()
        r = torch.tensor(np.append(rng.standard_normal(n), 0.0))
        upd = torch.tensor(rng.standard_normal((L.nk, L.bmax)))
        upd[L.bdofs >= n] = 0.0             # padded slots have no coupling
        scattered = r.clone().index_add_(0, L.bdofs.reshape(-1),
                                         -upd.reshape(-1))
        flat = torch.cat([upd.reshape(-1), upd.new_zeros(1)])
        acc = r[L.b_rows]
        for t in range(L.b_inc.shape[1]):
            acc = acc - flat[L.b_inc[:, t]]
        gathered = r.clone()
        gathered[L.b_rows] = acc
        assert torch.equal(gathered, scattered)


def test_indefinite_front_is_nan_not_raise():
    """A front that is not positive definite comes back non-finite (the
    reference's cholesky semantics), so the solver can retry with a larger
    shift instead of failing."""
    cols, n, xy, He = _grid_case(6, 6)
    dt = NT.NDDevicePlan(NT.NDPlan(cols, n, xy, leaf_elems=3)).to_device("cpu")
    ft = NT.nd_factor(dt, -torch.tensor(He), 1e-12)
    assert not NT.nd_finite(ft)
