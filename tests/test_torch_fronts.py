"""PyTorch port, the nested-dissection front operations (K5a
``front_factor``, K5b ``front_forward``/``front_backward``, on the CPU
through their plain versions) against the JAX x64 front code of ``mgbtpu/ops/ndchol.py``:
``jnp.linalg.cholesky`` + ``lax.linalg.triangular_solve`` + the Schur
product in ``nd_factor``, and ``triangular_solve`` in ``nd_solve``, on the
same seeded fronts. Tolerance 1e-12 relative to the largest entry: both
sides are LAPACK-backed f64 on the CPU, summing in their own orders."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import mgbtpu_torch.kernels as K

torch.set_num_threads(1)
TOL = 1e-12

# (nk, amax, bmax): fem2d_P2 L=5 ND levels (leaf, middle, root) and a
# one-column front
SHAPES = [(4, 73, 16), (8, 7, 39), (1, 31, 1), (5, 1, 18)]


def _fronts(nk, a, b, seed):
    """SPD fronts (nk, f+1, f+1) with a trailing dump slot, slightly
    asymmetric in A as the assembled fronts are (the factor symmetrizes)."""
    rng = np.random.default_rng(seed)
    f = a + b
    X = rng.standard_normal((nk, f, 2 * f))
    F = np.zeros((nk, f + 1, f + 1))
    F[:, :f, :f] = X @ X.transpose(0, 2, 1) / f + 0.5 * np.eye(f)
    F[:, :a, :a] += 1e-14 * rng.standard_normal((nk, a, a))
    return F


@jax.jit
def _jax_front(A, Bc, C):
    Lf = jnp.linalg.cholesky(A)
    U = lax.linalg.triangular_solve(Lf, Bc, left_side=False, lower=True,
                                    transpose_a=True)
    return Lf, U, C - jnp.einsum("nba,nca->nbc", U, U)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("nk,a,b", SHAPES)
def test_front_factor_matches_jax(nk, a, b):
    F = _fronts(nk, a, b, seed=a * 100 + b)
    ref = _jax_front(F[:, :a, :a], F[:, a:a + b, :a], F[:, a:a + b, a:a + b])
    before = K.front_factor.launches
    got = K.front_factor(torch.tensor(F), a, b)
    assert K.front_factor.launches == before      # the CPU takes the plain one
    for g, r in zip(got, ref):
        assert _rel(g.numpy(), r) <= TOL
    assert np.all(np.triu(got[0].numpy(), 1) == 0.0)


def test_front_factor_indefinite_front_is_nan():
    """A front that is not positive definite comes back NaN in Lf (lower
    triangle; the port fills the upper one too), U and S, as JAX's; the
    other fronts are unaffected."""
    nk, a, b = 3, 9, 5
    F = _fronts(nk, a, b, seed=7)
    F[1, 4, 4] = -1.0                             # front 1 is not PD
    ref = _jax_front(F[:, :a, :a], F[:, a:a + b, :a], F[:, a:a + b, a:a + b])
    got = K.front_factor(torch.tensor(F), a, b)
    low = np.tril(np.ones((a, a), bool))
    assert np.isnan(np.asarray(ref[0])[1][low]).all()
    assert torch.isnan(got[0][1]).all()
    for g, r in zip(got[1:], ref[1:]):
        assert np.isnan(np.asarray(r)[1]).all() and torch.isnan(g[1]).all()
    for g, r in zip(got, ref):
        assert _rel(g.numpy()[[0, 2]], np.asarray(r)[[0, 2]]) <= TOL


def _sweep_case(nk, a, b, seed):
    """A tree level's factors, dof maps and padded vectors (n_J + 1,): the
    fronts' assigned dofs distinct, one of them the dump slot n_J; the
    boundary dofs drawn from a shared separator pool, so several fronts'
    updates land on one dof, and a dump slot with zero coupling."""
    rng = np.random.default_rng(seed)
    F = _fronts(nk, a, b, seed)
    Lf = np.asarray(jnp.linalg.cholesky(F[:, :a, :a]))
    U = rng.standard_normal((nk, b, a))
    n_J = nk * a + b + 4
    perm = rng.permutation(n_J)
    adofs = perm[:nk * a].reshape(nk, a)
    adofs[nk // 2, a - 1] = n_J
    pool = perm[nk * a:]
    bdofs = np.stack([np.sort(rng.choice(pool, b, replace=False))
                      for _ in range(nk)])
    bdofs[0, b - 1] = n_J
    U[0, b - 1] = 0.0              # a padded slot has no coupling
    r = np.append(rng.standard_normal(n_J), 0.0)
    y = rng.standard_normal((nk, a))
    return Lf, U, adofs, bdofs, r, y, n_J


@jax.jit
def _jax_forward(Lf, U, adofs, bdofs, r):
    """``nd_solve``'s forward step of one level (mgbtpu/ops/ndchol.py:
    544-549)."""
    y = lax.linalg.triangular_solve(Lf, r[adofs][:, :, None], left_side=True,
                                    lower=True)[:, :, 0]
    upd = jnp.einsum("nba,na->nb", U, y)
    return y, upd, r.at[bdofs].add(-upd)


@jax.jit
def _jax_backward(Lf, U, adofs, bdofs, y, x):
    """``nd_solve``'s backward step of one level (mgbtpu/ops/ndchol.py:
    554-558)."""
    n_J = x.shape[0] - 1
    t = y - jnp.einsum("nba,nb->na", U, x[bdofs])
    xA = lax.linalg.triangular_solve(Lf, t[:, :, None], left_side=True,
                                     lower=True, transpose_a=True)[:, :, 0]
    xA = jnp.where(adofs < n_J, xA, 0.0)
    return xA, x.at[adofs].set(xA)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("nk,a,b", SHAPES)
def test_front_solve_matches_jax(nk, a, b, transpose):
    """The fused level sweep (plain version): forward, the gather, the
    triangular solve, the U product and the separator update by the
    boundary inverse incidence; backward, the gather, the U' product, the
    transposed solve, the dump mask and the write to x. 1e-13 relative."""
    from mgbtpu_torch.ops.ndchol import boundary_incidence

    Lf, U, adofs, bdofs, r, y, n_J = _sweep_case(nk, a, b, seed=a + b)
    rows, inc = boundary_incidence(bdofs, n_J)
    T = torch.tensor
    before = K.front_solve.launches
    v = T(r)
    if not transpose:
        ref = _jax_forward(Lf, U, adofs, bdofs, r)
        got = (*K.front_forward(T(Lf), T(U), T(adofs), v, T(rows), T(inc)), v)
    else:
        ref = _jax_backward(Lf, U, adofs, bdofs, y, r)
        got = (K.front_backward(T(Lf), T(U), T(adofs), T(bdofs), T(y), v), v)
    assert K.front_solve.launches == before
    for g, want in zip(got, ref):
        assert _rel(g.numpy(), want) <= 1e-13
    assert v[n_J] == (0.0 if transpose else r[n_J])   # the dump entry
