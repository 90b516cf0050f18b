"""PyTorch port, the nested-dissection front operations (K5a
``front_factor``, K5b ``front_solve``, on the CPU through their plain
versions) against the JAX x64 front code of ``mgbtpu/ops/ndchol.py``:
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


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("nk,a,b", SHAPES)
def test_front_solve_matches_jax(nk, a, b, transpose):
    F = _fronts(nk, a, b, seed=a + b)
    Lf = np.asarray(jnp.linalg.cholesky(F[:, :a, :a]))
    r = np.random.default_rng(a).standard_normal((nk, a))
    ref = lax.linalg.triangular_solve(Lf, r[:, :, None], left_side=True,
                                      lower=True, transpose_a=transpose)
    before = K.front_solve.launches
    got = K.front_solve(torch.tensor(Lf), torch.tensor(r), transpose)
    assert K.front_solve.launches == before
    assert _rel(got.numpy(), np.asarray(ref)[:, :, 0]) <= TOL
