"""PyTorch port, the six CUDA kernels against their plain PyTorch versions
on the card, at small ragged shapes and in every mode the wrappers take.

Marked ``cuda``: each test skips without a card. The file imports neither
JAX nor ``mgbtpu``, so it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Tolerance: the kernels sum in another order than the plain versions
(per thread in registers, the adjoint as a per-column gather, the front
factorization column by column where the library blocks), so they agree
to a few ulps, not bitwise; 1e-13 relative to the largest entry.
The power-cone kernel follows the plain version operation by operation
(built with --fmad=false) and must give the same non-finite pattern.
"""
import numpy as np
import pytest
import torch

import mgbtpu_torch.kernels as K
from mgbtpu_torch.solver.levelops import inverse_incidence

pytestmark = pytest.mark.cuda
TOL = 1e-13


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(out, ref):
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    np.testing.assert_array_equal(torch.isnan(out).cpu(), torch.isnan(ref).cpu())
    np.testing.assert_array_equal(torch.isposinf(out).cpu(),
                                  torch.isposinf(ref).cpu())
    np.testing.assert_array_equal(torch.isneginf(out).cpu(),
                                  torch.isneginf(ref).cpu())
    fin = torch.isfinite(ref)
    if not fin.any():
        return 0.0
    err = float((out[fin] - ref[fin]).abs().max())
    return err / max(float(ref[fin].abs().max()), 1e-300)


def _panels(rng, dev, nD=4, N=37, p=7, C=13, n_J=101):
    """Sorted per-element columns padded by repeating the last one (zero
    panels on the padded slots), as ``build_panel_ops`` lays them out."""
    cols = np.zeros((N, C), np.int64)
    panels = rng.standard_normal((nD, N, p, C))
    for e in range(N):
        k = rng.integers(C // 2, C + 1)
        c = np.sort(rng.choice(n_J, k, replace=False))
        cols[e, :k] = c
        cols[e, k:] = c[-1]
        panels[:, e, :, k:] = 0.0
    inv = inverse_incidence(cols, n_J)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return t(panels), t(cols), t(inv), n_J


def test_panel_fwd(dev):
    rng = np.random.default_rng(0)
    panels, cols, _, n_J = _panels(rng, dev)
    nD, N, p, _ = panels.shape
    s = torch.as_tensor(rng.standard_normal(n_J), device=dev)
    dz0 = torch.as_tensor(rng.standard_normal((N * p, nD)), device=dev)
    before = K.panel_fwd.launches
    for d in (None, dz0):
        assert _rel(K.panel_fwd(panels, cols, s, d),
                    K.panel_fwd_plain(panels, cols, s, d)) <= TOL
    assert K.panel_fwd.launches == before + 2


def test_panel_adj(dev):
    rng = np.random.default_rng(1)
    panels, cols, inv, n_J = _panels(rng, dev)
    nD, N, p, _ = panels.shape
    Y = torch.as_tensor(rng.standard_normal((N * p, nD)), device=dev)
    before = K.panel_adj.launches
    assert _rel(K.panel_adj(panels, cols, inv, Y, n_J),
                K.panel_adj_plain(panels, cols, inv, Y, n_J)) <= TOL
    assert K.panel_adj.launches == before + 1


def test_gram_matvec(dev):
    rng = np.random.default_rng(2)
    panels, cols, inv, n_J = _panels(rng, dev)
    nD, N, p, _ = panels.shape
    Ln = torch.as_tensor(np.tril(rng.standard_normal((N * p, nD, nD))),
                         device=dev)
    v = torch.as_tensor(rng.standard_normal(n_J), device=dev)
    before = K.gram_matvec.launches
    assert _rel(K.gram_matvec(panels, cols, inv, Ln, v),
                K.gram_matvec_plain(panels, cols, inv, Ln, v)) <= TOL
    assert K.gram_matvec.launches == before + 1


@pytest.mark.parametrize("spec,p", [(2, 1.0), (1, 2.0), (0, 1.5), (0, 3.0)])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_power_cone(dev, mode, spec, p):
    rng = np.random.default_rng(10 * mode + spec)
    m, nD, idx = 1000, 4, (1, 2, 3)
    Dz = rng.standard_normal((m, nD))
    Dz[:, 3] = np.sqrt((Dz[:, 1:3] ** 2).sum(axis=1)) ** p \
        + rng.uniform(1e-3, 1.0, m)
    Dz[:50, 3] = -rng.uniform(0.0, 1.0, 50)     # s < 0
    Dz[50:60, 3] = 0.0                           # s == 0
    Dz[60:80, 3] *= 0.1                          # inside |q|^p: log of < 0
    bw = np.full(m, 1.0 / m)
    bw[40:45] = 0.0                              # masked infeasible nodes
    bw[100:110] = 0.0
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    A = t(np.tile(np.eye(3).reshape(1, 9), (m, 1))
          + 0.01 * rng.standard_normal((m, 9)))
    b = t(0.01 * rng.standard_normal((m, 3)))
    pp, mu = t(np.full(m, p)), t(np.full(m, 0.0 if p <= 2 else 1.0))
    args = (t(Dz), A, b, pp, mu, t(bw), t(rng.standard_normal((m, nD))),
            idx, spec)
    before = K.power_cone_eval.launches
    assert _rel(K.power_cone_eval(mode, *args),
                K.power_cone_plain(mode, *args)) <= TOL
    assert K.power_cone_eval.launches == before + 1


def _fronts(rng, nk, a, b):
    """SPD fronts (nk, f+1, f+1) with a trailing dump slot, A slightly
    asymmetric (the factor symmetrizes it)."""
    f = a + b
    X = rng.standard_normal((nk, f, 2 * f))
    F = np.zeros((nk, f + 1, f + 1))
    F[:, :f, :f] = X @ X.transpose(0, 2, 1) / f + 0.5 * np.eye(f)
    F[:, :a, :a] += 1e-14 * rng.standard_normal((nk, a, a))
    return F


# (nk, amax, bmax): fem2d_P2 L=5 and L=7 nested-dissection levels
FRONTS = [(64, 73, 16), (32, 3, 24), (1, 31, 1), (7, 1, 18), (4, 91, 190)]


@pytest.mark.parametrize("nk,a,b", FRONTS)
def test_front_factor(dev, nk, a, b):
    rng = np.random.default_rng(a + b)
    F = _fronts(rng, nk, a, b)
    if nk > 1:
        F[1, a // 2, a // 2] = -1e3               # not positive definite
    F = torch.as_tensor(F, device=dev)
    before = K.front_factor.launches
    for out, ref in zip(K.front_factor(F, a, b), K.front_factor_plain(F, a, b)):
        assert _rel(out, ref) <= TOL
    assert K.front_factor.launches == before + 1


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("nk,a,b", FRONTS)
def test_front_solve(dev, nk, a, b, transpose):
    rng = np.random.default_rng(a * b)
    F = torch.as_tensor(_fronts(rng, nk, a, b), device=dev)
    Lf = K.front_factor_plain(F, a, b)[0].contiguous()   # the library's is
    # column-major; the kernel takes row-major factors, as K5a writes them
    r = torch.as_tensor(rng.standard_normal((nk, a)), device=dev)
    before = K.front_solve.launches
    assert _rel(K.front_solve(Lf, r, transpose),
                K.front_solve_plain(Lf, r, transpose)) <= TOL
    assert K.front_solve.launches == before + 1


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    rng = np.random.default_rng(3)
    panels, cols, inv, n_J = _panels(rng, dev)
    s = torch.zeros(n_J, dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="float64"):
        K.panel_fwd(panels, cols, s)
    with pytest.raises(ValueError, match="devices"):
        K.panel_fwd(panels, cols.cpu(), s.double())
