"""PyTorch port, barrier layer: the power cone's per-node F0/F1/F2 (kernel
K2's plain version) and the level f0/f1/f2 match the JAX x64 functions to
1e-13 at feasible points and give the identical non-finite pattern (NaN vs
+-inf, entry by entry) at infeasible ones; F1/F2 match torch.autograd of
F0/F1, as tests/test_convex.py checks the JAX forms against jax.grad."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgbtpu
import mgbtpu_torch
from mgbtpu.solver.barrier import make_level_fns as level_ref
from mgbtpu.solver.barrier import node_factors as node_factors_ref
from mgbtpu.solver.levelops import build_panel_ops as build_ref
from mgbtpu_torch.interop import from_reference_arrays
from mgbtpu_torch.solver.barrier import make_level_fns, node_factors

torch.set_num_threads(1)
TOL = 1e-13
IDX = (1, 2, 3)


def _cones(p, n):
    x = np.zeros((n, 2))
    Qj = mgbtpu.convex_euclidian_power(idx=IDX, p=p, x=x, dtype=np.float64)
    Qt = mgbtpu_torch.convex_euclidian_power(idx=IDX, p=p, x=x)
    return Qj, Qt


def _points(rng, n, feasible, p):
    Dz = rng.standard_normal((n, 4))
    qn = np.sqrt((Dz[:, 1:3] ** 2).sum(axis=1)) ** p
    Dz[:, 3] = qn + rng.uniform(0.05, 2.0, n)
    if not feasible:
        # beyond the walls: s < 0, s == 0 exactly, and 0 < s < |q|^p
        k = n // 4
        Dz[:k, 3] = -rng.uniform(0.0, 1.0, k)
        Dz[k:2 * k, 3] = 0.0
        Dz[2 * k:3 * k, 3] = 0.5 * qn[2 * k:3 * k]
    return Dz


def _per_node_ref(Qj, Dz, mode):
    F = Qj.barrier[mode]
    return np.asarray(jax.vmap(F)(*Qj.args, jnp.asarray(Dz)))


def _per_node(Qt, Dz, mode):
    Dzt = torch.tensor(Dz)
    n = Dz.shape[0]
    args = tuple(torch.tensor(a) for a in Qt.args)
    return Qt.barrier(mode, args, Dzt, torch.ones(n, dtype=torch.float64),
                      torch.zeros_like(Dzt)).numpy()


def _same_nonfinite(a, b):
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(np.isposinf(a), np.isposinf(b))
    np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b))


@pytest.mark.parametrize("p", [1.0, 1.5, 2.0, 3.0])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_power_cone_matches_jax(p, mode):
    rng = np.random.default_rng(int(p * 10) + mode)
    n = 64
    Qj, Qt = _cones(p, n)
    for feasible in (True, False):
        Dz = _points(rng, n, feasible, p)
        ref = _per_node_ref(Qj, Dz, mode)
        got = _per_node(Qt, Dz, mode)
        assert got.shape == ref.shape
        _same_nonfinite(got, ref)
        fin = np.isfinite(ref)
        if feasible:
            assert fin.all()
        err = np.abs(got[fin] - ref[fin]).max(initial=0.0)
        assert err <= TOL * max(np.abs(ref[fin]).max(initial=0.0), 1.0)


@pytest.mark.parametrize("p", [1.0, 1.5, 3.0])
def test_power_cone_derivatives_vs_autograd(p):
    rng = np.random.default_rng(7)
    n = 16
    _, Qt = _cones(p, n)
    Dz = torch.tensor(_points(rng, n, True, p), requires_grad=True)
    args = tuple(torch.tensor(a) for a in Qt.args)
    ones = torch.ones(n, dtype=torch.float64)
    zeros = torch.zeros((n, 4), dtype=torch.float64)
    F0 = Qt.barrier(0, args, Dz, ones, zeros)
    (g_ad,) = torch.autograd.grad(F0.sum(), Dz)
    g = Qt.barrier(1, args, Dz.detach(), ones, zeros)
    np.testing.assert_allclose(g.numpy(), g_ad.numpy(), rtol=1e-8, atol=1e-10)
    H = Qt.barrier(2, args, Dz.detach(), ones, zeros)
    for i in range(4):
        G = Qt.barrier(1, args, Dz, ones, zeros)
        (h_ad,) = torch.autograd.grad(G[:, i].sum(), Dz)
        np.testing.assert_allclose(H[:, i, :].numpy(), h_ad.numpy(),
                                   rtol=1e-7, atol=1e-9)


def _level_case(L=3):
    pj = mgbtpu.assemble(mgbtpu.amg(mgbtpu.subdivide(mgbtpu.fem2d_P2(), L)),
                         p=1.0)
    M = pj.M[0]
    oj = build_ref(M.D_fine, M.nu, M.R_fine[-1], 7, np.float64)
    A, b, p, mu = (np.asarray(a) for a in pj.Q.args)
    got = from_reference_arrays(
        device="cpu",
        convex=dict(A=A, b=b, p=p, mu=mu, idx=IDX),
        panel_ops=dict(cols=np.asarray(oj.cols), panels=np.asarray(oj.panels),
                       n_J=oj.n_J))
    z = pj.g_grid.T.reshape(-1)
    Dz0 = M.apply_D_full(z)
    w = M.w
    wc = w[:, None] * (50.0 * pj.f_grid)
    bw = np.where(w != 0, 1.0 / np.count_nonzero(w), 0.0)
    return pj, oj, got["panel_ops"], got["convex"], Dz0, wc, bw


@pytest.mark.parametrize("scale", [1e-3, 1e2])
def test_level_functions_match_jax(scale):
    """scale 1e-3: a feasible point near the start; 1e2: far outside the
    cone for most nodes (non-finite f0/f1/f2 entries)."""
    pj, oj, ot, Qt, Dz0, wc, bw = _level_case()
    fj = level_ref(pj.Q.barrier)
    ft = make_level_fns(Qt.barrier)
    rng = np.random.default_rng(3)
    s = scale * rng.standard_normal(oj.n_J)
    fa_j = (oj, jnp.asarray(Dz0), jnp.asarray(wc), jnp.asarray(bw)) + \
        tuple(pj.Q.args)
    # one device: the level's one shard (``PanelOps.split``)
    fa_t = (ot, (torch.tensor(Dz0),), (torch.tensor(wc),),
            (torch.tensor(bw),), (tuple(torch.tensor(a) for a in Qt.args),))
    for k in range(3):
        ref = np.asarray(fj[k](jnp.asarray(s), *fa_j))
        got = ft[k](torch.tensor(s), *fa_t).numpy()
        assert got.shape == ref.shape
        _same_nonfinite(got, ref)
        fin = np.isfinite(ref)
        if scale < 1:
            assert fin.all()
        err = np.abs(got[fin] - ref[fin]).max(initial=0.0)
        assert err <= TOL * max(np.abs(ref[fin]).max(initial=0.0), 1.0)


def test_node_factors_match_jax():
    rng = np.random.default_rng(5)
    m = 200
    B = rng.standard_normal((m, 4, 4))
    Y = B @ np.swapaxes(B, 1, 2)             # SPD blocks
    Y[:10] = -Y[:10]                         # indefinite: diagonal fallback
    Y[10:, 0, :] = Y[10:, :, 0] = 0.0        # the zero u row of the p-Laplace
                                             # F2 blocks: jitter pivots
    ref = np.asarray(node_factors_ref(jnp.asarray(Y)))
    got = node_factors(torch.tensor(Y)).numpy()
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()
